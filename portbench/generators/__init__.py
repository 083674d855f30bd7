"""On-device snapshot generators, one module per kind of simulation output.

A configuration file names its generator (``"generator": "nyx"``); the
module's ``fields(cfg, seed, device)`` yields ``(name, tensor)`` pairs, one
field at a time, made on ``device`` from ``seed`` alone."""

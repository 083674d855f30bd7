"""portbench: the benchmark of ``repro_torch``, the PyTorch/CUDA port.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench.run --workload nyx512.sz_abs --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by the name the cell's
entry gives: ``configs/<config>.json`` (sizes, source, ``assumed``,
``reduced``, and the name of its on-device generator in ``generators/``),
``mixes/<traffic>.json`` (compressor, settings per field, the reference
that judges it) and ``metrics/<metric>.py`` (a reader of the trace).
``reference/`` holds the plain coders that decide ``correct``; they import
nothing of the port.
"""

"""The trainer: the train step with the compressed cross-pod gradient hop,
the fault-tolerant loop, the elastic helpers, and the supervised fault drill
(fault injection and the supervisor) — the port of ``repro.train``."""

"""The trainer: the train step with the compressed cross-pod gradient hop,
the fault-tolerant loop and the elastic helpers (the port of
``repro.train``, without its fault drill and supervisor)."""

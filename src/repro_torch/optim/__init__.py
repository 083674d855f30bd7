"""The optimiser and learning-rate schedules of the trainer (the port of
``repro.optim``)."""

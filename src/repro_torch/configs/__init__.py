"""The ten architecture configs of ``repro.configs`` (data only) and the
registry that resolves ``--arch`` and builds models."""

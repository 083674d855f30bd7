"""The dense model family of ``repro.models``: configs, parameter specs,
layers with the blockfloat8 KV codec, and ``DenseLM``."""

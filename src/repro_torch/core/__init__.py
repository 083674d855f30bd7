"""repro_torch.core — TPU-SZ on PyTorch: bit packing, Lorenzo prediction,
the field transforms and the compressor registry."""

from repro_torch.core import api, bitpack, sz, transforms
from repro_torch.core.api import CompressionResult, available, get_compressor

__all__ = [
    "api",
    "bitpack",
    "sz",
    "transforms",
    "CompressionResult",
    "available",
    "get_compressor",
]

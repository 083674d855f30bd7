"""repro_torch.core — TPU-SZ and TPU-ZFP on PyTorch: bit packing, Lorenzo
prediction, the ZFP block transform and coder, the field transforms and the
compressor registry."""

from repro_torch.core import api, bitpack, sz, transforms, zfp
from repro_torch.core.api import CompressionResult, available, get_compressor

__all__ = [
    "api",
    "bitpack",
    "sz",
    "transforms",
    "zfp",
    "CompressionResult",
    "available",
    "get_compressor",
]

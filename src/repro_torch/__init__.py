"""repro_torch — the PyTorch/CUDA port of ``repro``: the TPU lossy compressors,
their snapshot path, and the LM serving stack whose KV cache they compress.

The JAX package ``repro`` is the reference; this package mirrors its module
names and emits the same streams.  It imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``.

Entry points run on a CUDA device unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`).  Below them, every function runs where its
tensor lives: a CUDA tensor goes through the hand-written Hopper kernel in
``repro_torch.kernels`` (or raises if the kernel library cannot be built or
loaded), a CPU tensor through the kernel's plain PyTorch version.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

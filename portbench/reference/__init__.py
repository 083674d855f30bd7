"""The plain references that decide ``correct``.

Each module here is a plain PyTorch coder, a frozen copy of the port's plain
versions of one compressor route, that imports nothing of the port, of jax
or of the JAX package.  It rederives the guarded bound, the partitions and
the stream from the benchmark's own inputs, and reads the program's results
only to judge them.  A mix names its reference (``"reference":
"sz_tiled"``); a module gives

* ``compress(x, kwargs) -> dict[str, Tensor]``: the stream;
* ``decompress(stream, x_shape, kwargs) -> Tensor``: the reconstruction;
* ``program_stream(result) -> dict[str, Tensor]``: the same keys, read from
  the program's ``CompressionResult``;
* ``guarantees(x, recon, kwargs) -> dict[str, Tensor]`` and ``LIMITS``: the
  numbers the configuration states a limit for, as 0-d tensors computed on
  the device without waiting for it.
"""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"portbench.reference.{name}")

"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

The library's name carries a hash of its source, of every ``csrc/*.cuh``
header and of the flags, so an edited kernel is rebuilt and an unchanged one
is reused.  The build runs at first use (or from :func:`build`), never at
import; it writes only under ``kernels/build/``.  Libraries are loaded with
``ctypes``: pointers and the stream are ``c_void_p``, and every C entry point
returns ``cudaGetLastError()`` after its launch, which :func:`launch` turns
into an exception.  ``--use_fast_math`` is never passed: the kernels rely on
IEEE division and round-half-even conversions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH,
    else the toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` each, in
    parallel.  Returns the compiler output per source (with ``-Xptxas=-v``
    register and shared-memory reports when ``verbose``); raises
    ``RuntimeError`` with the compiler's errors if any source fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(src, library_path(src.stem)) for src in sources()]
    todo = [(src, out) for src, out in todo if not out.exists()]
    if not todo:
        return {}
    compiler = nvcc()
    procs = []
    try:
        for src, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
                   "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = {}, []
        for src, out, tmp, proc in procs:
            logs[src.stem], _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{logs[src.stem]}")
            else:
                os.replace(tmp, out)  # atomic: a reader never sees a partial library
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [I]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launch(lib_name: str, fn_name: str, argtypes: list, *args, device: torch.device) -> None:
    """Call C entry point ``fn_name`` on ``device`` with PyTorch's current
    stream appended as the last argument; raise if the launch failed."""
    key = (lib_name, fn_name)
    fn = _FUNCS.get(key)
    lib = library(lib_name)
    if fn is None:
        fn = getattr(lib, fn_name)
        fn.argtypes = [*argtypes, P]
        fn.restype = I
        _FUNCS[key] = fn
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc} "
                           f"({lib.repro_error_string(rc).decode()})")


def check_cuda(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    """A kernel takes contiguous CUDA tensors of one dtype and nothing else."""
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: want a contiguous {dtype} CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")

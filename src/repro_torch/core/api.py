"""Compressor registry and (de)compression front end (the port of
``repro.core.api``, TPU-SZ only so far).

Modes (paper §II-A):
  * ``abs``     — error-bounded, |x̂ - x| <= eb           (TPU-SZ)
  * ``pw_rel``  — pointwise relative via log transform    (TPU-SZ, Liang'18)

A compressor runs on one device, CUDA unless ``device="cpu"`` is passed
(:func:`repro_torch.device.resolve_device`): inputs are moved there,
payloads live there, and a payload on another device is refused.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import sz, transforms
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CompressionResult:
    """Host-facing record: payload + exact storage accounting."""

    payload: Any
    nbytes: int
    raw_nbytes: int
    meta: dict[str, Any]

    @property
    def ratio(self) -> float:
        return self.raw_nbytes / max(self.nbytes, 1)

    @property
    def bitrate(self) -> float:
        """Bits per value: compressed bits over the f32 value count."""
        return 8.0 * self.nbytes / max(self.raw_nbytes / 4.0, 1.0)


class SZCompressor:
    """TPU-SZ front end. Accepts 1-D/2-D/3-D fields; 1-D fields are reshaped
    to the paper's 3-D partitions before prediction (§IV-B4).

    ``backend`` selects the encode/decode engine for 3-D fields:
      * ``core``   — global Lorenzo in plain PyTorch (best compression ratio;
                     the default on the CPU),
      * ``kernel`` — tile-blocked prediction through
                     :func:`repro_torch.kernels.ops.sz_compress_kernel`
                     (the hand-written K3/K4 kernels on CUDA),
      * ``auto``   — ``kernel`` on CUDA, ``core`` on the CPU.
    Non-3-D fields always use the core path.  Partitions are compressed one
    after another (the reference batches them with ``vmap``)."""

    name = "tpu-sz"

    def __init__(self, block_size: int | None = None, reshape_1d: bool = True,
                 backend: str = "auto", device: str | torch.device | None = None):
        if backend not in ("auto", "core", "kernel"):
            raise ValueError(f"unknown SZ backend {backend!r}; want auto|core|kernel")
        self.block_size = block_size
        self.reshape_1d = reshape_1d
        self.backend = backend
        self.device = resolve_device(device)

    def _use_kernel(self, x: torch.Tensor) -> bool:
        if x.ndim != 3 or self.block_size is not None:
            return False
        if self.backend == "kernel":
            return True
        return self.backend == "auto" and self.device.type == "cuda"

    def _canonical(self, x: torch.Tensor) -> tuple[list[torch.Tensor], dict]:
        if x.ndim == 1 and self.reshape_1d:
            shaped = []
            for p in transforms.partition_1d(x):
                side = max(4, int(np.ceil(len(p) ** (1 / 3))))
                shaped.append(transforms.to_3d(p, (side, side, side)))
            return shaped, {"orig_len": x.shape[0], "was_1d": True}
        return [x], {"orig_len": math.prod(x.shape), "was_1d": False}

    def _compress_parts(self, parts: list[torch.Tensor], eb) -> tuple[list, int]:
        comp = [sz.compress(p, eb, self.block_size) for p in parts]
        # per-part bit counts summed on the host as Python ints (many
        # partitions can exceed 2**31 bits combined)
        return comp, sum(int(c.packed.total_bits) for c in comp)

    def compress(self, x, eb: float | None = None, pw_rel: float | None = None,
                 **_: Any) -> CompressionResult:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        raw = math.prod(x.shape) * 4
        side_bits = 0
        meta: dict[str, Any] = {"mode": "abs", "eb": eb}
        signs = None
        if pw_rel is not None:
            t = transforms.log_forward(x)
            x, signs = t.logs, t.signs
            eb = transforms.pwrel_to_abs(pw_rel)
            side_bits = transforms.sign_channel_bits(math.prod(x.shape))
            meta = {"mode": "pw_rel", "pw_rel": pw_rel, "eb_log": eb}
        if eb is None:
            raise ValueError("SZ requires eb= (ABS) or pw_rel=")
        if self._use_kernel(x):
            from repro_torch.kernels import ops as kops

            packed, padded_shape, eb_i = kops.sz_compress_kernel(x, eb)
            nbits = int(packed.total_bits) + side_bits
            payload = {"kernel": True, "kpacked": packed, "padded_shape": padded_shape,
                       "eb_i": eb_i, "signs": signs, "shape": tuple(x.shape),
                       "orig_len": math.prod(x.shape), "was_1d": False}
            meta.update({"was_1d": False, "backend": "kernel"})
            return CompressionResult(payload, (nbits + 7) // 8, raw, meta)
        parts, shape_meta = self._canonical(x)
        comp, nbits = self._compress_parts(parts, eb)
        nbits += side_bits
        payload = {"parts": comp, "signs": signs, "shape": tuple(x.shape), **shape_meta}
        meta.update(shape_meta)
        return CompressionResult(payload, (nbits + 7) // 8, raw, meta)

    def decompress(self, r: CompressionResult) -> torch.Tensor:
        packed = (r.payload["kpacked"] if r.payload.get("kernel")
                  else r.payload["parts"][0].packed)
        if packed.words.device.type != self.device.type:
            raise ValueError(f"payload on {packed.words.device}, compressor on {self.device}; "
                             f"rebuild the payload with device={self.device.type!r}")
        if r.payload.get("kernel"):
            from repro_torch.kernels import ops as kops

            x = kops.sz_decompress_kernel(r.payload["kpacked"], r.payload["padded_shape"],
                                          r.payload["shape"], r.payload["eb_i"])
        else:
            parts = [sz.decompress(c) for c in r.payload["parts"]]
            if r.payload["was_1d"]:
                part = transforms.HACC_PARTITION
                flats = [transforms.from_3d(p, min(part, r.payload["orig_len"] - i * part))
                         for i, p in enumerate(parts)]
                x = torch.cat(flats)[: r.payload["orig_len"]]
            else:
                x = parts[0].reshape(r.payload["shape"])
        if r.meta["mode"] == "pw_rel":
            t = transforms.LogTransformed(x, r.payload["signs"], torch.zeros(()))
            x = transforms.log_inverse(t)
        return x


_REGISTRY: dict[str, Callable[..., Any]] = {
    "tpu-sz": SZCompressor,
}


def get_compressor(name: str, **kwargs: Any):
    if name not in _REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available() -> list[str]:
    return sorted(_REGISTRY)

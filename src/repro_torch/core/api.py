"""Compressor registry and (de)compression front end (the port of
``repro.core.api``).

Modes (paper §II-A):
  * ``abs``     — error-bounded, |x̂ - x| <= eb           (TPU-SZ)
  * ``pw_rel``  — pointwise relative via log transform    (TPU-SZ, Liang'18)
  * ``rate``    — fixed rate, exact bits/value            (TPU-ZFP)

A compressor runs on one device, CUDA unless ``device="cpu"`` is passed
(:func:`repro_torch.device.resolve_device`): inputs are moved there,
payloads live there, and a payload on another device is refused.

Traced (:mod:`repro_torch.obs.trace`): each ``compress`` and ``decompress``
is a call (``api.compress``, ``api.decompress``, with the compressor and the
raw bytes); the 1-D route's pad and reshape of each partition
(``route.to_3d``; on SZ's route with the counters ``codes``, the cube's
values, and ``pad``, the zeros it added) and the join of the parts
(``route.cat``) are spans, so the copies they put on the device are put
down to them; PW_REL's log transform and its inverse are
``pwrel.log_forward`` (with ``sign_bits``, the side channel's bits) and
``pwrel.log_inverse``; each host read-back is a ``sync.<what>`` span, so
their count a call is the call's host syncs.  The core coder's own spans
are :mod:`repro_torch.core.sz`'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import sz, transforms, zfp
from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace


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


def _check_payload_device(words: torch.Tensor, device: torch.device) -> None:
    if words.device.type != device.type:
        raise ValueError(f"payload on {words.device}, compressor on {device}; "
                         f"rebuild the payload with device={device.type!r}")


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
                with obs_trace.span("route.to_3d", codes=side ** 3, pad=side ** 3 - len(p)):
                    shaped.append(transforms.to_3d(p, (side, side, side)))
            return shaped, {"orig_len": x.shape[0], "was_1d": True}
        return [x], {"orig_len": math.prod(x.shape), "was_1d": False}

    def _compress_parts(self, parts: list[torch.Tensor], eb) -> tuple[list, int]:
        comp = [sz.compress(p, eb, self.block_size) for p in parts]
        # per-part bit counts summed on the host as Python ints (many
        # partitions can exceed 2**31 bits combined)
        with obs_trace.span("sync.total_bits"):
            return comp, sum(int(c.packed.total_bits) for c in comp)

    def compress(self, x, eb: float | None = None, pw_rel: float | None = None,
                 **_: Any) -> CompressionResult:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        raw = math.prod(x.shape) * 4
        with obs_trace.call("api.compress", compressor=self.name, raw_bytes=raw):
            side_bits = 0
            meta: dict[str, Any] = {"mode": "abs", "eb": eb}
            signs = None
            if pw_rel is not None:
                side_bits = transforms.sign_channel_bits(math.prod(x.shape))
                with obs_trace.span("pwrel.log_forward", sign_bits=side_bits):
                    t = transforms.log_forward(x)
                x, signs = t.logs, t.signs
                eb = transforms.pwrel_to_abs(pw_rel)
                meta = {"mode": "pw_rel", "pw_rel": pw_rel, "eb_log": eb}
            if eb is None:
                raise ValueError("SZ requires eb= (ABS) or pw_rel=")
            if self._use_kernel(x):
                from repro_torch.kernels import ops as kops

                packed, padded_shape, eb_i = kops.sz_compress_kernel(x, eb)
                with obs_trace.span("sync.total_bits"):
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
        _check_payload_device(packed.words, self.device)
        with obs_trace.call("api.decompress", compressor=self.name, raw_bytes=r.raw_nbytes):
            if r.payload.get("kernel"):
                from repro_torch.kernels import ops as kops

                x = kops.sz_decompress_kernel(r.payload["kpacked"], r.payload["padded_shape"],
                                              r.payload["shape"], r.payload["eb_i"])
            else:
                parts = [sz.decompress(c) for c in r.payload["parts"]]
                if r.payload["was_1d"]:
                    part = transforms.HACC_PARTITION
                    with obs_trace.span("route.cat"):
                        flats = [transforms.from_3d(p, min(part, r.payload["orig_len"] - i * part))
                                 for i, p in enumerate(parts)]
                        x = torch.cat(flats)[: r.payload["orig_len"]]
                else:
                    x = parts[0].reshape(r.payload["shape"])
            if r.meta["mode"] == "pw_rel":
                with obs_trace.span("pwrel.log_inverse"):
                    t = transforms.LogTransformed(x, r.payload["signs"], torch.zeros(()))
                    x = transforms.log_inverse(t)
            return x


class ZFPCompressor:
    """TPU-ZFP front end (fixed rate).  1-D fields are partitioned to the
    paper's HACC layout and each partition goes through the (N/64) x 8 x 8
    reshape (§IV-B4); 2-D fields get a trailing unit axis.

    ``backend`` selects the engine (as for :class:`SZCompressor`):
      * ``core``   — the word-level coder of :mod:`repro_torch.core.zfp` in
                     plain PyTorch (the default on the CPU),
      * ``kernel`` — :func:`repro_torch.kernels.ops.zfp_compress_kernel`
                     (the hand-written K6/K7 kernels on CUDA),
      * ``auto``   — ``kernel`` on CUDA, ``core`` on the CPU.
    All backends emit the same ``words``/``emax``/``gtops`` and decode each
    other's payloads.  Partitions are compressed one after another (the
    reference batches same-shape partitions with ``vmap``).

    Accounting: ``raw_nbytes`` (hence ``ratio``/``bitrate``) uses the
    original element count; the padding of the reshapes is charged to the
    compressed size."""

    name = "tpu-zfp"

    def __init__(self, reshape_1d: bool = True, backend: str = "auto",
                 device: str | torch.device | None = None):
        if backend not in ("auto", "core", "kernel"):
            raise ValueError(f"unknown ZFP backend {backend!r}; want auto|core|kernel")
        self.reshape_1d = reshape_1d
        self.backend = backend
        self.device = resolve_device(device)

    def _use_kernel(self) -> bool:
        if self.backend == "kernel":
            return True
        return self.backend == "auto" and self.device.type == "cuda"

    def _canonical(self, x: torch.Tensor) -> tuple[list[torch.Tensor], dict]:
        if x.ndim == 1:
            # cuZFP on HACC uses (N/64) x 8 x 8 partitions; the coder is
            # 3-D only, so the reshape is mandatory and ``reshape_1d=False``
            # only skips the HACC partitioning
            parts = transforms.partition_1d(x) if self.reshape_1d else [x]
            shaped = []
            for p in parts:
                with obs_trace.span("route.to_3d"):
                    shaped.append(transforms.to_3d(p, (-(-p.shape[0] // 64), 8, 8)))
            return shaped, {"orig_len": x.shape[0], "was_1d": True}
        if x.ndim == 2:
            x = x[:, :, None]
        return [x], {"orig_len": math.prod(x.shape), "was_1d": False}

    def compress(self, x, rate: int | None = None, **_: Any) -> CompressionResult:
        if rate is None:
            raise ValueError("ZFP requires rate= (bits/value)")
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        raw = math.prod(x.shape) * 4  # original count: padding not charged
        with obs_trace.call("api.compress", compressor=self.name, raw_bytes=raw):
            orig_shape = tuple(x.shape)
            parts, shape_meta = self._canonical(x)
            backend = "kernel" if self._use_kernel() else "core"
            if backend == "kernel":
                from repro_torch.kernels import ops as kops

                comp = [kops.zfp_compress_kernel(p, rate) for p in parts]
            else:
                comp = [zfp.compress(p, rate) for p in parts]
            nbytes = sum(zfp.compressed_nbytes(c) for c in comp)
            payload = {"parts": comp, "orig_shape": orig_shape, **shape_meta}
            return CompressionResult(payload, nbytes, raw,
                                     {"mode": "rate", "rate": rate, "backend": backend,
                                      **shape_meta})

    def decompress(self, r: CompressionResult) -> torch.Tensor:
        _check_payload_device(r.payload["parts"][0].words, self.device)
        with obs_trace.call("api.decompress", compressor=self.name, raw_bytes=r.raw_nbytes):
            if self._use_kernel():
                from repro_torch.kernels import ops as kops

                parts = [kops.zfp_decompress_kernel(c) for c in r.payload["parts"]]
            else:
                parts = [zfp.decompress(c) for c in r.payload["parts"]]
            orig = r.payload["orig_shape"]
            if r.payload["was_1d"]:
                with obs_trace.span("route.cat"):
                    return torch.cat([p.reshape(-1) for p in parts])[: orig[0]]
            x = parts[0]
            if len(orig) == 2:
                return x[:, :, 0]
            return x


_REGISTRY: dict[str, Callable[..., Any]] = {
    "tpu-sz": SZCompressor,
    "tpu-zfp": ZFPCompressor,
}


def get_compressor(name: str, **kwargs: Any):
    if name not in _REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available() -> list[str]:
    return sorted(_REGISTRY)

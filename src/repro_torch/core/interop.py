"""Carry compressed payloads between the JAX package and the port.

Every engine of either package emits the same stream (DESIGN.md §1), so each
side decodes the other's payloads once they cross.  They cross as a
*record*: the ``CompressionResult`` fields with every array as numpy.  The
JAX side builds or reads a record with ``np.asarray`` on its arrays; this
module turns a record into the port's :class:`CompressionResult` on a device
and back.  The payload layouts covered:

* SZ core (``parts``): ``{"parts": [part...], "signs", "shape", "orig_len",
  "was_1d"}`` with ``part = {"packed", "eb", "shape", "block_size"}``;
* SZ kernel: ``{"kernel": True, "kpacked", "padded_shape", "eb_i", "signs",
  "shape", "orig_len", "was_1d"}``;
* ZFP, either backend (``meta["mode"] == "rate"``): ``{"parts": [part...],
  "orig_shape", "orig_len", "was_1d"}`` with ``part = {"words":
  uint32[nb, wpb], "emax": uint8[nb], "gtops": uint8[nb, 10], "shape",
  "rate"}``;

where a packed stream is ``{"words": uint32[n + 2], "widths": uint8[nb],
"total_bits": int, "n": int}``, bounds are float32 scalars and ``signs`` is
an int8 array or ``None``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import bitpack, sz, zfp
from repro_torch.core.api import CompressionResult
from repro_torch.device import resolve_device


def _packed_to_record(p: bitpack.PackedCodes) -> dict[str, Any]:
    return {"words": bitpack.to_numpy(p.words), "widths": bitpack.to_numpy(p.widths),
            "total_bits": int(p.total_bits), "n": int(p.n)}


def _packed_from_record(rec: dict[str, Any], device) -> bitpack.PackedCodes:
    return bitpack.from_storage(rec["words"], rec["widths"], int(rec["n"]), rec["total_bits"],
                                device=device)


def _signs_from(v, device):
    return None if v is None else torch.from_numpy(np.array(v, np.int8)).to(device)


def _zfp_to_record(r: CompressionResult) -> dict[str, Any]:
    p = r.payload
    parts = [{"words": bitpack.to_numpy(c.words), "emax": bitpack.to_numpy(c.emax),
              "gtops": bitpack.to_numpy(c.gtops), "shape": tuple(c.shape), "rate": int(c.rate)}
             for c in p["parts"]]
    payload = {"parts": parts, "orig_shape": tuple(p["orig_shape"]),
               "orig_len": int(p["orig_len"]), "was_1d": bool(p["was_1d"])}
    return {"payload": payload, "nbytes": int(r.nbytes), "raw_nbytes": int(r.raw_nbytes),
            "meta": dict(r.meta)}


def _zfp_from_record(rec: dict[str, Any], device: torch.device) -> CompressionResult:
    p = rec["payload"]
    parts = [zfp.from_words(c["words"], c["emax"], c["gtops"], c["shape"], int(c["rate"]),
                            device=device) for c in p["parts"]]
    payload = {"parts": parts, "orig_shape": tuple(p["orig_shape"]),
               "orig_len": int(p["orig_len"]), "was_1d": bool(p["was_1d"])}
    return CompressionResult(payload, int(rec["nbytes"]), int(rec["raw_nbytes"]),
                             dict(rec["meta"]))


def to_record(r: CompressionResult) -> dict[str, Any]:
    """The port's result -> a numpy record the JAX package can rebuild."""
    if r.meta["mode"] == "rate":
        return _zfp_to_record(r)
    p = r.payload
    signs = None if p["signs"] is None else bitpack.to_numpy(p["signs"])
    common = {"signs": signs, "shape": tuple(p["shape"]), "orig_len": int(p["orig_len"]),
              "was_1d": bool(p["was_1d"])}
    if p.get("kernel"):
        payload = {"kernel": True, "kpacked": _packed_to_record(p["kpacked"]),
                   "padded_shape": tuple(p["padded_shape"]),
                   "eb_i": np.float32(bitpack.to_numpy(p["eb_i"])), **common}
    else:
        payload = {"parts": [{"packed": _packed_to_record(c.packed),
                              "eb": np.float32(bitpack.to_numpy(c.eb)),
                              "shape": tuple(c.shape), "block_size": c.block_size}
                             for c in p["parts"]], **common}
    return {"payload": payload, "nbytes": int(r.nbytes), "raw_nbytes": int(r.raw_nbytes),
            "meta": dict(r.meta)}


def from_record(rec: dict[str, Any],
                device: str | torch.device | None = None) -> CompressionResult:
    """A numpy record (from either package) -> the port's result on ``device``
    (CUDA unless ``"cpu"``, :func:`repro_torch.device.resolve_device`)."""
    device = resolve_device(device)
    if rec["meta"]["mode"] == "rate":
        return _zfp_from_record(rec, device)
    p = rec["payload"]
    common = {"signs": _signs_from(p["signs"], device), "shape": tuple(p["shape"]),
              "orig_len": int(p["orig_len"]), "was_1d": bool(p["was_1d"])}
    if p.get("kernel"):
        payload = {"kernel": True, "kpacked": _packed_from_record(p["kpacked"], device),
                   "padded_shape": tuple(p["padded_shape"]),
                   "eb_i": sz.f32_scalar(p["eb_i"], device), **common}
    else:
        payload = {"parts": [sz.SZCompressed(_packed_from_record(c["packed"], device),
                                             sz.f32_scalar(c["eb"], device), tuple(c["shape"]),
                                             c["block_size"])
                             for c in p["parts"]], **common}
    return CompressionResult(payload, int(rec["nbytes"]), int(rec["raw_nbytes"]),
                             dict(rec["meta"]))

"""Architecture registry: ``--arch <id>`` resolution, model construction and
the shape cells (the port of ``repro.configs.registry``).

Every arch's config resolves and :func:`build_model` builds every family:
``DenseLM`` (``dense``, ``vlm``), ``MoELM`` (``moe``), ``RWKV6LM``
(``ssm``), ``HymbaLM`` (``hybrid``) and ``EncDecLM`` (``audio``,
``encdec``), on the card, the CPU or the abstract ``meta`` device.
:func:`supports` says which (arch, shape) cells run, with the reference's
reasons, and :func:`input_specs` gives a cell's inputs as ``meta`` tensors
(the reference's ``ShapeDtypeStruct`` stand-ins) for the cost sweep
(:mod:`repro_torch.launch.dryrun`, :mod:`repro_torch.launch.costrun`).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

from repro_torch.models.config import ArchConfig

_MODULES = {
    "whisper-base": "whisper_base",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "hymba-1.5b": "hymba_1p5b",
    "qwen1.5-110b": "qwen15_110b",
    "starcoder2-3b": "starcoder2_3b",
    "phi3-medium-14b": "phi3_medium_14b",
    "minicpm-2b": "minicpm_2b",
    "internvl2-76b": "internvl2_76b",
    "rwkv6-1.6b": "rwkv6_1p6b",
}

ARCH_IDS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# long-context decode needs sub-quadratic attention: run only for
# SSM / hybrid archs; full-attention archs skip (DESIGN.md §5).
_SUBQUADRATIC_FAMILIES = {"ssm", "hybrid"}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def model_class(cfg: ArchConfig):
    """The model class of ``cfg``'s family."""
    if cfg.family in ("dense", "vlm"):
        from repro_torch.models.transformer import DenseLM

        return DenseLM
    if cfg.family == "moe":
        from repro_torch.models.moe import MoELM

        return MoELM
    if cfg.family == "ssm":
        from repro_torch.models.rwkv6 import RWKV6LM

        return RWKV6LM
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import HymbaLM

        return HymbaLM
    if cfg.family in ("audio", "encdec"):
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM
    raise ValueError(f"unknown family {cfg.family}")


def build_model(cfg: ArchConfig, device=None):
    """The model of ``cfg``'s family on ``device`` (CUDA unless ``"cpu"`` or
    ``"meta"``)."""
    return model_class(cfg)(cfg, device=device)


def supports(cfg: ArchConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Whether this (arch, shape) cell is runnable; else the documented skip."""
    if shape.name == "long_500k" and shape.kind == "decode":
        if cfg.family not in _SUBQUADRATIC_FAMILIES:
            return False, "full-attention arch: 500k decode needs sub-quadratic attention (DESIGN.md §5)"
    return True, ""


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeCell,
                batch_override: Optional[int] = None) -> dict[str, torch.Tensor]:
    """``meta`` stand-ins (shape and dtype, no data) for every model input
    of this cell; ``batch_override`` replaces the cell's global batch."""
    b = batch_override or shape.global_batch
    s = shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _spec((b, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _spec((b, s), torch.int32)
        if cfg.family == "vlm":
            specs["prefix"] = _spec((b, cfg.prefix_len, cfg.d_model), torch.bfloat16)
        if cfg.family == "audio":
            specs["frames"] = _spec((b, cfg.encoder_len, cfg.d_model), torch.bfloat16)
        return specs
    # decode: one new token against a cache of seq_len
    return {"token": _spec((b,), torch.int32), "index": _spec((), torch.int32)}

"""The one traffic generator: a configuration and a mix in, the calls of one
snapshot dump out.

The configuration (``configs/<config>.json``) names its generator module
(``generators/<generator>.py``), whose fields are made on the device from
the seed.  The mix (``mixes/<traffic>.json``) names the compressor, the
reference that judges it and its settings, with per-field overrides under
``"fields"``; ``"box"`` (in the mix, else in the configuration) is the
shape ``[z, y, x]`` of the boxes a 3-D field is held and handed over in (one
number for a cube).  Settings:

* ``{"mode": "abs", "rel_eb": r}``: ``eb = r * (max - min)`` of the whole
  field, ``compress(x, eb=eb)``;
* ``{"mode": "pw_rel", "pw_rel": p}``: ``compress(x, pw_rel=p)``;
* ``{"mode": "rate", "rate": k}``: ``compress(x, rate=k)``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Call:
    field: str
    x: torch.Tensor
    kwargs: dict  # the compressor's keyword arguments

    @property
    def raw_nbytes(self) -> int:
        return self.x.numel() * self.x.element_size()


@dataclasses.dataclass
class Snapshot:
    compressor: str
    reference: str
    calls: list[Call]

    @property
    def raw_nbytes(self) -> int:
        return sum(c.raw_nbytes for c in self.calls)


def load(kind: str, name: str) -> dict:
    """``configs/<name>.json`` or ``mixes/<name>.json``."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def compressor_kwargs(settings: dict, field: torch.Tensor) -> dict:
    mode = settings["mode"]
    if mode == "abs":
        return {"eb": float(settings["rel_eb"]) * float(field.amax() - field.amin())}
    if mode == "pw_rel":
        return {"pw_rel": float(settings["pw_rel"])}
    if mode == "rate":
        return {"rate": int(settings["rate"])}
    raise ValueError(f"unknown mode {mode!r}; want abs|pw_rel|rate")


def boxes(field: torch.Tensor, box) -> list[torch.Tensor]:
    """A 3-D field as contiguous boxes of shape ``box`` (``[z, y, x]``, or one
    side for cubes), z-major; anything else, or a box that does not tile the
    field, whole."""
    if not box or field.ndim != 3:
        return [field]
    bz, by, bx = (box,) * 3 if isinstance(box, int) else box
    if any(s % b for s, b in zip(field.shape, (bz, by, bx))):
        return [field]
    gz, gy, gx = (s // b for s, b in zip(field.shape, (bz, by, bx)))
    return [field[z * bz:(z + 1) * bz, y * by:(y + 1) * by, x * bx:(x + 1) * bx].contiguous()
            for z in range(gz) for y in range(gy) for x in range(gx)]


def build(cfg: dict, mix: dict, seed: int, device) -> Snapshot:
    gen = importlib.import_module(f"portbench.generators.{cfg['generator']}")
    box = mix.get("box", cfg.get("box"))
    calls = []
    for name, field in gen.fields(cfg, seed, device):
        settings = {**mix["settings"], **mix.get("fields", {}).get(name, {})}
        kwargs = compressor_kwargs(settings, field)
        calls += [Call(name, piece, kwargs) for piece in boxes(field, box)]
        del field
    return Snapshot(mix["compressor"], mix["reference"], calls)

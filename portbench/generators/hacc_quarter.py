"""One GPU's share of a HACC snapshot, handed over in pieces.

The snapshot is made whole by :func:`portbench.generators.hacc.fields`, from
the same seed and configuration keys as ``hacc1024``; of each field the first
``keep`` particles in GenericIO's rank-major order (a node's first GPU's
ranks) are held; the rest of a field is freed once it is cut, and the
snapshot's particle arrays once the last field is out, before the window.
Each held field is yielded as contiguous pieces of ``piece`` particles,
views of it, under the field's own name, so a mix's per-field settings
apply to each piece and its bounds are computed from the piece alone."""

from __future__ import annotations

from typing import Iterator

import torch

from portbench.generators import hacc


def fields(cfg: dict, seed: int, device) -> Iterator[tuple[str, torch.Tensor]]:
    keep, piece = int(cfg["keep"]), int(cfg["piece"])
    for name, whole in hacc.fields(cfg, seed, device):
        if not 0 < keep <= whole.numel() or piece <= 0:
            raise ValueError(f"keep {keep} of {whole.numel()} particles in pieces of {piece}")
        held = whole[:keep].clone()
        del whole
        for a in range(0, keep, piece):
            yield name, held[a:a + piece]

"""Parameter specification trees: shape + logical sharding axes + initializer
(the port of ``repro.models.spec``).

Models declare a nested dict of ``P`` leaves; :func:`init_params`
materializes tensors from an explicit ``torch.Generator`` on a given device,
and :func:`empty_params` gives the shapes without data (the ``meta`` device).
The draws are truncated normals with the reference's per-init standard
deviation, not the reference's bits (``jax.random`` and ``torch`` give
different numbers from one seed); tests that compare the two packages carry
one set of weights across with :func:`repro_torch.models.interop.params_from_jax`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional

import torch


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter: shape, logical axes (same rank), init style."""

    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | embed | small
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"rank mismatch: shape {self.shape} vs axes {self.axes}")


def is_spec(x: Any) -> bool:
    return isinstance(x, P)


def spec_items(specs: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, P]]:
    """(path, spec) for every leaf, dict keys in sorted order (the order
    ``jax.tree_util`` flattens a dict in)."""
    if is_spec(specs):
        yield prefix, specs
        return
    for k in sorted(specs):
        yield from spec_items(specs[k], prefix + (k,))


def map_specs(fn, specs: Any) -> Any:
    """The tree of ``fn(spec)`` over ``specs``."""
    if is_spec(specs):
        return fn(specs)
    return {k: map_specs(fn, v) for k, v in specs.items()}


def _std(p: P) -> float:
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    if p.init == "embed":
        return 1.0
    if p.init == "small":
        return 0.02
    return p.scale / math.sqrt(max(fan_in, 1))  # truncated-normal fan-in scaling


def _truncated_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to [-3, 3] in float32, by inverting the
    normal CDF on a uniform draw (as ``jax.random.truncated_normal`` does)."""
    lo = 0.5 * (1.0 + math.erf(-3.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(3.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = (lo + (hi - lo) * u).mul_(2.0).sub_(1.0)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0)


# A leaf of this many values or more is drawn one slice of its leading axis
# at a time: its whole float32 draw (8 GiB and up) would not fit beside the
# tree on one card (qwen3-moe's expert stacks are 9.66e9 values each).  Every
# smaller leaf, starcoder2-3b's and minicpm-2b's included, is drawn whole.
SLICED_DRAW_NUMEL = 1 << 31


def _init_leaf(p: P, generator: torch.Generator, device, dtype: torch.dtype) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if math.prod(p.shape) < SLICED_DRAW_NUMEL or len(p.shape) < 2:
        return _truncated_normal(p.shape, generator, device).mul_(_std(p)).to(dtype)
    # peak: the destination plus one float32 slice
    out = torch.empty(p.shape, dtype=dtype, device=device)
    for row in out:
        row.copy_(_truncated_normal(row.shape, generator, device).mul_(_std(p)))
    return out


def init_params(specs: Any, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32, keep=None) -> Any:
    """Materialize ``specs`` on ``device`` (default: the generator's) in
    ``dtype``; leaves are drawn in :func:`spec_items` order, a leaf of
    ``SLICED_DRAW_NUMEL`` values or more one leading-axis slice after
    another, each written straight into ``dtype``.  ``keep(path, spec,
    leaf)``, when given, is what the tree holds of each leaf as it is drawn
    (the sharded train state keeps this rank's block and drops the rest
    before the next draw)."""
    device = torch.device(device) if device is not None else generator.device
    out: dict = {}
    for path, p in spec_items(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        leaf = _init_leaf(p, generator, device, dtype)
        node[path[-1]] = leaf if keep is None else keep(path, p, leaf)
        del leaf
    return out


def empty_params(specs: Any, device, dtype: torch.dtype = torch.float32) -> Any:
    """``specs`` as uninitialised tensors on ``device``: on ``"meta"``, the
    parameters of the cost sweep (shapes and dtypes, no data, no draw)."""
    return map_specs(lambda p: torch.empty(p.shape, dtype=dtype, device=device), specs)


def param_count(specs: Any) -> int:
    return sum(math.prod(p.shape) for _, p in spec_items(specs))

"""Carry a parameter tree, or a training state, of the JAX package across to
the port.

:func:`params_from_jax` takes the reference's parameter tree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``), checks it
against the model's specs (every leaf present with its shape, no leaf left
over) and returns the port's tree on ``device``, cast once to the compute
dtype.  The reference casts every weight to ``cfg.dtype`` where it is used
(``p[...].astype(dt)``), so holding the cast copies computes the same
numbers, and at full width it saves re-reading float32 weights every step.

:func:`state_from_jax` carries a reference training state (``params``,
``opt.m``, ``opt.v``, ``opt.step`` and the error feedback ``ef``) into the
port's trainer: float32 parameters and moments, an int32 step, and, of the
reference's ``(n_pods, *shape)`` bfloat16 error-feedback stack, the row of
the pod this rank serves.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.spec import spec_items


def _leaf(tree: Any, path: tuple) -> Any:
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            raise KeyError(f"parameter {'/'.join(path)} is missing from the tree")
        node = node[k]
    return node


def _leaf_paths(tree: Any, prefix: tuple = ()) -> set:
    if not isinstance(tree, dict):
        return {prefix}
    out = set()
    for k, v in tree.items():
        out |= _leaf_paths(v, prefix + (k,))
    return out


def params_from_jax(tree: dict, specs: dict, device, dtype: torch.dtype) -> dict:
    """The port's parameters for ``specs`` from the reference's ``tree``.

    Raises ``KeyError`` for a missing or an extra leaf and ``ValueError``
    for a leaf whose shape is not its spec's."""
    out: dict = {}
    used = set()
    for path, spec in spec_items(specs):
        arr = np.asarray(_leaf(tree, path))
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"parameter {'/'.join(path)}: shape {tuple(arr.shape)}, "
                             f"spec wants {tuple(spec.shape)}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))  # a writable copy
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.to(device=device, dtype=dtype)
        used.add(path)
    extra = _leaf_paths(tree) - used
    if extra:
        raise KeyError("parameters not in the model's specs: "
                       + ", ".join(sorted("/".join(p) for p in extra)))
    return out


def _rows(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _rows(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def state_from_jax(tree: dict, specs: dict, device, *, pod: int = 0) -> dict:
    """The port's train state from the reference's ``tree``
    (``jax.tree.map(np.asarray, state)``), checked leaf for leaf against
    ``specs``.  ``ef``, when present, is the reference's stacked
    ``(n_pods, *shape)`` residual; the port keeps row ``pod``.  Raises
    ``KeyError`` for a missing or an extra entry."""
    extra = set(tree) - {"params", "opt", "ef"}
    if extra or set(tree["opt"]) != {"m", "v", "step"}:
        raise KeyError(f"not a train state: {sorted(tree)}, opt {sorted(tree['opt'])}")
    out = {"params": params_from_jax(tree["params"], specs, device, torch.float32),
           "opt": {"m": params_from_jax(tree["opt"]["m"], specs, device, torch.float32),
                   "v": params_from_jax(tree["opt"]["v"], specs, device, torch.float32),
                   "step": torch.tensor(int(np.asarray(tree["opt"]["step"])),
                                        dtype=torch.int32, device=device)}}
    if "ef" in tree:
        out["ef"] = params_from_jax(_rows(tree["ef"], pod), specs, device, torch.bfloat16)
    return out

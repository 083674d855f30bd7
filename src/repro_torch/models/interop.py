"""Carry a parameter tree of the JAX package across to the port.

:func:`params_from_jax` takes the reference's parameter tree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``), checks it
against the model's specs (every leaf present with its shape, no leaf left
over) and returns the port's tree on ``device``, cast once to the compute
dtype.  The reference casts every weight to ``cfg.dtype`` where it is used
(``p[...].astype(dt)``), so holding the cast copies computes the same
numbers, and at full width it saves re-reading float32 weights every step.
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

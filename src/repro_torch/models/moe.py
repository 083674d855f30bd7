"""Mixture-of-Experts decoder (qwen3-moe, phi3.5-moe; the port of
``repro.models.moe``).

Dispatch is the reference's *sort-based* scheme: flatten tokens, route each
to its top-k experts, sort the assignments by expert, place them into a
capacity-padded (E, C, d) buffer, run every expert as one batched matrix
product, and add the gated outputs back to their tokens.  Assignments past
an expert's capacity are dropped (Switch/GShard semantics, capacity factor
1.25).  The Switch load-balance loss (E * sum_e f_e * p_e) comes back beside
the output and ``loss`` adds it.

The routing is the reference's, decision for decision:

* top-k is a stable descending sort, so ties go to the lower expert id, as
  ``jax.lax.top_k`` gives them (``torch.topk`` promises no order);
* ``capacity = int(max(1, round(k * n / e * capacity_factor)))`` with
  Python's ``round``, where ``n`` counts every row of the batch (prompt
  padding and free serving lanes too);
* the assignment sort is stable, and a dropped assignment lands on one
  spare buffer row that is thrown away (``.at[slot].set(mode="drop")``).

The combine adds each token's k contributions one after another in the
order the stable sort gives them (ascending expert id), rounding to the
compute dtype after each add, as the reference's sequential
``.at[tok].add`` does.  ``index_add_`` would sum them with atomics in no
fixed order on the card, so a repeated serving run could give other tokens.

In the sharded train step (``repro_torch.dist.spmd``) the ranks along
``model`` share their rows, and the routing sees every row of the
microbatch, as the reference's global program does (``spmd.all_rows``
gathers them over the batch axes, ``pod`` and ``data``; the capacity counts
them all): every ``model`` rank routes the same rows alike, and each rank
keeps its own rows of the combined output (``layers.constrain_batch``).
:func:`_constrain_experts`, the reference's sharding hint on the dispatch
buffer, keeps this rank's experts when the ``model`` axis splits them
(expert parallelism: the expert stacks stay split there), and their
outputs are gathered back over ``model`` before the combine (backward:
each rank keeps its experts' gradient, and the buffer's gradient is every
rank's experts' gathered).  Where the experts do not divide over ``model``
the stacks' ``mlp`` axis splits there instead (qwen3-moe's 8 SMOKE experts
on a 16-wide axis), and each expert is a Megatron MLP on its blocks.
Without a mesh all of these are the identity, so serving does not
change.  ``MoELM``
inherits ``DenseLM``'s decode, prefill, paged pool and
``attention="fused"`` route (K10) through its ``_mlp_block`` hook.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from repro_torch.dist import spmd
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.spec import P
from repro_torch.models.transformer import DenseLM, lm_loss, unstack


def _constrain_experts(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """This rank's experts of ``x`` (dim 0: experts) where the sharded
    step keeps the expert stack ``w`` split (its tagged spec); ``x``
    otherwise (no mesh, or a stack the spec replicates)."""
    return spmd.own_experts(x, w)


def moe_spec(c: ArchConfig) -> dict:
    return {
        "router": P((c.d_model, c.n_experts), ("embed", "experts"), "small"),
        "gate": P((c.n_experts, c.d_model, c.d_ff), ("experts", "embed", "mlp")),
        "up": P((c.n_experts, c.d_model, c.d_ff), ("experts", "embed", "mlp")),
        "down": P((c.n_experts, c.d_ff, c.d_model), ("experts", "mlp", "embed")),
    }


@dataclasses.dataclass
class Routing:
    """One layer's routing of n rows.  ``top_e`` is (n, k) in descending
    probability; the ``*_s`` tensors are the n*k assignments sorted by
    expert (stable), ``valid`` marks those within capacity and ``slot``
    their buffer row (``n_experts * capacity`` when dropped); ``pos`` (n, k)
    holds each token's assignments' sorted positions in ascending expert
    id."""

    top_e: torch.Tensor
    aux: torch.Tensor
    capacity: int
    tok_s: torch.Tensor
    gat_s: torch.Tensor
    valid: torch.Tensor
    slot: torch.Tensor
    pos: torch.Tensor


def _counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """Occurrences of each of ``e`` ids (``bincount`` without its host sync
    on the card, where it reads the largest id to size its output)."""
    return torch.zeros(e, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def route(p: dict, c: ArchConfig, xf: torch.Tensor) -> Routing:
    """The routing of ``xf`` (n, d) through ``p["router"]``."""
    n = xf.shape[0]
    k, e = c.top_k, c.n_experts
    dev = xf.device
    logits = (xf @ p["router"].to(xf.dtype)).to(torch.float32)  # (n, e)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    gates = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # Switch aux loss: fraction routed vs mean prob per expert
    routed = _counts(top_e.reshape(-1), e).to(torch.float32)
    f = routed / torch.full((), float(n * k), device=dev)  # a fill, not a host copy
    aux = e * torch.sum(f * probs.mean(0))

    capacity = int(max(1, round(k * n / e * c.capacity_factor)))
    eid = top_e.reshape(-1)  # (n*k,)
    eid_s, order = torch.sort(eid, stable=True)
    tok_s = torch.div(order, k, rounding_mode="floor")  # order indexes (token, choice)
    gat_s = gates.reshape(-1).to(xf.dtype)[order]
    counts = _counts(eid_s, e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n * k, device=dev) - starts[eid_s]
    valid = rank < capacity
    slot = torch.where(valid, eid_s * capacity + rank, e * capacity)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=dev)
    pos = torch.sort(inv.view(n, k), dim=1).values  # a token's sorted positions: ascending expert
    return Routing(top_e, aux, capacity, tok_s, gat_s, valid, slot, pos)


def moe_apply(p: dict, c: ArchConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    x = spmd.all_rows(x)  # the routing sees the whole microbatch
    b, s, d = x.shape
    n, e, dt = b * s, c.n_experts, x.dtype
    xf = x.reshape(n, d)
    r = route(p, c, xf)
    rows = e * r.capacity
    # one spare row takes every dropped assignment and is thrown away
    buf = torch.zeros((rows + 1, d), dtype=dt, device=x.device)
    buf.index_copy_(0, r.slot, xf[r.tok_s])
    h = _constrain_experts(buf[:rows].view(e, r.capacity, d), p["gate"])
    split = spmd.model_split(p["gate"], p["up"], p["down"])  # mlp blocks: experts not split
    if split is not None:
        h = spmd.to_model(h)
    g = torch.bmm(h, p["gate"].to(dt))
    u = torch.bmm(h, p["up"].to(dt))
    y = torch.bmm(F.silu(g) * u, p["down"].to(dt))
    if split is not None:
        y = spmd.from_model(y)
    y = spmd.all_experts(y, p["down"]).reshape(rows, d)

    contrib = y[torch.clamp(r.slot, 0, rows - 1)] * r.gat_s[:, None]
    contrib = torch.where(r.valid[:, None], contrib, torch.zeros((), dtype=dt, device=x.device))
    per_token = contrib[r.pos]  # (n, k, d), each token's contributions by ascending expert
    out = torch.zeros((n, d), dtype=dt, device=x.device)
    for j in range(c.top_k):
        out = out + per_token[:, j]
    return L.constrain_batch(out.reshape(b, s, d)), r.aux


class MoELM(DenseLM):
    """DenseLM with the MLP replaced by a routed expert layer."""

    def layer_spec(self) -> dict:
        c = self.cfg
        return {
            "attn_norm": self.norm_spec(c.d_model),
            "attn": L.attention_spec(c.attn()),
            "mlp_norm": self.norm_spec(c.d_model),
            "moe": moe_spec(c),
        }

    def _mlp_block(self, lp: dict, x: torch.Tensor) -> torch.Tensor:
        return x + moe_apply(lp["moe"], self.cfg, self.norm(lp["mlp_norm"], x))[0]

    def _layer_with_aux(self, lp: dict, x: torch.Tensor, positions: torch.Tensor):
        c = self.cfg
        x = x + L.attention(lp["attn"], c.attn(), self.norm(lp["attn_norm"], x), positions)
        y, aux = moe_apply(lp["moe"], c, self.norm(lp["mlp_norm"], x))
        return x + y, aux

    def forward_with_aux(self, params: dict, tokens: torch.Tensor,
                         prefix: Optional[torch.Tensor] = None):
        """Logits and the layers' mean aux loss; differentiable with
        per-layer activation checkpointing, as ``DenseLM.forward``."""
        c = self.cfg
        params = spmd.gather_outer(params)
        x = L.embed(params["embed"], tokens, self.dtype)
        if prefix is not None:
            x = torch.cat([prefix.to(self.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        remat = torch.is_grad_enabled()
        auxes = []
        for lp in unstack(params["layers"], c.n_layers):
            if remat:
                x, aux = spmd.remat(self._layer_with_aux, lp, x, positions)
            else:
                x, aux = self._layer_with_aux(spmd.gather(lp), x, positions)
            auxes.append(aux)
        x = self.norm(params["final_norm"], x)
        if prefix is not None:
            x = x[:, prefix.shape[1]:, :]
        return L.unembed(self._table(params), x), torch.stack(auxes).mean()

    def forward(self, params, tokens, prefix=None):
        return self.forward_with_aux(params, tokens, prefix)[0]

    def loss(self, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
             prefix: Optional[torch.Tensor] = None, aux_weight: float = 0.01) -> torch.Tensor:
        logits, aux = self.forward_with_aux(params, tokens, prefix)
        return lm_loss(logits, labels) + aux_weight * aux

"""RWKV-6 "Finch": attention-free LM with data-dependent per-channel decay
(the port of ``repro.models.rwkv6``).

Recurrence (per head, K = V = 64):
    S_t   = diag(w_t) S_{t-1} + k_t^T v_t          w_t = exp(-exp(ww_t))
    out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
where ww_t = w0 + tanh(x_t A) B is the data-dependent decay, r/k/v/g come
from token-shift-mixed projections, and u is the per-channel bonus for the
current token.

Training and forward passes run the reference's exact chunked form
(:func:`wkv_chunked`, chunk 32): within a chunk the pairwise decays
exp(A_t - A_s) have non-positive exponents, so they never overflow in f32,
and one f32 state per chunk is carried by a Python loop (the reference's
``lax.scan``).  Decode is the O(1) recurrent step (:func:`wkv_step`).

In the sharded train and serving steps (``dist.spmd``) the layers compute
on Megatron blocks over ``model``, as the reference's GSPMD program
partitions them: the time mix's ``wr``, ``wk``, ``wv`` and ``wg`` are
column-parallel (this rank's heads), ``u`` holds the same heads and ``wo``
is row-parallel; the token-shift mixes and the decay LoRA are computed
whole from the rows every ``model`` rank shares, inside the model region
(their leaves enter it through ``spmd.to_model``, since each rank's
gradient is its heads' part), and only this rank's columns of the decay
are formed.  Where the column blocks cut a head (``u`` does not split),
the time mix gathers them whole and computes every head on every rank.
The channel mix's ``wk`` is column-parallel and ``wv`` row-parallel; its
``wr`` (``embed`` on both dimensions) is whole on every rank.  Decode
advances this rank's heads of the recurrent state and gathers the whole
state over ``model``, since every ``model`` rank holds all of it.

The model has no attention, so it has no paged KV pool, no prefill and no
K10 route: the serving engine feeds prompts token by token.  One serving
difference from the reference: with a (B,) per-slot index, a free lane
(index -1) keeps its state.  The reference advances every lane, so a lane
left free for a tick holds state that a request admitted there later would
start from; the port's engine zeroes a lane on release and nothing writes
it until the next admission.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist import spmd
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.spec import P
from repro_torch.models.transformer import lm_loss, stack_specs, torch_dtype, unstack

CHUNK = 32
DECAY_LORA = 64


def _heads(c: ArchConfig) -> tuple[int, int]:
    hd = 64
    return c.d_model // hd, hd


def time_mix_spec(c: ArchConfig) -> dict:
    d = c.d_model
    h, k = _heads(c)
    return {
        "ln": L.layernorm_spec(d),
        "mu_r": P((d,), ("embed",), "small"),
        "mu_k": P((d,), ("embed",), "small"),
        "mu_v": P((d,), ("embed",), "small"),
        "mu_w": P((d,), ("embed",), "small"),
        "mu_g": P((d,), ("embed",), "small"),
        "wr": P((d, d), ("embed", "heads")),
        "wk": P((d, d), ("embed", "heads")),
        "wv": P((d, d), ("embed", "heads")),
        "wg": P((d, d), ("embed", "heads")),
        "w0": P((d,), ("embed",), "zeros"),
        "wA": P((d, DECAY_LORA), ("embed", None), "small"),
        "wB": P((DECAY_LORA, d), (None, "embed"), "small"),
        "u": P((h, k), ("heads", None), "small"),
        "wo": P((d, d), ("heads", "embed")),
    }


def channel_mix_spec(c: ArchConfig) -> dict:
    d = c.d_model
    return {
        "ln": L.layernorm_spec(d),
        "mu_k": P((d,), ("embed",), "small"),
        "mu_r": P((d,), ("embed",), "small"),
        "wk": P((d, c.d_ff), ("embed", "mlp")),
        "wr": P((d, d), ("embed", "embed")),
        "wv": P((c.d_ff, d), ("mlp", "embed")),
    }


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x[:, :-1], (0, 0, 1, 0))


def _mix(x, prev, mu):
    return x + (prev - x) * mu.to(x.dtype)


def _rkvwg(p: dict, c: ArchConfig, x: torch.Tensor, prev: torch.Tensor):
    """r, k, v (B, T, heads, 64), g (B, T, columns) and the log decay
    (float32, as r) of the heads that ``p``'s column leaves hold (all of
    them, or this rank's: :func:`time_heads`)."""
    _, k = _heads(c)
    b, t, _ = x.shape
    dt = x.dtype
    r = _mix(x, prev, p["mu_r"]) @ p["wr"].to(dt)
    key = _mix(x, prev, p["mu_k"]) @ p["wk"].to(dt)
    v = _mix(x, prev, p["mu_v"]) @ p["wv"].to(dt)
    g = F.silu(_mix(x, prev, p["mu_g"]) @ p["wg"].to(dt))
    xw = _mix(x, prev, p["mu_w"])
    f32 = torch.float32
    ww = p["w0"].to(f32) + torch.tanh(xw.to(f32) @ p["wA"].to(f32)) @ p["wB"].to(f32)
    logw = -torch.exp(torch.clamp(ww, -8.0, 4.0))  # log decay, in (-e^4, 0)
    shp = (b, t, r.shape[-1] // k, k)
    return r.reshape(shp), key.reshape(shp), v.reshape(shp), g, logw.reshape(shp)


_COLUMNS = ("wr", "wk", "wv", "wg")  # the time mix's column-parallel leaves
_REGION = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "wA")  # whole, used for this rank's heads


def time_heads(p: dict) -> tuple[dict, Optional[tuple[int, int]]]:
    """The time mix's leaves as this rank computes them, and the block of
    the heads it holds, ``(index, count)``; ``None`` where it computes
    every head (no mesh, heads replicated, or column blocks that cut a
    head, which are gathered whole here).  On blocks, the whole leaves the
    region uses enter it through ``spmd.to_model`` and ``w0`` and ``wB``
    are cut to this rank's columns."""
    split = spmd.model_split(*(p[k] for k in _COLUMNS + ("wo",)))
    if split is None:
        return p, None
    if spmd.model_split(p["u"]) is None:  # the column blocks cut a head
        whole = {k: spmd.model_gather(p[k], 1) for k in _COLUMNS}
        return dict(p, **whole, wo=spmd.model_gather(p["wo"], 0)), None
    width = p["wr"].shape[1]
    lo = split[0] * width
    q = dict(p, **{k: spmd.to_model(p[k]) for k in _REGION})
    q["w0"] = spmd.to_model(p["w0"]).narrow(0, lo, width)
    q["wB"] = spmd.to_model(p["wB"]).narrow(1, lo, width)
    return q, split


def time_out(p: dict, out: torch.Tensor, g: torch.Tensor, split, dtype) -> torch.Tensor:
    """The time mix's output of the wkv ``out`` (B, T, heads, 64) gated by
    ``g``: the (row-parallel) ``wo``, reduced over ``model`` on blocks."""
    b, t = out.shape[:2]
    y = (out.reshape(b, t, -1).to(dtype) * g) @ p["wo"].to(dtype)
    return y if split is None else spmd.from_model(y)


def channel_out(p: dict, xn: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """The channel mix of the normed ``xn`` and its token shift ``prev``:
    column-parallel ``wk`` and row-parallel ``wv`` where ``mlp`` splits over
    ``model``; ``wr`` whole."""
    dt = xn.dtype
    split = spmd.model_split(p["wk"], p["wv"])
    xk = _mix(xn, prev, p["mu_k"])
    if split is not None:
        xk = spmd.to_model(xk)
    kk = torch.square(F.relu(xk @ p["wk"].to(dt)))
    kv = kk @ p["wv"].to(dt)
    if split is not None:
        kv = spmd.from_model(kv)
    rr = torch.sigmoid(_mix(xn, prev, p["mu_r"]) @ p["wr"].to(dt))
    return rr * kv


def wkv_chunked(r, k, v, logw, u, state0=None):
    """Exact chunked scan. r/k/v: (B,T,H,K); logw f32; u (H,K).

    Returns (out (B,T,H,K), final state (B,H,K,V) f32)."""
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    pad = (-t) % CHUNK
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    nch = r.shape[1] // CHUNK
    f32 = torch.float32
    u32 = u.to(f32)
    later = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=r.device), -1)
    mask = later[None, :, :, None, None]  # t > s
    S = torch.zeros((b, h, kd, vd), dtype=f32, device=r.device) if state0 is None else state0
    outs = []
    for i in range(nch):
        sl = slice(i * CHUNK, (i + 1) * CHUNK)
        r32, k32, v32 = (a[:, sl].to(f32) for a in (r, k, v))
        wb = logw[:, sl]
        F_ = torch.cumsum(wb, dim=1)  # inclusive log-decay (B,C,H,K)
        E = F_ - wb  # exclusive
        inter = torch.einsum("bchk,bhkv->bchv", r32 * torch.exp(E), S)
        Dlog = E[:, :, None] - F_[:, None, :]  # (B, C, C, H, K): E_t - F_s <= 0 for t > s
        D = torch.where(mask, torch.exp(torch.clamp_max(Dlog, 0.0)),
                        torch.zeros((), device=r.device))
        scores = torch.einsum("bthk,bshk,btshk->bths", r32, k32, D)
        intra = torch.einsum("bths,bshv->bthv", scores, v32)
        diag = torch.einsum("bthk,hk,bthk->bth", r32, u32, k32)  # current-token bonus
        intra = intra + diag[..., None] * v32
        Ftot = F_[:, -1][:, None]  # (B,1,H,K)
        S = torch.exp(Ftot[:, 0])[..., None] * S + torch.einsum(
            "bshk,bshv->bhkv", k32 * torch.exp(Ftot - F_), v32)
        outs.append(inter + intra)
    out = torch.cat(outs, dim=1)[:, :t]
    return out, S


def wkv_step(r, k, v, logw, u, S):
    """O(1) recurrent decode step. r/k/v: (B,H,K); S: (B,H,K,V) f32."""
    f32 = torch.float32
    r32, k32, v32 = (a.to(f32) for a in (r, k, v))
    kv = torch.einsum("bhk,bhv->bhkv", k32, v32)
    out = torch.einsum("bhk,bhkv->bhv", r32, S + u.to(f32)[None, :, :, None] * kv)
    S_new = torch.exp(logw)[..., None] * S + kv
    return out, S_new


def _keep_free_lanes(new: torch.Tensor, old: torch.Tensor, index) -> torch.Tensor:
    """``new``, except on the lanes a (B,) index marks free (-1)."""
    if not (hasattr(index, "ndim") and index.ndim == 1):
        return new
    live = (index >= 0).reshape((-1,) + (1,) * (new.ndim - 1))
    return torch.where(live, new, old)


class RWKV6LM:
    # no attention: no paged KV pool and no K10 route
    supports_paged_kv = False
    supports_fused_attention = False

    def __init__(self, cfg: ArchConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)

    def layer_spec(self) -> dict:
        return {"time": time_mix_spec(self.cfg), "channel": channel_mix_spec(self.cfg)}

    def specs(self) -> dict:
        c = self.cfg
        return {
            "embed": L.embedding_spec(c.padded_vocab, c.d_model),
            "ln_in": L.layernorm_spec(c.d_model),
            "layers": stack_specs(c.n_layers, self.layer_spec()),
            "final_norm": L.layernorm_spec(c.d_model),
            "unembed": {"table": P((c.padded_vocab, c.d_model), ("vocab", "embed"), "small")},
        }

    def _time_mix(self, p, x):
        xn = L.layernorm(p["ln"], x)
        q, split = time_heads(p)
        if split is not None:
            xn = spmd.to_model(xn)
        r, k, v, g, logw = _rkvwg(q, self.cfg, xn, _token_shift(xn))
        out, _ = wkv_chunked(r, k, v, logw, q["u"])
        return time_out(q, out, g, split, x.dtype)

    def _layer(self, lp: dict, x: torch.Tensor) -> torch.Tensor:
        x = x + self._time_mix(lp["time"], x)
        xn = L.layernorm(lp["channel"]["ln"], x)
        return x + channel_out(lp["channel"], xn, _token_shift(xn))

    def forward(self, params: dict, tokens: torch.Tensor,
                prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Differentiable; with gradients enabled each layer is recomputed in
        the backward pass (per-layer activation checkpointing)."""
        c = self.cfg
        params = spmd.gather_outer(params)
        x = L.embed(params["embed"], tokens, self.dtype)
        if prefix is not None:
            x = torch.cat([prefix.to(self.dtype), x], dim=1)
        x = L.layernorm(params["ln_in"], x)
        remat = torch.is_grad_enabled()
        for lp in unstack(params["layers"], c.n_layers):
            x = spmd.remat(self._layer, lp, x) if remat else self._layer(spmd.gather(lp), x)
        x = L.layernorm(params["final_norm"], x)
        if prefix is not None:
            x = x[:, prefix.shape[1]:, :]
        return L.unembed(params["unembed"], x)

    def loss(self, params, tokens, labels, prefix=None):
        return lm_loss(self.forward(params, tokens, prefix), labels)

    # ------------------------------------------------------------ decode --
    def cache_spec(self, batch: int, max_len: int, codec=None) -> dict:
        c = self.cfg
        h, kd = _heads(c)
        ls = c.n_layers
        f32 = torch.float32
        return {
            "wkv": L.TensorSpec((ls, batch, h, kd, kd), f32),
            "tm_x": L.TensorSpec((ls, batch, c.d_model), f32),
            "cm_x": L.TensorSpec((ls, batch, c.d_model), f32),
        }

    def init_cache(self, batch: int, max_len: int, codec=None) -> dict:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self.cache_spec(batch, max_len).items()}

    @torch.no_grad()
    def decode_step(self, params: dict, cache: dict, token: torch.Tensor, index,
                    codec=None, attention: str = "xla") -> tuple[torch.Tensor, dict]:
        """token: (B,) -> logits (B, vocab); writes the recurrent state in
        place (and returns the cache).  ``index`` only marks free lanes: a
        (B,) vector's -1 lanes keep their state."""
        if attention == "fused":
            raise ValueError("RWKV6LM has no attention, so no K10 route")
        c = self.cfg
        f32 = torch.float32
        params = spmd.gather_outer(params)
        x = L.embed(params["embed"], token[:, None], self.dtype)
        x = L.layernorm(params["ln_in"], x)
        for i, lp in enumerate(unstack(params["layers"], c.n_layers)):
            lp = spmd.gather(lp)
            tp, cp = lp["time"], lp["channel"]
            xn = L.layernorm(tp["ln"], x)
            prev = cache["tm_x"][i][:, None, :].to(xn.dtype)
            q, split = time_heads(tp)
            r, k, v, g, logw = _rkvwg(q, c, xn, prev)
            S = cache["wkv"][i]  # every head's state, on every model rank
            lo = 0 if split is None else split[0] * r.shape[2]
            out, S_new = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], q["u"],
                                  S[:, lo:lo + r.shape[2]])
            if split is not None:  # every rank's heads of the new state
                S_new = spmd.gather_model(S_new, 1)
            x = x + time_out(q, out[:, None], g, split, x.dtype)
            xn2 = L.layernorm(cp["ln"], x)
            prev2 = cache["cm_x"][i][:, None, :].to(xn2.dtype)
            x = x + channel_out(cp, xn2, prev2)
            for name, new in (("wkv", S_new), ("tm_x", xn[:, 0].to(f32)),
                              ("cm_x", xn2[:, 0].to(f32))):
                cache[name][i] = _keep_free_lanes(new, cache[name][i], index)
        x = L.layernorm(params["final_norm"], x)
        return L.unembed(params["unembed"], x)[:, 0, :], cache

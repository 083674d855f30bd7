"""Continuous-batching serving engine with a paged, compressed KV cache
(the port of ``repro.serving.engine``).

Requests occupy batch slots; every engine tick runs one fused decode step
over all live slots. Unlike the first-cut engine (which advanced every slot
with a single shared position counter and never cleared a freed slot's KV —
a recycled slot could attend over its previous occupant's keys/values),
each slot now carries its own write index:

  * ``pos[i]`` is slot *i*'s next cache write position (-1 = free lane), fed
    to ``decode_step`` as a ``(B,)`` vector — or as a ``layers.PagedKV``
    pytree when the cache is paged — so lanes at different depths decode
    correctly in one step.
  * Prompts are prefilled in ONE chunked call (``model.prefill``) at
    admission instead of token-by-token ticks; models without a ``prefill``
    method fall back to per-slot token-by-token feeding (still leak-free).
  * On completion the slot's cache rows (or its pages) are zeroed on-device
    before the slot can be recycled — isolation holds by construction, not
    by masking alone.

The KV cache can run ``none`` (bf16 baseline) or ``blockfloat8`` (the
paper's fixed-rate int8 block-float mode on inference state; 8.25
bits/value). With ``paged=True`` (auto-on for attention models) the cache
is a page pool (`serving/kv_pages.py`): admitted work is bounded by pool
bytes, not ``batch_slots``, and a compressed pool admits ~2x the concurrent
requests of bf16 at equal bytes. Admission walks a saxml-style batch-size
ladder (`serving/admission.py`).

Anything with ``decode_step`` / ``init_cache`` serves through the engine;
``model.supports_paged_kv`` / ``model.prefill`` unlock the paged and
chunked-prefill fast paths (``DenseLM`` and ``MoELM``; ``RWKV6LM``,
``HymbaLM`` and ``EncDecLM`` feed prompts token by token into a dense
per-slot cache), and ``model.supports_fused_attention`` declares a K10
route for blockfloat8 decode attention (``DenseLM``, ``MoELM``,
``EncDecLM``).

What differs from the reference:

* The cache lives on the model's device and is written in place; a step
  returns the same tensors.
* ``attention="auto"`` sends blockfloat8 decode attention through K10 on a
  CUDA model that declares a K10 route and the plain path otherwise (the
  reference picks its Pallas kernel only on the TPU); ``"fused"`` asks for
  K10 on either device (on the CPU it runs K10's plain version) and is
  refused with ``ValueError`` for a model without the route.  The choice is
  an argument of the model's ``decode_step`` / ``prefill``, not a
  trace-time flag.
* Sampled decoding keeps the reference's contract, not its bits: output
  token t of request ``uid`` draws Gumbel noise from a ``torch.Generator``
  seeded with a pure function of ``(sample_seed, uid, key_offset + t)``,
  independent of the tick and of the batch.
* ``steps`` counts the ticks that ran the model's decode step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.admission import AdmissionConfig, AdmissionController
from repro_torch.serving.kv_pages import PagePool

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def sample_seed(seed: int, uid: int, t: int) -> int:
    """The generator seed of output token ``t`` of request ``uid``: a pure
    function of the three (the role of the reference's
    ``fold_in(fold_in(key(seed), uid), t)``)."""
    return _mix64(_mix64(_mix64(seed & _MASK64) ^ (uid & _MASK64)) ^ (t & _MASK64))


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # stamped at submit() so completion can observe end-to-end latency
    # (queue wait + every tick the request was live) without the engine
    # keeping a side table
    submitted_t: Optional[float] = None
    # sampling-key offset: output token t of this request samples with the
    # generator of sample_seed(seed, uid, key_offset + t).  A router re-dispatching
    # a half-decoded request onto another replica sets key_offset to the
    # number of tokens already emitted, so the continuation draws exactly
    # the tokens the original dispatch would have drawn.
    key_offset: int = 0


@dataclasses.dataclass
class EngineConfig:
    batch_slots: int = 8
    max_len: int = 512
    codec: str = "none"  # none | blockfloat8
    eos_token: Optional[int] = None
    greedy: bool = True
    # sampling (greedy=False): logits / temperature -> categorical, seeded
    temperature: float = 1.0
    sample_seed: int = 0
    # paged KV pool: "auto" = on iff the model supports it
    paged: Union[bool, str] = "auto"
    page_size: int = 16
    pool_pages: Optional[int] = None  # pages in the pool (default: slots*max)
    pool_bytes: Optional[int] = None  # or size the pool by bytes
    prefill_chunk: int = 16  # prompts pad to a multiple -> bounded recompiles
    attention: str = "auto"  # auto | fused | xla (fused = K10, xla = plain PyTorch)
    # saxml-style admission: sorted batch-size ladder + max-live-batches
    ladder: tuple[int, ...] = ()
    max_live_batches: int = 1

    def __post_init__(self):
        if self.codec not in ("none", "blockfloat8"):
            raise ValueError(f"unknown codec {self.codec!r}")
        if self.batch_slots <= 0:
            raise ValueError(f"batch_slots must be positive: {self.batch_slots}")
        if self.max_len <= 1:
            raise ValueError(f"max_len must be > 1: {self.max_len}")
        if not self.greedy and not self.temperature > 0:
            raise ValueError(
                f"greedy=False requires temperature > 0, got {self.temperature}")
        if self.attention not in ("auto", "fused", "xla"):
            raise ValueError(f"unknown attention mode {self.attention!r}")
        if self.attention == "fused" and self.codec != "blockfloat8":
            raise ValueError("attention='fused' requires codec='blockfloat8' "
                             "(the kernel dequantizes int8 block-float)")
        if self.paged not in (True, False, "auto"):
            raise ValueError(f"paged must be True/False/'auto': {self.paged!r}")
        if self.page_size <= 0 or self.prefill_chunk <= 0:
            raise ValueError("page_size and prefill_chunk must be positive")


class DrainResult(list):
    """All requests submitted before the drain, in submission order.
    ``drained`` is False when ``max_ticks`` ran out with work still live —
    callers must check it instead of silently losing unfinished requests.
    ``stalls`` is the consecutive no-progress tick count at exit: nonzero
    means the drain hit the livelock guard (queued work that can never be
    admitted, e.g. a request whose worst case exceeds the page pool)."""

    def __init__(self, requests, drained: bool, stalls: int = 0):
        super().__init__(requests)
        self.drained = drained
        self.stalls = stalls


class KVIntegrityError(RuntimeError):
    """The zero-on-free invariant is violated: a free page / lane holds
    nonzero state (corruption, or a buggy recycle path)."""


class ServingEngine:
    def __init__(self, model, params, cfg: EngineConfig, *,
                 tick_hook=None, clock=time.time):
        self.model = model
        self.params = params
        self.cfg = cfg
        # injectable seams for the serving fault drill (and for routers that
        # need deterministic time): ``tick_hook(engine)`` runs at the top of
        # every tick, before any state changes — raising from it aborts the
        # tick cleanly; ``clock`` backs every timestamp the engine takes.
        self.tick_hook = tick_hook
        self.clock = clock
        self.codec = L.KVCodecConfig(cfg.codec)
        paged_ok = bool(getattr(model, "supports_paged_kv", False))
        self.paged = paged_ok if cfg.paged == "auto" else bool(cfg.paged)
        if self.paged and not paged_ok:
            raise ValueError(
                f"{type(model).__name__} does not support paged KV "
                "(no supports_paged_kv); use paged=False or 'auto'")
        if self.paged:
            self.pool: Optional[PagePool] = PagePool(
                model, self.codec, cfg.batch_slots, cfg.max_len,
                page_size=cfg.page_size, n_pages=cfg.pool_pages,
                pool_bytes=cfg.pool_bytes)
            self.cache = self.pool.cache
        else:
            self.pool = None
            self.cache = model.init_cache(cfg.batch_slots, cfg.max_len, self.codec)
        self.device = model.device
        self.pos = np.full(cfg.batch_slots, -1, np.int32)  # -1 = free lane
        self.slots: list[Optional[Request]] = [None] * cfg.batch_slots
        self.pending: list[Request] = []
        self.admission = AdmissionController(
            AdmissionConfig(tuple(cfg.ladder), cfg.max_live_batches),
            cfg.batch_slots)
        # K10 on CUDA ("auto"), or wherever "fused" asks for it, on a model
        # that has the route; an explicit "fused" without one is refused
        fused_ok = bool(getattr(model, "supports_fused_attention", False))
        if cfg.attention == "fused" and not fused_ok:
            raise ValueError(f"{type(model).__name__} has no K10 route "
                             "(no supports_fused_attention); use attention='auto' or 'xla'")
        self._fused = fused_ok and cfg.codec == "blockfloat8" and (
            cfg.attention == "fused"
            or (cfg.attention == "auto" and self.device.type == "cuda"))
        self._attention = "fused" if self._fused else "xla"
        self.ticks = 0
        self.steps = 0  # ticks that ran the model's decode step
        self.last_admits = 0  # admissions on the most recent tick
        self._can_prefill = hasattr(model, "prefill")
        # process-global instruments (no-ops until repro.obs is enabled)
        self._h_request = obs_metrics.histogram("serving.request_s")
        self._h_tick = obs_metrics.histogram("serving.tick_s")
        self._h_prefill = obs_metrics.histogram("serving.prefill_s")
        self._g_occupancy = obs_metrics.gauge("serving.batch_occupancy")
        self._g_cache = obs_metrics.gauge("serving.cache_occupancy")
        self._c_admitted = obs_metrics.counter("serving.admitted")
        self._c_completed = obs_metrics.counter("serving.completed")
        self._c_deferred = obs_metrics.counter("serving.admission_deferred")

    # -------------------------------------------------------- lifecycle --
    def submit(self, req: Request) -> None:
        if not req.prompt:
            req.prompt = [0]  # old engine fed token 0 for empty prompts
        if len(req.prompt) > self.cfg.max_len - 1:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens does not fit "
                f"max_len={self.cfg.max_len} (needs at least one decode step)")
        req.submitted_t = self.clock()
        self.pending.append(req)

    def _live(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def cache_nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self.cache.values())

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _index_arg(self, pos: np.ndarray):
        p = self._on_device(pos)
        if self.paged:
            return L.PagedKV(p, self._on_device(self.pool.page_table()))
        return p

    def _step(self, tokens: np.ndarray, index):
        return self.model.decode_step(self.params, self.cache, self._on_device(tokens), index,
                                      self.codec, attention=self._attention)

    # zero-on-free: every arch's cache leaves are (n_layers, batch, ...), and
    # the paged pool's are (n_layers, n_pages, ...): axis 1 is the recycled
    # resource in both.  Padding freed-page ids with 0 re-zeroes the reserved
    # zero page, which is a no-op by its invariant.
    def _zero_axis1(self, ids) -> None:
        for x in self.cache.values():
            x[:, ids] = 0

    # -------------------------------------------------------- admission --
    def _admit(self) -> list[tuple[int, Request]]:
        live = len(self._live())
        quota = self.admission.admittable(live, len(self.pending))
        free = [i for i, s in enumerate(self.slots) if s is None]
        admitted: list[tuple[int, Request]] = []
        while quota > 0 and free and self.pending:
            req = self.pending[0]
            # worst-case reservation: a request can never OOM mid-flight
            cap = min(len(req.prompt) + req.max_new_tokens, self.cfg.max_len)
            if self.paged and not self.pool.can_admit(cap):
                self._c_deferred.inc()
                break  # FIFO head-of-line: wait for pages to free up
            self.pending.pop(0)
            slot = free.pop(0)
            if self.paged:
                self.pool.allocate(slot, cap)
            self.slots[slot] = req
            self.pos[slot] = 0
            admitted.append((slot, req))
            quota -= 1
        if admitted:
            self._c_admitted.inc(len(admitted))
            if self._can_prefill:
                self._prefill_admitted(admitted)
        return admitted

    def _prefill_admitted(self, admitted: list[tuple[int, Request]]) -> None:
        """One chunked prefill call writes every admitted prompt into the
        cache and yields logits at each prompt's last token, from which the
        first output token is sampled — replacing len(prompt) decode ticks.
        Lanes not being prefilled pass length 0 / start -1: their writes are
        dropped and their logits ignored, so live decoding lanes are
        untouched."""
        t0 = self.clock()
        chunk = self.cfg.prefill_chunk
        longest = max(len(r.prompt) for _, r in admitted)
        width = -(-longest // chunk) * chunk  # pad -> bounded recompiles
        tokens = np.zeros((self.cfg.batch_slots, width), np.int32)
        length = np.zeros(self.cfg.batch_slots, np.int32)
        start = np.full(self.cfg.batch_slots, -1, np.int32)
        for slot, req in admitted:
            tokens[slot, : len(req.prompt)] = req.prompt
            length[slot] = len(req.prompt)
            start[slot] = 0
        index = self._index_arg(start)
        with obs_trace.span("serving.prefill", lanes=len(admitted), width=width):
            logits, self.cache = self.model.prefill(
                self.params, self.cache, self._on_device(tokens), index,
                self._on_device(length), self.codec, attention=self._attention)
            nxt = self._sample(logits, admitted)
        for slot, req in admitted:
            self.pos[slot] = len(req.prompt)
            self._emit(slot, req, int(nxt[slot]))
        self._h_prefill.observe(self.clock() - t0)

    # --------------------------------------------------------- sampling --
    def _sample(self, logits: torch.Tensor,
                lanes: list[tuple[int, Request]]) -> np.ndarray:
        """Next token per lane.  Sampled lanes use their request's own
        generator, seeded by (seed, uid, token index), never a shared
        per-tick draw, so the draw is identical whatever else shares the
        batch: Gumbel-max over ``logits / temperature`` in float32."""
        if self.cfg.greedy:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        lg = logits.to(torch.float32).cpu()
        out = np.zeros(lg.shape[0], np.int64)
        for slot, req in lanes:
            g = torch.Generator().manual_seed(sample_seed(
                self.cfg.sample_seed, req.uid & 0x7FFFFFFF,
                req.key_offset + len(req.out_tokens)))
            u = torch.rand(lg.shape[1], generator=g)
            gumbel = -torch.log(-torch.log(u))
            out[slot] = int(torch.argmax(lg[slot] / self.cfg.temperature + gumbel))
        return out

    # ------------------------------------------------------- completion --
    def _emit(self, slot: int, req: Request, tok: int) -> None:
        req.out_tokens.append(tok)
        hit_eos = self.cfg.eos_token is not None and tok == self.cfg.eos_token
        if (len(req.out_tokens) >= req.max_new_tokens or hit_eos
                or self.pos[slot] >= self.cfg.max_len - 1):
            self._retire(slot, req)

    def _release_slot(self, slot: int) -> None:
        """Free the slot and zero its cache state on-device BEFORE it can be
        recycled — the isolation half of the PR-9 bugfix."""
        self.slots[slot] = None
        self.pos[slot] = -1
        if self.paged:
            ids = self.pool.free_slot(slot)
            padded = np.zeros(self.pool.max_pages, np.int64)
            padded[: len(ids)] = ids
            self._zero_axis1(self._on_device(padded))
        else:
            self._zero_axis1(slot)

    def _retire(self, slot: int, req: Request) -> None:
        req.done = True
        self._release_slot(slot)
        self._c_completed.inc()
        if req.submitted_t is not None:
            self._h_request.observe(self.clock() - req.submitted_t)

    def cancel(self, req: Request) -> bool:
        """Evict ``req`` (queued or live) without marking it done; a live
        request's slot is released and zeroed.  Returns False when the
        request is not owned by this engine (already retired, or never
        submitted here)."""
        if req in self.pending:
            self.pending.remove(req)
            return True
        for slot, s in enumerate(self.slots):
            if s is req:
                self._release_slot(slot)
                return True
        return False

    def drain_requests(self) -> list[Request]:
        """Evict ALL unfinished work — live slots (released + zeroed, slot
        order) then the pending queue — and return the evicted requests.
        This is the failover path: a router pulling requests off a failed
        replica to re-dispatch them elsewhere."""
        evicted: list[Request] = []
        for slot, s in enumerate(self.slots):
            if s is not None:
                evicted.append(s)
                self._release_slot(slot)
        evicted.extend(self.pending)
        self.pending.clear()
        return evicted

    # -------------------------------------------------- health / repair --
    def free_resource_ids(self) -> list[int]:
        """Axis-1 indices of the cache that must be exactly zero right now:
        unallocated pages plus the reserved zero page (paged), or free lanes
        (dense).  Empty when every resource is in use."""
        if self.paged:
            return sorted(self.pool.free_ids())
        return [i for i, s in enumerate(self.slots) if s is None]

    def check_kv_integrity(self) -> bool:
        """Verify the zero-on-free invariant on-device: every free page /
        free lane (and the reserved zero page) holds exact zeros.  This is
        the detection point for corrupt-KV poison — a router probes it
        before trusting a replica's output."""
        ids = self.free_resource_ids()
        if not ids:
            return True
        idx = self._on_device(np.asarray(ids, np.int64))
        nonzero = torch.zeros((), dtype=torch.bool, device=self.device)
        for leaf in self.cache.values():
            nonzero |= (leaf[:, idx] != 0).any()
        return not bool(nonzero)

    def reset(self) -> None:
        """Rebuild the cache (and page allocator) to pristine all-zero
        state — a router 'restarting' a quarantined replica after draining
        it.  Refuses while any work is still owned by the engine."""
        if self._live() or self.pending:
            raise RuntimeError("reset() with live or pending requests; "
                               "drain_requests() first")
        if self.paged:
            # out-of-band reservations (fault-drill pool pressure) die with
            # the restart — only request-owned pages block a reset, and
            # drain_requests() already released those
            for owner in self.pool.owners():
                self.pool.free_slot(owner)
            self.pool.reset()
            self.cache = self.pool.cache
        else:
            for x in self.cache.values():
                x.zero_()
        self.pos[:] = -1

    def can_accept(self, req: Request) -> bool:
        """Would ``req`` be admitted promptly?  A free slot exists, nothing
        is queued ahead of it, and the page pool covers its worst case.
        Routers use this to place work on the replica that will actually
        run it instead of burying it in a busy replica's queue."""
        if self.pending or not any(s is None for s in self.slots):
            return False
        if len(req.prompt) > self.cfg.max_len - 1:
            return False
        if self.paged:
            cap = min(len(req.prompt) + req.max_new_tokens, self.cfg.max_len)
            return self.pool.can_admit(cap)
        return True

    # ------------------------------------------------------------- tick --
    def tick(self) -> int:
        """One engine step: admit from the queue, then feed each live slot
        its next token at its OWN position. Returns the number of live
        requests (0 = idle tick — still counted and timed).  The injectable
        ``tick_hook`` fires first, before any state changes — an exception
        from it aborts the tick with the engine untouched."""
        t0 = self.clock()
        if self.tick_hook is not None:
            self.tick_hook(self)
        self.last_admits = len(self._admit())
        live = self._live()
        self._g_occupancy.set(len(live) / self.cfg.batch_slots)
        if self.paged:
            self._g_cache.set(self.pool.occupancy())
        if not live:
            self.ticks += 1
            self._h_tick.observe(self.clock() - t0)
            return 0
        tokens = np.zeros(self.cfg.batch_slots, np.int32)
        for i in live:
            req = self.slots[i]
            p = self.pos[i]
            if p < len(req.prompt):  # no-prefill fallback: feed prompt
                tokens[i] = req.prompt[p]
            else:
                tokens[i] = req.out_tokens[-1] if req.out_tokens else 0
        index = self._index_arg(self.pos)
        with obs_trace.span("serving.tick", live=len(live)):
            logits, self.cache = self._step(tokens, index)
            nxt = self._sample(logits, [(i, self.slots[i]) for i in live])
        self.steps += 1
        for i in live:
            req = self.slots[i]
            self.pos[i] += 1
            if self.pos[i] >= len(req.prompt):
                self._emit(i, req, int(nxt[i]))
        self.ticks += 1
        self._h_tick.observe(self.clock() - t0)
        return len(live)

    def run_until_drained(self, max_ticks: int = 10_000,
                          stall_ticks: int = 100) -> DrainResult:
        """Tick until queue and slots are empty (or ``max_ticks``). Returns
        EVERY request that was submitted — finished or not — with
        ``.drained`` flagging exhaustion, so callers can never silently lose
        the requests that were still occupying slots.

        Livelock guard: ``stall_ticks`` consecutive ticks with zero
        progress (no admission, no live lane — queued work that can never
        be admitted, e.g. a worst case bigger than the page pool) emits a
        ``serving.stall`` event and stops early instead of silently burning
        the remaining ``max_ticks``; the count comes back as ``.stalls``."""
        submitted = [r for r in self.slots if r is not None] + list(self.pending)
        stalls = 0
        for _ in range(max_ticks):
            live = self.tick()
            if not live and not self.pending:
                break
            stalls = 0 if (live or self.last_admits) else stalls + 1
            if stall_ticks and stalls >= stall_ticks:
                obs_metrics.event("serving.stall", consecutive=stalls,
                                  pending=len(self.pending),
                                  max_ticks=max_ticks)
                break
        drained = not self._live() and not self.pending
        if not drained and (not stall_ticks or stalls < stall_ticks):
            obs_metrics.event("serving.drain_exhausted",
                              live=len(self._live()),
                              pending=len(self.pending), max_ticks=max_ticks)
        return DrainResult(submitted, drained, stalls=stalls)

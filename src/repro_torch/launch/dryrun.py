"""Multi-pod dry run: whether each (architecture x input shape x mesh) cell
fits one card and what its step costs, without a card (the port of
``repro.launch.dryrun``).

For every cell this builds the model on the abstract ``meta`` device (shapes
and dtypes, no data), lays out the production mesh on a fake process group
of which this process is rank 0, and runs the port's own step once on
``meta`` tensors under four dispatch-level counters (:class:`CostCounter`):

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``;
* ``bytes_accessed_per_device``: the input and output bytes of every aten
  op that is not a view (nor a bare allocation).  Eager PyTorch moves about
  that much, so this is the eager counterpart of XLA's "bytes accessed";
* ``collective_bytes_per_device``: each c10d op's result bytes under the
  reference's five keys; send and recv count as ``collective-permute``;
* ``peak_bytes_per_device``: a live-bytes tracker.  It counts the state and
  inputs that exist before the step (``memory.argument_bytes``) plus every
  storage an op creates, each rounded up to the 512-byte blocks the CUDA
  caching allocator counts, and frees each storage when its last tensor
  dies.

These counters see every executed operation: a Python loop over layers or
chunks is counted once per trip, so the reference's undercount (XLA's cost
analysis counts a while-loop body once, whatever its trip count) does not
arise here.

What differs from the reference, and why:

* **Mesh.**  Every cell runs on the reference's meshes: ``single`` is (16,
  16) over ("data", "model"), ``multi`` (2, 16, 16) over ("pod", "data",
  "model"), on a fake process group of 256 or 512 ranks that
  :func:`run_cell` creates and destroys (it refuses to run beside a group
  that is already up).  Parameters are placed as the reference's
  ``DEFAULT_RULES`` place them (``train.step.make_state_specs``) and
  gathered where they are used (``dist.spmd``).  A cell's global batch
  splits over pod x data exactly as the reference splits it, and the ranks
  along ``model`` share their rows: every family computes on Megatron
  blocks over ``model``, as under the reference's GSPMD program.  A train
  cell whose rows do not divide over pod x data is skipped with its reason
  (the step would raise; :func:`train_refusal`).  A decode cell's cache is
  placed as the reference's ``cache_shardings`` places it
  (``train.step.cache_shardings``: the batch over pod x data, the sequence
  over ``model`` from 4096 positions; ``long_500k``'s one lane takes the
  sequence over ``data``), and each rank attends to its block of
  positions.  The cells predict the port's partition, which is fixed where
  XLA's may choose: each MoE layer routes the whole microbatch on every
  rank and gathers every expert's output.
* **Steps.**  Train runs :func:`repro_torch.train.step.build_train_step`
  with bfloat16 parameters (and the compressed pod hop with ``--grad-comp``
  on the multi mesh) on a ``meta`` state; the batch comes from the host, as
  the trainer's does, so each rank's rows reach the device inside the step.
  Prefill runs ``model.forward`` on this rank's rows under
  ``torch.no_grad()`` and keeps the last position's logits (gathered over
  the vocabulary's ``model`` blocks).  Decode runs one step of
  :func:`repro_torch.train.step.build_serve_step` (attention ``xla``) over
  a placed cache of the cell's length (codec ``blockfloat8`` for
  ``long_500k``, ``none`` otherwise), every lane at the cell's one position.
* **Card sizes.**  ``fits_device`` compares the predicted peak with one
  H100 80GB HBM3's memory (:data:`DEVICE_MEMORY_BYTES`).  The microbatch
  count ``k`` is the smallest power of two up to this rank's rows whose
  predicted peak fits; if none fits, ``k`` is this rank's rows.  A candidate
  is traced over its first microbatch with the float32 accumulators present:
  every iteration runs the same operations, so the loop's peak is one
  iteration's.  The chosen ``k``'s counters are ``C1 + (k - 1)(C2 - C1)``
  from traces that stop after one and after two microbatches.

The dry run works on ``meta`` wherever it runs, the card's machine too; its
check against the card is ``chip_smoke.py``'s phase 29.  Each cell's JSON
keeps the reference's keys where their meaning holds (``compile_s`` is the
seconds the cell's traces took); ``fits_device`` and ``mesh_shape`` are new.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as tree_util
from repro_torch.configs import registry
from repro_torch.dist import sharding as shardlib
from repro_torch.dist import spmd
from repro_torch.dist.collectives import (GradCompressionConfig, pod_hop_device_bytes,
                                          wire_bytes_per_param)
from repro_torch.models import layers as L
from repro_torch.models.spec import param_count
from repro_torch.obs import metrics as obs_metrics
from repro_torch.train import step as step_lib

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "torch_dryrun"

# torch.cuda.get_device_properties(0).total_memory of one NVIDIA H100 80GB
# HBM3, read on the card by chip_smoke.py's phase 29
DEVICE_MEMORY_BYTES = 85_017_493_504
ALLOC_BLOCK = 512  # the CUDA caching allocator's block: every allocation is a multiple

SINGLE_POD = (16, 16)  # ("data", "model"): the reference's meshes
MULTI_POD = (2, 16, 16)  # ("pod", "data", "model")

_log = logging.getLogger("repro_torch.launch.dryrun")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d op name -> the reference's collective; each op's first argument holds
# its result tensors (the in-place buffer of an all-reduce, a send's payload)
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_coalesced_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute", "recv_": "collective-permute",
         "recv_any_source_": "collective-permute"}
# ops that move no bytes: aliases that are not views by schema (they return
# their input's storage), and bare allocations
_NO_BYTES = (torch.ops.aten._unsafe_view.default, torch.ops.aten.lift_fresh.default,
             torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
             torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
             torch.ops.aten.new_empty_strided.default)


def _ensure_cli_logging() -> None:
    """CLI entry points keep their human-readable output by routing the
    ``repro_torch.launch`` logger to stderr; library callers (tests,
    costrun) inherit whatever handler config the host process set up."""
    root = logging.getLogger("repro_torch.launch")
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(message)s"))
        root.addHandler(h)
        root.setLevel(logging.INFO)


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    if shardlib.is_dtensor(x):
        yield x.to_local()  # this rank's block is what its device holds
    elif isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def alloc_bytes(nbytes: int) -> int:
    """What the CUDA caching allocator counts for an allocation of
    ``nbytes``: whole 512-byte blocks."""
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


class CostCounter(TorchDispatchMode):
    """Bytes accessed, collective bytes and live device bytes of what runs
    under it (module docstring).  ``held`` trees are the arguments: their
    device storages are live from the start (``argument_bytes``).  Host
    (CPU) storages are not device memory and are not tracked."""

    def __init__(self, *held: Any):
        super().__init__()
        self.bytes_accessed = 0
        self.collective = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}
        for t in _tensors(held):
            self.track(t)
        self.argument_bytes = self.live

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until its last tensor dies."""
        if t.device.type == "cpu":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = alloc_bytes(st.nbytes())
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            kind = _C10D.get(func._opname)
            if kind is not None:
                self.collective[kind] += sum(_nbytes(t) for t in _tensors(args[0]))
        elif func.namespace == "aten" and not func.is_view and func not in _NO_BYTES:
            self.bytes_accessed += (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                                    + sum(_nbytes(t) for t in _tensors(out)))
        for t in _tensors(out):
            self.track(t)
        return out


class AllLive(TorchDispatchMode):
    """``nonzero`` of a ``meta`` mask as if every element were true.  The
    cache write selects its kept (lane, token) rows with ``nonzero``, whose
    size depends on data; at the dry run's decode every lane is live and
    every write kept, so the all-true answer is the card's."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.nonzero.default and args[0].device.type == "meta":
            return torch.empty((args[0].numel(), args[0].dim()), dtype=torch.int64,
                               device="meta")
        return func(*args, **(kwargs or {}))


def measure(fn: Callable[[], Any], *held: Any) -> dict:
    """Run ``fn()`` under the four counters, ``held`` live from the start:
    ``{"flops", "bytes", "collective": {kind: bytes}, "peak",
    "argument_bytes"}``."""
    counter = CostCounter(*held)
    with FlopCounterMode(display=False) as flops, counter:
        fn()
    return {"flops": float(flops.get_total_flops()), "bytes": float(counter.bytes_accessed),
            "collective": dict(counter.collective), "peak": counter.peak,
            "argument_bytes": counter.argument_bytes}


@contextlib.contextmanager
def fake_mesh(multi_pod: bool):
    """The production mesh (module docstring) on a fake process group of
    which this process is rank 0; the group is destroyed on exit.  Refuses
    to replace a group the caller already has up."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("the dry run lays its mesh out on a fake process group of its own, "
                           "and a process group is already initialized")
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of ``mesh``; ``{}`` for one process (``None``)."""
    return {} if mesh is None else shardlib.mesh_sizes(mesh)


def extra_keys(cfg) -> tuple[str, ...]:
    return ("prefix",) if cfg.family == "vlm" else ("frames",) if cfg.family == "audio" else ()


def host_batch(specs: dict) -> dict:
    """The batch of ``specs``' shapes and dtypes on the host, every value
    one zero broadcast (no host memory): the trainer moves each rank's rows
    to the device inside the step."""
    return {k: torch.zeros((), dtype=v.dtype).expand(v.shape) for k, v in specs.items()}


def train_cost(model, cfg, shape, mesh, microbatches: int, runs: int,
               grad_comp: bool = False, param_dtype=torch.bfloat16) -> dict:
    """The train step of ``microbatches`` over this rank's rows of the
    cell's global batch, traced through its first ``runs`` microbatches."""
    scfg = step_lib.TrainStepConfig(grad_comp=GradCompressionConfig(enabled=grad_comp),
                                    microbatches=microbatches, param_dtype=param_dtype)
    state = step_lib.empty_state(model, mesh, scfg)
    step = step_lib.build_train_step(model, mesh, scfg, extra_keys=extra_keys(cfg))
    batch = host_batch(registry.input_specs(cfg, shape))
    return measure(lambda: step(state, batch, trace_microbatches=runs), state)


def loop_cost(c1: dict, c2: dict, k: int) -> dict:
    """The k-microbatch step's counters from traces that stop after one
    (``c1``) and two (``c2``) microbatches: ``C1 + (k - 1)(C2 - C1)``."""
    out = dict(c1, peak=max(c1["peak"], c2["peak"]))
    for key in ("flops", "bytes"):
        out[key] = c1[key] + (k - 1) * (c2[key] - c1[key])
    out["collective"] = {kind: c1["collective"][kind]
                         + (k - 1) * (c2["collective"][kind] - c1["collective"][kind])
                         for kind in COLLECTIVES}
    return out


def local_batch(shape, mesh) -> int:
    """This rank's rows of a prefill or decode cell's global batch: split
    over the pod x data ranks where it divides, else every row (the
    reference's ``bshard``)."""
    sizes = mesh_sizes(mesh)
    n = sizes.get("pod", 1) * sizes.get("data", 1)
    return shape.global_batch // n if shape.global_batch % n == 0 else shape.global_batch


ROW_AXES = ("pod", "data")  # a train cell's rows split over these; model ranks share them


def train_rows(shape, mesh) -> int:
    """This rank's rows of a train cell's global batch: the step splits
    them over :data:`ROW_AXES` (``train.step.build_train_step``), so this
    bounds the microbatch count."""
    sizes = mesh_sizes(mesh)
    return shape.global_batch // math.prod(sizes.get(a, 1) for a in ROW_AXES)


def train_refusal(shape, multi_pod: bool) -> Optional[str]:
    """Why the train step cannot take a train cell on its mesh, or None:
    the rows split over :data:`ROW_AXES`, and no rank repeats another's."""
    sizes = dict(zip(("pod", "data", "model") if multi_pod else ("data", "model"),
                     MULTI_POD if multi_pod else SINGLE_POD))
    n = math.prod(sizes.get(a, 1) for a in ROW_AXES)
    if shape.global_batch % n == 0:
        return None
    return (f"the global batch of {shape.global_batch} rows does not split over the {n} ranks of "
            + " x ".join(a for a in ROW_AXES if a in sizes))


def choose_microbatches(trace: Callable[[int], dict], b_local: int, state_bytes: int,
                        acc_bytes: int) -> tuple[int, dict]:
    """``(k, the trace of k's first microbatch)``: the smallest power of two
    up to ``b_local`` whose predicted peak fits the card, else ``b_local``.
    A ``k`` is skipped untraced when its arguments alone (the state, and for
    ``k > 1`` the float32 accumulators) exceed the card."""
    k = 1
    while True:
        need = state_bytes + (acc_bytes if k > 1 else 0)
        if k >= b_local or need <= DEVICE_MEMORY_BYTES:
            c = trace(k)
            if c["peak"] <= DEVICE_MEMORY_BYTES or k >= b_local:
                return k, c
        k = min(2 * k, b_local)


def _param_blocks(model, mesh) -> tuple:
    """``(bfloat16 parameter blocks of this rank, their shardings)``."""
    scfg = step_lib.TrainStepConfig(param_dtype=torch.bfloat16)
    state_abs, shard = step_lib.make_state_specs(model, mesh, scfg)
    return step_lib.empty_blocks(state_abs["params"], shard["params"], mesh,
                                 model.device), shard["params"]


def prefill_cost(model, cfg, shape, mesh) -> dict:
    """``model.forward`` over this rank's rows under ``torch.no_grad()``,
    bfloat16 parameter blocks gathered where they are used, keeping the last
    position's logits."""
    params, p_shard = _param_blocks(model, mesh)
    b = local_batch(shape, mesh)
    ins = registry.input_specs(cfg, shape, batch_override=b)
    extras = [ins[k] for k in extra_keys(cfg)]
    sizes = mesh_sizes(mesh)
    rows = tuple(a for a in ("pod", "data") if a in sizes) if b < shape.global_batch else ()

    def prefill():
        with torch.no_grad():
            if mesh is None:
                # serving semantic: only the last position's logits feed sampling
                return model.forward(params, ins["tokens"], *extras)[:, -1, :]
            blocks = step_lib.tagged_params(model, params, p_shard)
            with spmd.use(spmd.Context(mesh, rows, b)):
                last = model.forward(blocks, ins["tokens"], *extras)[:, -1, :]
                if last.shape[-1] != cfg.padded_vocab:  # a vocab-parallel block
                    last = spmd.gather_model(last, 1)
                return last

    return measure(prefill, params, ins)


def decode_cost(model, cfg, shape, mesh) -> dict:
    """One step of ``train.step.build_serve_step`` (attention ``xla``) over
    a cache of the cell's length placed as the reference's, bfloat16
    parameter blocks; the global batch's token, each rank computing its
    rows."""
    codec = L.KVCodecConfig("blockfloat8" if shape.name == "long_500k" else "none")
    serve, _, (p_abs, p_shard) = step_lib.build_serve_step(model, mesh, codec, torch.bfloat16,
                                                           "xla")
    params = step_lib.empty_blocks(p_abs, p_shard, mesh, model.device)
    cache_abs = model.cache_spec(shape.global_batch, shape.seq_len, codec)
    cache = step_lib.empty_blocks(cache_abs, step_lib.cache_shardings(cache_abs, mesh), mesh,
                                  model.device)
    ins = registry.input_specs(cfg, shape)
    # every lane at the cell's one position: the (B,) form of the scalar
    # index, which the port decodes without reading it back to the host
    index = ins["index"].expand(shape.global_batch)
    with AllLive():
        return measure(lambda: serve(params, cache, ins["token"], index), params, cache, ins)


def grad_wire(model, mesh, grad_comp: bool) -> dict:
    """Cross-pod gradient wire accounting, with and without the compressed
    hop, from :mod:`repro_torch.dist.collectives`."""
    n_params = param_count(model.specs())
    n_pods = mesh_sizes(mesh).get("pod", 1)
    gc_off, gc_on = GradCompressionConfig(enabled=False), GradCompressionConfig(enabled=True)
    bpp_off, bpp_on = wire_bytes_per_param(gc_off), wire_bytes_per_param(gc_on)
    dev_off = pod_hop_device_bytes(gc_off, n_params, n_pods)
    dev_on = pod_hop_device_bytes(gc_on, n_params, n_pods)
    return {
        "params": n_params,
        "n_pods": n_pods,
        # per-crossing wire format (pod-count-independent)
        "bytes_per_param": {"off": bpp_off, "on": bpp_on},
        "format_savings_x": round(bpp_off / bpp_on, 2),
        # aggregate per-device bytes at this topology
        "device_hop_bytes": {"off": dev_off, "on": dev_on},
        "device_savings_x": round(dev_off / dev_on, 2) if dev_on else None,
        "grad_comp_lowered": bool(grad_comp),
    }


def state_blocks(model, mesh, step_cfg) -> tuple[list, list]:
    """``(state block shapes and dtypes, param block shapes)`` of one rank:
    each leaf's local block under its spec (``TensorSpec`` leaves)."""
    state_abs, shard = step_lib.make_state_specs(model, mesh, step_cfg)

    def block(s, sh):
        if sh is None:
            return s
        return L.TensorSpec(shardlib.local_shape(s.shape, sh.spec, mesh), s.dtype)

    leaves = tree_util.tree_flatten(state_abs)[0]
    params = tree_util.tree_flatten(state_abs["params"])[0]
    return ([block(s, sh) for s, sh in zip(leaves, step_lib._flat_shardings(
                shard, mesh, len(leaves)))],
            [block(s, sh) for s, sh in zip(params, step_lib._flat_shardings(
                shard["params"], mesh, len(params)))])


def train_arg_bytes(model, mesh, grad_comp: bool = False) -> tuple[int, int]:
    """``(state bytes, float32 accumulator bytes)`` of one rank's blocks of
    the train step's bfloat16-parameter state, as the card allocates them."""
    scfg = step_lib.TrainStepConfig(grad_comp=GradCompressionConfig(enabled=grad_comp),
                                    param_dtype=torch.bfloat16)
    leaves, params = state_blocks(model, mesh, scfg)
    return (sum(alloc_bytes(s.nbytes) for s in leaves),
            sum(alloc_bytes(4 * math.prod(s.shape)) for s in params))


def cell_cost(cfg, shape, mesh, grad_comp: bool = False) -> tuple[dict, int]:
    """``(counters, microbatches)`` of one cell at full depth on ``mesh``."""
    model = registry.build_model(cfg, device="meta")
    if shape.kind == "prefill":
        return prefill_cost(model, cfg, shape, mesh), 1
    if shape.kind == "decode":
        return decode_cost(model, cfg, shape, mesh), 1

    def trace(k: int, runs: int = 1) -> dict:
        return train_cost(model, cfg, shape, mesh, k, runs, grad_comp)

    k, c1 = choose_microbatches(trace, train_rows(shape, mesh),
                                *train_arg_bytes(model, mesh, grad_comp))
    if k == 1:
        return c1, 1
    return loop_cost(c1, trace(k, 2), k), k


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             grad_comp: bool = False) -> dict:
    cfg = registry.get_config(arch)
    shape = registry.SHAPES[shape_name]
    ok, why = registry.supports(cfg, shape)
    mesh_name = "multi" if multi_pod else "single"
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "kind": shape.kind, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch}
    if ok and shape.kind == "train":
        why = train_refusal(shape, multi_pod)
        ok = why is None
    if not ok:
        cell["status"] = "skipped"
        cell["skip_reason"] = why
        return cell

    t0 = time.time()
    try:
        gc_on = grad_comp and multi_pod
        with fake_mesh(multi_pod) as mesh:
            cost, k = cell_cost(cfg, shape, mesh, gc_on)
            n_dev = mesh.size()
            mesh_shape = mesh_sizes(mesh)
            if shape.kind == "train":
                cell["microbatches"] = k
                wire = grad_wire(registry.build_model(cfg, device="meta"), mesh, gc_on)
        coll = cost["collective"]
        peak = int(cost["peak"])
        cell.update({
            "status": "ok",
            "compile_s": round(time.time() - t0, 1),
            "n_devices": n_dev,
            "mesh_shape": mesh_shape,
            "flops_per_device": cost["flops"],
            "bytes_accessed_per_device": cost["bytes"],
            "collective_bytes_per_device": coll,
            "collective_total": sum(coll.values()),
            "memory": {"argument_bytes": int(cost["argument_bytes"]),
                       "temp_bytes": peak - int(cost["argument_bytes"])},
            "peak_bytes_per_device": peak,
            "device_memory_bytes": DEVICE_MEMORY_BYTES,
            "fits_device": bool(peak <= DEVICE_MEMORY_BYTES),
        })
        if shape.kind == "train":
            cell["grad_wire"] = wire
        # one structured record per cell into the shared metrics JSONL
        # stream (no-op unless repro_torch.obs is enabled, e.g. via --metrics-dir)
        obs_metrics.event(
            "dryrun.cell", arch=arch, shape=shape_name, mesh=mesh_name,
            status="ok", compile_s=cell["compile_s"],
            flops_per_device=cell["flops_per_device"],
            bytes_accessed_per_device=cell["bytes_accessed_per_device"],
            peak_bytes_per_device=peak, fits_device=cell["fits_device"],
            collective_total=cell["collective_total"])
        if verbose:
            _log.info(
                "[%s x %s x %s] OK in %ss  flops/dev=%.3e  peak/dev=%.2fGiB (fits: %s)  "
                "coll=%.1fMiB", arch, shape_name, mesh_name, cell["compile_s"],
                cell["flops_per_device"], peak / 2**30, cell["fits_device"],
                cell["collective_total"] / 2**20)
            _log.info("  memory: %s", cell["memory"])
            _log.info("  bytes accessed: %.3e", cell["bytes_accessed_per_device"])
            _log.info("  collective_bytes/dev: %s",
                      "  ".join(f"{k}={v/2**20:.2f}MiB" for k, v in coll.items()))
            if "grad_wire" in cell:
                gw = cell["grad_wire"]
                _log.info(
                    "  grad wire (%.1fM params, %d pods): format %s->%.3f "
                    "B/param (%sx); per-device hop %.1fMiB -> %.1fMiB "
                    "(%sx, lowered=%s)", gw["params"] / 1e6, gw["n_pods"],
                    gw["bytes_per_param"]["off"], gw["bytes_per_param"]["on"],
                    gw["format_savings_x"], gw["device_hop_bytes"]["off"] / 2**20,
                    gw["device_hop_bytes"]["on"] / 2**20, gw["device_savings_x"],
                    gw["grad_comp_lowered"])
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        cell["status"] = "error"
        cell["error"] = f"{type(e).__name__}: {e}"
        cell["traceback"] = traceback.format_exc()[-2000:]
        obs_metrics.event("dryrun.error", arch=arch, shape=shape_name,
                          mesh=mesh_name, error=cell["error"])
        if verbose:
            _log.error("[%s x %s x %s] FAILED: %s",
                       arch, shape_name, mesh_name, cell["error"])
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(registry.ARCH_IDS))
    ap.add_argument("--shape", choices=list(registry.SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="sweep every cell")
    ap.add_argument("--grad-comp", action="store_true",
                    help="enable compressed cross-pod gradient hop")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--metrics-dir", default=None,
                    help="also append per-cell records to DIR/metrics.jsonl")
    args = ap.parse_args(argv)

    _ensure_cli_logging()
    if args.metrics_dir is not None:
        mdir = Path(args.metrics_dir)
        mdir.mkdir(parents=True, exist_ok=True)
        obs_metrics.enable(mdir / "metrics.jsonl")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    archs = list(registry.ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(registry.SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cell = run_cell(arch, shape, mp, grad_comp=args.grad_comp)
                tag = f"{arch.replace('/', '_')}__{shape}__{'multi' if mp else 'single'}"
                if args.grad_comp:
                    tag += "__gradcomp"
                (out_dir / f"{tag}.json").write_text(json.dumps(cell, indent=2))
                if cell["status"] == "error":
                    failures += 1
    _log.info("dry-run complete; %d failures", failures)
    if obs_metrics.enabled():
        obs_metrics.export_snapshot(final=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

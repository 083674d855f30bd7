"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: ``meta``
tensors and a fake process group, no card.

* ``supports`` and ``input_specs`` against the reference's registry, cell
  for cell (the reasons word for word; shapes and dtypes, with
  ``batch_override``);
* the collective counter on the shapes of ``test_dist.py``'s HLO parse
  (``TestCollectiveParse``): each c10d op adds its result bytes under the
  reference's five keys, a matmul adds nothing; and the compressed pod hop
  on 8 fake ranks within the wire bounds of ``test_dist.py``'s stacked hop
  (an s8 gather of 8·N to 16·N bytes, an all-reduce under 4·N);
* the ``grad_wire`` block equal to the reference's committed
  ``experiments/dryrun/minicpm-2b__train_4k__multi.json``;
* a SMOKE dense forward's FLOPs equal to the matmul count from its shapes,
  and the live-bytes tracker's peak on a hand-made allocate / free sequence;
* the CLI at full width on ``starcoder2-3b decode_32k single`` (on the
  unfolded ``(16, 16)`` mesh: the cache's bytes a device are the whole
  cache over data x model, the argument bytes exactly the parameter and
  cache blocks) and a skipped ``long_500k`` cell;
* train cells on the reference's unfolded meshes (with the sharded
  state): a traced step's state is each leaf's local block (its bytes the
  sum of the blocks' from the specs) and its all-gather and reduce-scatter
  bytes are non-zero; the committed ``experiments/torch_dryrun/`` train
  cells (every one ``ok``, rwkv6's and hymba's multi-pod cells too) lie on
  ``(16, 16)`` and ``(2, 16, 16)`` with non-zero all-gather and
  reduce-scatter bytes, the prefill, decode and ``long_500k`` cells on the
  same unfolded meshes, every ``decode_32k`` cell fitting one card; a
  prefill cell traces on the unfolded meshes with its parameters in blocks;
* the train step's rows: every family computes on Megatron blocks, so the
  rows split over pod x data (the ranks along ``model`` share them) and
  rows that do not split there are refused; ``train_4k``'s 256 rows lie on
  the 512 ranks, and rwkv6 and hymba trace a step on the multi-pod mesh
  with no all-gather over ``model``;
* a Megatron block that reaches a layer without its hook makes the step
  raise (no fallback);
* the dry run refuses to replace a process group that is up, ``meta`` is a
  device the port accepts and never a default, and every hand-kernel wrapper
  refuses a ``meta`` tensor.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg
from repro_torch.device import resolve_device
from repro_torch.dist import collectives
from repro_torch.launch import dryrun
from repro_torch.models.spec import empty_params

ROOT = Path(__file__).resolve().parents[1]
SHAPE_PAIRS = [(a, s) for a in jreg.ARCH_IDS for s in jreg.SHAPES]


def _fake_world(n: int):
    """A fake default group of ``n`` ranks (this process rank 0), torn down
    by the caller."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


@pytest.mark.parametrize("arch,shape", SHAPE_PAIRS)
def test_supports_matches_reference(arch, shape):
    want = jreg.supports(jreg.get_config(arch), jreg.SHAPES[shape])
    assert treg.supports(treg.get_config(arch), treg.SHAPES[shape]) == want


@pytest.mark.parametrize("batch_override", [None, 3])
def test_input_specs_match_reference(batch_override):
    for arch, shape in SHAPE_PAIRS:
        want = jreg.input_specs(jreg.get_config(arch), jreg.SHAPES[shape],
                                batch_override=batch_override)
        got = treg.input_specs(treg.get_config(arch), treg.SHAPES[shape],
                               batch_override=batch_override)
        assert sorted(got) == sorted(want), (arch, shape)
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(w.shape), (arch, shape, k)
            assert str(got[k].dtype).removeprefix("torch.") == str(jnp.dtype(w.dtype)), \
                (arch, shape, k)


def test_collective_counter_sums_result_bytes_per_op():
    _fake_world(16)
    try:
        meta = dict(device="meta")
        with dryrun.CostCounter() as c:
            dist.all_gather_into_tensor(torch.empty(80, 512, 3072, dtype=torch.bfloat16, **meta),
                                        torch.empty(5, 512, 3072, dtype=torch.bfloat16, **meta))
            dist.all_reduce(torch.empty(1024, **meta))
            for _ in range(2):  # the HLO's (f32[256], f32[256]) tuple result
                dist.reduce_scatter_tensor(torch.empty(256, **meta), torch.empty(4096, **meta))
            codes = torch.empty(65536, 128, dtype=torch.int8, **meta)
            dist.all_to_all_single(torch.empty_like(codes), codes)
            dist.send(torch.empty(4, 4096, dtype=torch.bfloat16, **meta), dst=1)
        assert c.collective == {"all-gather": 80 * 512 * 3072 * 2, "all-reduce": 1024 * 4,
                                "reduce-scatter": 2 * 256 * 4, "all-to-all": 65536 * 128,
                                "collective-permute": 4 * 4096 * 2}
        a, b = torch.empty(4096, 4096, **meta), torch.empty(4096, 4096, **meta)
        with dryrun.CostCounter() as c:
            a @ b
            torch.empty(4096, 4096, **meta)  # an allocation moves nothing
        assert sum(c.collective.values()) == 0 and c.bytes_accessed == 3 * 4096 * 4096 * 4
    finally:
        dist.destroy_process_group()


def test_compressed_pod_hop_wire_on_eight_fake_ranks():
    """``test_dist.py``'s stacked hop: the wire is the s8 code gather (plus
    f32 block scales), not an f32 all-reduce of the gradients."""
    from torch.distributed.device_mesh import init_device_mesh

    n_pods, n = 8, 4096
    _fake_world(n_pods)
    try:
        mesh = init_device_mesh("cpu", (n_pods,), mesh_dim_names=("pod",))
        gc = collectives.GradCompressionConfig(enabled=True, bits=8)
        g = torch.empty(n, device="meta")
        ef = torch.empty(n, dtype=torch.bfloat16, device="meta")
        with dryrun.CostCounter() as c:
            collectives.compressed_pod_mean({"w": g}, gc, {"w": ef}, mesh=mesh)
        assert n_pods * n <= c.collective["all-gather"] <= n_pods * n * 2, c.collective
        assert c.collective["all-reduce"] < 4 * n, c.collective
    finally:
        dist.destroy_process_group()


def test_grad_wire_matches_reference_dryrun():
    want = json.loads((ROOT / "experiments/dryrun/minicpm-2b__train_4k__multi.json").read_text())
    model = treg.build_model(treg.get_config("minicpm-2b"), device="meta")
    with dryrun.fake_mesh(multi_pod=True) as mesh:
        got = dryrun.grad_wire(model, mesh, grad_comp=False)
    assert got == want["grad_wire"]
    assert got["params"] == 2725173504 and got["bytes_per_param"] == {"off": 8.0, "on": 1.00390625}
    assert got["device_hop_bytes"] == {"off": 10900694016, "on": 2735818713}


def test_dense_forward_flops_equal_the_matmul_count():
    cfg = treg.get_config("minicpm-2b", smoke=True)
    model = treg.build_model(cfg, device="meta")
    params = empty_params(model.specs(), "meta", torch.bfloat16)
    b, s = 3, 40
    tokens = torch.empty(b, s, dtype=torch.int32, device="meta")
    with torch.no_grad():
        got = dryrun.measure(lambda: model.forward(params, tokens), params, tokens)
    a = cfg.attn()
    d, h, hkv, hd = cfg.d_model, a.n_heads, a.n_kv_heads, a.head_dim
    proj = d * (h + 2 * hkv) * hd + h * hd * d + 3 * d * cfg.d_ff  # swiglu: gate, up, down
    per_layer = 2 * b * s * proj + 2 * (2 * b * h * s * s * hd)  # q.k and p.v
    want = cfg.n_layers * per_layer + 2 * b * s * d * cfg.padded_vocab
    assert cfg.mlp_kind == "swiglu" and got["flops"] == want


def test_loop_cost_from_two_traces_equals_the_whole_loop():
    """``C1 + (k - 1)(C2 - C1)`` from traces that stop after one and two
    microbatches is the k-microbatch step's count, and one iteration's peak
    is the loop's: every iteration runs the same operations."""
    cfg = treg.get_config("minicpm-2b", smoke=True)
    k = 4  # a row a rank of each microbatch on the 256 ranks
    shape = treg.ShapeCell("train_small", 16, 256 * k, "train")
    with dryrun.fake_mesh(multi_pod=False) as mesh:
        model = treg.build_model(cfg, device="meta")
        c1, c2, whole = (dryrun.train_cost(model, cfg, shape, mesh, k, runs)
                         for runs in (1, 2, k))
    got = dryrun.loop_cost(c1, c2, k)
    assert (got["flops"], got["bytes"], got["collective"]) == \
        (whole["flops"], whole["bytes"], whole["collective"])
    assert got["peak"] == whole["peak"] and c1["flops"] * k == whole["flops"]


def test_live_bytes_tracker_peak_on_a_hand_made_sequence():
    meta = dict(device="meta")
    a = torch.empty(1000, **meta)  # 4000 B -> 4096 held from the start
    with dryrun.CostCounter(a) as c:
        b = torch.empty(300, **meta)  # 1200 -> 1536: live 5632
        v = b[10:]  # a view: no new storage
        x = torch.empty(1000, **meta)  # 4096: live 9728
        del b  # the view keeps b's storage
        x.add_(1)  # in place: no new storage
        del v  # b's storage dies: 8192
        y = torch.empty(2000, dtype=torch.int8, **meta)  # 2048: 10240
        del x  # 6144
        z = torch.empty(1024, **meta)  # 4096: 10240 again
        assert c.live == 10240
    assert (c.argument_bytes, c.peak) == (4096, 10240)
    del y, z
    assert dryrun.alloc_bytes(0) == 0 and dryrun.alloc_bytes(512) == 512
    assert dryrun.alloc_bytes(513) == 1024


def test_cli_at_full_width_decode_and_a_skipped_cell(tmp_path):
    assert dryrun.main(["--arch", "starcoder2-3b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    cell = json.loads((tmp_path / "starcoder2-3b__decode_32k__single.json").read_text())
    assert cell["status"] == "ok" and cell["n_devices"] == 256
    assert cell["mesh_shape"] == {"data": 16, "model": 16}
    # 128 rows of a 32768-position cache (30 layers of bf16 K and V, 2 kv
    # heads x 128), 8 rows and 2048 positions a device
    cache = 30 * 2 * 128 * 32768 * 2 * 128 * 2
    model = treg.build_model(treg.get_config("starcoder2-3b"), device="meta")
    shape = treg.SHAPES["decode_32k"]
    with dryrun.fake_mesh(False) as mesh:
        cache_abs = model.cache_spec(128, shape.seq_len, dryrun.L.KVCodecConfig("none"))
        blocks = dryrun.step_lib.empty_blocks(
            cache_abs, dryrun.step_lib.cache_shardings(cache_abs, mesh), mesh, "meta")
        local = [dryrun.shardlib.local(x) for x in blocks.values()]
        params = dryrun._param_blocks(model, mesh)[0]
        p_local = [dryrun.shardlib.local(x) for x in dryrun.tree_util.tree_flatten(params)[0]]
    assert sum(t.numel() * t.element_size() for t in local) * 256 == cache
    assert cell["memory"]["argument_bytes"] == sum(
        dryrun.alloc_bytes(t.numel() * t.element_size()) for t in local + p_local) + 2 * 512
    assert cell["fits_device"] and cell["peak_bytes_per_device"] < dryrun.DEVICE_MEMORY_BYTES
    params = 3181274112
    assert cell["flops_per_device"] > 2 * 8 * params / 16  # its rows on every weight's block
    coll = cell["collective_bytes_per_device"]
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0  # weights over data, softmax over model
    assert "fits_16gb" not in cell
    assert dryrun.main(["--arch", "starcoder2-3b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    skipped = json.loads((tmp_path / "starcoder2-3b__long_500k__single.json").read_text())
    assert skipped["status"] == "skipped"
    assert skipped["skip_reason"] == jreg.supports(jreg.get_config("starcoder2-3b"),
                                                   jreg.SHAPES["long_500k"])[1]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_cell_on_the_unfolded_mesh_holds_blocks(multi_pod):
    cfg = treg.get_config("minicpm-2b", smoke=True)
    shape = treg.ShapeCell("train_small", 16, 512 if multi_pod else 256, "train")
    with dryrun.fake_mesh(multi_pod) as mesh:
        assert dryrun.mesh_sizes(mesh)["model"] == 16 and mesh.size() == (512 if multi_pod
                                                                          else 256)
        model = treg.build_model(cfg, device="meta")
        cost = dryrun.train_cost(model, cfg, shape, mesh, 1, 1)
        state_bytes, _ = dryrun.train_arg_bytes(model, mesh)
        blocks, _ = dryrun.state_blocks(model, mesh, dryrun.step_lib.TrainStepConfig(
            param_dtype=torch.bfloat16))
    assert cost["argument_bytes"] == state_bytes == sum(dryrun.alloc_bytes(s.nbytes)
                                                       for s in blocks)
    whole = sum(p.nbytes for p in dryrun.tree_util.tree_flatten(
        dryrun.step_lib.make_state_specs(model, None, dryrun.step_lib.TrainStepConfig(
            param_dtype=torch.bfloat16))[0])[0])
    assert state_bytes < whole / 8  # every large leaf split over data and model
    assert cost["collective"]["all-gather"] > 0 and cost["collective"]["reduce-scatter"] > 0


def test_train_cell_without_a_mesh_holds_the_whole_state():
    """One rank and no mesh (``chip_smoke.py`` phase 29's cells): the
    state is every leaf whole and the step gathers nothing."""
    cfg = treg.get_config("minicpm-2b", smoke=True)
    model = treg.build_model(cfg, device="meta")
    cost = dryrun.train_cost(model, cfg, treg.ShapeCell("train_small", 16, 4, "train"), None,
                             1, 1)
    whole = dryrun.step_lib.make_state_specs(model, None, dryrun.step_lib.TrainStepConfig(
        param_dtype=torch.bfloat16))[0]
    leaves = dryrun.tree_util.tree_flatten(whole)[0]
    assert cost["argument_bytes"] == dryrun.train_arg_bytes(model, None)[0] == sum(
        dryrun.alloc_bytes(s.nbytes) for s in leaves)
    assert sum(cost["collective"].values()) == 0 and cost["flops"] > 0


def test_committed_cells_lie_on_their_meshes():
    cells = [json.loads(p.read_text()) for p in sorted((ROOT / "experiments/torch_dryrun")
                                                       .glob("*.json"))]
    assert len(cells) == 62
    for c in cells:
        multi = c["mesh"] == "multi"
        if c["kind"] == "train":
            assert c["status"] == "ok", (c["arch"], c["mesh"])
        if c["status"] != "ok":
            continue
        if c["kind"] == "train":
            assert c["mesh_shape"] == ({"pod": 2, "data": 16, "model": 16} if multi
                                       else {"data": 16, "model": 16}), c["arch"]
            assert c["collective_bytes_per_device"]["all-gather"] > 0
            assert c["collective_bytes_per_device"]["reduce-scatter"] > 0
        else:
            assert c["mesh_shape"] == ({"pod": 2, "data": 16, "model": 16} if multi
                                       else {"data": 16, "model": 16}), c["arch"]
            assert c["collective_bytes_per_device"]["all-gather"] > 0, c["arch"]
            if c["shape"] == "decode_32k":
                assert c["fits_device"], c["arch"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_prefill_cell_on_the_unfolded_mesh_holds_blocks(multi_pod):
    """A prefill cell on (16, 16) or (2, 16, 16): the parameters are this
    rank's blocks, gathered where they are used, and its rows split over
    pod x data."""
    cfg = treg.get_config("minicpm-2b", smoke=True)
    shape = treg.ShapeCell("prefill_small", 64, 64 if multi_pod else 32, "prefill")
    with dryrun.fake_mesh(multi_pod) as mesh:
        model = treg.build_model(cfg, device="meta")
        cost = dryrun.prefill_cost(model, cfg, shape, mesh)
        params = dryrun._param_blocks(model, mesh)[0]
        blocks = sum(dryrun.alloc_bytes(x.to_local().numel() * x.element_size())
                     if dryrun.shardlib.is_dtensor(x) else dryrun.alloc_bytes(
                         x.numel() * x.element_size())
                     for x in dryrun.tree_util.tree_flatten(params)[0])
        assert dryrun.local_batch(shape, mesh) == 2
    whole = sum(p.nbytes for p in dryrun.tree_util.tree_flatten(
        dryrun.step_lib.make_state_specs(model, None, dryrun.step_lib.TrainStepConfig(
            param_dtype=torch.bfloat16))[0]["params"])[0])
    ins = dryrun.alloc_bytes(2 * 64 * 4)  # this rank's two rows of tokens
    assert cost["argument_bytes"] == blocks + ins and blocks < whole / 4
    assert cost["collective"]["all-gather"] > 0 and cost["flops"] > 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_step_refuses_rows_that_do_not_split_over_pod_and_data(multi_pod):
    """No rank repeats another's rows: every family computes on Megatron
    blocks, so the rows split over pod x data (the ranks along ``model``
    share them), and a microbatch whose rows do not divide over those ranks
    raises in the step; the dry run skips such a cell with its reason before
    tracing it."""
    cfg = treg.get_config("minicpm-2b", smoke=True)
    n = 32 if multi_pod else 16  # pod x data ranks
    with dryrun.fake_mesh(multi_pod) as mesh:
        model = treg.build_model(cfg, device="meta")
        for rows, k in ((n // 2, 1), (n, 2), (n + 8, 1)):
            with pytest.raises(ValueError, match="does not split"):
                dryrun.train_cost(model, cfg, treg.ShapeCell("train_small", 8, rows, "train"),
                                  mesh, k, 1)
        assert dryrun.train_rows(treg.ShapeCell("train_small", 8, 2 * n, "train"), mesh) == 2
    why = dryrun.train_refusal(treg.ShapeCell("train_small", 8, n // 2, "train"), multi_pod)
    assert why is not None and why.endswith("ranks of pod x data" if multi_pod else "ranks of data")
    assert dryrun.train_refusal(treg.ShapeCell("train_small", 8, n, "train"), multi_pod) is None


def test_multi_pod_train_4k_takes_256_rows_on_model_blocks():
    """``train_4k``'s 256 rows on the 512 ranks of (2, 16, 16): eight rows
    a rank, shared along ``model``."""
    shape = treg.SHAPES["train_4k"]
    assert dryrun.train_refusal(shape, True) is None
    assert dryrun.ROW_AXES == ("pod", "data")
    with dryrun.fake_mesh(True) as mesh:
        assert dryrun.train_rows(shape, mesh) == 8


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_whole_weight_families_still_refuse_256_rows_on_512_ranks(arch):
    """rwkv6 and hymba, which gathered their weights whole and refused
    ``train_4k``'s 256 rows on the 512 ranks of (2, 16, 16), compute on
    Megatron blocks: nothing refuses the cell, and a step at published
    widths (2 layers, 32 rows of 8 tokens: one a pod x data rank) traces on
    the multi-pod mesh with its weights gathered over ``data``, its
    activations reduced over ``model`` and no all-gather over ``model``
    (rwkv6's 32 heads split 2 a rank, hymba's 25 replicated)."""
    from repro_torch.dist import spmd

    cfg = treg.get_config(arch).scaled(n_layers=2)
    assert dryrun.train_refusal(treg.SHAPES["train_4k"], True) is None
    with dryrun.fake_mesh(True) as mesh:
        assert dryrun.train_rows(treg.SHAPES["train_4k"], mesh) == 8
        model = treg.build_model(cfg, device="meta")
        spmd.reset_sent_bytes()
        cost = dryrun.train_cost(model, cfg, treg.ShapeCell("train_small", 8, 32, "train"),
                                 mesh, 1, 1)
        sent = {k: dict(v) for k, v in spmd.sent_by_axis.items()}
    assert cost["flops"] > 0 and cost["collective"]["all-gather"] > 0
    assert sent["all_gather"].get("data", 0) > 0 and sent["all_reduce"].get("model", 0) > 0
    assert "model" not in sent["all_gather"] and "model" not in sent["reduce_scatter"], sent


def test_a_model_block_no_layer_takes_raises(monkeypatch):
    """No fallback: a Megatron block that reaches a layer which does not
    take it as a block (``spmd.model_split``) makes the step raise; the MLP
    here would otherwise compute on its ``mlp`` blocks as if they were the
    whole weights and never reduce."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L

    def mlp_without_its_hook(p, x, kind="swiglu"):
        dt = x.dtype
        return (F.silu(x @ p["gate"].to(dt)) * (x @ p["up"].to(dt))) @ p["down"].to(dt)

    monkeypatch.setattr(L, "mlp", mlp_without_its_hook)
    cfg = treg.get_config("minicpm-2b", smoke=True)
    with dryrun.fake_mesh(False) as mesh:
        model = treg.build_model(cfg, device="meta")
        with pytest.raises(RuntimeError, match="without taking them as blocks"):
            dryrun.train_cost(model, cfg, treg.ShapeCell("train_small", 8, 16, "train"), mesh,
                              1, 1)


def test_dry_run_refuses_a_group_that_is_up():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        cell = dryrun.run_cell("whisper-base", "decode_32k", False, verbose=False)
        assert cell["status"] == "error" and "already initialized" in cell["error"]
        assert dist.is_initialized() and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_meta_is_an_explicit_device_only():
    assert resolve_device("meta").type == "meta"
    assert resolve_device("cpu").type == "cpu"
    model = treg.build_model(treg.get_config("hymba-1.5b"), device="meta")
    assert model.device.type == "meta"
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        resolve_device("xpu")


def test_every_kernel_wrapper_refuses_meta():
    """A ``meta`` tensor reaching a hand-kernel wrapper raises, as a CUDA
    tensor whose library cannot load does; none takes the plain version."""
    from repro_torch import kernels
    from repro_torch.core import bitpack
    from repro_torch.kernels import kvc_attention as k10
    from repro_torch.kernels import lorenzo3d, sz_fused, zfp3d, zfp_fused

    m = dict(device="meta")
    eb = torch.tensor(0.1)
    x = torch.empty(8, 64, 128, **m)
    words = torch.empty(64, dtype=torch.int32, **m)
    packed = bitpack.PackedCodes(words.view(torch.uint32), torch.empty(1024, dtype=torch.uint8, **m),
                                 torch.empty((), dtype=torch.int64, **m), 8 * 64 * 128)
    blocks = torch.empty(64, 4, 4, 4, **m)
    q = torch.empty(2, 4, 64, **m)
    codes, scale = torch.empty(2, 16, 2, 64, dtype=torch.int8, **m), torch.empty(2, 16, 2, **m)
    table = torch.zeros(2, 1, dtype=torch.int32, **m)
    calls = {
        "lorenzo3d_reconstruct": lambda: lorenzo3d.lorenzo3d_reconstruct(
            torch.empty(8, 64, 128, dtype=torch.int32, **m), eb),
        "fused_decompress": lambda: sz_fused.fused_decompress(packed, (8, 64, 128), eb),
        "fused_compress_batched": lambda: sz_fused.fused_compress_batched(
            torch.empty(2, 8, 64, 128, **m), torch.full((2,), 0.1)),
        "fused_decompress_batched": lambda: sz_fused.fused_decompress_batched(
            torch.empty(128, dtype=torch.int32, **m), torch.empty(2, 1024, dtype=torch.uint8, **m),
            (8, 64, 128), torch.full((2,), 0.1)),
        "zfp3d_transform": lambda: zfp3d.zfp3d_transform(blocks),
        "fused_compress_blocks": lambda: zfp_fused.fused_compress_blocks(blocks, 8),
        "fused_decompress_blocks": lambda: zfp_fused.fused_decompress_blocks(
            torch.empty(4, 15, dtype=torch.int32, **m), torch.empty(4, dtype=torch.uint8, **m),
            torch.empty(4, 10, dtype=torch.uint8, **m), 8),
        "kvc_decode_attention": lambda: k10.kvc_decode_attention(
            q, codes, scale, codes, scale, torch.zeros(2, dtype=torch.int32, **m)),
        "kvc_decode_attention_paged": lambda: k10.kvc_decode_attention_paged(
            q, codes, scale, codes, scale, table, torch.zeros(2, dtype=torch.int32, **m)),
    }
    kernels.reset_launch_counts()
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert not any(kernels.launch_counts().values())

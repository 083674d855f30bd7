"""Twin tests of the port's checkpoint manager (``repro_torch.checkpoint``)
and its telemetry copy (``repro_torch.obs``) against the JAX package.

The on-disk format is the contract: for the same state both managers write
the same payload files and the same manifest, byte for byte, and a snapshot
directory written by either package restores in the other — raw leaves
bitwise, compressed leaves within their bound, every leaf in its dtype
(bfloat16 included).  The managers meet with ``CodecPolicy(zstd_level=0)``
so the result does not depend on whether ``zstandard`` imports.  Also here:
integrity (CRC and digest), the drain thread, retries, quiesce, quarantine
and the observatory sidecar of the port alone.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jman
from repro.core import arena as ja
from repro.obs import metrics as jmetrics
from repro.obs import observatory as jobs
from repro.train import faults
from repro_torch.checkpoint import manager as tman
from repro_torch.core import arena as ta
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import observatory as tobs
from repro_torch.obs import trace as ttrace

TILE = (8, 64, 128)
EB = 1e-3
NO_ZSTD = dict(zstd_level=0)


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(64, 4100)).astype(np.float32),  # > 1 MiB: lossy eligible
        "b": np.arange(7, dtype=np.float32),
        "h": rng.normal(size=(300, 1000)).astype(np.float32) * 4,  # bf16 leaf
        "step": np.int32(5),
    }


def _jstate(v):
    return {"params": {"w": jnp.asarray(v["w"]), "b": jnp.asarray(v["b"]),
                       "h": jnp.asarray(v["h"]).astype(jnp.bfloat16)},
            "opt": {"step": jnp.int32(v["step"])}}


def _tstate(v):
    return {"params": {"w": torch.from_numpy(v["w"]), "b": torch.from_numpy(v["b"]),
                       "h": torch.from_numpy(v["h"]).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(int(v["step"]), dtype=torch.int32)}}


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _tmgr(path, **kw):
    kw.setdefault("async_save", False)
    return tman.CheckpointManager(path, device="cpu", **kw)


# ------------------------------------------------------------- the port ---


def test_lossless_roundtrip_keeps_every_dtype(tmp_path):
    mgr = _tmgr(tmp_path)
    s = _tstate(_values())
    mgr.save(3, s)
    out, extra = mgr.restore(state_like=s)
    assert extra == {}
    for a, b in zip(jax.tree.leaves(s), jax.tree.leaves(out)):
        assert b.dtype == a.dtype and b.shape == a.shape and not b.is_cuda
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["sz_abs", "sz_pwrel"])
def test_lossy_leaves_within_bound(tmp_path, mode):
    pol = tman.CodecPolicy(mode=mode, eb=EB, min_bytes=1 << 16)
    mgr = _tmgr(tmp_path, policy=pol)
    v = _values()
    s = _tstate(v)
    mgr.save(1, s)
    res = mgr.wait()
    out, _ = mgr.restore(state_like=s)
    w1 = out["params"]["w"].numpy()
    if mode == "sz_abs":  # PW_REL on Gaussian weights barely shrinks without zstd
        assert res.ratio > 1.2, f"lossy checkpoint should shrink, got {res.ratio}"
        assert np.abs(w1 - v["w"]).max() <= EB * (1 + 1e-5)
    else:
        nz = v["w"] != 0
        assert np.abs(w1[nz] / v["w"][nz] - 1).max() <= EB * 1.05
    h = _f32(out["params"]["h"])
    assert out["params"]["h"].dtype == torch.bfloat16
    h0 = _f32(s["params"]["h"])
    assert np.abs(h - h0).max() <= EB * (1 + 1e-5) + np.abs(h0).max() * 2.0**-8  # bf16 re-round
    assert torch.equal(out["params"]["b"], s["params"]["b"])  # small leaves stay exact
    assert int(out["opt"]["step"]) == 5


def test_zstd_payloads_restore(tmp_path):
    """The default policy zstd-compresses every payload when ``zstandard``
    imports (and writes them plain when it does not); a single leaf is
    expanded once on restore, so both round-trip."""
    mgr = _tmgr(tmp_path)
    s = _tstate(_values())
    mgr.save(1, s)
    manifest = json.loads((tmp_path / "step_000000001/MANIFEST.json").read_text())
    assert all(m.get("zstd", False) == (tman._zstd is not None) for m in manifest["leaves"])
    out, _ = mgr.restore(state_like=s)
    for a, b in zip(jax.tree.leaves(s), jax.tree.leaves(out)):
        assert torch.equal(a, b)


def test_corruption_detected_and_digest_covers_extra(tmp_path):
    mgr = _tmgr(tmp_path)
    s = _tstate(_values())
    mgr.save(1, s, extra={"data_step": 1})
    blob = tmp_path / "step_000000001" / "leaf_00000.bin"
    raw = bytearray(blob.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    blob.write_bytes(bytes(raw))
    with pytest.raises(tman.SnapshotCorruptionError, match="crc") as ei:
        mgr.restore(state_like=s)
    assert ei.value.payload == "leaf_00000.bin" and ei.value.step == 1
    mgr.save(2, s, extra={"data_step": 2})
    mpath = tmp_path / "step_000000002/MANIFEST.json"
    m = json.loads(mpath.read_text())
    m["extra"]["data_step"] = 999
    mpath.write_text(json.dumps(m))
    with pytest.raises(tman.SnapshotCorruptionError, match="digest"):
        mgr.restore(step=2, state_like=s)
    assert issubclass(tman.SnapshotCorruptionError, IOError)


@pytest.mark.parametrize("target", ["payload", "manifest"])
@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_fallback_quarantines_corrupt_steps(tmp_path, target, mode):
    mgr = _tmgr(tmp_path)
    s3, s6 = _tstate(_values(3)), _tstate(_values(6))
    mgr.save(3, s3)
    mgr.save(6, s6)
    faults.corrupt_snapshot(tmp_path / "step_000000006", target, mode, seed=7)
    with pytest.raises(tman.SnapshotCorruptionError):
        mgr.restore(step=6, state_like=s6)
    out, _, step = mgr.restore_latest_valid(state_like=s3)
    assert step == 3
    for a, b in zip(jax.tree.leaves(s3), jax.tree.leaves(out)):
        assert torch.equal(a, b)
    assert not (tmp_path / "step_000000006").exists()
    assert (tmp_path / "quarantine/step_000000006").exists()
    assert mgr.available_steps() == [3]
    faults.corrupt_snapshot(tmp_path / "step_000000003", "payload", "bitflip")
    with pytest.raises(tman.SnapshotCorruptionError):
        mgr.restore(fallback=True, state_like=s3)


def test_keep_last_async_and_extra(tmp_path):
    mgr = _tmgr(tmp_path, keep_last=2, async_save=True)
    s = _tstate(_values())
    done = []
    for step in (1, 2, 3, 4):
        mgr.save(step, s, extra={"data_step": step}, on_complete=done.append)
    res = mgr.wait()
    assert res.step == 4 and done == [1, 2, 3, 4]
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_000000003",
                                                                "step_000000004"]
    assert mgr.latest_step() == 4 and mgr.last_result is res
    _, extra = mgr.restore(state_like=s)
    assert extra == {"data_step": 4}
    assert mgr.quiesce(1.0) == (True, None)


class TestDrain:
    def _flaky(self, fail_first):
        calls = {"n": 0}

        def wb(path, data):
            calls["n"] += 1
            if calls["n"] <= fail_first:
                raise OSError(f"transient #{calls['n']}")
            tman._write_bytes(path, data)

        return wb, calls

    def test_transient_oserror_retried_and_counted(self, tmp_path):
        wb, _ = self._flaky(2)
        mgr = _tmgr(tmp_path, async_save=True, write_bytes=wb, retry_backoff_s=0.01)
        s = _tstate(_values())
        mgr.save(1, s)
        assert mgr.wait().retries == 2
        out, _ = mgr.restore(state_like=s)
        assert torch.equal(out["params"]["b"], s["params"]["b"])

    def test_exhausted_retries_surface_and_nothing_partial(self, tmp_path):
        wb, calls = self._flaky(10**9)
        mgr = _tmgr(tmp_path, async_save=True, write_bytes=wb, retry_backoff_s=0.01)
        mgr.save(1, _tstate(_values()))
        with pytest.raises(OSError, match="transient"):
            mgr.wait()
        assert calls["n"] == 3 and mgr.latest_step() is None

    def test_quiesce_consumes_error_and_bounds_a_wedged_drain(self, tmp_path):
        def fire(path, data):
            raise OSError("disk on fire")

        mgr = _tmgr(tmp_path / "a", async_save=True, write_bytes=fire, io_retries=1)
        mgr.save(1, _tstate(_values()))
        drained, err = mgr.quiesce(10.0)
        assert drained and isinstance(err, OSError) and mgr.wait() is None

        def slow(path, data):
            time.sleep(0.25)
            tman._write_bytes(path, data)

        mgr = _tmgr(tmp_path / "b", async_save=True, write_bytes=slow)
        mgr.save(1, _tstate(_values()))
        t0 = time.monotonic()
        drained, err = mgr.quiesce(0.05)
        assert time.monotonic() - t0 < 1.0 and not drained and err is None
        mgr.wait()
        assert mgr.latest_step() == 1


def test_sharded_leaves_and_insitu_codec_wait_for_dist(tmp_path):
    """A raw mesh-sharded leaf still waits for the next dist slice; an
    ``insitu-*`` leaf now restores through ``dist.insitu.host_restore``, so
    a manifest that claims the codec for a plain payload is corruption."""
    class FakeDTensor(torch.Tensor):
        placements = ("Shard(0)",)

    mgr = _tmgr(tmp_path)
    leaf = torch.zeros(4).as_subclass(FakeDTensor)
    with pytest.raises(NotImplementedError, match="item 1: _ShardedLeaf"):
        mgr.save(1, {"w": leaf})
    mgr.save(2, {"w": torch.zeros(4)})
    mpath = tmp_path / "step_000000002/MANIFEST.json"
    m = json.loads(mpath.read_text())
    m["leaves"][0]["codec"] = "insitu-sz"
    body = {k: v for k, v in m.items() if k != "digest"}
    m["digest"] = tman._crc(json.dumps(body, sort_keys=True).encode())
    mpath.write_text(json.dumps(m))
    with pytest.raises(tman.SnapshotCorruptionError, match="in-situ decode of leaf 0"):
        mgr.restore(state_like={"w": 0})


# --------------------------------------------------- the two packages -----


def _arena_states(seed=5):
    """One snapshot state per package: an ``arena-szk`` bucket of two tile
    fields, a flat ``arena-sz`` bucket (f32 and bf16 leaves), and raw
    leaves.  Both are built from the same numpy values."""
    rng = np.random.default_rng(seed)
    fields = [(rng.normal(size=TILE) * 5).astype(np.float32) for _ in range(2)]
    flat = {"u": rng.normal(size=(48, 32)).astype(np.float32),
            "v": (rng.normal(size=(3000,)) * 30).astype(np.float32)}
    n = int(np.prod(TILE))
    kb = dict(padded=n, names=("f0", "f1"), shapes=(TILE,) * 2, dtypes=("float32",) * 2,
              ns=(n,) * 2)
    entries = [("u", (48, 32), "float32"), ("v", (3000,), "bfloat16")]
    jkb, tkb = ja.Bucket(**kb), ta.Bucket(**kb)
    jfb, tfb = ja.plan_buckets(entries), ta.plan_buckets(entries)
    jst = {"karena": ja.to_host(ja.szk_compress_bucket([jnp.asarray(f) for f in fields], jkb, EB),
                                jkb, codec=ja.CODEC_SZK),
           "raw": {"i": jnp.arange(10, dtype=jnp.int32),
                   "g": jnp.asarray(flat["u"]).astype(jnp.bfloat16)}}
    tst = {"karena": ta.to_host(ta.szk_compress_bucket([torch.from_numpy(f) for f in fields], tkb,
                                                       EB, device="cpu"), tkb, codec=ta.CODEC_SZK),
           "raw": {"i": torch.arange(10, dtype=torch.int32),
                   "g": torch.from_numpy(flat["u"]).to(torch.bfloat16)}}
    jleaves = {"u": jnp.asarray(flat["u"]), "v": jnp.asarray(flat["v"]).astype(jnp.bfloat16)}
    tleaves = {"u": torch.from_numpy(flat["u"]), "v": torch.from_numpy(flat["v"]).to(torch.bfloat16)}
    for k, (jb, tb) in enumerate(zip(jfb, tfb)):
        jst[f"farena{k}"] = ja.to_host(ja.sz_compress_bucket([jleaves[x] for x in jb.names], jb, EB), jb)
        ta_ = ta.sz_compress_bucket([tleaves[x] for x in tb.names], tb, EB, device="cpu")
        tst[f"farena{k}"] = ta.to_host_async(ta_, tb)  # the deferred handle, drained later
    orig = {"f0": fields[0], "f1": fields[1], "u": flat["u"],
            "v": _f32(tleaves["v"])}
    return jst, tst, orig


def _check_restored(out, orig, like):
    """Arena leaves within the bound of their (dtype-cast) values, raw
    leaves bitwise, every leaf in its dtype."""
    for k in like:
        if k.startswith(("karena", "farena")):
            for nm, got in out[k].items():
                want = orig[nm]
                g = _f32(got)
                bf16 = (str(getattr(got, "dtype", "")).endswith("bfloat16"))
                slack = np.abs(want).max() * 2.0**-8 if bf16 else 0.0
                assert g.shape == want.shape
                assert np.abs(g - want).max() <= EB * (1 + 1e-5) + slack, nm
    np.testing.assert_array_equal(np.asarray(out["raw"]["i"]), np.arange(10, dtype=np.int32))
    np.testing.assert_array_equal(_f32(out["raw"]["g"]), _f32(like["raw"]["g"]))


def test_same_state_same_files_byte_for_byte(tmp_path):
    """For the same snapshot state both managers write the same payload
    files and the same manifest (digest included), byte for byte."""
    jst, tst, _ = _arena_states()
    jman.CheckpointManager(tmp_path / "jax", async_save=False,
                           policy=jman.CodecPolicy(**NO_ZSTD)).save(7, jst, extra={"n": 1})
    _tmgr(tmp_path / "torch", policy=tman.CodecPolicy(**NO_ZSTD)).save(7, tst, extra={"n": 1})
    dj, dt = tmp_path / "jax/step_000000007", tmp_path / "torch/step_000000007"
    names = sorted(p.name for p in dj.iterdir())
    assert names == sorted(p.name for p in dt.iterdir())
    assert "arena_00000_s000.bin" in names and "leaf_00003.bin" in names
    for n in names:
        if not n.startswith("obs_"):  # the observatory holds timings
            assert (dj / n).read_bytes() == (dt / n).read_bytes(), n
    oj, ot = jobs.read_obs(dj), tobs.read_obs(dt)
    assert ot["total_stored_bytes"] == oj["total_stored_bytes"]
    assert [r["codec"] for r in ot["records"]] == [r["codec"] for r in oj["records"]]


def test_lossy_leaf_payload_equals_reference(tmp_path):
    """An ``sz_abs`` leaf: the same stream bytes in both packages."""
    v = _values()
    pol = dict(mode="sz_abs", eb=EB, min_bytes=1 << 16, **NO_ZSTD)
    jman.CheckpointManager(tmp_path / "jax", async_save=False,
                           policy=jman.CodecPolicy(**pol)).save(1, {"w": jnp.asarray(v["w"])})
    _tmgr(tmp_path / "torch", policy=tman.CodecPolicy(**pol)).save(1, {"w": torch.from_numpy(v["w"])})
    for n in ("leaf_00000.bin", "MANIFEST.json"):
        assert (tmp_path / "jax/step_000000001" / n).read_bytes() == \
            (tmp_path / "torch/step_000000001" / n).read_bytes()


@pytest.mark.parametrize("mode", ["none", "sz_abs", "sz_pwrel"])
def test_jax_snapshot_restores_in_the_port(tmp_path, mode):
    jst, tst, orig = _arena_states()
    v = _values()
    jst["leaves"], tst["leaves"] = _jstate(v), _tstate(v)
    pol = dict(mode=mode, eb=EB, min_bytes=1 << 16, **NO_ZSTD)
    jman.CheckpointManager(tmp_path, async_save=False, policy=jman.CodecPolicy(**pol)).save(4, jst)
    out, _ = _tmgr(tmp_path, policy=tman.CodecPolicy(**pol)).restore(state_like=tst)
    _check_restored(out, orig, tst)
    _check_leaves(out["leaves"], v, mode)


@pytest.mark.parametrize("mode", ["none", "sz_abs", "sz_pwrel"])
def test_port_snapshot_restores_in_jax(tmp_path, mode):
    jst, tst, orig = _arena_states()
    v = _values()
    jst["leaves"], tst["leaves"] = _jstate(v), _tstate(v)
    pol = dict(mode=mode, eb=EB, min_bytes=1 << 16, **NO_ZSTD)
    mgr = _tmgr(tmp_path, policy=tman.CodecPolicy(**pol), async_save=True)
    mgr.save(4, tst)
    assert mgr.wait().step == 4
    out, _ = jman.CheckpointManager(tmp_path, async_save=False,
                                    policy=jman.CodecPolicy(**pol)).restore(state_like=jst)
    assert out["karena"]["f0"].dtype == np.float32 and out["farena1"]["v"].dtype == jnp.bfloat16
    _check_restored(out, orig, jst)
    _check_leaves(out["leaves"], v, mode)


def _check_leaves(out, v, mode):
    w, h = _f32(out["params"]["w"]), _f32(out["params"]["h"])
    assert str(out["params"]["h"].dtype).endswith("bfloat16")
    h0 = _f32(torch.from_numpy(v["h"]).to(torch.bfloat16))
    if mode == "none":
        np.testing.assert_array_equal(w, v["w"])
        np.testing.assert_array_equal(h, h0)
    elif mode == "sz_abs":
        assert np.abs(w - v["w"]).max() <= EB * (1 + 1e-5)
        assert np.abs(h - h0).max() <= EB * (1 + 1e-5) + np.abs(h0).max() * 2.0**-8
    else:
        nz = v["w"] != 0
        assert np.abs(w[nz] / v["w"][nz] - 1).max() <= EB * 1.05
    np.testing.assert_array_equal(_f32(out["params"]["b"]), v["b"])
    assert int(out["opt"]["step"]) == 5


def test_arena_corruption_detected_in_the_port(tmp_path):
    _, tst, _ = _arena_states()
    mgr = _tmgr(tmp_path, policy=tman.CodecPolicy(**NO_ZSTD))
    mgr.save(1, tst)
    blob = sorted((tmp_path / "step_000000001").glob("arena_*.bin"))[0]
    raw = bytearray(blob.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    blob.write_bytes(bytes(raw))
    with pytest.raises(tman.SnapshotCorruptionError, match="arena_00000"):
        mgr.restore(state_like=tst)


def _states_for(route):
    """(state, policy) whose restore decodes through ``route``: an
    ``arena-szk`` or ``arena-sz`` bucket, or an ``sz_abs`` single leaf."""
    if route == "sz_abs":
        return _tstate(_values()), tman.CodecPolicy(mode="sz_abs", eb=EB, **NO_ZSTD)
    return _arena_states()[1], tman.CodecPolicy(**NO_ZSTD)


def _reseal(step_dir, edit):
    """Edit a manifest and seal it with a fresh digest: a writer whose
    descriptor index disagrees with its payloads, past every CRC."""
    mpath = step_dir / "MANIFEST.json"
    m = json.loads(mpath.read_text())
    edit(m)
    body = {k: v for k, v in m.items() if k != "digest"}
    m["digest"] = tman._crc(json.dumps(body, sort_keys=True).encode())
    mpath.write_text(json.dumps(m))


def _leaf_of(m, route):
    return next(meta for meta in m["leaves"] if meta.get("codec") == route)


@pytest.mark.parametrize("route", ["arena-szk", "arena-sz", "sz_abs", "raw"])
def test_descriptor_disagreeing_with_payload_is_corruption(tmp_path, route):
    """A leaf whose manifest shape does not hold its payload's values is
    corruption: restore names the payload, and restore_latest_valid
    quarantines the step and falls back to the older one."""
    state, policy = _states_for("arena-sz" if route == "raw" else route)
    mgr = _tmgr(tmp_path, policy=policy)
    mgr.save(1, state)
    mgr.save(2, state)

    def grow(m):
        meta = _leaf_of(m, route)
        if route.startswith("arena-"):
            meta["arena"]["shapes"][0][-1] += 1
        else:
            meta["shape"][-1] += 1

    _reseal(tmp_path / "step_000000002", grow)
    with pytest.raises(tman.SnapshotCorruptionError, match="decode") as ei:
        mgr.restore(step=2, state_like=state)
    assert ei.value.step == 2 and ei.value.payload.endswith(".bin")
    _, _, step = mgr.restore_latest_valid(state_like=state)
    assert step == 1 and mgr.available_steps() == [1]
    assert (tmp_path / "quarantine/step_000000002").exists()


@pytest.mark.parametrize("error", [OSError, RuntimeError, torch.OutOfMemoryError])
@pytest.mark.parametrize("route", ["arena-szk", "arena-sz", "sz_abs"])
def test_device_decode_failure_is_not_corruption(tmp_path, monkeypatch, route, error):
    """A decode that fails for a reason of its own (a kernel library that
    cannot be built or loaded, a failed launch, an exhausted device) is no
    corruption: restore_latest_valid raises it unchanged and moves no
    snapshot to the quarantine."""
    from repro_torch.core import sz as tsz
    from repro_torch.kernels import ops as tops

    state, policy = _states_for(route)
    mgr = _tmgr(tmp_path, policy=policy)
    mgr.save(1, state)
    mgr.save(2, state)

    def fail(*args, **kw):
        raise error("the device decode failed")

    target = {"arena-szk": (tops, "sz_decompress_kernel"),
              "arena-sz": (tsz, "lorenzo_reconstruct"),
              "sz_abs": (tsz, "decompress")}[route]
    monkeypatch.setattr(*target, fail)
    with pytest.raises(error, match="device decode failed") as ei:
        mgr.restore_latest_valid(state_like=state)
    assert type(ei.value) is error
    assert mgr.available_steps() == [2, 1]
    assert not (tmp_path / "quarantine").exists()


def test_observatory_sidecar_matches_manifest(tmp_path):
    _, tst, _ = _arena_states()
    fetched = []
    mgr = _tmgr(tmp_path, policy=tman.CodecPolicy(**NO_ZSTD), async_save=True,
                fetch_hook=fetched.append)
    mgr.save(9, tst)
    res = mgr.wait()
    d = tmp_path / "step_000000009"
    doc = tobs.read_obs(d)
    manifest = json.loads((d / "MANIFEST.json").read_text())
    stored = sum(m.get("stored_bytes", 0) + sum(s["stored_bytes"] for s in m.get("shards", []))
                 for m in manifest["leaves"])
    assert doc["total_stored_bytes"] == stored == res.nbytes_stored
    assert doc["total_raw_bytes"] == res.nbytes_raw
    assert fetched == [9, 9]  # each deferred flat bucket resolved on the drain thread
    arena_recs = [r for r in doc["records"] if r["kind"] == "arena"]
    assert {r["codec"] for r in arena_recs} == {ta.CODEC_SZ, ta.CODEC_SZK}
    assert all(r["launches"] == 1 for r in arena_recs)


# ----------------------------------------------------------------- obs ---


def test_obs_copy_behaves_as_reference():
    recs = [{"leaf": 0, "raw_bytes": 400, "stored_bytes": 100},
            {"leaf": 1, "raw_bytes": 40, "stored_bytes": 0}]
    assert tobs.build_doc(3, [dict(r) for r in recs], retries=2) == \
        jobs.build_doc(3, [dict(r) for r in recs], retries=2)
    assert tobs.obs_name(12) == jobs.obs_name(12) and tobs.SCHEMA == jobs.SCHEMA
    regs = [tmetrics.Registry(), jmetrics.Registry()]
    for reg in regs:
        reg.enable()
        reg.counter("c").inc(3)
        reg.gauge("g").set(2.5)
        for i in range(10):
            reg.histogram("h").observe(float(i))
        reg.event("ckpt.retry", step=1)
    snaps = [{k: v for k, v in reg.snapshot().items() if k != "t"} for reg in regs]
    assert snaps[0] == snaps[1]
    assert [{k: v for k, v in e.items() if k != "t"} for e in regs[0].events()] == \
        [{k: v for k, v in e.items() if k != "t"} for e in regs[1].events()]
    assert regs[0].summary() == regs[1].summary()
    tr = ttrace.Tracer()
    assert tr.span("x") is ttrace._NULL_SPAN  # disabled: the shared no-op
    tr.enable()
    with tr.span("x", k=1):
        pass
    (ev,) = tr.events
    assert ev["name"] == "x" and ev["ph"] == "X" and ev["args"] == {"k": 1}


# ------------------------------------- drain-thread and crash contracts ---
# The port's twins of ``tests/test_overlap.py``'s manager cases (DESIGN.md
# §9): errors surface, backpressure bounds the queue, a crash mid-write
# never leaves a partial snapshot.


def _small():
    return {"w": torch.arange(4096, dtype=torch.float32), "step": torch.tensor(1, dtype=torch.int32)}


def test_drain_error_reraised_on_wait_then_on_next_save(tmp_path, monkeypatch):
    broken = {"on": True}
    orig = tman._write_bytes

    def flaky(path, data):
        if broken["on"]:
            raise IOError("disk full")
        orig(path, data)

    monkeypatch.setattr(tman, "_write_bytes", flaky)
    mgr = _tmgr(tmp_path, async_save=True, io_retries=1)
    s = _small()
    done = []
    mgr.save(1, s, on_complete=done.append)
    with pytest.raises(IOError, match="disk full"):
        mgr.wait()
    assert done == [1]  # the slot recycles even when the write fails
    assert mgr.latest_step() is None and not list(tmp_path.glob(".tmp_step_*"))
    mgr.save(2, s)
    mgr._queue.join()  # drain without wait(), which would raise here
    broken["on"] = False
    with pytest.raises(IOError, match="disk full"):
        mgr.save(3, s)
    mgr.save(3, s)  # the error was consumed; the manager keeps working
    assert mgr.wait().step == 3
    out, _ = mgr.restore(state_like=s)
    assert torch.equal(out["w"], s["w"])


def test_bounded_queue_backpressure(tmp_path, monkeypatch):
    gate = threading.Event()
    orig = tman._write_bytes

    def gated(path, data):
        gate.wait(timeout=30)
        orig(path, data)

    monkeypatch.setattr(tman, "_write_bytes", gated)
    mgr = _tmgr(tmp_path, keep_last=5, async_save=True, max_in_flight=1)
    s = _small()
    mgr.save(1, s)  # picked up by the worker, parked on the gate
    mgr.save(2, s)  # fills the queue
    third_done = threading.Event()
    t = threading.Thread(target=lambda: (mgr.save(3, s), third_done.set()), daemon=True)
    t.start()
    assert not third_done.wait(timeout=0.3)  # backpressure: save 3 blocks
    gate.set()
    assert third_done.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive() and mgr.wait().step == 3
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_000000001", "step_000000002", "step_000000003"]


_KILL = """
    import os, signal
    import torch
    from repro_torch.checkpoint import manager as m

    s = {"w": torch.arange(4096, dtype=torch.float32), "step": torch.tensor(1, dtype=torch.int32)}
    mgr = m.CheckpointManager("CKPTDIR", async_save=False, device="cpu")
    mgr.save(1, s)
    orig = m._write_bytes
    def killing(path, data):
        if path.name.endswith("KILLAT"):
            os.kill(os.getpid(), signal.SIGKILL)  # crash mid-finalization
        orig(path, data)
    m._write_bytes = killing
    mgr.save(2, s)
"""


@pytest.mark.parametrize("kill_at", ["leaf_00000.bin", "MANIFEST.json"])
def test_kill_mid_write_never_partial(tmp_path, kill_at):
    """SIGKILL during step 2's write leaves step 1 restorable and step 2
    invisible (manifest last, rename last)."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    script = tmp_path / "sub.py"
    script.write_text(textwrap.dedent(_KILL).replace("CKPTDIR", str(tmp_path / "ckpt"))
                      .replace("KILLAT", kill_at))
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == -9, r.stdout + r.stderr
    ckpt = tmp_path / "ckpt"
    assert sorted(p.name for p in ckpt.glob("step_*")) == ["step_000000001"]
    for d in ckpt.glob(".tmp_step_*"):
        assert not (d / "MANIFEST.json").exists()
    mgr = _tmgr(ckpt)
    assert mgr.latest_step() == 1
    out, _ = mgr.restore(state_like=_small())
    assert torch.equal(out["w"], _small()["w"])

"""Twin tests of the port's in-situ snapshot hook
(``repro_torch.launch.train.build_insitu_hook``) against the JAX package's
(``repro.launch.train.build_insitu_hook``).

One small state tree on a ``("pod", "data", "model")`` mesh of (2, 1, 1)
takes every route: a replicated TILE-aligned field (the K8 kernel bucket),
leaves split on their leading dim (flat arena buckets with the halo), a
replicated flat leaf and a bfloat16 one (a flat bucket with no axis), and a
field split on its second dim (not arena-eligible: the per-leaf path).  The
reference snapshots it on two forced host devices, the port on a two-rank
``gloo`` group (each rank a subprocess), two steps each, with ``overlap``
on (two slots) and off: the step directories hold the same files, byte for
byte, manifest included, and the port says what the reference says about
the ineligible leaf.  With the drain slowed, the port's two snapshots are
in flight together — the drain thread's gathers on the hook's own group
while the caller's thread issues the next snapshot's collectives — and
both finish.
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
EB = 1e-2

CASES = """
import numpy as np
EB = 1e-2
AXES = ("pod", "data", "model")
SPECS = {"tile": (), "vel": ("pod",), "hacc": ("pod",), "rep": (), "bf": (),
         "temp": (None, "pod")}

def values():
    rng = np.random.default_rng(5)
    return {"tile": (rng.normal(size=(8, 64, 128)) * 3).astype(np.float32),
            "vel": (rng.normal(size=(32, 64)) * 10).astype(np.float32),
            "hacc": rng.random(4096).astype(np.float32) * 64,
            "rep": rng.normal(size=(1000,)).astype(np.float32),
            "bf": rng.normal(size=(64, 64)).astype(np.float32),  # stored as bfloat16
            "temp": (rng.normal(size=(8, 128, 128)) * 5).astype(np.float32)}
"""

REFERENCE = """
import contextlib, io, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as PS
from repro.launch.train import build_insitu_hook
from cases import EB, AXES, SPECS, values

root = sys.argv[1]
mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(2, 1, 1), AXES)
state = {}
for k, x in values().items():
    a = jnp.asarray(x).astype(jnp.bfloat16) if k == "bf" else jnp.asarray(x)
    state[k] = jax.device_put(a, NamedSharding(mesh, PS(*SPECS[k])))
for overlap in (True, False):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hook = build_insitu_hook(mesh, os.path.join(root, f"ref_{overlap}"), EB, min_bytes=1024,
                                 overlap=overlap, slots=2)
        hook(1, state)
        hook(2, state)
        hook.wait()
    open(os.path.join(root, f"ref_{overlap}.log"), "w").write(buf.getvalue())
"""

RANK = """
import contextlib, io, os, pickle, sys, time
import numpy as np, torch, torch.distributed as dist
rank, world, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
from torch.distributed.device_mesh import DeviceMesh
from repro_torch import kernels
from repro_torch.dist import insitu
from repro_torch.dist.sharding import NamedSharding, place
from repro_torch.launch.train import build_insitu_hook
from cases import EB, AXES, SPECS, values

mesh = DeviceMesh("cpu", torch.arange(world).reshape(world, 1, 1), mesh_dim_names=AXES)
state = {}
for k, x in values().items():
    t = torch.from_numpy(x).to(torch.bfloat16) if k == "bf" else torch.from_numpy(x)
    state[k] = place(t, NamedSharding(mesh, SPECS[k]))
res = {}
for overlap in (True, False):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hook = build_insitu_hook(mesh, os.path.join(root, f"port_{overlap}"), EB,
                                 min_bytes=1024, overlap=overlap, slots=2)
        if overlap:  # a slow drain: the second snapshot starts while the first drains
            hook.manager._fetch_hook = lambda step: time.sleep(0.5)
        kernels.reset_launch_counts()
        insitu.reset_sent_bytes()
        hook(1, state)
        hook(2, state)
        res[("in_flight", overlap)] = hook.slots.in_flight if hook.slots else None
        hook.wait()
        res[("after", overlap)] = hook.slots.in_flight if hook.slots else None
        res[("sent", overlap)] = dict(insitu.sent_bytes)
        res[("launches", overlap)] = sum(kernels.launch_counts().values())
    res[("log", overlap)] = buf.getvalue()
    dist.barrier()
pickle.dump(res, open(os.path.join(root, f"rank{rank}.pkl"), "wb"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's hook on two forced host devices and the port's on
    a two-rank gloo group, started together."""
    d = tmp_path_factory.mktemp("insitu_hook")
    (d / "cases.py").write_text(CASES)
    (d / "reference.py").write_text(textwrap.dedent(REFERENCE))
    (d / "rank.py").write_text(textwrap.dedent(RANK))
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{d}", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(d / "reference.py"), str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    procs += [subprocess.Popen([sys.executable, str(d / "rank.py"), str(r), "2", str(port),
                                str(d)], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append((p.returncode, out.decode(errors="replace")))
    for rc, log in logs:
        assert rc == 0, log[-4000:]
    return d, [pickle.load(open(d / f"rank{r}.pkl", "rb")) for r in range(2)]


def _files(d: Path) -> dict:
    return {f"{s.name}/{p.name}": p.read_bytes() for s in sorted(d.glob("step_*"))
            for p in sorted(s.iterdir()) if not p.name.startswith("obs_")}


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_hook_writes_the_reference_files(runs, overlap):
    """Both steps' payload files and manifests, byte for byte the
    reference's: one K8 bucket, the flat buckets (split ones gathered from
    both ranks), the per-leaf stream of the field split on its second dim."""
    d, _ = runs
    ref, got = _files(d / f"ref_{overlap}"), _files(d / f"port_{overlap}")
    assert sorted(got) == sorted(ref)
    assert len([n for n in ref if n.endswith("MANIFEST.json")]) == 2
    assert any("arena_" in n for n in ref) and any("leaf_" in n for n in ref)
    for name in ref:
        assert got[name] == ref[name], name


def test_overlapped_and_synchronous_snapshots_agree(runs):
    d, _ = runs
    assert _files(d / "port_True") == _files(d / "port_False")


def test_ineligible_leaf_takes_the_per_leaf_route_with_the_reference_message(runs):
    d, ranks = runs
    want = [ln for ln in (d / "ref_True.log").read_text().splitlines()
            if "not arena-eligible" in ln]
    assert len(want) == 1 and "['temp']" in want[0]
    for res in ranks:
        got = [ln for ln in res[("log", True)].splitlines() if "not arena-eligible" in ln]
        assert got == want


def test_two_snapshots_in_flight_finish(runs):
    """With ``slots=2`` and a slow drain both snapshots are in flight when
    the second call returns, and both drain (on every rank)."""
    d, ranks = runs
    for res in ranks:
        assert res[("in_flight", True)] == 2
        assert res[("after", True)] == 0
    assert sorted(p.name for p in (d / "port_True").glob("step_*")) == \
        ["step_000000001", "step_000000002"]


def test_ranks_send_no_raw_leaf(runs):
    """The CPU launches no kernel; the second rank sends faces, bounds and
    compressed bytes, less than its share of the raw split leaves; the
    replicated buckets cost it nothing."""
    _, ranks = runs
    for res in ranks:
        assert res[("launches", True)] == 0
    sent = ranks[1][("sent", True)]
    raw_split = 4 * (32 * 64 + 4096 + 8 * 128 * 128) // 2
    assert 0 < sum(sent.values()) < raw_split
    assert sent["all_gather"] == 0

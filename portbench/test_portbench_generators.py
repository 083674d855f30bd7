"""The on-device generators at small sizes on the CPU: deterministic in the
seed, Table II ranges, shapes, and the particles' rank-major order."""

import pytest
import torch

from portbench import traffic
from portbench.generators import hacc, nyx


def _nyx(seed, grid=32):
    cfg = {**traffic.load("configs", "nyx512"), "grid": grid}
    return cfg, dict(nyx.fields(cfg, seed, "cpu"))


def _hacc(seed, grid=24):
    cfg = {**traffic.load("configs", "hacc1024"), "grid": grid, "particles": grid ** 3 - 77}
    return cfg, dict(hacc.fields(cfg, seed, "cpu"))


@pytest.mark.parametrize("make", [_nyx, _hacc], ids=["nyx", "hacc"])
def test_same_seed_same_fields_other_seed_other_fields(make):
    big = 2**31 + 12345  # seeds may pass 32 signed bits
    _, a = make(big)
    _, b = make(big)
    _, c = make(big + 1)
    assert list(a) == list(b) == list(c)
    for name in a:
        assert torch.equal(a[name], b[name]), name
        assert not torch.equal(a[name], c[name]), name


def test_nyx_shapes_and_table_ii_ranges():
    cfg, f = _nyx(7)
    assert list(f) == cfg["fields"]
    for name, x in f.items():
        lo, hi = cfg["ranges"][name]
        assert x.shape == (32, 32, 32) and x.dtype == torch.float32 and x.is_contiguous()
        assert float(x.min()) >= lo and float(x.max()) <= hi, name
        assert bool(torch.isfinite(x).all())
    for name in cfg["log_normal_sigma"]:  # each density reaches the top of its range
        assert float(f[name].max()) == pytest.approx(cfg["ranges"][name][1], rel=1e-6)
    for name in ("vx", "vy", "vz"):
        assert float(f[name].abs().max()) == pytest.approx(0.8e8, rel=1e-6)


def test_hacc_shapes_ranges_and_rank_major_order():
    cfg, f = _hacc(3)
    n = cfg["particles"]
    assert list(f) == cfg["fields"]
    box, vmax = cfg["box_mpc_h"], cfg["velocity_max"]
    for name, x in f.items():
        assert x.shape == (n,) and x.dtype == torch.float32, name
        lo, hi = (0.0, box) if name in ("x", "y", "z") else (-vmax, vmax)
        assert float(x.min()) >= lo and float(x.max()) <= hi, name
    nx, ny, nz = cfg["rank_grid"]
    rank = ((torch.floor(f["x"] / (box / nx)) * ny + torch.floor(f["y"] / (box / ny))) * nz
            + torch.floor(f["z"] / (box / nz)))
    assert bool((rank[1:] >= rank[:-1]).all())  # GenericIO's rank-major order


def test_halo_masses_hold_exactly_the_halo_particles():
    gen = torch.Generator().manual_seed(5)
    m = hacc._halo_masses(100_000, 20.0, 3000.0, -2.0, gen, "cpu")
    assert int(m.sum()) == 100_000 and bool((m[:-1] >= 20).all()) and int(m[-1]) >= 0


def test_boxes_cut_a_field_into_contiguous_cubes_in_z_major_order():
    x = torch.arange(4 * 4 * 4, dtype=torch.float32).reshape(4, 4, 4)
    parts = traffic.boxes(x, 2)
    assert len(parts) == 8 and all(p.is_contiguous() and p.shape == (2, 2, 2) for p in parts)
    assert torch.equal(parts[1], x[:2, :2, 2:]) and torch.equal(parts[7], x[2:, 2:, 2:])
    assert [p is x for p in traffic.boxes(x, 3)] == [True]
    assert len(traffic.boxes(x[0], 2)) == 1


def test_boxes_of_the_nyx_shape_halve_z_and_y_and_keep_x_whole():
    x = torch.arange(8 * 8 * 8, dtype=torch.float32).reshape(8, 8, 8)
    parts = traffic.boxes(x, [4, 4, 8])
    assert len(parts) == 4 and all(p.is_contiguous() and p.shape == (4, 4, 8) for p in parts)
    assert torch.equal(parts[1], x[:4, 4:, :]) and torch.equal(parts[2], x[4:, :4, :])
    assert [p is x for p in traffic.boxes(x, [3, 4, 8])] == [True]

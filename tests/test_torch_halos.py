"""Twin tests of the port's FoF halo finder (``repro_torch.analysis.halos``)
against the JAX package's (``repro.analysis.halos``) on the reference
tests' snapshot, ``hacc_particles(grid=32)``.

Both run FoF on the host with numpy, so every output is held exactly: the
catalog (labels, sizes, count), the mass function, the count ratio, the
gate, the most connected and most bound particles, and the perturbation
cases of ``tests/test_analysis.py::TestHalos``.
"""

import numpy as np
import pytest

from repro.analysis import halos as jhalos
from repro_torch.analysis import halos as thalos
from repro_torch.data import cosmo

PERTURB = {"small": 0.005, "large": 0.4}  # TestHalos' uniform position noise


@pytest.fixture(scope="module")
def snap():
    return cosmo.hacc_particles(grid=32)


@pytest.fixture(scope="module")
def catalogs(snap):
    """(reference, port) catalogs of the snapshot and of its perturbed
    copies, FoF run once per package and input."""
    pos = snap.positions()
    inputs = {"orig": pos}
    for name, amp in PERTURB.items():
        rng = np.random.default_rng(1)
        inputs[name] = (pos + rng.uniform(-amp, amp, pos.shape)) % snap.box
    return {k: (jhalos.fof_halos(p, snap.box), thalos.fof_halos(p, snap.box), p)
            for k, p in inputs.items()}


def _same_catalog(j, t):
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.sizes, j.sizes)
    assert t.labels.dtype == j.labels.dtype and t.sizes.dtype == j.sizes.dtype
    assert (t.n_halos, t.linking_length, t.min_members) == (j.n_halos, j.linking_length,
                                                            j.min_members)


@pytest.mark.parametrize("case", ["orig", *PERTURB])
def test_catalog_equals_reference(catalogs, case):
    j, t, _ = catalogs[case]
    _same_catalog(j, t)


def test_planted_halos_found(catalogs):
    _, t, _ = catalogs["orig"]
    assert t.n_halos > 20 and t.sizes.max() > 100


@pytest.mark.parametrize("n_bins", [6, 12])
def test_mass_function_equals_reference(catalogs, n_bins):
    j, t, _ = catalogs["orig"]
    for a, b in zip(thalos.mass_function(t, n_bins=n_bins), jhalos.mass_function(j, n_bins=n_bins)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(PERTURB))
def test_count_ratio_and_gate_equal_reference(catalogs, case):
    jo, to, _ = catalogs["orig"]
    jr, tr, _ = catalogs[case]
    for a, b in zip(thalos.halo_count_ratio(to, tr), jhalos.halo_count_ratio(jo, jr)):
        np.testing.assert_array_equal(a, b)
    assert thalos.halo_gate(to, tr) == jhalos.halo_gate(jo, jr)


def test_self_ratio_one(catalogs):
    _, t, _ = catalogs["orig"]
    _, ratio = thalos.halo_count_ratio(t, t)
    np.testing.assert_allclose(ratio, 1.0)


def test_small_perturbation_keeps_halos(catalogs):
    """Paper Fig. 6: eb=0.005 on positions preserves the halo catalog."""
    ok, dev = thalos.halo_gate(catalogs["orig"][1], catalogs["small"][1])
    assert ok, f"dev={dev}"


def test_large_perturbation_breaks_small_halos(catalogs):
    _, dev = thalos.halo_gate(catalogs["orig"][1], catalogs["large"][1])
    assert dev > 0.01


@pytest.mark.parametrize("rank", [0, 1, 5])
def test_mcp_and_mbp_equal_reference(catalogs, snap, rank):
    """Most connected and most bound particle of the ``rank``-th largest
    halo, on the snapshot's catalog."""
    j, t, pos = catalogs["orig"]
    hid = int(np.argsort(-np.bincount(t.labels[t.labels >= 0]))[rank])
    assert thalos.most_connected_particle(pos, t, snap.box, hid) == \
        jhalos.most_connected_particle(pos, j, snap.box, hid)
    assert thalos.most_bound_particle(pos, t, snap.box, hid) == \
        jhalos.most_bound_particle(pos, j, snap.box, hid)


def test_union_find_two_clusters():
    rng = np.random.default_rng(0)
    pos = np.concatenate([rng.normal(scale=0.1, size=(50, 3)) + 10,
                          rng.normal(scale=0.1, size=(60, 3)) + 50])
    cat = thalos.fof_halos(pos, box=100.0, linking_length=1.0, min_members=10)
    _same_catalog(jhalos.fof_halos(pos, box=100.0, linking_length=1.0, min_members=10), cat)
    assert cat.n_halos == 2 and sorted(cat.sizes.tolist()) == [50, 60]


def test_mcp_and_mbp_at_blob_centre():
    rng = np.random.default_rng(2)
    blob = rng.normal(scale=0.5, size=(80, 3)) + 30
    blob[0] = 30.0  # dead centre: most connected and most bound
    cat = thalos.fof_halos(blob, box=100.0, linking_length=2.0, min_members=10)
    hid = cat.labels[0]
    assert hid >= 0
    centre = np.linalg.norm(blob - 30.0, axis=1)
    assert centre[thalos.most_connected_particle(blob, cat, 100.0, hid)] < np.median(centre)
    assert centre[thalos.most_bound_particle(blob, cat, 100.0, hid)] < np.median(centre)


def test_periodic_wraparound():
    rng = np.random.default_rng(3)
    pos = rng.normal(scale=0.3, size=(40, 3)) % 100.0  # a halo across the box edge
    cat = thalos.fof_halos(pos, box=100.0, linking_length=1.5, min_members=10)
    _same_catalog(jhalos.fof_halos(pos, box=100.0, linking_length=1.5, min_members=10), cat)
    assert cat.n_halos == 1 and cat.sizes[0] == 40

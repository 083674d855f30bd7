"""Twin tests of the port's optimiser and schedules (``repro_torch.optim``)
against the JAX package's (``repro.optim``), on the CPU.

* ``cosine`` and ``wsd`` at every step of short runs equal the reference's
  within 4 ulps of float32 at the peak rate (``4 * 2**-23 * peak_lr``
  absolute): the two packages share every operation but the reference's
  ``cos`` / ``power``, which are XLA's polynomials against the C library's
  here; near the end of the cosine, ``1 + cos`` cancels, so an ulp of the
  cosine shows as a few ulps of the small rate (3 ulps seen).  ``wsd`` and
  the warmup are equal bit for bit.
* ``global_norm`` equals the reference's within 2 ulps: XLA and PyTorch
  sum a leaf's squares in other orders.
* ``apply_updates`` (eager, three steps, clipped or not) agrees with the
  reference's eager ``apply_updates`` within ``rtol`` 1e-6 (8 ulps), ``atol`` 1e-8, in
  params, ``m`` and ``v``: the port divides by tensors where the reference
  divides, so no reciprocal multiply creeps in, and the bias corrections
  are equal bit for bit; with the clip active the scale carries the norm's
  ulp, and without it an element in a few thousand still differs by an ulp
  (XLA's CPU kernels against PyTorch's).
* The port's twins of ``tests/test_dist.py::TestSchedules``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch.optim import adamw, schedules

RUNS = [dict(peak_lr=3e-4, warmup_steps=5, total_steps=40),
        dict(peak_lr=1.0, warmup_steps=10, total_steps=100),
        dict(peak_lr=3e-4, warmup_steps=1, total_steps=3),
        dict(peak_lr=1e-3, warmup_steps=0, total_steps=17)]


@pytest.mark.parametrize("name", ["cosine", "wsd"])
@pytest.mark.parametrize("run", range(len(RUNS)))
def test_schedule_equals_reference_at_every_step(name, run):
    kw = RUNS[run]
    steps = range(kw["total_steps"] + 3)
    want = np.array([float(getattr(jsched, name)(s, **kw)) for s in steps], np.float32)
    got = np.array([float(getattr(schedules, name)(s, **kw)) for s in steps], np.float32)
    # the optimiser's int32 step counter gives the same rates
    got_t = np.array([float(getattr(schedules, name)(torch.tensor(s, dtype=torch.int32), **kw))
                      for s in steps], np.float32)
    np.testing.assert_array_equal(got, got_t)
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0**-23 * kw["peak_lr"])
    if name == "wsd":
        np.testing.assert_array_equal(got, want)
    warm = [s for s in steps if s < kw["warmup_steps"]]
    np.testing.assert_array_equal(got[warm], want[warm])


class TestSchedules:
    """The port's twins of ``tests/test_dist.py::TestSchedules``."""

    def test_cosine_shape(self):
        lr0 = float(schedules.cosine(0, peak_lr=1.0, warmup_steps=10, total_steps=100))
        lrp = float(schedules.cosine(10, peak_lr=1.0, warmup_steps=10, total_steps=100))
        lre = float(schedules.cosine(100, peak_lr=1.0, warmup_steps=10, total_steps=100))
        assert lr0 == 0.0 and lrp == pytest.approx(1.0) and lre == pytest.approx(0.1, rel=0.01)

    def test_wsd_plateau_then_decay(self):
        kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100)
        assert float(schedules.wsd(50, **kw)) == pytest.approx(1.0)
        assert float(schedules.wsd(89, **kw)) == pytest.approx(1.0)
        assert float(schedules.wsd(100, **kw)) == pytest.approx(0.01, rel=0.05)


def _tree(rng, scale=1.0):
    return {"a": (rng.normal(size=(64, 33)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(7,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(3, 5, 2)) * scale).astype(np.float32)}}


def _torch(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("clip", [1.0, None, 1e3], ids=["clipped", "no-clip", "loose-clip"])
def test_apply_updates_equals_reference(clip):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 3.0) for _ in range(3)]
    jcfg = jadamw.AdamWConfig(clip_norm=clip)
    tcfg = adamw.AdamWConfig(clip_norm=clip)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.init_state(jp)
    tp = _torch(params)
    ts = adamw.init_state(tp)
    assert ts["step"].dtype == torch.int32 and ts["m"]["a"].dtype == torch.float32
    for i, g in enumerate(grads):
        lr = 1e-2 / (i + 1)
        jp, js, jm = jadamw.apply_updates(jp, js, jax.tree.map(jnp.asarray, g),
                                          jnp.float32(lr), jcfg)
        tp2, ts, tm = adamw.apply_updates(tp, ts, _torch(g), torch.tensor(lr), tcfg)
        assert tp2 is tp  # written in place
        np.testing.assert_allclose(tm["grad_norm"].numpy(), np.asarray(jm["grad_norm"]),
                                   rtol=2 * 2.0**-23)
    assert int(ts["step"]) == int(js["step"]) == 3
    for want, got in zip(_leaves(jp) + _leaves(js["m"]) + _leaves(js["v"]),
                         [x.numpy() for x in jax.tree.leaves(tp)]
                         + [x.numpy() for x in jax.tree.leaves(ts["m"])]
                         + [x.numpy() for x in jax.tree.leaves(ts["v"])]):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_global_norm_equals_reference(seed):
    tree = _tree(np.random.default_rng(seed), 7.0)
    np.testing.assert_allclose(adamw.global_norm(_torch(tree)).numpy(),
                               np.asarray(jadamw.global_norm(jax.tree.map(jnp.asarray, tree))),
                               rtol=2 * 2.0**-23)

"""Twins of ``tests/test_arch_smoke.py``'s three per-architecture tests for
the families the port added beside the dense one: the MoE, RWKV6, Hymba
and enc-dec models at SMOKE size, with one parameter tree drawn by the
reference and carried across with ``params_from_jax``.

* forward logits at ``dtype="float32"`` within rtol 1e-4 / atol 5e-5
  (logits of order 1; whisper's encoder attention sums 32 frames);
* the loss within rtol 1e-5, and every gradient leaf against ``jax.grad``
  within 2e-3 of that leaf's largest magnitude (per-layer checkpointing on
  both sides; routing, scans and softmaxes sum in other orders);
* greedy decode over cached steps against the full forward, in the
  configs' own bfloat16, within the reference test's tolerance (rtol 0.15,
  atol 0.35), and the port's last decode logits against the reference's
  decode within rtol / atol 0.1 (bf16 products summed in other orders over
  16 steps and, for whisper, a bf16 encoder).  Hymba is skipped for the reference's
  reason (a cold decode cache lacks the meta tokens); whisper decodes with
  its encoder memory built by ``init_cache(params=, frames=)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import spec as jspec
from repro_torch.configs import registry as treg
from repro_torch.models import layers as TL
from repro_torch.models.interop import params_from_jax
from repro_torch.models.spec import spec_items

ARCHS = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b", "hymba-1.5b",
         "whisper-base")
B, S = 2, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _build(arch, dtype):
    jcfg = jreg.get_config(arch, smoke=True).scaled(dtype=dtype)
    jm = jreg.build_model(jcfg)
    jp = jspec.init_params(jm.specs(), jax.random.key(0), jnp.float32)
    tm = treg.build_model(treg.get_config(arch, smoke=True).scaled(dtype=dtype), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.specs(), "cpu",
                         torch.float32 if dtype == "float32" else torch.bfloat16)
    return jm, jp, tm, tp


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    frames = (rng.normal(size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
              if cfg.family == "audio" else None)
    return tokens, labels, frames


def _extras(frames, jdt=jnp.float32, tdt=torch.float32):
    if frames is None:
        return (), ()
    return (jnp.asarray(frames).astype(jdt),), (_t(frames).to(tdt),)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jm, jp, tm, tp = _build(arch, "float32")
    tokens, _, frames = _inputs(jm.cfg, 1)
    je, te = _extras(frames)
    want = np.asarray(jm.forward(jp, jnp.asarray(tokens), *je))
    with torch.no_grad():
        got = tm.forward(tp, _t(tokens), *te).numpy()
    assert got.shape == (B, S, jm.cfg.padded_vocab)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_grad_matches_reference(arch):
    jm, jp, tm, tp = _build(arch, "float32")
    tokens, labels, frames = _inputs(jm.cfg, 2)
    je, te = _extras(frames)
    want_loss, want = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(tokens), jnp.asarray(labels), *je))(jp)
    leaves = [(path, _leaf(tp, path)) for path, _ in spec_items(tm.specs())]
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    loss = tm.loss(tp, _t(tokens), _t(labels), *te)
    loss.backward()
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(loss) < np.log(jm.cfg.vocab) * 3
    for path, leaf in leaves:
        w = np.asarray(_leaf(want, path))
        g = leaf.grad.numpy()
        assert np.isfinite(g).all(), path
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * max(np.abs(w).max(), 1e-12),
                                   err_msg="/".join(path))
    assert any(float(leaf.grad.abs().max()) > 0 for _, leaf in leaves)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_forward(arch):
    cfg = jreg.get_config(arch, smoke=True)
    if cfg.family == "hybrid":
        pytest.skip("hymba forward prepends learnable meta tokens; a cold decode cache lacks "
                    "them, so logits differ by design (tests/test_arch_smoke.py:69-72)")
    jm, jp, tm, tp = _build(arch, "bfloat16")
    tokens, _, frames = _inputs(cfg, 3)
    je, te = _extras(frames, jnp.bfloat16, torch.bfloat16)
    with torch.no_grad():
        full = tm.forward(tp, _t(tokens), *te)
    jc, tc = JL.KVCodecConfig("none"), TL.KVCodecConfig("none")
    if cfg.family == "audio":
        jcache = jm.init_cache(B, S + 4, jc, params=jp, frames=je[0])
        cache = tm.init_cache(B, S + 4, tc, params=tp, frames=te[0])
    else:
        jcache, cache = jm.init_cache(B, S + 4, jc), tm.init_cache(B, S + 4, tc)
    for t in range(S):
        logits, cache = tm.decode_step(tp, cache, _t(tokens[:, t]),
                                       torch.tensor(t, dtype=torch.int32), tc)
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(tokens[:, t]), jnp.int32(t), jc)
    np.testing.assert_allclose(logits.float().numpy(), full[:, -1].float().numpy(),
                               rtol=0.15, atol=0.35)
    np.testing.assert_allclose(logits.float().numpy(), np.asarray(jlog, np.float32),
                               rtol=0.1, atol=0.1)

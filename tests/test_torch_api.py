"""The slices as a whole: ``get_compressor("tpu-sz")`` and
``get_compressor("tpu-zfp")`` of the port against the JAX package's on the
six Nyx fields (and, for ZFP, on HACC 1-D and 2-D input), payload
interchange both ways, and the size limit.

Both sides run the same backend on the CPU (the JAX kernel backend in Pallas
interpret mode, the port's through its plain versions): payload streams,
``nbytes`` and reconstructions are equal bit for bit, and so are the
Foresight checks computed on them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import metrics as jmetrics
from repro.analysis import spectrum as jspectrum
from repro.core import bitpack as jbp
from repro.core import sz as jsz
from repro.core import transforms as jtransforms
from repro.core import zfp as jzfp
from repro.core.api import CompressionResult as JaxResult
from repro.core.api import get_compressor as jax_compressor
from repro.data import cosmo as jcosmo
from repro_torch.analysis import metrics as tmetrics
from repro_torch.analysis import spectrum as tspectrum
from repro_torch.core import bitpack as tbp
from repro_torch.core import interop
from repro_torch.core import sz as tsz
from repro_torch.core import transforms as ttransforms
from repro_torch.core import zfp as tzfp
from repro_torch.core.api import available
from repro_torch.core.api import get_compressor as torch_compressor
from repro_torch.data import cosmo as tcosmo

N = 64
FIELDS = tcosmo.NYX_FIELDS


def _fields():
    return tcosmo.nyx_fields(n=N)


def _eb(x: np.ndarray) -> float:
    return 1e-4 * float(x.max() - x.min())


# ---- the JAX side of a payload record (the port's side is core.interop) ----


def _jax_packed_record(p) -> dict:
    return {"words": np.asarray(p.words), "widths": np.asarray(p.widths),
            "total_bits": int(p.total_bits), "n": int(p.n)}


def _jax_to_record(r: JaxResult) -> dict:
    p = r.payload
    common = {"signs": None if p["signs"] is None else np.asarray(p["signs"]),
              "shape": tuple(p["shape"]), "orig_len": int(p["orig_len"]),
              "was_1d": bool(p["was_1d"])}
    if p.get("kernel"):
        payload = {"kernel": True, "kpacked": _jax_packed_record(p["kpacked"]),
                   "padded_shape": tuple(p["padded_shape"]), "eb_i": np.float32(p["eb_i"]),
                   **common}
    else:
        payload = {"parts": [{"packed": _jax_packed_record(c.packed), "eb": np.float32(c.eb),
                              "shape": tuple(c.shape), "block_size": c.block_size}
                             for c in p["parts"]], **common}
    return {"payload": payload, "nbytes": r.nbytes, "raw_nbytes": r.raw_nbytes,
            "meta": dict(r.meta)}


def _jax_packed(rec: dict) -> jbp.PackedCodes:
    return jbp.PackedCodes(jnp.asarray(rec["words"], jnp.uint32), jnp.asarray(rec["widths"], jnp.uint8),
                           jnp.int32(rec["total_bits"]), int(rec["n"]))


def _record_to_jax(rec: dict) -> JaxResult:
    p = rec["payload"]
    common = {"signs": None if p["signs"] is None else jnp.asarray(p["signs"]),
              "shape": tuple(p["shape"]), "orig_len": p["orig_len"], "was_1d": p["was_1d"]}
    if p.get("kernel"):
        payload = {"kernel": True, "kpacked": _jax_packed(p["kpacked"]),
                   "padded_shape": tuple(p["padded_shape"]), "eb_i": jnp.float32(p["eb_i"]),
                   **common}
    else:
        payload = {"parts": [jsz.SZCompressed(_jax_packed(c["packed"]), jnp.float32(c["eb"]),
                                              tuple(c["shape"]), c["block_size"])
                             for c in p["parts"]], **common}
    return JaxResult(payload, rec["nbytes"], rec["raw_nbytes"], dict(rec["meta"]))


def _assert_same_record(a: dict, b: dict):
    """Two records hold the same payload (streams bit for bit)."""
    assert a["nbytes"] == b["nbytes"] and a["raw_nbytes"] == b["raw_nbytes"]
    assert a["meta"] == b["meta"]
    pa, pb = a["payload"], b["payload"]
    assert pa.keys() == pb.keys()
    packs = ([(pa["kpacked"], pb["kpacked"])] if pa.get("kernel")
             else [(ca["packed"], cb["packed"]) for ca, cb in zip(pa["parts"], pb["parts"])])
    for x, y in packs:
        np.testing.assert_array_equal(x["words"], y["words"])
        np.testing.assert_array_equal(x["widths"], y["widths"])
        assert x["total_bits"] == y["total_bits"] and x["n"] == y["n"]
    if pa.get("kernel"):
        assert np.float32(pa["eb_i"]).view(np.uint32) == np.float32(pb["eb_i"]).view(np.uint32)
        assert tuple(pa["padded_shape"]) == tuple(pb["padded_shape"])
    else:
        for ca, cb in zip(pa["parts"], pb["parts"]):
            assert np.float32(ca["eb"]).view(np.uint32) == np.float32(cb["eb"]).view(np.uint32)
            assert ca["shape"] == cb["shape"] and ca["block_size"] == cb["block_size"]


# ------------------------------------------------------------------ tests --


def test_nyx_fields_copy_matches_reference():
    tf, jf = _fields(), jcosmo.nyx_fields(n=N)
    assert list(tf) == list(jf) == list(FIELDS)
    for name in FIELDS:
        np.testing.assert_array_equal(tf[name], jf[name])
    np.testing.assert_array_equal(tcosmo.hacc_particles(grid=8).fields["vx"],
                                  jcosmo.hacc_particles(grid=8).fields["vx"])


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("backend", ["core", "kernel"])
def test_slice_matches_reference_on_nyx(backend, field):
    """The main path: a Nyx field through both registries' same backend
    gives the same payload, size and reconstruction, hence the same
    distortion metrics and power-spectrum gate."""
    x = _fields()[field]
    eb = _eb(x)
    jc = jax_compressor("tpu-sz", backend=backend)
    tc = torch_compressor("tpu-sz", backend=backend, device="cpu")
    rj, rt = jc.compress(jnp.asarray(x), eb=eb), tc.compress(x, eb=eb)
    _assert_same_record(_jax_to_record(rj), interop.to_record(rt))
    assert (rt.nbytes, rt.raw_nbytes, rt.ratio, rt.bitrate) == (rj.nbytes, rj.raw_nbytes,
                                                                rj.ratio, rj.bitrate)
    xj, xt = np.asarray(jc.decompress(rj)), tc.decompress(rt).numpy()
    np.testing.assert_array_equal(xj.view(np.uint32), xt.view(np.uint32))
    assert np.abs(xt - x).max() <= eb * (1 + 1e-5)
    assert dataclasses.asdict(tmetrics.distortion(x, xt)) == dataclasses.asdict(
        jmetrics.distortion(x, xj))
    assert tspectrum.pk_gate(x, xt) == jspectrum.pk_gate(x, xj)


@pytest.mark.parametrize("backend", ["core", "kernel"])
@pytest.mark.parametrize("mode", ["abs", "pw_rel"])
def test_cross_decode_both_ways(backend, mode):
    """A JAX payload decodes in the port and a port payload in the JAX
    package, through numpy records (core.interop)."""
    x = _fields()["temperature"] if mode == "abs" else _fields()["vx"]
    x = x[:, :40, :72]  # ragged: the kernel layout pads it
    kw = {"eb": _eb(x)} if mode == "abs" else {"pw_rel": 1e-2}
    jc = jax_compressor("tpu-sz", backend=backend)
    tc = torch_compressor("tpu-sz", backend=backend, device="cpu")
    rj, rt = jc.compress(jnp.asarray(x), **kw), tc.compress(x, **kw)

    # each side's decode of the other's payload equals the payload's own
    # decoder; after the log transform torch.exp and XLA's exp may differ by
    # one ulp, so PW_REL is compared within one ulp and held to its bound
    def same(a, b):
        if mode == "abs":
            np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
        else:
            np.testing.assert_array_max_ulp(a, b, maxulp=1)

    from_jax = tc.decompress(interop.from_record(_jax_to_record(rj), device="cpu")).numpy()
    same(from_jax, np.asarray(jc.decompress(rj)))
    to_jax = np.asarray(jc.decompress(_record_to_jax(interop.to_record(rt))))
    same(to_jax, tc.decompress(rt).numpy())
    if mode == "pw_rel":
        nz = x != 0
        for xr in (from_jax, to_jax):
            assert np.abs(xr[nz] / x[nz] - 1.0).max() <= 1e-2 * (1 + 0.05)
    _assert_same_record(interop.to_record(interop.from_record(interop.to_record(rt),
                                                              device="cpu")),
                        interop.to_record(rt))
    if mode == "abs":
        _assert_same_record(_jax_to_record(rj), interop.to_record(rt))


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("backend", ["core", "kernel"])
def test_pw_rel_streams_match_reference_on_nyx(backend, field):
    """PW_REL 1e-2 on a Nyx field: the payload (sign channel, stream, bound)
    is the reference's word for word.  The port's stated exception to
    stream identity is that ``torch.log``/``torch.exp`` may differ from
    XLA's by one ulp, which would change a stream only where a quantization
    code lies on a rounding border; on these fields none does.  The
    reconstructions are held within one ulp and to the bound."""
    x = _fields()[field]
    jc = jax_compressor("tpu-sz", backend=backend)
    tc = torch_compressor("tpu-sz", backend=backend, device="cpu")
    rj, rt = jc.compress(jnp.asarray(x), pw_rel=1e-2), tc.compress(x, pw_rel=1e-2)
    rec_j, rec_t = _jax_to_record(rj), interop.to_record(rt)
    _assert_same_record(rec_j, rec_t)
    np.testing.assert_array_equal(rec_j["payload"]["signs"], rec_t["payload"]["signs"])
    xj, xt = np.asarray(jc.decompress(rj)), tc.decompress(rt).numpy()
    np.testing.assert_array_max_ulp(xj, xt, maxulp=1)
    nz = x != 0
    assert np.abs(xt[nz] / x[nz] - 1.0).max() <= 1e-2 * (1 + 0.05)
    assert (xt[~nz] == 0).all()


def test_payload_rebuild_defaults_to_cuda(monkeypatch):
    """Rebuilding a payload without a device means CUDA: with no CUDA device
    it raises instead of landing on the CPU."""
    x = _fields()["vx"][:8, :16, :16]
    rec = interop.to_record(torch_compressor("tpu-sz", backend="core", device="cpu")
                            .compress(x, eb=_eb(x)))
    part = rec["payload"]["parts"][0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.from_record(rec)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbp.from_storage(part["packed"]["words"], part["packed"]["widths"], part["packed"]["n"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tsz.from_stream(part["packed"]["words"], part["packed"]["widths"], part["packed"]["n"],
                        part["eb"], part["shape"])
    assert interop.from_record(rec, device="cpu").payload["parts"][0].eb.device.type == "cpu"


@pytest.mark.parametrize("backend", ["core", "kernel"])
def test_decompress_refuses_payload_on_another_device(backend):
    """A compressor decodes only payloads on its own device: one on another
    device is refused, never decoded where it happens to lie."""
    tc = torch_compressor("tpu-sz", backend=backend, device="cpu")
    x = _fields()["vx"][:8, :64, :128]
    r = tc.compress(x, eb=_eb(x))
    p = dict(r.payload)
    if backend == "kernel":
        p["kpacked"] = dataclasses.replace(p["kpacked"], words=p["kpacked"].words.to("meta"))
    else:
        c = p["parts"][0]
        p["parts"] = [dataclasses.replace(
            c, packed=dataclasses.replace(c.packed, words=c.packed.words.to("meta")))]
    with pytest.raises(ValueError, match="payload on meta"):
        tc.decompress(dataclasses.replace(r, payload=p))


@pytest.mark.parametrize("backend", ["core", "kernel"])
def test_oversized_field_refused_like_reference(backend):
    """n * 32 >= 2**31 is refused with the reference's ValueError, before
    anything is allocated (a zero-stride tensor here, shapes only there)."""
    shape = (512, 512, 512)
    jc = jax_compressor("tpu-sz", backend=backend)
    with pytest.raises(ValueError) as ej:
        jax.eval_shape(lambda a: jc.compress(a, eb=1.0), jax.ShapeDtypeStruct(shape, jnp.float32))
    tc = torch_compressor("tpu-sz", backend=backend, device="cpu")
    with pytest.raises(ValueError) as et:
        tc.compress(torch.zeros(1).expand(*shape), eb=1.0)
    assert str(et.value) == str(ej.value)


def test_registry_matches_reference_where_ported():
    assert available() == ["tpu-sz", "tpu-zfp"]
    with pytest.raises(KeyError) as ej:
        jax_compressor("no-such")
    with pytest.raises(KeyError) as eu:
        torch_compressor("no-such", device="cpu")
    assert str(eu.value) == str(ej.value)
    assert str(eu.value) == "\"unknown compressor 'no-such'; have ['tpu-sz', 'tpu-zfp']\""
    for name in ("tpu-sz", "tpu-zfp"):
        with pytest.raises(ValueError) as ej:
            jax_compressor(name, backend="gpu")
        with pytest.raises(ValueError) as et:
            torch_compressor(name, backend="gpu", device="cpu")
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="SZ requires eb"):
        torch_compressor("tpu-sz", device="cpu").compress(np.zeros(8, np.float32))
    with pytest.raises(ValueError, match="ZFP requires rate"):
        torch_compressor("tpu-zfp", device="cpu").compress(np.zeros(8, np.float32))


# ---------------------------------------------------------------- TPU-ZFP --


def _jax_zfp_to_record(r: JaxResult) -> dict:
    p = r.payload
    parts = [{"words": np.asarray(c.words), "emax": np.asarray(c.emax),
              "gtops": np.asarray(c.gtops), "shape": tuple(c.shape), "rate": c.rate}
             for c in p["parts"]]
    return {"payload": {"parts": parts, "orig_shape": tuple(p["orig_shape"]),
                        "orig_len": int(p["orig_len"]), "was_1d": bool(p["was_1d"])},
            "nbytes": r.nbytes, "raw_nbytes": r.raw_nbytes, "meta": dict(r.meta)}


def _zfp_record_to_jax(rec: dict) -> JaxResult:
    p = rec["payload"]
    parts = [jzfp.from_words(c["words"], c["emax"], c["gtops"], c["shape"], c["rate"])
             for c in p["parts"]]
    return JaxResult({"parts": parts, "orig_shape": tuple(p["orig_shape"]),
                      "orig_len": p["orig_len"], "was_1d": p["was_1d"]},
                     rec["nbytes"], rec["raw_nbytes"], dict(rec["meta"]))


def _assert_same_zfp_record(a: dict, b: dict):
    """Two ZFP records hold the same payload (streams bit for bit)."""
    assert (a["nbytes"], a["raw_nbytes"], a["meta"]) == (b["nbytes"], b["raw_nbytes"], b["meta"])
    pa, pb = a["payload"], b["payload"]
    assert (tuple(pa["orig_shape"]), pa["orig_len"], pa["was_1d"]) == (
        tuple(pb["orig_shape"]), pb["orig_len"], pb["was_1d"])
    assert len(pa["parts"]) == len(pb["parts"])
    for ca, cb in zip(pa["parts"], pb["parts"]):
        for key in ("words", "emax", "gtops"):
            np.testing.assert_array_equal(ca[key], cb[key])
        assert tuple(ca["shape"]) == tuple(cb["shape"]) and ca["rate"] == cb["rate"]


def _zfp_pair(backend: str, x: np.ndarray, rate: int = 8):
    jc = jax_compressor("tpu-zfp", backend=backend)
    tc = torch_compressor("tpu-zfp", backend=backend, device="cpu")
    rj, rt = jc.compress(jnp.asarray(x), rate=rate), tc.compress(x, rate=rate)
    _assert_same_zfp_record(_jax_zfp_to_record(rj), interop.to_record(rt))
    assert (rt.nbytes, rt.raw_nbytes, rt.ratio, rt.bitrate) == (rj.nbytes, rj.raw_nbytes,
                                                                rj.ratio, rj.bitrate)
    xj, xt = np.asarray(jc.decompress(rj)), tc.decompress(rt).numpy()
    assert xt.shape == x.shape
    np.testing.assert_array_equal(xj.view(np.uint32), xt.view(np.uint32))
    return rt, xt


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("backend", ["core", "kernel"])
def test_zfp_slice_matches_reference_on_nyx(backend, field):
    """The ZFP main path: a Nyx 32^3 field at quickstart's rate through both
    registries' same backend gives the same payload, size and
    reconstruction, hence the same Foresight checks; on a 4-aligned 3-D
    field the ratio is exactly 32 / rate."""
    x = tcosmo.nyx_fields(n=32)[field]
    rt, xt = _zfp_pair(backend, x)
    assert rt.meta == {"mode": "rate", "rate": 8, "backend": backend, "orig_len": x.size,
                       "was_1d": False}
    assert rt.ratio == 4.0 and rt.bitrate == 8.0
    xj = np.asarray(jax_compressor("tpu-zfp", backend=backend).decompress(
        _zfp_record_to_jax(interop.to_record(rt))))
    assert dataclasses.asdict(tmetrics.distortion(x, xt)) == dataclasses.asdict(
        jmetrics.distortion(x, xj))
    assert tspectrum.pk_gate(x, xt) == jspectrum.pk_gate(x, xj)


@pytest.mark.parametrize("kind", ["hacc", "2d", "odd-3d"])
@pytest.mark.parametrize("backend", ["core", "kernel"])
def test_zfp_hacc_and_other_shapes_match_reference(backend, kind):
    """HACC 1-D (partition, then (N/64) x 8 x 8), 2-D (a trailing unit axis)
    and a ragged 3-D field; the ratio counts the original values."""
    x = {"hacc": tcosmo.hacc_particles(grid=16).fields["vx"][:4000],
         "2d": tcosmo.nyx_fields(n=32)["temperature"][3, :30, :29],
         "odd-3d": tcosmo.nyx_fields(n=32)["vy"][:17, :13, :11]}[kind]
    rt, _ = _zfp_pair(backend, x)
    assert rt.raw_nbytes == x.size * 4
    nb = sum(c.words.shape[0] for c in rt.payload["parts"])
    assert rt.nbytes == nb * 8 * 64 // 8 and rt.ratio == x.size * 4 / rt.nbytes
    assert rt.meta["was_1d"] == (kind == "hacc")


def test_zfp_multi_partition_matches_reference(monkeypatch):
    """A 1-D field of several partitions (the partition shrunk in both
    packages): the reference batches them with vmap, the port runs them one
    after another, and the payloads and reconstructions are equal."""
    part = 4096
    for mod in (jtransforms, ttransforms):
        orig = mod.partition_1d
        monkeypatch.setattr(mod, "partition_1d", lambda x, p=part, orig=orig: orig(x, p))
    rng = np.random.default_rng(29)
    x = np.cumsum(rng.normal(size=3 * part + 33)).astype(np.float32)
    rt, _ = _zfp_pair("core", x)
    assert len(rt.payload["parts"]) == 4


@pytest.mark.parametrize("backend", ["core", "kernel"])
def test_zfp_cross_decode_both_ways(backend):
    """A JAX ZFP payload decodes in the port and a port payload in the JAX
    package, through numpy records (core.interop), for 3-D and HACC 1-D."""
    for x in (tcosmo.nyx_fields(n=32)["dark_matter_density"][:, :30, :31],
              tcosmo.hacc_particles(grid=16).fields["x"]):
        jc = jax_compressor("tpu-zfp", backend=backend)
        tc = torch_compressor("tpu-zfp", backend=backend, device="cpu")
        rj, rt = jc.compress(jnp.asarray(x), rate=4), tc.compress(x, rate=4)
        from_jax = tc.decompress(interop.from_record(_jax_zfp_to_record(rj), device="cpu"))
        np.testing.assert_array_equal(from_jax.numpy().view(np.uint32),
                                      np.asarray(jc.decompress(rj)).view(np.uint32))
        to_jax = np.asarray(jc.decompress(_zfp_record_to_jax(interop.to_record(rt))))
        np.testing.assert_array_equal(to_jax.view(np.uint32),
                                      tc.decompress(rt).numpy().view(np.uint32))
        _assert_same_zfp_record(
            interop.to_record(interop.from_record(interop.to_record(rt), device="cpu")),
            interop.to_record(rt))


def test_zfp_payload_device_rules(monkeypatch):
    """A ZFP record rebuilt without a device means CUDA (raising without it),
    and a compressor refuses a payload on another device."""
    x = tcosmo.nyx_fields(n=32)["vx"][:8, :8, :8]
    tc = torch_compressor("tpu-zfp", backend="core", device="cpu")
    r = tc.compress(x, rate=8)
    rec = interop.to_record(r)
    c = r.payload["parts"][0]
    moved = dataclasses.replace(r, payload={**r.payload, "parts": [
        dataclasses.replace(c, words=c.words.to("meta"))]})
    with pytest.raises(ValueError, match="payload on meta"):
        tc.decompress(moved)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.from_record(rec)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_compressor("tpu-zfp")
    assert interop.from_record(rec, device="cpu").payload["parts"][0].words.device.type == "cpu"

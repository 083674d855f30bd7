"""The port's hand-written kernels and their build, with no JAX in the file,
so that it also runs on a machine that has a card and no JAX.

* The build (runs anywhere, with a stand-in compiler): one ``nvcc`` per
  ``csrc/*.cu`` into a library named by a hash of its sources, reused while
  they are unchanged, and an error when the compiler fails.
* On a card (marked ``cuda``, skipped without one): each kernel bitwise
  against its plain version (K10, whose output is float attention, within
  the reference's tolerance), the default compressors against the plain
  CPU path, wrappers that raise when their kernel library cannot be built
  or loaded or their inputs are not what the kernel takes, and a serving
  engine at the SMOKE size whose decode goes through K10.

The card's cases run with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.core import interop
from repro_torch.core import zfp as tzfp
from repro_torch.core.api import get_compressor
from repro_torch.data import cosmo, kvc_cases, sz_cases, zfp_cases
from repro_torch.kernels import _build
from repro_torch.kernels import lorenzo3d as tlor
from repro_torch.kernels import sz_fused as tszf
from repro_torch.kernels import zfp3d as tzfp3d
from repro_torch.kernels import zfp_fused as tzfpf

# Writes the file named after -o, or fails when FAKE_NVCC_FAIL is set.
FAKE_NVCC = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
if [ -n "$FAKE_NVCC_FAIL" ]; then echo "error: refused"; exit 2; fi
echo "ptxas info    : Used 32 registers" > "$out"
echo "ptxas info    : Used 32 registers"
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """A copy of ``csrc`` and a stand-in ``nvcc``, with an empty build
    directory and no loaded library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.delenv("FAKE_NVCC_FAIL", raising=False)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FUNCS", {})
    return csrc


def test_build_compiles_each_source_once_and_again_when_edited(fake_toolchain):
    csrc = fake_toolchain
    names = {p.stem for p in csrc.glob("*.cu")}
    assert names == {"kvc_attention", "lorenzo3d", "sz_fused", "zfp3d", "zfp_fused"}
    logs = _build.build(verbose=True)
    assert set(logs) == names and all("registers" in log for log in logs.values())
    libs = {name: _build.library_path(name) for name in names}
    assert all(p.is_file() and p.parent == _build.BUILD_DIR for p in libs.values())
    assert not list(_build.BUILD_DIR.glob("*.tmp"))
    assert _build.build() == {}  # unchanged sources are reused

    (csrc / "sz_fused.cu").write_text((csrc / "sz_fused.cu").read_text() + "\n// edit\n")
    assert set(_build.build()) == {"sz_fused"}
    assert _build.library_path("lorenzo3d") == libs["lorenzo3d"]

    header = next(csrc.glob("*.cuh"))
    header.write_text(header.read_text() + "\n// edit\n")  # every source includes it
    assert set(_build.build()) == names


def test_build_failure_raises_and_leaves_no_library(fake_toolchain, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match=r"(?s)nvcc failed for .*error: refused"):
        _build.library("lorenzo3d")
    assert not list(_build.BUILD_DIR.glob("*.so"))
    assert "lorenzo3d" not in _build._LIBS


# ------------------------------------------------------------ on a card ---


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality, uint32 and float32 compared as their int32 bits."""
    a = a.view(torch.int32) if a.dtype in (torch.uint32, torch.float32) else a
    b = b.view(torch.int32) if b.dtype in (torch.uint32, torch.float32) else b
    return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))


def _same_packed(a, b) -> None:
    """Two SZ streams equal word for word (the zero tail included), width
    for width and in ``total_bits``."""
    assert _same(a.words, b.words) and _same(a.widths, b.widths)
    assert int(a.total_bits) == int(b.total_bits) and a.n == b.n


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape).astype(np.float32)
    for ax in range(len(shape)):
        f = np.cumsum(f, axis=ax)
    return (f * 100.0 / max(np.abs(f).max(), 1e-9)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 64, 128), (10, 70, 130)])
def test_cuda_kernels_match_plain(cuda_device, shape):
    """Each kernel on the card against its plain version on the same CUDA
    inputs: bitwise equal."""
    x = F.pad(torch.from_numpy(_field(shape, seed=9)),
              (0, (-shape[2]) % 128, 0, (-shape[1]) % 64, 0, (-shape[0]) % 8))
    x = x.to(cuda_device).contiguous()
    eb_i = tlor.guarded_eb(x, 1e-2)
    delta = tlor.lorenzo3d_quantize(x, eb_i)
    assert _same(delta, tlor.lorenzo3d_quantize_plain(x, eb_i))
    assert _same(tlor.lorenzo3d_reconstruct(delta, eb_i),
                 tlor.lorenzo3d_reconstruct_plain(delta, eb_i))
    packed = tszf.fused_compress(x, eb_i)
    _same_packed(packed, tszf.fused_compress_plain(x, eb_i))
    padded = tuple(x.shape)
    assert _same(tszf.fused_decompress(packed, padded, eb_i),
                 tszf.fused_decompress_plain(packed, padded, eb_i))


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["baryon_density", "vx"])
def test_cuda_compressor_matches_plain_cpu(cuda_device, field):
    """The default compressor (CUDA, kernel backend, fused path) emits the
    stream and reconstruction of the plain versions on the CPU."""
    x = cosmo.nyx_fields(n=64)[field]
    eb = 1e-4 * float(x.max() - x.min())
    gpu = get_compressor("tpu-sz")
    cpu = get_compressor("tpu-sz", backend="kernel", device="cpu")
    rg, rc = gpu.compress(x, eb=eb), cpu.compress(x, eb=eb)
    assert rg.meta["backend"] == "kernel" and rg.nbytes == rc.nbytes
    assert _same(rg.payload["kpacked"].words, rc.payload["kpacked"].words)
    assert _same(rg.payload["kpacked"].widths, rc.payload["kpacked"].widths)
    xg = gpu.decompress(rg)
    assert xg.is_cuda and _same(xg, cpu.decompress(rc))
    assert float((xg.cpu() - torch.from_numpy(x)).abs().max()) <= eb * (1 + 1e-5)


@pytest.mark.cuda
def test_cuda_record_lands_on_the_card(cuda_device):
    """A payload record rebuilt without a device lands on the card and
    decodes through the kernels there; a CPU payload is refused by the
    card's compressor, never decoded on the CPU."""
    x = cosmo.nyx_fields(n=64)["temperature"]
    eb = 1e-4 * float(x.max() - x.min())
    gpu = get_compressor("tpu-sz")
    cpu = get_compressor("tpu-sz", backend="kernel", device="cpu")
    rc = cpu.compress(x, eb=eb)
    rg = interop.from_record(interop.to_record(rc))
    assert rg.payload["kpacked"].words.is_cuda and rg.payload["eb_i"].is_cuda
    before = tszf.launches["fused_decompress"]
    xg = gpu.decompress(rg)
    assert tszf.launches["fused_decompress"] == before + 1
    assert xg.is_cuda and _same(xg, cpu.decompress(rc))
    with pytest.raises(ValueError, match="payload on cpu"):
        gpu.decompress(rc)


@pytest.mark.cuda
def test_cuda_wrapper_raises_when_the_library_cannot_be_built(cuda_device, fake_toolchain,
                                                               monkeypatch):
    """No fallback: a CUDA tensor whose kernel library fails to build raises
    and launches nothing."""
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    x = torch.zeros(8, 64, 128, device=cuda_device)
    before = dict(tlor.launches)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tlor.lorenzo3d_quantize(x, torch.tensor(0.1, device=cuda_device))
    assert tlor.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [1, 2, 4, 8, 16, 32, 40])
def test_cuda_zfp_kernels_match_plain(cuda_device, rate):
    """K5, K6 and K7 on the card against their plain versions on the same
    CUDA inputs, at block counts that are no multiple of a CTA's (1, 31,
    1003), on the hard blocks, and K7 on full-payload streams: bitwise."""
    for nb in (1, 31, 1003):
        blocks = zfp_cases.hard_blocks(nb, seed=rate).to(cuda_device)
        for got, want in zip(tzfp3d.zfp3d_transform(blocks), tzfp3d.zfp3d_transform_plain(blocks)):
            assert _same(got, want)
        enc = tzfpf.fused_compress_blocks(blocks, rate)
        for got, want in zip(enc, tzfpf.fused_compress_blocks_plain(blocks, rate)):
            assert _same(got, want)
        assert _same(tzfpf.fused_decompress_blocks(*enc, rate),
                     tzfpf.fused_decompress_blocks_plain(*enc, rate))
        full = [t.to(cuda_device) for t in zfp_cases.full_streams(nb, rate, seed=nb + rate)]
        assert _same(tzfpf.fused_decompress_blocks(*full, rate),
                     tzfpf.fused_decompress_blocks_plain(*full, rate))


@pytest.mark.cuda
def test_cuda_kernels_match_cpu_on_out_of_range_inputs(cuda_device):
    """K1, K3, K5, K6 and K7 on the card give what the CPU's plain versions
    give on inputs whose quantized values leave the int32 range (5e6 at eb
    1e-3, 3e38, +inf) or are NaN: both saturate and map NaN to 0, as the
    reference does (``test_torch_casts.py`` holds the CPU to it)."""
    rng = np.random.default_rng(0)
    base = np.cumsum(rng.normal(size=(8, 64, 128)).astype(np.float32), axis=2)
    for value in (5e6, np.nan, 3e38, np.inf):
        x = base.copy()
        x[1, 2, 3] = value
        xc = torch.from_numpy(x)
        eb_i = tlor.guarded_eb(xc, 1e-3)
        xg, ebg = xc.to(cuda_device), eb_i.to(cuda_device)
        assert _same(tlor.lorenzo3d_quantize(xg, ebg), tlor.lorenzo3d_quantize(xc, eb_i))
        _same_packed(tszf.fused_compress(xg, ebg), tszf.fused_compress(xc, eb_i))
    blocks = zfp_cases.hard_blocks(256, seed=5)
    bg = blocks.to(cuda_device)
    for got, want in zip(tzfp3d.zfp3d_transform(bg), tzfp3d.zfp3d_transform(blocks)):
        assert _same(got, want)
    for rate in (4, 8):
        enc = tzfpf.fused_compress_blocks(bg, rate)
        enc_c = tzfpf.fused_compress_blocks(blocks, rate)
        for got, want in zip(enc, enc_c):
            assert _same(got, want)
        assert _same(tzfpf.fused_decompress_blocks(*enc, rate),
                     tzfpf.fused_decompress_blocks(*enc_c, rate))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["256^3", "ragged", "out_of_range"])
def test_cuda_k1_matches_plain(cuda_device, case):
    """K1 (a warp per 8 rows of a tile column, walking its planes) bitwise
    against its plain version on the same CUDA inputs: the main path's
    256^3 field, a ragged field padded to tiles, and a tile of +-inf, NaN,
    3e38 and 5e6 at eb 1e-3 (saturated and NaN-to-0 codes)."""
    if case == "256^3":
        x = torch.from_numpy(_field((256, 256, 256), seed=4))
    elif case == "ragged":
        x = F.pad(torch.from_numpy(_field((20, 130, 300), seed=5)), (0, 84, 0, 62, 0, 4))
    else:
        x = torch.from_numpy(_field((16, 128, 256), seed=6))
        x[0, 0, :5] = torch.tensor([np.inf, -np.inf, np.nan, 3e38, 5e6])
        x[9, 64, 127] = np.nan
    x = x.to(cuda_device).contiguous()
    eb_i = tlor.guarded_eb(x, 1e-3) if case != "out_of_range" else torch.tensor(
        1e-3, device=cuda_device)
    before = tlor.launches["lorenzo3d_quantize"]
    got = tlor.lorenzo3d_quantize(x, eb_i)
    torch.cuda.synchronize()
    assert tlor.launches["lorenzo3d_quantize"] == before + 1
    assert _same(got, tlor.lorenzo3d_quantize_plain(x, eb_i))


@pytest.mark.cuda
def test_cuda_zfp_wrapper_raises_when_the_library_cannot_be_loaded(cuda_device, monkeypatch):
    """No fallback: a CUDA tensor whose kernel library cannot be loaded
    raises and never runs the plain version."""

    def refuse(name):
        raise OSError(f"cannot load {name}")

    def plain(*args):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(tzfpf, "fused_compress_blocks_plain", plain)
    before = dict(tzfpf.launches)
    with pytest.raises(OSError, match="cannot load zfp_fused"):
        tzfpf.fused_compress_blocks(torch.zeros(16, 4, 4, 4, device=cuda_device), 8)
    assert tzfpf.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["baryon_density", "vx"])
def test_cuda_zfp_compressor_launches_k6_k7_and_matches_plain_cpu(cuda_device, field):
    """``tpu-zfp`` on the card goes through K6 and K7 and gives the stream
    and reconstruction of the plain versions on the CPU."""
    x = cosmo.nyx_fields(n=64)[field][:, :61, :62]  # two ragged axes
    gpu = get_compressor("tpu-zfp")
    cpu = get_compressor("tpu-zfp", backend="kernel", device="cpu")
    kernels.reset_launch_counts()
    rg = gpu.compress(x, rate=8)
    xg = gpu.decompress(rg)
    counts = kernels.launch_counts()
    assert counts["fused_compress_blocks"] == 1 and counts["fused_decompress_blocks"] == 1
    rc = cpu.compress(x, rate=8)
    assert rg.meta["backend"] == "kernel" and rg.nbytes == rc.nbytes
    for name in ("words", "emax", "gtops"):
        assert _same(getattr(rg.payload["parts"][0], name), getattr(rc.payload["parts"][0], name))
    assert xg.is_cuda and _same(xg, cpu.decompress(rc))
    assert xg.shape == x.shape
    rec = interop.to_record(rc)
    assert _same(gpu.decompress(interop.from_record(rec)), xg)
    assert tzfp.compression_ratio(rg.payload["parts"][0], n_values=x.size) == rg.ratio


# ------------------------------------ the SZ stream kernels (K3, K4, K8, K9) ----


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(sz_cases.cases()))
def test_cuda_sz_stream_kernels_match_plain(cuda_device, case):
    """K3 and K4 on the card against their plain versions on the same CUDA
    inputs, on the hard cases (every width 0, every width 32 from +-3e38, NaN
    and +inf, a ragged padded field, out-of-range values): the stream word
    for word with its zero tail, and the reconstruction, bitwise."""
    x, eb_i = (t.to(cuda_device) for t in sz_cases.cases()[case])
    kernels.reset_launch_counts()
    packed = tszf.fused_compress(x, eb_i)
    xr = tszf.fused_decompress(packed, tuple(x.shape), eb_i)
    counts = kernels.launch_counts()
    assert counts["fused_compress"] == 1 and counts["fused_decompress"] == 1
    _same_packed(packed, tszf.fused_compress_plain(x, eb_i))
    assert packed.words.shape == (x.numel() + 2,) and packed.total_bits.dtype == torch.int64
    assert _same(xr, tszf.fused_decompress_plain(packed, tuple(x.shape), eb_i))


@pytest.mark.cuda
def test_cuda_sz_stream_batched_match_plain_on_uneven_rows(cuda_device):
    """K8 and K9 on three rows whose ratios differ by more than 4x (so the
    row offsets are arbitrary), and on rows that are all zero or all at
    width 32: the arena, widths, offsets, counts, total_bits and used, and
    the decoded rows, bitwise against the plain versions."""
    x, eb = sz_cases.rows()
    hard = sz_cases.cases()
    zero = torch.zeros(16, 64, 128)
    full = hard["full_width"][0].repeat(2, 1, 1)
    for xs, ebs in ((x, eb), (torch.stack([zero, full, x[0]]), torch.tensor([1e-2, 1.0, 0.5]))):
        xg, ebg = xs.to(cuda_device), ebs.to(cuda_device)
        enc = tszf.fused_compress_batched(xg, ebg)
        for got, want in zip(enc, tszf.fused_compress_batched_plain(xg, ebg)):
            assert _same(got, want)
        assert _same(tszf.fused_decompress_batched(enc[0], enc[1], (16, 64, 128), ebg),
                     tszf.fused_decompress_batched_plain(enc[0], enc[1], (16, 64, 128), ebg))
    ratios = 32 * x[0].numel() / tszf.fused_compress_batched(x, eb)[4].double()
    assert float(ratios.max() / ratios.min()) > 4


@pytest.mark.cuda
def test_cuda_sz_stream_calls_repeat_and_capture_in_a_graph(cuda_device):
    """Two calls in a row give identical streams (each call clears its
    look-back flags), and a CUDA-graph capture replays to the same stream
    and reconstruction."""
    x, eb_i = (t.to(cuda_device) for t in sz_cases.cases()["ragged"])
    shape = tuple(x.shape)
    first = tszf.fused_compress(x, eb_i)
    again = tszf.fused_compress(x, eb_i)
    _same_packed(first, again)
    assert _same(tszf.fused_decompress(first, shape, eb_i), tszf.fused_decompress(again, shape, eb_i))
    xr = tszf.fused_decompress(first, shape, eb_i)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tszf.fused_compress(x, eb_i)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tszf.fused_compress(x, eb_i)
        decoded = tszf.fused_decompress(captured, shape, eb_i)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        _same_packed(captured, first)
        assert _same(decoded, xr)


@pytest.mark.cuda
def test_cuda_sz_stream_more_chunks_than_resident_ctas(cuda_device):
    """A field of more chunks (tile planes) than the card holds CTAs at once,
    so the look-back spans CTAs that ran in earlier waves: K3/K4 and K8/K9
    bitwise against their plain versions."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    # an (8, 256, 512) slab holds 128 chunks; an even number of slabs, to split in two rows
    z = 16 * -(-(16 * sms // 128 + 1) // 2)
    x = torch.from_numpy(sz_cases.smooth((z, 256, 512), 21, 1e3)).to(cuda_device)
    assert x.numel() // (64 * 128) > 16 * sms
    eb_i = tlor.guarded_eb(x, 1e-1)
    packed = tszf.fused_compress(x, eb_i)
    _same_packed(packed, tszf.fused_compress_plain(x, eb_i))
    assert _same(tszf.fused_decompress(packed, tuple(x.shape), eb_i),
                 tszf.fused_decompress_plain(packed, tuple(x.shape), eb_i))
    xb = x.view(2, z // 2, 256, 512)
    ebb = torch.stack([eb_i, 2 * eb_i])
    enc = tszf.fused_compress_batched(xb, ebb)
    for got, want in zip(enc, tszf.fused_compress_batched_plain(xb, ebb)):
        assert _same(got, want)
    assert _same(tszf.fused_decompress_batched(enc[0], enc[1], (z // 2, 256, 512), ebb),
                 tszf.fused_decompress_batched_plain(enc[0], enc[1], (z // 2, 256, 512), ebb))


# ------------------------------------------------ K8 / K9 and snapshots ----


@pytest.mark.cuda
def test_cuda_k8_k9_match_plain_one_launch_per_bucket(cuda_device):
    """K8 and K9 on the card against their plain versions on the same CUDA
    inputs (three rows, three bounds): bitwise, one launch each; the
    arena and sidecars equal the plain CPU versions'."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy((rng.normal(size=(3, 16, 64, 128)) * 20).astype(np.float32))
    x[0] = torch.cumsum(x[0], dim=2)
    eb = torch.tensor([1e-3, 0.2, 7.0])
    xg, ebg = x.to(cuda_device), eb.to(cuda_device)
    kernels.reset_launch_counts()
    enc = tszf.fused_compress_batched(xg, ebg)
    out = tszf.fused_decompress_batched(enc[0], enc[1], (16, 64, 128), ebg)
    counts = kernels.launch_counts()
    assert counts["fused_compress_batched"] == 1 and counts["fused_decompress_batched"] == 1
    for got, want in zip(enc, tszf.fused_compress_batched_plain(xg, ebg)):
        assert _same(got, want)
    assert _same(out, tszf.fused_decompress_batched_plain(enc[0], enc[1], (16, 64, 128), ebg))
    for got, want in zip(enc, tszf.fused_compress_batched(x, eb)):
        assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["encode", "decode"])
def test_cuda_batched_wrappers_raise_when_the_library_cannot_be_loaded(cuda_device, monkeypatch,
                                                                      which):
    def refuse(name):
        raise OSError(f"cannot load {name}")

    def plain(*args):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_build, "library", refuse)
    name = "compress" if which == "encode" else "decompress"
    monkeypatch.setattr(tszf, f"fused_{name}_batched_plain", plain)
    monkeypatch.setattr(tszf, f"fused_{name}_plain", plain)
    before = dict(tszf.launches)
    eb = torch.ones(2, device=cuda_device)
    with pytest.raises(OSError, match="cannot load sz_fused"):
        if which == "encode":
            tszf.fused_compress_batched(torch.zeros(2, 8, 64, 128, device=cuda_device), eb)
        else:
            tszf.fused_decompress_batched(torch.zeros(2 * (65536 + 2), dtype=torch.int32,
                                                      device=cuda_device),
                                          torch.zeros(2, 1024, dtype=torch.uint8,
                                                      device=cuda_device),
                                          (8, 64, 128), eb)
    with pytest.raises(OSError, match="cannot load sz_fused"):
        if which == "encode":
            tszf.fused_compress(torch.zeros(8, 64, 128, device=cuda_device), eb[0])
        else:
            tszf.fused_decompress(tszf.bitpack.PackedCodes(
                torch.zeros(65536 + 2, dtype=torch.int32, device=cuda_device).view(torch.uint32),
                torch.zeros(1024, dtype=torch.uint8, device=cuda_device),
                torch.zeros((), dtype=torch.int64, device=cuda_device), 65536), (8, 64, 128), eb[0])
    assert tszf.launches == before


@pytest.mark.cuda
def test_cuda_snapshot_writes_the_cpu_files_and_restores(cuda_device, tmp_path):
    """A snapshot through the card (K8 for two tile fields, the flat route,
    pinned deferred fetches, the drain thread) writes the payload files
    and manifest the plain CPU versions write, byte for byte, and restores
    on the card to the CPU restore's values."""
    from repro_torch.checkpoint import manager as tman
    from repro_torch.core import arena as ta

    rng = np.random.default_rng(21)
    n = 8 * 64 * 128
    tiles = [torch.from_numpy((rng.normal(size=(8, 64, 128)) * 9).astype(np.float32))
             for _ in range(2)]
    flat = {"w": torch.from_numpy(rng.normal(size=(40, 50)).astype(np.float32)),
            "g": torch.from_numpy(rng.normal(size=(3000,)).astype(np.float32)).to(torch.bfloat16)}
    kb = ta.Bucket(n, ("t0", "t1"), ((8, 64, 128),) * 2, ("float32",) * 2, (n, n))
    fbs = ta.plan_buckets([(k, tuple(v.shape), v.dtype) for k, v in flat.items()])
    dirs, restored = {}, {}
    for dev in (cuda_device, torch.device("cpu")):
        a = ta.szk_compress_bucket([t.to(dev) for t in tiles], kb, 1e-2, device=dev)
        snap = {"karena": ta.to_host_async(a, kb, codec=ta.CODEC_SZK)}
        for k, b in enumerate(fbs):
            fa = ta.sz_compress_bucket([flat[nm].to(dev) for nm in b.names], b, 1e-3,
                                       staged=True, device=dev)
            snap[f"farena{k}"] = ta.to_host_async(fa, b)
        mgr = tman.CheckpointManager(tmp_path / dev.type, async_save=True,
                                     policy=tman.CodecPolicy(zstd_level=0), device=dev)
        mgr.save(1, snap)
        mgr.wait()
        dirs[dev.type] = tmp_path / dev.type / "step_000000001"
        restored[dev.type], _ = mgr.restore(state_like={k: 0 for k in snap})
    names = sorted(p.name for p in dirs["cpu"].iterdir() if not p.name.startswith("obs_"))
    for nm in names:
        assert (dirs["cuda"] / nm).read_bytes() == (dirs["cpu"] / nm).read_bytes(), nm
    for key, leaves in restored["cpu"].items():
        for nm, want in leaves.items():
            got = restored["cuda"][key][nm]
            assert not got.is_cuda and got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_restore_propagates_a_library_failure_and_quarantines_nothing(
        cuda_device, tmp_path, monkeypatch):
    """A kernel library that cannot be loaded during restore is no
    corruption: ``restore_latest_valid`` raises the ``OSError`` unchanged
    and leaves every step where it was (no fallback to an older one)."""
    from repro_torch.checkpoint import manager as tman
    from repro_torch.core import arena as ta

    rng = np.random.default_rng(22)
    n = 8 * 64 * 128
    tiles = [torch.from_numpy(rng.normal(size=(8, 64, 128)).astype(np.float32)).to(cuda_device)
             for _ in range(2)]
    kb = ta.Bucket(n, ("t0", "t1"), ((8, 64, 128),) * 2, ("float32",) * 2, (n, n))
    mgr = tman.CheckpointManager(tmp_path, async_save=True,
                                 policy=tman.CodecPolicy(zstd_level=0), device=cuda_device)
    for step in (1, 2):
        a = ta.szk_compress_bucket(tiles, kb, 1e-2, device=cuda_device)
        mgr.save(step, {"karena": ta.to_host_async(a, kb, codec=ta.CODEC_SZK)})
        mgr.wait()

    def refuse(name):
        raise OSError(f"cannot load {name}")

    monkeypatch.setattr(_build, "library", refuse)
    with pytest.raises(OSError, match="cannot load") as ei:
        mgr.restore_latest_valid(state_like={"karena": 0})
    assert not isinstance(ei.value, tman.SnapshotCorruptionError)
    assert mgr.available_steps() == [2, 1]
    assert not (tmp_path / "quarantine").exists()


# ------------------------------------------------------------------ K10 ----


def _kvc_inputs(seed, b, s, h, hkv, d, device, qdtype=torch.float32):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32)).to(qdtype)
    codes = [torch.from_numpy(rng.integers(-127, 128, size=(b, s, hkv, d)).astype(np.int8))
             for _ in range(2)]
    scales = [torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(b, s, hkv)).astype(np.float32))
              for _ in range(2)]
    return [t.to(device) for t in (q, codes[0], scales[0], codes[1], scales[1])]


def _bf16_close(got: torch.Tensor, want: torch.Tensor, atol: float = 2e-6) -> bool:
    """|got - want| <= one bf16 ulp of want, plus the f32 case's atol: an
    element near 0 (a sum that cancels) differs by several of its own tiny
    ulps at the f32 rounding error of a different summation order."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w.abs())[1] - 8)
    return bool(((got.float() - w).abs() <= torch.where(w == 0, 0.0, ulp) + atol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,qdtype", [
    (1, 128, 4, 4, 64, torch.float32), (2, 256, 8, 8, 64, torch.float32),
    (2, 384, 2, 2, 128, torch.float32), (4, 200, 4, 2, 16, torch.float32),
    (8, 2048, 24, 2, 128, torch.bfloat16), (3, 1000, 8, 1, 64, torch.bfloat16)])
def test_cuda_kvc_matches_plain(cuda_device, b, s, h, hkv, d, qdtype):
    """K10 on the card against its plain version on the same CUDA inputs:
    f32 within rtol 2e-5 / atol 2e-6 (``tests/test_kernels.py:189``), bf16
    within 1 ulp after the cast (plus that atol, :func:`_bf16_close`) and
    with the bf16 query's values in f32 within the f32 tolerance; a lane
    with index -1 is exactly 0."""
    from repro_torch.kernels import kvc_attention as tkvc
    from repro_torch.kernels import ref as tref

    q, kc, ks, vc, vs = _kvc_inputs(b * s + h, b, s, h, hkv, d, cuda_device, qdtype)
    idx = torch.from_numpy(np.random.default_rng(s).integers(0, s, size=b).astype(np.int32))
    idx[-1] = s - 1
    if b > 1:
        idx[0] = -1  # a free lane
    idx = idx.to(cuda_device)
    before = tkvc.launches["kvc_decode_attention"]
    got = tkvc.kvc_decode_attention(q, kc, ks, vc, vs, idx)
    torch.cuda.synchronize()
    assert tkvc.launches["kvc_decode_attention"] == before + 1
    want = tref.kvc_decode_attention_ref(q, kc, ks, vc, vs, idx)
    assert got.dtype == q.dtype and got.shape == q.shape
    if b > 1:
        assert torch.equal(got[0], torch.zeros_like(got[0]))
    if qdtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    else:
        assert _bf16_close(got, want)
        q32 = q.float()
        torch.testing.assert_close(tkvc.kvc_decode_attention(q32, kc, ks, vc, vs, idx),
                                   tref.kvc_decode_attention_ref(q32, kc, ks, vc, vs, idx),
                                   rtol=2e-5, atol=2e-6)
    scalar = tkvc.kvc_decode_attention(q, kc, ks, vc, vs, torch.tensor(s // 2, dtype=torch.int32,
                                                                          device=cuda_device))
    want = tref.kvc_decode_attention_ref(q, kc, ks, vc, vs, s // 2)
    if qdtype == torch.float32:
        torch.testing.assert_close(scalar, want, rtol=2e-5, atol=2e-6)
    else:
        assert _bf16_close(scalar, want)


def _kvc_pool(seed, b, cap, h, hkv, d, device, qdtype):
    """``kvc_cases.paged_pool`` at positions from cap / 2 up, lane 0 free and
    the last lane at the end of its mapped pages."""
    idx = np.random.default_rng(seed).integers(cap // 2, cap, size=b)
    idx[0], idx[-1] = -1, cap - 16 - 1
    return kvc_cases.paged_pool(b, cap, h, hkv, d, qdtype, idx.tolist(), device, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [2048, 32768])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_cuda_kvc_paged_matches_plain(cuda_device, cap, qdtype):
    """K10's paged entry at starcoder2-3b's serving shape (B = 8, 24/2
    heads, D = 128, 16-token pages) and at S = 32768, against its plain
    version (the gather, then ``ref.kvc_decode_attention_ref``) on the same
    CUDA inputs: f32 within rtol 2e-5 / atol 2e-6, bf16 within one ulp plus
    2e-6; one launch; a free lane exactly 0; the dense entry on the gathered
    cache gives the same."""
    from repro_torch.kernels import kvc_attention as tkvc
    from repro_torch.kernels import ref as tref

    args = _kvc_pool(cap + 3, 8, cap, 24, 2, 128, cuda_device, qdtype)
    before = tkvc.launches["kvc_decode_attention"]
    got = tkvc.kvc_decode_attention_paged(*args)
    torch.cuda.synchronize()
    assert tkvc.launches["kvc_decode_attention"] == before + 1
    want = tref.kvc_decode_attention_paged_ref(*args)
    assert got.dtype == qdtype and torch.equal(got[0], torch.zeros_like(got[0]))
    q, kp, ksp, vp, vsp, table, idx = args
    dense = tkvc.kvc_decode_attention(q, *(tref.gather_pages(p, table) for p in (kp, ksp, vp, vsp)),
                                      idx)
    for out in (got, dense):
        if qdtype == torch.float32:
            torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-6)
        else:
            assert _bf16_close(out, want)


@pytest.mark.cuda
def test_cuda_kvc_entries_capture_in_a_graph_with_clean_tickets(cuda_device):
    """Both entries captured in a CUDA graph: each replay equals a direct
    call bit for bit, and the merge tickets are zero after every replay (the
    merging block resets them)."""
    from repro_torch.kernels import kvc_attention as tkvc
    from repro_torch.kernels import ref as tref

    q, kp, ksp, vp, vsp, table, idx = _kvc_pool(7, 8, 2048, 24, 2, 128, cuda_device,
                                                torch.bfloat16)
    dense = [tref.gather_pages(p, table) for p in (kp, ksp, vp, vsp)]
    calls = {"paged": lambda: tkvc.kvc_decode_attention_paged(q, kp, ksp, vp, vsp, table, idx),
             "dense": lambda: tkvc.kvc_decode_attention(q, *dense, idx)}
    assert tkvc.split_plan(8, 2, 2048, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)[0] > 1  # the merge runs
    for name, fn in calls.items():
        direct = fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, direct), name
            assert all(int(t.abs().sum()) == 0 for t in tkvc._TICKETS.values()), name


@pytest.mark.cuda
def test_cuda_kvc_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    """A CPU/CUDA mix, a wrong dtype, a non-contiguous input or a head
    count the kernel does not map raise before any launch."""
    from repro_torch.kernels import kvc_attention as tkvc

    q, kc, ks, vc, vs = _kvc_inputs(5, 2, 64, 4, 2, 16, cuda_device)
    idx = torch.tensor([3, 10], dtype=torch.int32, device=cuda_device)
    before = dict(tkvc.launches)
    bad = [
        (q.cpu(), kc, ks, vc, vs, idx), (q, kc.cpu(), ks, vc, vs, idx),
        (q, kc, ks, vc, vs, idx.cpu()), (q.double(), kc, ks, vc, vs, idx),
        (q, kc.to(torch.int16), ks, vc, vs, idx), (q, kc, ks.half(), vc, vs, idx),
        (q, kc, ks, vc, vs, idx.long()),
        (q.transpose(1, 2).contiguous().transpose(1, 2), kc, ks, vc, vs, idx),
        (q, kc.transpose(0, 1).contiguous().transpose(0, 1), ks, vc, vs, idx),
        (q[:, :3].contiguous(), kc, ks, vc, vs, idx),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tkvc.kvc_decode_attention(*args)
    assert tkvc.launches == before


@pytest.mark.cuda
def test_cuda_kvc_paged_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    """The paged entry refuses a table off the card, of another dtype or
    batch, a pool whose shapes disagree and a head dim the kernel has no
    instantiation for, before any launch."""
    from repro_torch.kernels import kvc_attention as tkvc

    q, kp, ksp, vp, vsp, table, idx = _kvc_pool(9, 2, 64, 4, 2, 16, cuda_device, torch.float32)
    before = dict(tkvc.launches)
    bad = [
        (q, kp, ksp, vp, vsp, table.cpu(), idx), (q, kp, ksp, vp, vsp, table.long(), idx),
        (q, kp, ksp, vp, vsp, table[:1].contiguous(), idx),
        (q, kp, ksp[:, :8].contiguous(), vp, vsp, table, idx),
        (q[..., :8].contiguous(), kp[..., :8].contiguous(), ksp, vp[..., :8].contiguous(), vsp,
         table, idx),
        (torch.zeros(2, 4, 48, device=cuda_device), *(torch.zeros(
            t.shape[:3] + (48,), dtype=torch.int8, device=cuda_device) if t.ndim == 4 else t
            for t in (kp, ksp, vp, vsp)), table, idx),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tkvc.kvc_decode_attention_paged(*args)
    assert tkvc.launches == before


@pytest.mark.cuda
def test_cuda_kvc_wrapper_raises_when_the_library_cannot_be_loaded(cuda_device, monkeypatch):
    from repro_torch.kernels import kvc_attention as tkvc
    from repro_torch.kernels import ref as tref

    def refuse(name):
        raise OSError(f"cannot load {name}")

    def plain(*args):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(tref, "kvc_decode_attention_ref", plain)
    q, kc, ks, vc, vs = _kvc_inputs(6, 1, 64, 2, 2, 16, cuda_device)
    before = dict(tkvc.launches)
    with pytest.raises(OSError, match="cannot load kvc_attention"):
        tkvc.kvc_decode_attention(q, kc, ks, vc, vs, torch.tensor(5, dtype=torch.int32,
                                                                  device=cuda_device))
    assert tkvc.launches == before


@pytest.mark.cuda
def test_cuda_engine_smoke_decodes_through_k10(cuda_device):
    """One request through ``ServingEngine`` at starcoder2-3b's SMOKE size
    on the card (paged blockfloat8, ``attention="auto"``): K10 launches once
    per layer and decode step, the pool is clean after the drain, and the
    greedy tokens agree with K10's plain version on the CPU
    (``attention="fused"``) in at least 6 of 8 (``tests/test_serving.py``'s
    bar)."""
    from repro_torch.configs import registry
    from repro_torch.models.spec import init_params
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    cfg = registry.get_config("starcoder2-3b", smoke=True)
    params = init_params(registry.build_model(cfg, device="cpu").specs(),
                         torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    toks = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = registry.build_model(cfg, device=dev)
        on = _to_device(params, dev)
        eng = ServingEngine(model, on, EngineConfig(
            batch_slots=2, max_len=64, codec="blockfloat8", paged=True,
            attention="auto" if dev.type == "cuda" else "fused"))
        assert eng._fused
        kernels.reset_launch_counts()
        req = Request(uid=0, prompt=[3, 1, 4, 1, 5], max_new_tokens=8)
        eng.submit(req)
        done = eng.run_until_drained()
        assert done.drained and len(req.out_tokens) == 8
        launches = kernels.launch_counts()["kvc_decode_attention"]
        assert launches == (cfg.n_layers * eng.steps if dev.type == "cuda" else 0)
        assert eng.check_kv_integrity()
        toks[dev.type] = req.out_tokens
    agree = sum(a == b for a, b in zip(toks["cuda"], toks["cpu"]))
    assert agree >= 6, toks


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# ------------------------------------------- Foresight and in-situ (card) ----


@pytest.mark.cuda
def test_cuda_run_case_launches_k3_k4_and_matches_plain_cpu(cuda_device):
    """A CBench case on the card goes through K3 and K4 once per call
    (warm-up and timed) and reports the ratio and reconstruction of the
    kernel backend's plain versions on the CPU."""
    from repro_torch.foresight import cbench

    f = cosmo.nyx_fields(n=64)["baryon_density"]
    kernels.reset_launch_counts()
    r = cbench.run_case("tpu-sz", "baryon_density", f, {"eb": 10.0}, warmup=1, iters=2)
    counts = kernels.launch_counts()
    assert counts["fused_compress"] == 3 and counts["fused_decompress"] == 3
    cpu = get_compressor("tpu-sz", backend="kernel", device="cpu")
    rc = cpu.compress(f, eb=10.0)
    assert r.ratio == rc.ratio and r.max_abs_err <= 10.0 * (1 + 1e-5)
    np.testing.assert_array_equal(r.reconstructed, cpu.decompress(rc).numpy())


@pytest.mark.cuda
def test_cuda_one_rank_sharded_compress_equals_single_device(cuda_device):
    """A one-rank mesh on the card: each codec's stream and decode are the
    single-device entry point's, and K3, K4, K6, K7 launch once each (the
    field is TILE-aligned, as the sharded kernel backend requires)."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import insitu, sharding

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
        x = torch.from_numpy(_field((16, 64, 256), 3)).to(cuda_device)
        spec = sharding.field_spec(x.shape, mesh)
        eb = 1e-3 * float(x.max() - x.min())
        single = {"core": get_compressor("tpu-sz", backend="core"),
                  "kernel": get_compressor("tpu-sz", backend="kernel")}
        for backend, comp in single.items():
            kernels.reset_launch_counts()
            st = insitu.sharded_compress(x, "sz", mesh, spec, eb=eb, backend=backend)
            y = insitu.sharded_decompress(st, mesh).to_local()
            counts = kernels.launch_counts()
            want = int(backend == "kernel")
            assert counts["fused_compress"] == want and counts["fused_decompress"] == want
            r = comp.compress(x, eb=eb)
            p = r.payload["kpacked"] if backend == "kernel" else r.payload["parts"][0].packed
            assert _same(st.words, p.words) and _same(st.widths, p.widths)
            assert int(st.total_bits) == int(p.total_bits)
            assert _same(y, comp.decompress(r))
        kernels.reset_launch_counts()
        st = insitu.sharded_compress(x, "zfp", mesh, spec, rate=8)
        y = insitu.sharded_decompress(st, mesh).to_local()
        counts = kernels.launch_counts()
        assert counts["fused_compress_blocks"] == 1 and counts["fused_decompress_blocks"] == 1
        zc = get_compressor("tpu-zfp")
        r = zc.compress(x, rate=8)
        assert _same(st.words, r.payload["parts"][0].words) and _same(y, zc.decompress(r))
    finally:
        dist.destroy_process_group()

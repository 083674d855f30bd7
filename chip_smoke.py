#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of TPU-SZ on one GPU and check every result.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; it builds the hand-written kernels from
``src/repro_torch/kernels/csrc`` at first use.  In order it:

1. prints the card's name and power limit (``nvidia-smi``) and the kernel
   build time;
2. holds each kernel (K1-K4) against its plain PyTorch version on the card,
   at 256^3 and at a ragged shape, requiring bitwise equality;
3. drives the main path: the six ``nyx_fields(n=256, seed=42)`` fields
   through ``get_compressor("tpu-sz")`` (CUDA, ``kernel`` backend, ``fused``
   path), then through the ``xla`` path, with the launch counts reset just
   before each run and read just after.  The two paths' streams must be
   equal, every kernel of a path must have launched, and ``max|x̂ - x| <= eb
   (1 + 1e-5)`` with ``eb = 1e-4 x value range``.  Prints ratio, PSNR, the
   power-spectrum gate and compress/decompress MB/s (median and range of
   20 CUDA-event-timed calls after a warm-up);
4. checks the card's streams against the plain versions on the CPU for the
   six 64^3 fields;
5. runs the ``core`` backend on the card: baryon density (ABS) and HACC
   ``vx`` (``hacc_particles(grid=128)``) in PW_REL 1e-2 mode, each held to
   its bound;
6. prints one JSON line of per-kernel numbers (launches, max difference from
   the plain version, median ms at 256^3, the plain version's ms, the bound)
   and, last, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; so does a machine without CUDA, and a
directory without the rest of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# These fail, and the script exits non-zero, outside a checkout of the repository.
from repro_torch import kernels  # noqa: E402
from repro_torch.analysis import metrics, spectrum  # noqa: E402
from repro_torch.core import bitpack  # noqa: E402
from repro_torch.core.api import get_compressor  # noqa: E402
from repro_torch.data import cosmo  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import lorenzo3d as lor  # noqa: E402
from repro_torch.kernels import sz_fused as szf  # noqa: E402

N = 256  # Nyx grid side of the main path
HACC_GRID = 128  # HACC particles per side of the core-backend check
SMALL_N = 64  # grid side of the CPU agreement check
SEED = 42
REL_EB = 1e-4  # eb = REL_EB x value range (10.0 on baryon density, as in quickstart)
PW_REL = 1e-2
TIMING_ITERS = 20  # CUDA-event-timed calls per kernel, stage and field
PLAIN_ITERS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM INT32 rate: an SM has 64 INT32 lanes beside its 128 FP32 lanes, so
# half the data sheet's 67 TFLOP/s FP32 rate.  The kernels' work is integer.
INT32_OPS_PER_S = 67e12 / 2

# Integer operations per point (quantize 2, Lorenzo 7; zigzag 2, bit length
# 1, block max 1, packing 6; prefix sums 3, dequantize 2; unpacking 6,
# unzigzag 3).
OPS_PER_POINT = {"lorenzo3d_quantize": 9, "lorenzo3d_reconstruct": 5,
                 "fused_encode": 19, "fused_decode": 14}

KERNELS = {
    "lorenzo3d_quantize": ("K1", "src/repro_torch/kernels/csrc/lorenzo3d.cu",
                           "src/repro/kernels/lorenzo3d.py:72"),
    "lorenzo3d_reconstruct": ("K2", "src/repro_torch/kernels/csrc/lorenzo3d.cu",
                              "src/repro/kernels/lorenzo3d.py:101"),
    "fused_encode": ("K3", "src/repro_torch/kernels/csrc/sz_fused.cu",
                     "src/repro/kernels/sz_fused.py:177"),
    "fused_decode": ("K4", "src/repro_torch/kernels/csrc/sz_fused.cu",
                     "src/repro/kernels/sz_fused.py:336"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bits(t):
    """A tensor's raw bits as a comparable integer tensor (uint32 is viewed
    as int32, float32 as int32)."""
    if t.dtype in (torch.uint32, torch.float32):
        return t.view(torch.int32)
    return t


def max_abs_diff(a, b) -> float:
    if a.dtype == torch.float32:
        return float((a - b).abs().max())
    return float((bits(a).to(torch.int64) - bits(b).to(torch.int64)).abs().max())


def same(a, b) -> bool:
    """Bitwise equality (a card tensor is compared on the host with a CPU one)."""
    a, b = bits(a), bits(b)
    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
    return a.shape == b.shape and bool(torch.equal(a, b))


def cuda_times(fn, iters: int) -> list[float]:
    """Milliseconds of each of ``iters`` CUDA-event-timed runs of ``fn()``,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def cuda_ms(fn, iters: int) -> float:
    return statistics.median(cuda_times(fn, iters))


def pad_to_tile(x):
    pads = [(-s) % t for s, t in zip(x.shape, lor.TILE)]
    return F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0])).contiguous()


def kernels_vs_plain(inputs: dict) -> dict[str, float]:
    """Each kernel against its plain version on the same CUDA inputs; bitwise
    equality required.  Returns the largest difference per kernel (0)."""
    worst = {name: 0.0 for name in KERNELS}
    for label, (x, eb) in inputs.items():
        xp = pad_to_tile(x)
        eb_i = lor.guarded_eb(xp, eb)
        pairs = {}
        delta = lor.lorenzo3d_quantize(xp, eb_i)
        pairs["lorenzo3d_quantize"] = (delta, lor.lorenzo3d_quantize_plain(xp, eb_i))
        pairs["lorenzo3d_reconstruct"] = (lor.lorenzo3d_reconstruct(delta, eb_i),
                                          lor.lorenzo3d_reconstruct_plain(delta, eb_i))
        words, widths = szf.fused_encode(xp, eb_i)
        words_p, widths_p = szf.fused_encode_plain(xp, eb_i)
        check(same(widths, widths_p), f"K3 widths differ from plain at {label}")
        pairs["fused_encode"] = (words, words_p)
        pairs["fused_decode"] = (szf.fused_decode(words, widths, tuple(xp.shape), eb_i),
                                 szf.fused_decode_plain(words, widths, tuple(xp.shape), eb_i))
        for name, (got, want) in pairs.items():
            err = max_abs_diff(got, want)
            check(same(got, want), f"{name} differs from plain at {label} (max |diff| {err})")
            worst[name] = max(worst[name], err)
        print(f"kernels vs plain at {label} {tuple(xp.shape)}: bitwise equal")
    return worst


def error_bound_ok(x, xr, eb: float) -> float:
    check(xr.shape == x.shape, f"shape {tuple(xr.shape)} != {tuple(x.shape)}")
    check(bool(torch.isfinite(xr).all()), "non-finite reconstruction")
    err = float((xr - x).abs().max())
    check(err <= eb * (1 + 1e-5), f"max |x̂ - x| = {err} > eb = {eb}")
    return err


def main_path(fields: dict, device) -> dict[str, int]:
    """The six fields through the default entry point (fused), then the xla
    path; returns each kernel's launches in the run of its path."""
    comp = get_compressor("tpu-sz")
    check(comp.device.type == "cuda", "the default compressor is not on CUDA")
    xs = {k: torch.from_numpy(v).to(device) for k, v in fields.items()}
    ebs = {k: REL_EB * float(v.max() - v.min()) for k, v in fields.items()}

    kernels.reset_launch_counts()
    fused = {}
    for name, x in xs.items():
        r = comp.compress(x, eb=ebs[name])
        xr = comp.decompress(r)
        check(r.meta.get("backend") == "kernel", "default backend on CUDA is not kernel")
        fused[name] = (r, xr)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches = {k: counts[k] for k in ("fused_encode", "fused_decode")}

    kernels.reset_launch_counts()
    for name, x in xs.items():
        packed, padded, eb_i = ops.sz_compress_kernel(x, ebs[name], path="xla")
        xr = ops.sz_decompress_kernel(packed, padded, x.shape, eb_i, path="xla")
        r, xr_f = fused[name]
        kp = r.payload["kpacked"]
        check(same(packed.words, kp.words) and same(packed.widths, kp.widths)
              and int(packed.total_bits) == int(kp.total_bits), f"{name}: fused and xla streams differ")
        check(same(xr, xr_f), f"{name}: fused and xla reconstructions differ")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches.update({k: counts[k] for k in ("lorenzo3d_quantize", "lorenzo3d_reconstruct")})
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    print("main path launches: " + json.dumps(launches))

    for name, x in xs.items():
        r, xr = fused[name]
        err = error_bound_ok(x, xr, ebs[name])
        orig, recon = fields[name], xr.cpu().numpy()
        d = metrics.distortion(orig, recon)
        ok, dev = spectrum.pk_gate(orig, recon)
        mb = r.raw_nbytes / 1e6
        rates = {}
        for what, fn in (("compress", lambda x=x, name=name: comp.compress(x, eb=ebs[name])),
                         ("decompress", lambda r=r: comp.decompress(r))):
            ms = sorted(cuda_times(fn, TIMING_ITERS))
            rates[what] = (f"{mb / statistics.median(ms) * 1e3:.1f}MB/s "
                           f"[{mb / ms[-1] * 1e3:.1f}..{mb / ms[0] * 1e3:.1f}]")
        print(f"{name:20s} eb={ebs[name]:.6g} ratio={r.ratio:.4f} bitrate={r.bitrate:.4f} "
              f"psnr={d.psnr:.4f}dB max_err={err:.6g} pk_gate={'PASS' if ok else 'FAIL'} "
              f"(dev {dev:.6f}) compress={rates['compress']} decompress={rates['decompress']}")
    return launches


def agrees_with_cpu(small: dict, device) -> None:
    """The card's streams and reconstructions equal the plain versions' on
    the CPU (which the tests hold to the JAX package) at 64^3."""
    gpu = get_compressor("tpu-sz", device=device)
    cpu = get_compressor("tpu-sz", backend="kernel", device="cpu")
    for name, v in small.items():
        eb = REL_EB * float(v.max() - v.min())
        rg, rc = gpu.compress(v, eb=eb), cpu.compress(v, eb=eb)
        pg, pc = rg.payload["kpacked"], rc.payload["kpacked"]
        check(same(pg.words, pc.words) and same(pg.widths, pc.widths)
              and rg.nbytes == rc.nbytes, f"{name}: card and CPU streams differ at {SMALL_N}^3")
        check(same(gpu.decompress(rg), cpu.decompress(rc)),
              f"{name}: card and CPU reconstructions differ at {SMALL_N}^3")
    torch.cuda.synchronize()
    print(f"card == plain CPU versions on the six {SMALL_N}^3 fields: streams and reconstructions")


def core_backend(baryon, vx, device) -> None:
    comp = get_compressor("tpu-sz", backend="core")
    x = torch.from_numpy(baryon).to(device)
    eb = REL_EB * float(baryon.max() - baryon.min())
    r = comp.compress(x, eb=eb)
    err = error_bound_ok(x, comp.decompress(r), eb)
    print(f"core backend baryon_density: ratio={r.ratio:.4f} max_err={err:.6g} (eb {eb:.6g})")

    v = torch.from_numpy(vx).to(device)
    r = comp.compress(v, pw_rel=PW_REL)
    vr = comp.decompress(r)
    check(vr.shape == v.shape and bool(torch.isfinite(vr).all()), "HACC vx: bad reconstruction")
    nz = v != 0
    rel = float((vr[nz] / v[nz] - 1.0).abs().max())
    check(rel <= PW_REL * 1.05, f"HACC vx: pointwise relative error {rel} > {PW_REL} x 1.05")
    check(bool((vr[~nz] == 0).all()), "HACC vx: exact zeros not kept")
    print(f"core backend HACC vx (grid {HACC_GRID}, pw_rel {PW_REL}): ratio={r.ratio:.4f} "
          f"max_rel_err={rel:.6g}")


def kernel_times(x, eb: float) -> dict[str, dict]:
    """Median ms of each kernel and of its plain version at the main path's
    256^3 shape, beside the bound from this run's bytes and operations."""
    xp = pad_to_tile(x)
    shape = tuple(xp.shape)
    n = xp.numel()
    nb = n // 64
    eb_i = lor.guarded_eb(xp, eb)
    delta = lor.lorenzo3d_quantize(xp, eb_i)
    words, widths = szf.fused_encode(xp, eb_i)
    payload_words = 2 * int(widths.sum())  # the words K4 must read for this data
    runs = {
        "lorenzo3d_quantize": (lambda: lor.lorenzo3d_quantize(xp, eb_i),
                               lambda: lor.lorenzo3d_quantize_plain(xp, eb_i), 8 * n),
        "lorenzo3d_reconstruct": (lambda: lor.lorenzo3d_reconstruct(delta, eb_i),
                                  lambda: lor.lorenzo3d_reconstruct_plain(delta, eb_i), 8 * n),
        "fused_encode": (lambda: szf.fused_encode(xp, eb_i),
                         lambda: szf.fused_encode_plain(xp, eb_i), 4 * n + 4 * 64 * nb + 4 * nb),
        "fused_decode": (lambda: szf.fused_decode(words, widths, shape, eb_i),
                         lambda: szf.fused_decode_plain(words, widths, shape, eb_i),
                         4 * payload_words + 4 * nb + 4 * n),
    }
    out = {}
    for name, (kernel, plain, nbytes) in runs.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_POINT[name] * n / INT32_OPS_PER_S * 1e3
        out[name] = {"ms": cuda_ms(kernel, TIMING_ITERS), "plain_ms": cuda_ms(plain, PLAIN_ITERS),
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "bytes": nbytes}
    return out


def stage_times(x, eb: float) -> dict[str, float]:
    """Median ms of each stage of one compress and one decompress of ``x`` at
    the main path's shape, on both paths, beside the whole entry-point calls,
    and the peak device memory of one entry-point call each."""
    comp = get_compressor("tpu-sz")
    xp = pad_to_tile(x)
    shape, n = tuple(xp.shape), xp.numel()
    eb_i = lor.guarded_eb(xp, eb)
    words, widths = szf.fused_encode(xp, eb_i)
    packed = szf._assemble_stream(words, widths, n)
    rows, rwidths = szf._disassemble_stream(packed)
    delta = lor.lorenzo3d_quantize(xp, eb_i)
    r = comp.compress(x, eb=eb)
    stages = {
        "fused.compress": lambda: comp.compress(x, eb=eb),
        "fused.compress.guarded_eb": lambda: lor.guarded_eb(xp, eb),
        "fused.compress.K3": lambda: szf.fused_encode(xp, eb_i),
        "fused.compress.assemble_stream": lambda: szf._assemble_stream(words, widths, n),
        "fused.compress.total_bits_readback": lambda: int(packed.total_bits),
        "fused.decompress": lambda: comp.decompress(r),
        "fused.decompress.disassemble_stream": lambda: szf._disassemble_stream(packed),
        "fused.decompress.K4": lambda: szf.fused_decode(rows, rwidths, shape, eb_i),
        "xla.compress.K1": lambda: lor.lorenzo3d_quantize(xp, eb_i),
        "xla.compress.pack_codes": lambda: bitpack.pack_codes(szf.tile_major_flatten(delta)),
        "xla.decompress.unpack_codes": lambda: szf.tile_major_unflatten(
            bitpack.unpack_codes(packed), shape),
        "xla.decompress.K2": lambda: lor.lorenzo3d_reconstruct(delta, eb_i),
    }
    out = {name: cuda_ms(fn, TIMING_ITERS) for name, fn in stages.items()}
    for name, fn in (("fused.compress.peak_mib", lambda: comp.compress(x, eb=eb)),
                     ("fused.decompress.peak_mib", lambda: comp.decompress(r))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        out[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
    return out


def run(device) -> dict:
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({len(logs)} sources compiled)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    fields = cosmo.nyx_fields(n=N, seed=SEED)
    print(f"nyx_fields(n={N}, seed={SEED}): {time.perf_counter() - t0:.2f} s")
    ebs = {k: REL_EB * float(v.max() - v.min()) for k, v in fields.items()}
    base = torch.from_numpy(fields["baryon_density"]).to(device)
    vx = torch.from_numpy(fields["vx"]).to(device)
    ragged = vx[: N - 56, : N - 126, : N - 6].contiguous()
    inputs = {f"{N}^3 baryon_density": (base, ebs["baryon_density"]),
              "ragged vx": (ragged, ebs["vx"])}
    worst = kernels_vs_plain(inputs)

    launches = main_path(fields, device)
    agrees_with_cpu(cosmo.nyx_fields(n=SMALL_N, seed=SEED), device)
    hacc = cosmo.hacc_particles(grid=HACC_GRID)
    core_backend(fields["baryon_density"], hacc.fields["vx"], device)

    stages = stage_times(base, ebs["baryon_density"])
    print(f"stages at {N}^3 baryon_density (median ms; peak MiB): " + json.dumps(stages))
    times = kernel_times(base, ebs["baryon_density"])
    rows = []
    for name, (kid, source, replaces) in KERNELS.items():
        t = times[name]
        rows.append({"name": f"{kid} {name}", "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None})
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    print(card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    report = run(torch.device("cuda"))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(report))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

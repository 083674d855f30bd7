#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of TPU-SZ, TPU-ZFP, the in-situ snapshot
path, Foresight, in-situ sharded compression and blockfloat8 serving on one
GPU and check every result.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; it builds the hand-written kernels from
``src/repro_torch/kernels/csrc`` at first use.  In order it:

1. prints the card's name and power limit (``nvidia-smi``) and the kernel
   build time;
2. holds each SZ kernel (K1-K4) against its plain PyTorch version on the
   card, at 256^3 and at a ragged shape, K1, K3 and K4 (K3 and K4 take and
   give the dense stream) also on the hard cases of ``data/sz_cases.py`` (every block
   at width 0, every block at width 32 from +-3e38, NaN and +inf, a ragged
   padded field, values whose quantized value leaves the int32 range),
   requiring bitwise equality of the words with their zero tail, the widths,
   ``total_bits`` and the reconstruction;
3. drives the SZ main path: the six ``nyx_fields(n=256, seed=42)`` fields
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
6. holds each ZFP kernel (K5-K7) against its plain version on the card, at
   the 256^3 baryon density and the ragged vx slice, and on hard blocks
   (+-inf, NaN, 3e38, saturated, zero, subnormal; 1, 31 and 1003 of them)
   at rates 1, 2, 4, 8, 16, 32 and 40, K7 also on streams whose every plane
   carries a full payload, requiring bitwise equality;
7. drives the ZFP main path: the six 256^3 fields through
   ``get_compressor("tpu-zfp")`` at rate 8 (CUDA, ``kernel`` backend,
   ``fused`` path: K6 then K7), then through the ``xla`` path (K5) and the
   ``core`` backend on the card, with the launch counts reset before each
   run and read after.  All three streams must be equal and the ratio
   exactly 4.0; prints PSNR, the power-spectrum gate and compress /
   decompress MB/s (median and range of 20 calls);
8. compresses the paper's 512^3 Nyx side, the 256^3 baryon density tiled
   2 x 2 x 2 on the card (Nyx fields are periodic), through the same entry
   point, whose reconstruction must be the 256^3 one tiled; prints MB/s and
   peak memory;
9. checks the card's ZFP streams against the plain versions on the CPU for
   the six 64^3 fields, and drives HACC ``x`` and ``vx`` (2^21 particles,
   one (32768, 8, 8) partition each) through ``tpu-zfp``;
10. holds K8 and K9 (the arena-batched SZ kernels) against their plain
    versions on the card, bitwise (arena, widths, offsets, counts,
    total_bits, used and the decoded rows), on four of the 256^3 fields (one
    bucket), on three (16, 128, 256) rows with three different bounds, on
    ``sz_cases.rows()`` (ratios more than 4x apart) and on rows at width 0
    and 32; each row's arena slice must be the one-field fused stream and
    K9's rows K4's;
11. drives the snapshot path: a state of the six 256^3 Nyx fields, the six
    HACC arrays (2^21 particles), the ragged vx slice and a 64^3 bfloat16
    baryon density, planned with ``plan_kernel_buckets`` then
    ``plan_buckets`` (the Nyx fields make two kernel buckets, 4 + 2 rows),
    compressed with ``szk_compress_bucket`` (K8) and
    ``sz_compress_bucket(staged=True)``, handed to
    ``CheckpointManager(async_save=True).save`` through ``to_host_async``,
    drained with ``wait()`` and restored on the card; the launch counts are
    reset just before and read just after (K8 exactly 2, K9 exactly 2 from
    ``szk_decompress_bucket``: one launch per bucket each way, since each
    writes or reads the whole arena).  Each leaf's bound is 1e-4 x its own value
    range, passed to the bucket coders as one bound per row.  Every row must
    hold codes (a nonzero
    block width), every row's stream must equal the one-field coder's, every
    restored leaf must lie within its bound in its dtype, and K9 must equal
    K4 per field.  Prints the ratio, the stall until
    ``save()`` returns, the wall and MB/s through ``wait()``, the restore
    MB/s, the peak device memory per kernel bucket, the snapshot stages and
    the files written; at small size the card's payload files must equal
    the plain CPU versions' byte for byte;
12. runs Foresight's CBench (``repro_torch.foresight.cbench.run_sweep``) on
    the card over the six 256^3 fields: ``tpu-sz`` at eb = {1e-2, 1e-3,
    1e-4} x value range and ``tpu-zfp`` at rates 4 and 8, 30 cases, warm-up
    1 and 3 timed calls each way; K3 and K4 must launch exactly 72 times and
    K6 and K7 48, every SZ case hold its bound, every ZFP ratio be 32/rate
    and the eb 1e-4 and rate 8 ratios equal phase 3's and 7's.  Prints each
    case's CBench MB/s (host clock, each call ended by a synchronise) beside
    the CUDA-event MB/s of phases 3 and 7, and writes the rows and a Cinema
    database to the gitignored ``chip_smoke_out/foresight/``;
13. runs the halo gate: ``hacc_particles(grid=64)`` positions (262144
    particles) through ``tpu-zfp`` at rates 8 and 16 on the card and on the
    CPU (streams and reconstructions bitwise equal), their FoF catalogs
    (equal), and ``guideline.evaluate_gates(particles=...)``; prints the
    halo counts and the worst deviation.  FoF and the P(k) gates of phase
    14 run on the host in a pool of spawned processes beside the card's
    work;
14. runs the §V-D guideline on the card: ``best_fit_per_field`` per 256^3
    field over the three SZ bounds must pick the passing configuration of
    highest ratio (the least-bad one where none passes), as the CBench
    reconstructions gated on the host say; at 64^3 the card's picks and
    ratios must equal the CPU's (the CPU pinned to the kernel backend's
    plain versions); then the port's workflow example
    (``examples/torch_foresight_workflow.py``) at n=64 on the card, its
    SLURM scripts and Cinema database written;
15. drives the in-situ sharded path (``repro_torch.dist.insitu``): in a
    one-rank NCCL group in this process the 256^3 baryon density through
    ``sz`` core + halo, ``sz`` kernel and ``zfp`` kernel must give the
    single-device entry points' streams and decodes, bitwise, K3, K4, K6
    and K7 once each; two-process ``gloo`` groups (``pod`` = 2, (128, 256,
    256) shards; both ranks on the one card, and again on the CPU), each
    rank this script run with ``--insitu-rank``, must gather equal streams
    on card and CPU, decode each shard and (``host_decode``) the whole
    field bitwise as the single device does, send only faces, scalars and
    compressed payloads (counted exactly), and launch each kernel once per
    shard; ``CheckpointManager`` saves every host stream as ``insitu-*``
    shard files and restores them on the card, bitwise;
16. prints each of these phases' wall time and their K3, K4, K6 and K7
    launches, which the kernel line below adds to the main paths';
17. holds K10 (decode attention over the blockfloat8 KV cache) against its
    plain version on the card: the dense entry at the reference tests'
    shapes (f32 query, rtol 2e-5 / atol 2e-6), and both entries at the
    serving shape (B=8, S=2048, H=24, Hkv=2, D=128, bf16 query, one lane at
    index -1, which must be exactly 0; the others within one bf16 ulp plus
    2e-6, and the same query in f32 within the f32 tolerance) and at
    S=32768 (``decode_32k``); the paged entry reads a pool of 16-token
    pages through a permuted page table with a page id used twice and an
    unmapped entry at the zero page, against the gather + plain K10;
18. serves starcoder2-3b at full width (random bf16 weights drawn on the
    card from a seeded ``torch.Generator``) through ``ServingEngine``:
    8 slots, max_len 2048, paged blockfloat8 pool of 16-token pages,
    greedy, ``attention="auto"``; 12 requests of 256-1024 prompt tokens
    (numpy seed) and 32 new tokens each, so 4 recycle a slot.  The launch
    counts are reset just before and read just after: K10 (its paged
    entry, reading the pool through the page table) must launch 30 times
    per decode step, ``layers._gather_pages`` must not run (the ``xla`` run
    below must run it), every request must get 32 tokens and the pool must
    be clean (``check_kv_integrity``).  A second run must repeat the
    tokens, and an ``attention="xla"`` run (plain attention) must give the
    same first token for every request (it comes from prefill).  Prints
    prefill ms, the median tick, decode tokens/s, K10's share of a tick,
    the pool's bytes, peak device memory and a profiled tick's kernel
    launches and device busy share.  TF32 is off throughout;
19. runs the SMOKE config on the card (K10) and on the CPU (K10's plain
    version, ``attention="fused"``) with the same parameters and prompts:
    greedy tokens agree in at least 6 of 8 per request
    (``tests/test_serving.py``'s bar).  The CPU's ``xla`` path is another
    function in bfloat16 (it rounds attention logits and probabilities to
    bfloat16, as the reference's does), so its agreement is printed only;
20. prints the ZFP stage times and one JSON line of per-kernel numbers for
    K1-K10 (launches, max difference from the plain version (K10's at the
    serving shape with its bf16 query), device ms at the main path's
    shapes from CUDA-graph replays (every wrapper captures), the plain
    version's ms, the bound (bytes at 3.35 TB/s, or the operations of the
    pipe that takes longest: 32-bit integer at 16.7 T/s, conversions and
    leading-zero counts at 4.2 T/s, float32 multiplies at 33.5 T/s), and
    for K10
    ``library_ms``: one ``F.scaled_dot_product_attention`` call over K/V
    dequantized to bf16 beforehand, the GQA repeat included; K10's row is
    its paged entry, the main path's, and its bound counts the page table's
    bytes; K10's dense entry, both at S=32768, K1's and K10's share of
    their bound and their registers and spills are printed before it) and,
    last, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; so does a machine without CUDA, and a
directory without the rest of the repository.
"""

from __future__ import annotations

import importlib.util
import json
import multiprocessing
import pickle
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))

# These fail, and the script exits non-zero, outside a checkout of the repository.
from repro_torch import kernels  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.analysis import halos, metrics, spectrum  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import arena  # noqa: E402
from repro_torch.core import bitpack  # noqa: E402
from repro_torch.core import sz as sz_core  # noqa: E402
from repro_torch.core import zfp as zfp_core  # noqa: E402
from repro_torch.core.api import get_compressor  # noqa: E402
from repro_torch.data import cosmo, kvc_cases, sz_cases, zfp_cases  # noqa: E402
from repro_torch.dist import insitu, sharding  # noqa: E402
from repro_torch.foresight import cbench, cinema, guideline  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import kvc_attention as k10  # noqa: E402
from repro_torch.kernels import lorenzo3d as lor  # noqa: E402
from repro_torch.kernels import sz_fused as szf  # noqa: E402
from repro_torch.kernels import zfp3d as k5  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import zfp_fused as zff  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models.spec import init_params, param_count  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine  # noqa: E402

from cuda_timing import cuda_ms, cuda_times, graph_ms  # noqa: E402  (tools/)

N = 256  # Nyx grid side of the main path
HACC_GRID = 128  # HACC particles per side of the core-backend check
SMALL_N = 64  # grid side of the CPU agreement check
SEED = 42
REL_EB = 1e-4  # eb = REL_EB x value range (10.0 on baryon density, as in quickstart)
PW_REL = 1e-2
ZFP_RATE = 8  # quickstart's rate
ZFP_CHECK_RATES = (1, 2, 4, 8, 16, 32, 40)  # rates of the kernel-vs-plain checks (one above 32)
ZFP_HARD_COUNTS = (1, 31, 1003)  # block counts of the hard-block checks: no multiple of a CTA's
TIMING_ITERS = 20  # timed calls (or CUDA-graph replays per round) per kernel, stage and field
PLAIN_ITERS = 3
SNAPSHOT_DIR = Path(__file__).resolve().parent / ".chip_smoke_snapshots"  # gitignored
K_ROWS = 4  # rows of the first kernel bucket: 4 x 2^24 points fill ROW_ELEM_BUDGET
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# Peak operation rates per pipe: 132 SMs at the 1.98 GHz boost clock, times
# the per-SM throughputs of compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instructions): 64 32-bit integer operations a clock
# (add, shift, logic, min/max), 16 conversions between float32 and int32 or
# leading-zero counts, 128 float32 multiplies.  The data sheet's 67 TFLOP/s
# FP32 counts an FMA as two operations on those 128 lanes; half of it is
# twice the INT32 pipe.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
CVT_OPS_PER_S = 132 * 16 * 1.98e9
F32_OPS_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores, an FMA as two (data sheet)
PIPE_OPS_PER_S = {"int32": INT32_OPS_PER_S, "cvt": CVT_OPS_PER_S,
                  "f32": F32_OPS_PER_S / 2}  # a multiply takes an FMA's slot
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores (data sheet)

ARCH = "starcoder2-3b"  # the JAX launcher's example (repro/launch/serve.py:8)
SERVE = dict(batch_slots=8, max_len=2048, page_size=16, codec="blockfloat8", paged=True)
SERVE_REQUESTS, SERVE_NEW, PROMPT_LEN = 12, 32, (256, 1024)
KVC_SERVE_SHAPE = (8, 2048, 24, 2, 128)  # B, S, H, Hkv, D at starcoder2-3b's serving
KVC_LONG_S = registry.SHAPES["decode_32k"].seq_len
SMOKE_REQUESTS, SMOKE_NEW = 4, 8

# Operations per point, by pipe: the least work the function needs, whatever
# a kernel issues (K3/K4 quantize a plane twice and scan with shuffles; none
# of that is charged).  int32: Lorenzo 7; zigzag 2, block max 1, packing 6;
# prefix sums 3; unpacking 6, unzigzag 3.  f32 and cvt: the quantizer's
# multiply and rounding conversion (the dequantizer's conversion and
# multiply), and the bit length's leading-zero count.  The stream's offsets
# (a scan of one width per 64 points) round to nothing per point.
# K8 and K9 do K3's and K4's work per point.
OPS_PER_POINT = {"lorenzo3d_quantize": {"int32": 7, "f32": 1, "cvt": 1},
                 "lorenzo3d_reconstruct": {"int32": 3, "f32": 1, "cvt": 1},
                 "fused_compress": {"int32": 16, "f32": 1, "cvt": 2},
                 "fused_decompress": {"int32": 12, "f32": 1, "cvt": 1}}
OPS_PER_POINT.update(fused_compress_batched=OPS_PER_POINT["fused_compress"],
                     fused_decompress_batched=OPS_PER_POINT["fused_decompress"])

# Operations the ZFP functions need per 64-point block, by pipe, counted as
# the least work one thread's registers allow, whatever a kernel issues: no
# idle lanes, no loop or address work; data moves (loads, stores, the
# sequency permutation) count 0, and a three-input logic function, a funnel
# shift or a byte permute counts one, as each is one instruction.
# Stages 1-3 (K5, K6): |x| 64 and their max 63 over the IEEE bits, the
# exponent, nonzero test and scale bits 6, 48 four-point lifts of 16,
# negabinary 2 a point; the scale multiply and the rounding, 1 a point each.
ZFP_FORWARD = {"int32": 64 + 63 + 6 + 48 * 16 + 64 * 2, "f32": 64, "cvt": 64}
# Group tops: each group's OR by three-input ORs (sizes 1, 3, 6, 10, 12, 12,
# 10, 6, 3, 1: 30), then its bit length, a leading-zero count and a subtract.
ZFP_TOPS = {"int32": 30 + 10, "cvt": 10}
# K7's stages 1-3 inverted: negabinary 2 a point, 48 inverse lifts of 16, the
# scale bits 4; the conversion and the scale multiply, 1 a point each.
ZFP_INVERSE = {"int32": 64 * 2 + 48 * 16 + 4, "f32": 64, "cvt": 64}
# The coder (K6, K7), all int32.  Per block: two 32x32 bit transposes
# (Hacker's Delight 7-3), each 2 rounds of 32 byte permutes and 3 rounds of
# 16 word pairs at 4 (two shifts, two three-input selects); the layout: each
# group's entry plane 10, the first of them 9, the plane width as each group
# enters 10, and at the plane that spends the budget its kept width 2 and
# two masks 4.
ZFP_CODER_BLOCK = 2 * (2 * 32 + 3 * 16 * 4) + (10 + 9 + 10 + 6)
# Per plane that keeps bits: the budget test, the offset's advance, its word
# and shift 4; the encoder then places the payload (shift and merge into the
# word it carries 2, two funnel shifts 2, the next carried word 2), the
# decoder fetches it (two funnel shifts 2).
ZFP_ENC_PLANE, ZFP_DEC_PLANE = 4 + 6, 4 + 2
# Per group absent from such a plane (a present group costs nothing): its
# test, and squeezing its zero run out (or putting it back), a funnel shift,
# a shift and a three-input merge.  Plane and run counts come from this
# run's headers.
ZFP_ABSENT_RUN = 4


def add_ops(*parts) -> dict[str, int]:
    """Sum of ``(count, {pipe: operations})`` parts, per pipe."""
    out: dict[str, int] = {}
    for count, ops in parts:
        for pipe, v in ops.items():
            out[pipe] = out.get(pipe, 0) + count * v
    return out


def zfp_ops(gtops, rate: int) -> dict[str, dict[str, int]]:
    """Operations per pipe that K5, K6 and K7 need on the blocks whose
    headers are ``gtops`` at ``rate``: the coder's share follows the planes
    that keep bits and the groups absent from them."""
    nb = gtops.shape[0]
    _, keep = zfp_core._plane_offsets(gtops, rate * 64 - zfp_core._HEADER_BITS)
    kept = keep > 0
    planes = torch.arange(32, device=gtops.device)
    absent = gtops.to(torch.int64)[:, None, :] + planes[None, :, None] < 32
    n_kept, n_absent = int(kept.sum()), int((absent & kept[..., None]).sum())
    transform = [(nb, ZFP_FORWARD), (nb, ZFP_TOPS)]
    coder = [(nb, {"int32": ZFP_CODER_BLOCK}), (n_absent, {"int32": ZFP_ABSENT_RUN})]
    return {"zfp3d_transform": add_ops(*transform),
            "fused_compress_blocks": add_ops(*transform, *coder,
                                             (n_kept, {"int32": ZFP_ENC_PLANE})),
            "fused_decompress_blocks": add_ops((nb, ZFP_INVERSE), *coder,
                                               (n_kept, {"int32": ZFP_DEC_PLANE}))}


KERNELS = {
    "lorenzo3d_quantize": ("K1", "src/repro_torch/kernels/csrc/lorenzo3d.cu",
                           "src/repro/kernels/lorenzo3d.py:72"),
    "lorenzo3d_reconstruct": ("K2", "src/repro_torch/kernels/csrc/lorenzo3d.cu",
                              "src/repro/kernels/lorenzo3d.py:101"),
    "fused_compress": ("K3", "src/repro_torch/kernels/csrc/sz_fused.cu",
                       "src/repro/kernels/sz_fused.py:177"),
    "fused_decompress": ("K4", "src/repro_torch/kernels/csrc/sz_fused.cu",
                         "src/repro/kernels/sz_fused.py:336"),
    "zfp3d_transform": ("K5", "src/repro_torch/kernels/csrc/zfp3d.cu",
                        "src/repro/kernels/zfp3d.py:116"),
    "fused_compress_blocks": ("K6", "src/repro_torch/kernels/csrc/zfp_fused.cu",
                              "src/repro/kernels/zfp_fused.py:84"),
    "fused_decompress_blocks": ("K7", "src/repro_torch/kernels/csrc/zfp_fused.cu",
                                "src/repro/kernels/zfp_fused.py:161"),
    "fused_compress_batched": ("K8", "src/repro_torch/kernels/csrc/sz_fused.cu",
                               "src/repro/kernels/sz_fused.py:238"),
    "fused_decompress_batched": ("K9", "src/repro_torch/kernels/csrc/sz_fused.cu",
                                 "src/repro/kernels/sz_fused.py:361"),
    "kvc_decode_attention": ("K10", "src/repro_torch/kernels/csrc/kvc_attention.cu",
                             "src/repro/kernels/kvc_attention.py:68"),
}
SZ_KERNELS = ("lorenzo3d_quantize", "lorenzo3d_reconstruct", "fused_compress", "fused_decompress")


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


def pad_to_tile(x):
    pads = [(-s) % t for s, t in zip(x.shape, lor.TILE)]
    return F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0])).contiguous()


def hold_stream(got, want, label: str) -> float:
    """Two SZ streams equal word for word (zero tail included), width for
    width and in total_bits; returns the largest word difference (0)."""
    check(same(got.widths, want.widths), f"K3 widths differ from plain at {label}")
    check(got.total_bits.dtype == torch.int64 and int(got.total_bits) == int(want.total_bits),
          f"K3 total_bits {int(got.total_bits)} != {int(want.total_bits)} at {label}")
    err = max_abs_diff(got.words, want.words)
    check(same(got.words, want.words), f"K3 words differ from plain at {label} (max |diff| {err})")
    return err


def kernels_vs_plain(inputs: dict, device) -> dict[str, float]:
    """Each kernel against its plain version on the same CUDA inputs; bitwise
    equality required, K3/K4 also on the hard cases of ``sz_cases``.  Returns
    the largest difference per kernel (0)."""
    worst = {name: 0.0 for name in SZ_KERNELS}

    def hold_k3_k4(xp, eb_i, label):
        packed = szf.fused_compress(xp, eb_i)
        worst["fused_compress"] = max(worst["fused_compress"], hold_stream(
            packed, szf.fused_compress_plain(xp, eb_i), label))
        got = szf.fused_decompress(packed, tuple(xp.shape), eb_i)
        want = szf.fused_decompress_plain(packed, tuple(xp.shape), eb_i)
        err = max_abs_diff(got, want)
        check(same(got, want), f"fused_decompress differs from plain at {label} (max |diff| {err})")
        worst["fused_decompress"] = max(worst["fused_decompress"], err)

    for label, (x, eb) in inputs.items():
        xp = pad_to_tile(x)
        eb_i = lor.guarded_eb(xp, eb)
        delta = lor.lorenzo3d_quantize(xp, eb_i)
        pairs = {"lorenzo3d_quantize": (delta, lor.lorenzo3d_quantize_plain(xp, eb_i)),
                 "lorenzo3d_reconstruct": (lor.lorenzo3d_reconstruct(delta, eb_i),
                                           lor.lorenzo3d_reconstruct_plain(delta, eb_i))}
        for name, (got, want) in pairs.items():
            err = max_abs_diff(got, want)
            check(same(got, want), f"{name} differs from plain at {label} (max |diff| {err})")
            worst[name] = max(worst[name], err)
        hold_k3_k4(xp, eb_i, label)
        print(f"kernels vs plain at {label} {tuple(xp.shape)}: bitwise equal")
    for label, (x, eb_i) in sz_cases.cases(SEED).items():
        x, eb_i = x.to(device), eb_i.to(device)
        got, want = lor.lorenzo3d_quantize(x, eb_i), lor.lorenzo3d_quantize_plain(x, eb_i)
        check(same(got, want), f"lorenzo3d_quantize differs from plain at {label}")
        hold_k3_k4(x, eb_i, label)
    print(f"K1 and K3/K4 vs plain on the hard cases {list(sz_cases.cases(SEED))}: K1's residuals, "
          "K3/K4's streams (zero tail included), widths, total_bits and reconstructions bitwise "
          "equal")
    return worst


def zfp_kernels_vs_plain(inputs: dict, device) -> dict[str, float]:
    """K5-K7 against their plain versions on the same CUDA inputs, at every
    rate of ZFP_CHECK_RATES: on each field's blocks, on the hard blocks at
    ZFP_HARD_COUNTS, and K7 on full-payload streams; bitwise equality
    required."""
    worst = {"zfp3d_transform": 0.0, "fused_compress_blocks": 0.0,
             "fused_decompress_blocks": 0.0}

    def hold(name, got, want, label):
        for g, w in zip(got, want):
            err = max_abs_diff(g, w)
            check(same(g, w), f"{name} differs from plain at {label} (max |diff| {err})")
            worst[name] = max(worst[name], err)

    def hold_all(label, blocks):
        hold("zfp3d_transform", k5.zfp3d_transform(blocks), k5.zfp3d_transform_plain(blocks),
             label)
        for rate in ZFP_CHECK_RATES:
            enc = zff.fused_compress_blocks(blocks, rate)
            hold("fused_compress_blocks", enc, zff.fused_compress_blocks_plain(blocks, rate),
                 f"{label} rate {rate}")
            hold("fused_decompress_blocks", [zff.fused_decompress_blocks(*enc, rate)],
                 [zff.fused_decompress_blocks_plain(*enc, rate)], f"{label} rate {rate}")

    for label, x in inputs.items():
        hold_all(label, zfp_core._carve_blocks(x))
        print(f"ZFP kernels vs plain at {label} {tuple(x.shape)}, rates {ZFP_CHECK_RATES}: "
              "bitwise equal")
    for nb in ZFP_HARD_COUNTS:
        blocks = zfp_cases.hard_blocks(nb, SEED + nb).to(device)
        hold_all(f"{nb} hard blocks", blocks)
        for rate in ZFP_CHECK_RATES:
            full = [t.to(device) for t in zfp_cases.full_streams(nb, rate, SEED + nb + rate)]
            hold("fused_decompress_blocks", [zff.fused_decompress_blocks(*full, rate)],
                 [zff.fused_decompress_blocks_plain(*full, rate)],
                 f"{nb} full-payload streams rate {rate}")
    print(f"ZFP kernels vs plain on the hard blocks (+-inf, NaN, 3e38, saturated, zero, "
          f"subnormal) at {ZFP_HARD_COUNTS} blocks and K7 on full-payload streams, rates "
          f"{ZFP_CHECK_RATES}: bitwise equal")
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
    launches = {k: counts[k] for k in ("fused_compress", "fused_decompress")}

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
        rates = rate_line(comp, lambda: comp.compress(x, eb=ebs[name]), r, ("tpu-sz", name),
                          {"eb": ebs[name]})
        print(f"{name:20s} eb={ebs[name]:.6g} ratio={r.ratio:.4f} bitrate={r.bitrate:.4f} "
              f"psnr={d.psnr:.4f}dB max_err={err:.6g} pk_gate={'PASS' if ok else 'FAIL'} "
              f"(dev {dev:.6f}) {rates}")
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


def rate_line(comp, compress, r, key=None, config=None) -> str:
    """Compress and decompress MB/s of one field: median [slowest..fastest]
    of TIMING_ITERS CUDA-event-timed entry-point calls after a warm-up;
    ``compress()`` compresses the field, ``r`` is its result.  With a
    ``key``, the medians, ratio and ``config`` are kept in ``EVENT_MBS`` for
    the CBench phase to print beside its own."""
    mb = r.raw_nbytes / 1e6
    out, med = [], {}
    for what, fn in (("compress", compress), ("decompress", lambda: comp.decompress(r))):
        ms = sorted(cuda_times(fn, TIMING_ITERS))
        med[what] = mb / statistics.median(ms) * 1e3
        out.append(f"{what}={med[what]:.1f}MB/s "
                   f"[{mb / ms[-1] * 1e3:.1f}..{mb / ms[0] * 1e3:.1f}]")
    if key is not None:
        EVENT_MBS[key] = {**med, "ratio": r.ratio, "config": config}
    return " ".join(out)


def peak_mib(fn) -> float:
    """Peak device memory of one call of ``fn`` above what was allocated before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def same_zfp(a, b) -> bool:
    return (same(a.words, b.words) and same(a.emax, b.emax) and same(a.gtops, b.gtops)
            and tuple(a.shape) == tuple(b.shape) and a.rate == b.rate)


def zfp_main_path(fields: dict, device) -> dict[str, int]:
    """The six fields through the default ``tpu-zfp`` entry point (fused),
    then the xla path and the core backend on the card; returns each
    kernel's launches in the run of its path."""
    comp = get_compressor("tpu-zfp")
    check(comp.device.type == "cuda", "the default ZFP compressor is not on CUDA")
    xs = {k: torch.from_numpy(v).to(device) for k, v in fields.items()}

    kernels.reset_launch_counts()
    fused = {}
    for name, x in xs.items():
        r = comp.compress(x, rate=ZFP_RATE)
        fused[name] = (r, comp.decompress(r))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches = {k: counts[k] for k in ("fused_compress_blocks", "fused_decompress_blocks")}

    kernels.reset_launch_counts()
    for name, x in xs.items():
        c = ops.zfp_compress_kernel(x, ZFP_RATE, path="xla")
        r, xr = fused[name]
        check(same_zfp(c, r.payload["parts"][0]), f"{name}: ZFP fused and xla streams differ")
        check(same(ops.zfp_decompress_kernel(c, path="xla"), xr),
              f"{name}: ZFP fused and xla reconstructions differ")
    torch.cuda.synchronize()
    launches["zfp3d_transform"] = kernels.launch_counts()["zfp3d_transform"]
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the ZFP main path")
    print("ZFP main path launches: " + json.dumps(launches))

    core = get_compressor("tpu-zfp", backend="core")
    for name, x in xs.items():
        rc = core.compress(x, rate=ZFP_RATE)
        r, xr = fused[name]
        check(same_zfp(rc.payload["parts"][0], r.payload["parts"][0]),
              f"{name}: ZFP fused and core streams differ")
        check(same(core.decompress(rc), xr), f"{name}: ZFP fused and core reconstructions differ")
    print("ZFP fused == xla == core on the card: streams and reconstructions, six fields")

    for name, x in xs.items():
        r, xr = fused[name]
        check(r.meta.get("backend") == "kernel", "default ZFP backend on CUDA is not kernel")
        check(r.ratio == 4.0, f"{name}: ZFP ratio {r.ratio} != 32 / {ZFP_RATE}")
        check(xr.shape == x.shape and bool(torch.isfinite(xr).all()),
              f"{name}: bad ZFP reconstruction")
        orig, recon = fields[name], xr.cpu().numpy()
        d = metrics.distortion(orig, recon)
        ok, dev = spectrum.pk_gate(orig, recon)
        rates = rate_line(comp, lambda: comp.compress(x, rate=ZFP_RATE), r, ("tpu-zfp", name),
                          {"rate": ZFP_RATE})
        print(f"zfp {name:20s} rate={ZFP_RATE} ratio={r.ratio:.4f} bitrate={r.bitrate:.4f} "
              f"psnr={d.psnr:.4f}dB max_err={d.max_abs_err:.6g} "
              f"pk_gate={'PASS' if ok else 'FAIL'} (dev {dev:.6f}) {rates}")
    return launches


def zfp_nyx_512(base) -> None:
    """The paper's 512^3 Nyx side: the 256^3 field tiled 2 x 2 x 2 on the
    card.  256 is a multiple of 4, so every block of the tiled field is a
    block of the 256^3 one and the reconstruction is the 256^3 one tiled."""
    comp = get_compressor("tpu-zfp")
    x = base.repeat(2, 2, 2)
    r = comp.compress(x, rate=ZFP_RATE)
    xr = comp.decompress(r)
    check(r.ratio == 4.0 and r.payload["parts"][0].words.shape[0] == 2**21,
          f"512^3: ratio {r.ratio}, blocks {r.payload['parts'][0].words.shape[0]}")
    small = comp.decompress(comp.compress(base, rate=ZFP_RATE))
    check(same(xr, small.repeat(2, 2, 2)), "512^3 reconstruction is not the 256^3 one tiled")
    pc = peak_mib(lambda: comp.compress(x, rate=ZFP_RATE))
    pd = peak_mib(lambda: comp.decompress(r))
    rates = rate_line(comp, lambda: comp.compress(x, rate=ZFP_RATE), r)
    print(f"zfp 512^3 tiled baryon_density rate={ZFP_RATE} ratio={r.ratio:.4f} "
          f"{rates} peak_mib compress={pc:.1f} decompress={pd:.1f}")


def zfp_agrees_with_cpu(small: dict, device) -> None:
    gpu = get_compressor("tpu-zfp", device=device)
    cpu = get_compressor("tpu-zfp", backend="kernel", device="cpu")
    for name, v in small.items():
        rg, rc = gpu.compress(v, rate=ZFP_RATE), cpu.compress(v, rate=ZFP_RATE)
        check(same_zfp(rg.payload["parts"][0], rc.payload["parts"][0]) and rg.nbytes == rc.nbytes,
              f"{name}: card and CPU ZFP streams differ at {SMALL_N}^3")
        check(same(gpu.decompress(rg), cpu.decompress(rc)),
              f"{name}: card and CPU ZFP reconstructions differ at {SMALL_N}^3")
    torch.cuda.synchronize()
    print(f"ZFP card == plain CPU versions on the six {SMALL_N}^3 fields: streams and "
          "reconstructions")


def zfp_hacc(hacc, device) -> None:
    """HACC x and vx (one partition each, (N/64) x 8 x 8) through tpu-zfp,
    the stream held to the core backend on the card."""
    comp = get_compressor("tpu-zfp")
    core = get_compressor("tpu-zfp", backend="core")
    for name in ("x", "vx"):
        v = torch.from_numpy(hacc.fields[name]).to(device)
        r = comp.compress(v, rate=ZFP_RATE)
        vr = comp.decompress(r)
        part = r.payload["parts"][0]
        check(tuple(part.shape) == (v.shape[0] // 64, 8, 8), f"HACC {name}: shape {part.shape}")
        check(same_zfp(part, core.compress(v, rate=ZFP_RATE).payload["parts"][0]),
              f"HACC {name}: ZFP kernel and core streams differ")
        check(vr.shape == v.shape and bool(torch.isfinite(vr).all()),
              f"HACC {name}: bad reconstruction")
        d = metrics.distortion(hacc.fields[name], vr.cpu().numpy())
        rates = rate_line(comp, lambda: comp.compress(v, rate=ZFP_RATE), r)
        print(f"zfp HACC {name} (grid {HACC_GRID}, {v.shape[0]} particles, "
              f"{part.words.shape[0]} blocks) rate={ZFP_RATE} ratio={r.ratio:.4f} "
              f"psnr={d.psnr:.4f}dB {rates}")


def zfp_stage_times(x) -> dict[str, float]:
    """Median ms of each stage of one ZFP compress and decompress of ``x``
    on both paths (CUDA-graph replays), beside the whole entry-point calls
    (event pairs), and the peak device memory of one entry-point call each."""
    comp = get_compressor("tpu-zfp")
    r = comp.compress(x, rate=ZFP_RATE)
    c = r.payload["parts"][0]
    blocks = zfp_core._carve_blocks(x)
    dec = zff.fused_decompress_blocks(c.words, c.emax, c.gtops, ZFP_RATE)
    u, _, gtops = k5.zfp3d_transform(blocks)
    perm = zfp_core._index(zfp_core.PERM, x.device)
    entry = {
        "zfp.fused.compress": lambda: comp.compress(x, rate=ZFP_RATE),
        "zfp.fused.decompress": lambda: comp.decompress(r),
        "zfp.xla.decompress.core_decompress": lambda: zfp_core.decompress(c),
    }
    stages = {
        "zfp.fused.compress.carve": lambda: zfp_core._carve_blocks(x),
        "zfp.fused.compress.K6": lambda: zff.fused_compress_blocks(blocks, ZFP_RATE),
        "zfp.fused.decompress.K7": lambda: zff.fused_decompress_blocks(
            c.words, c.emax, c.gtops, ZFP_RATE),
        "zfp.fused.decompress.uncarve": lambda: zfp_core._uncarve_blocks(dec, c.shape),
        "zfp.xla.compress.K5": lambda: k5.zfp3d_transform(blocks),
        "zfp.xla.compress.permute+encode_words": lambda: zfp_core.encode_words(
            u.view(torch.int32)[:, perm], gtops, ZFP_RATE),
    }
    # the entry points event-timed per call (their host work, index copies
    # included, is part of them); the stages, which neither sync nor copy
    # from the host, from CUDA-graph replays
    out = {name: cuda_ms(fn, TIMING_ITERS) for name, fn in entry.items()}
    out.update({name: graph_ms(fn) for name, fn in stages.items()})
    out["zfp.fused.compress.peak_mib"] = peak_mib(lambda: comp.compress(x, rate=ZFP_RATE))
    out["zfp.fused.decompress.peak_mib"] = peak_mib(lambda: comp.decompress(r))
    return out


# ------------------------------------------------ K8 / K9 and snapshots ----


def same_stream(h, i: int, packed) -> bool:
    """Row ``i`` of host arena ``h`` is ``packed``'s stored stream."""
    ref = bitpack.to_storage(packed)
    ls = arena.leaf_stream(h, i)
    return (ls["words"].shape == ref["words"].shape and bool((ls["words"] == ref["words"]).all())
            and bool((ls["widths"] == ref["widths"]).all())
            and ls["total_bits"] == int(packed.total_bits))


def batched_vs_plain(inputs: dict) -> dict[str, float]:
    """K8 and K9 against their plain versions on the same CUDA inputs,
    bitwise (the arena with its zero tail and every sidecar, the decoded
    rows); each row's arena slice against the one-field fused stream (K3)
    and K9's rows against K4's."""
    worst = {"fused_compress_batched": 0.0, "fused_decompress_batched": 0.0}
    for label, (x, eb_i) in inputs.items():
        shape = tuple(x.shape[1:])
        enc = szf.fused_compress_batched(x, eb_i)
        for what, got, want in zip(("arena", "widths", "offsets", "counts", "total_bits", "used"),
                                   enc, szf.fused_compress_batched_plain(x, eb_i)):
            err = max_abs_diff(got, want)
            check(same(got, want), f"K8 {what} differs from plain at {label} (max |diff| {err})")
            worst["fused_compress_batched"] = max(worst["fused_compress_batched"], err)
        ar, wrows, offs, counts, tbits, used = enc
        rows = szf.fused_decompress_batched(ar, wrows, shape, eb_i)
        want = szf.fused_decompress_batched_plain(ar, wrows, shape, eb_i)
        err = max_abs_diff(rows, want)
        check(same(rows, want), f"K9 differs from plain at {label} (max |diff| {err})")
        worst["fused_decompress_batched"] = max(worst["fused_decompress_batched"], err)
        del want
        pos = 0
        for b in range(x.shape[0]):
            packed = szf.fused_compress(x[b], eb_i[b])
            ref = bitpack.to_storage(packed)
            cnt = int(counts[b])
            check(int(offs[b]) == pos and cnt == ref["words"].shape[0]
                  and same(ar[pos:pos + cnt], torch.from_numpy(ref["words"].view("int32")))
                  and same(wrows[b], packed.widths) and int(tbits[b]) == int(packed.total_bits),
                  f"row {b} of the K8 arena is not the fused one-field stream at {label}")
            check(same(rows[b], szf.fused_decompress(packed, shape, eb_i[b])),
                  f"row {b} of K9 differs from K4 at {label}")
            pos += cnt
        check(int(used) == pos, f"K8 arena used {int(used)} != {pos} at {label}")
        print(f"K8/K9 vs plain at {label} {tuple(x.shape)}: bitwise equal; rows equal the "
              "one-field K3/K4 streams")
    return worst


def snapshot_state(fields: dict, hacc, small: dict, device) -> dict:
    """The in-situ snapshot's state: six Nyx fields, six HACC arrays, the
    ragged vx slice (flat route) and a 64^3 bfloat16 baryon density."""
    vx = torch.from_numpy(fields["vx"]).to(device)
    return {"nyx": {k: torch.from_numpy(v).to(device) for k, v in fields.items()},
            "hacc": {k: torch.from_numpy(hacc.fields[k]).to(device) for k in cosmo.HACC_FIELDS},
            "vx_ragged": vx[:200, :130, :250].contiguous(),
            "baryon64_bf16": torch.from_numpy(small["baryon_density"]).to(device).to(torch.bfloat16)}


def plan_snapshot(state: dict):
    """Kernel buckets first (``plan_kernel_buckets``), the rest flat.  Each
    leaf's absolute bound is 1e-4 x its own value range (range / eb = 1e4,
    inside the guarded regime), as the one-field phases set it; a bucket's
    bounds are one float32 tensor [rows] on the leaves' device, so the
    snapshot makes no host-to-device copy for them.  Returns the leaves,
    the kernel and flat buckets, and each bucket's bounds."""
    leaves = dict(tree_util.tree_flatten_with_path(state)[0])
    entries = [(name, tuple(x.shape), x.dtype) for name, x in leaves.items()
               if arena.is_float_leaf(x)]
    kbuckets, rest = insitu.plan_kernel_buckets(entries)
    fbuckets = arena.plan_buckets(rest)

    def bucket_eb(b):
        ebs = [REL_EB * float(leaves[n].float().max() - leaves[n].float().min())
               for n in b.names]
        return torch.tensor(ebs, dtype=torch.float32, device=leaves[b.names[0]].device)

    return (leaves, kbuckets, fbuckets, [bucket_eb(b) for b in kbuckets],
            [bucket_eb(b) for b in fbuckets])


def snapshot(leaves: dict, kbuckets, fbuckets, keb: list, feb: list, mgr, step: int,
             device=None):
    """One in-situ snapshot: every bucket compressed on ``device`` (one K8
    launch per kernel bucket on the card), its D2H deferred, and the whole
    snapshot handed to the manager's drain thread.  Returns the state
    handed to ``save`` and the device arenas."""
    snap, arenas = {}, {}
    for k, (b, eb) in enumerate(zip(kbuckets, keb)):
        a = arena.szk_compress_bucket([leaves[n] for n in b.names], b, eb, device=device)
        snap[f"karena{k:03d}"] = arena.to_host_async(a, b, codec=arena.CODEC_SZK)
        arenas[f"karena{k:03d}"] = (a, b)
    for k, (b, eb) in enumerate(zip(fbuckets, feb)):
        a = arena.sz_compress_bucket([leaves[n] for n in b.names], b, eb, staged=True,
                                     device=device)
        snap[f"farena{k:03d}"] = arena.to_host_async(a, b)
        arenas[f"farena{k:03d}"] = (a, b)
    mgr.save(step, snap)
    return snap, arenas


def snapshot_path(fields: dict, hacc, small: dict, device) -> dict[str, int]:
    """The snapshot main path at full size (module docstring, phase 11);
    returns K8's and K9's launches in its run."""
    state = snapshot_state(fields, hacc, small, device)
    leaves, kbuckets, fbuckets, keb, feb = plan_snapshot(state)
    check([b.rows for b in kbuckets] == [K_ROWS, 6 - K_ROWS]
          and all(n.startswith("['nyx']") for b in kbuckets for n in b.names),
          f"kernel buckets {[b.names for b in kbuckets]}")
    check(sum(b.rows for b in fbuckets) == 8, f"flat buckets {[b.names for b in fbuckets]}")
    raw = sum(b.nbytes_raw for b in kbuckets + fbuckets)
    print(f"snapshot plan: kernel buckets {[b.rows for b in kbuckets]}, flat buckets "
          f"{[(b.rows, b.padded) for b in fbuckets]} (rows, P), eb per row "
          f"{[[float(f'{e:.6g}') for e in eb.tolist()] for eb in keb + feb]}, "
          f"{raw / 2**20:.1f} MiB raw; zstd {'on' if ckpt._zstd is not None else 'off'}")
    shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)
    mgr = ckpt.CheckpointManager(SNAPSHOT_DIR, keep_last=3, async_save=True)
    like = {f"{p}arena{k:03d}": 0 for p, bs in (("k", kbuckets), ("f", fbuckets))
            for k in range(len(bs))}

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    snap, arenas = snapshot(leaves, kbuckets, fbuckets, keb, feb, mgr, 1)
    ebs = {f"{p}arena{k:03d}": eb for p, eb_list in (("k", keb), ("f", feb))
           for k, eb in enumerate(eb_list)}
    res = mgr.wait()
    out, _ = mgr.restore(step=1, state_like=like)
    decoded = {k: arena.szk_decompress_bucket(*arenas[k]) for k in arenas if k[0] == "k"}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches = {k: counts[k] for k in ("fused_compress_batched", "fused_decompress_batched")}
    print("snapshot path launches: " + json.dumps({k: v for k, v in counts.items() if v}))
    # one K8 launch per kernel bucket (it writes the bucket's whole arena) and
    # one K9 launch per bucket decoded by szk_decompress_bucket
    check(launches == {"fused_compress_batched": 2, "fused_decompress_batched": 2},
          f"K8/K9 launches per snapshot {launches}, want 2 and 2")
    check(res.step == 1 and res.nbytes_raw == raw, f"save result {res}")

    worst = {"arena-szk": 0.0, "arena-sz": 0.0}
    for key, (a, b) in arenas.items():
        h = snap[key].result()  # resolved on the drain thread; cached
        codec = arena.CODEC_SZK if key[0] == "k" else arena.CODEC_SZ
        check(h.codec == codec, f"{key}: codec {h.codec}")
        flat_rows = None if key[0] == "k" else arena.sz_decode_rows(
            a.arena, a.widths, a.offsets, a.counts, a.eb_i)
        for i, name in enumerate(b.names):
            x = leaves[name]
            eb = float(ebs[key][i])  # the row's float32 bound
            got = out[key][name]
            check(got.dtype == x.dtype and tuple(got.shape) == tuple(x.shape) and not got.is_cuda,
                  f"{name}: restored {got.dtype} {tuple(got.shape)}")
            check(bool(a.widths[i].any()), f"{name}: every block width is 0 at eb {eb}")
            if key[0] == "k":
                packed, padded, eb_i = ops.sz_compress_kernel(x, eb)
                check(same_stream(h, i, packed), f"{name}: arena row != fused one-field stream")
                k4 = ops.sz_decompress_kernel(packed, padded, x.shape, eb_i, path="fused")
                check(same(decoded[key][i], k4), f"{name}: K9 differs from K4")
                check(same(got, k4), f"{name}: restored (K2 path) differs from K4")
                xf = x
            else:
                xf = x.float().reshape(-1)
                check(same_stream(h, i, sz_core.compress(xf, eb).packed),
                      f"{name}: arena row != sz.compress on the flat leaf")
                dec = flat_rows[i, :xf.numel()].reshape(x.shape)
                check(same(got, dec.to(x.dtype)), f"{name}: restored leaf != its decoded row")
                got, xf = dec, x.float()  # the bound holds before a bf16 cast
            err = float((got.to(device).float() - xf.float()).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= eb * (1 + 1e-5),
                  f"{name}: max |x^ - x| = {err} > eb = {eb}")
            worst[codec] = max(worst[codec], err / eb)
    print(f"snapshot step 1: every row holds codes and equals its one-field stream; restored "
          f"leaves within eb (max err/eb: {json.dumps(worst)}); K9 == K4 == restore per Nyx "
          "field")
    del out, decoded, snap, arenas

    # timed snapshot (allocator and pinned pools warm), then timed restore
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap, arenas = snapshot(leaves, kbuckets, fbuckets, keb, feb, mgr, 2)
    stall = time.perf_counter() - t0
    res = mgr.wait()
    wall = time.perf_counter() - t0
    del snap, arenas
    t0 = time.perf_counter()
    out, _ = mgr.restore(step=2, state_like=like)
    restore_s = time.perf_counter() - t0
    files = {p.name: p.stat().st_size for p in sorted((SNAPSHOT_DIR / "step_000000002").iterdir())}
    print(f"snapshot step 2: ratio={res.ratio:.4f} raw={res.nbytes_raw} stored={res.nbytes_stored} "
          f"save_returns_ms={stall * 1e3:.3f} wall_ms={wall * 1e3:.3f} "
          f"MB/s={res.nbytes_raw / 1e6 / wall:.1f} restore_ms={restore_s * 1e3:.3f} "
          f"restore_MB/s={res.nbytes_raw / 1e6 / restore_s:.1f}")
    print("snapshot files (bytes): " + json.dumps(files))
    del out

    for k, (b, eb) in enumerate(zip(kbuckets, keb)):
        xs = [leaves[n] for n in b.names]
        pc = peak_mib(lambda: arena.szk_compress_bucket(xs, b, eb))
        a = arena.szk_compress_bucket(xs, b, eb)
        pd = peak_mib(lambda: arena.szk_decompress_bucket(a, b))
        print(f"kernel bucket {k} ({b.rows} x {b.shapes[0]}): peak_mib compress={pc:.1f} "
              f"decompress={pd:.1f}")
    print("snapshot stages (median ms): " + json.dumps(
        snapshot_stages(leaves, kbuckets[0], fbuckets, keb[0], feb)))
    return launches


def snapshot_stages(leaves: dict, kb, fbuckets, eb_k, feb: list) -> dict[str, float]:
    """Median ms of the stages of one kernel bucket's compress (stack +
    bounds, K8, which writes the arena) and decode (K9, which reads it), and
    of each flat bucket's compress, CUDA-event timed."""
    xs = [leaves[n] for n in kb.names]
    x = torch.stack([t.float() for t in xs])
    eb_i = sz_core.internal_bound(x.abs().amax(dim=(1, 2, 3)), eb_k)
    a = arena.szk_compress_bucket(xs, kb, eb_k)
    stages = {
        f"szk_compress_bucket[{kb.rows}]": lambda: arena.szk_compress_bucket(xs, kb, eb_k),
        "szk.stack+bounds": lambda: sz_core.internal_bound(
            torch.stack([t.float() for t in xs]).abs().amax(dim=(1, 2, 3)), eb_k),
        "szk.K8": lambda: szf.fused_compress_batched(x, eb_i),
        f"szk_decompress_bucket[{kb.rows}]": lambda: arena.szk_decompress_bucket(a, kb),
        "szk.K9": lambda: szf.fused_decompress_batched(a.arena, a.widths, kb.shapes[0], a.eb_i),
    }
    for b, eb in zip(fbuckets, feb):
        fx = [leaves[nm] for nm in b.names]
        stages[f"sz_compress_bucket[{b.rows}x{b.padded}]"] = (
            lambda fx=fx, b=b, eb=eb: arena.sz_compress_bucket(fx, b, eb, staged=True))
    return {name: cuda_ms(fn, TIMING_ITERS // 2) for name, fn in stages.items()}


def snapshot_agrees_with_cpu(fields: dict, hacc, device) -> None:
    """At small size the card's snapshot payload files equal the plain CPU
    versions' byte for byte (kernel and flat routes)."""
    state = {"f": {k: torch.from_numpy(fields[k][:16, :64, :128].copy())
                   for k in ("baryon_density", "temperature")},
             "h": torch.from_numpy(hacc.fields["vx"][:5000].copy()),
             "g": torch.from_numpy(fields["vy"][:3, :50, :7].copy()).to(torch.bfloat16)}
    dirs = {}
    for dev in (device, torch.device("cpu")):
        on = {"f": {k: v.to(dev) for k, v in state["f"].items()}, "h": state["h"].to(dev),
              "g": state["g"].to(dev)}
        d = SNAPSHOT_DIR / f"small_{dev.type}"
        mgr = ckpt.CheckpointManager(d, async_save=True, policy=ckpt.CodecPolicy(zstd_level=0),
                                     device=dev)
        snapshot(*plan_snapshot(on), mgr, 1, device=dev)
        mgr.wait()
        dirs[dev.type] = d / "step_000000001"
    names = sorted(p.name for p in dirs["cuda"].glob("*.bin"))
    check(names == sorted(p.name for p in dirs["cpu"].glob("*.bin")) and len(names) >= 2,
          f"small snapshot files differ: {names}")
    for nm in names + ["MANIFEST.json"]:
        check((dirs["cuda"] / nm).read_bytes() == (dirs["cpu"] / nm).read_bytes(),
              f"small snapshot: {nm} differs between the card and the CPU")
    print(f"snapshot card == plain CPU versions at small size: {len(names)} payload files and "
          "the manifest byte for byte")


def sz_stream_bytes(n: int, rows: int, used: int, decode: bool) -> int:
    """Bytes the SZ stream functions must move for ``rows`` TILE-padded
    fields of ``n`` points whose payloads take ``used`` words in all.
    Encode (K3, K8): f32 in, the word buffer of capacity ``rows * (n + 2)``
    out once (payload and zero tail), a width byte per block, the look-back
    flags (8 B per chunk and the ticket) and the row descriptors.  Decode
    (K4, K9): the payload and the widths in, f32 out."""
    nb = rows * n // 64
    if decode:
        return 4 * used + nb + 4 * rows * n + 4 * rows
    chunks = rows * n // szf.CHUNK_POINTS
    return 4 * rows * n + 4 * rows * (n + 2) + nb + 8 * (chunks + 1) + 4 * rows + 16 * rows


def batched_kernel_times(xb, eb_i) -> dict[str, dict]:
    """Device ms of K8 and K9 (CUDA-graph replays) and their plain versions'
    event-timed ms at the snapshot's (4, 256, 256, 256) bucket, beside the
    bound from this run's bytes (:func:`sz_stream_bytes`: K9 reads the payload
    words this data needs) and operations (:func:`timed`)."""
    shape = tuple(xb.shape[1:])
    n = xb[0].numel()
    enc = szf.fused_compress_batched(xb, eb_i)
    used = int(enc[5])
    runs = {
        "fused_compress_batched": (lambda: szf.fused_compress_batched(xb, eb_i),
                                   lambda: szf.fused_compress_batched_plain(xb, eb_i),
                                   sz_stream_bytes(n, xb.shape[0], used, decode=False)),
        "fused_decompress_batched": (
            lambda: szf.fused_decompress_batched(enc[0], enc[1], shape, eb_i),
            lambda: szf.fused_decompress_batched_plain(enc[0], enc[1], shape, eb_i),
            sz_stream_bytes(n, xb.shape[0], used, decode=True)),
    }
    return {name: timed(kernel, plain, nbytes, add_ops((xb.numel(), OPS_PER_POINT[name])))
            for name, (kernel, plain, nbytes) in runs.items()}


def timed(kernel, plain, nbytes: int, ops: dict[str, int]) -> dict:
    """A kernel's device ms from CUDA-graph replays (``ms``; its wrapper
    makes no host sync, so it captures) beside an event pair around one
    direct call (``call_ms``: the ctypes launch's host time included), its
    plain version's event-timed ms, and the bound: the larger of the bytes
    over the memory rate and the operations over their pipe's rate, for the
    pipe that takes longest (``pipes_ms``: each pipe's time)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    pipes_ms = {pipe: v / PIPE_OPS_PER_S[pipe] * 1e3 for pipe, v in ops.items()}
    ops_ms = max(pipes_ms.values())
    return {"ms": graph_ms(kernel), "call_ms": cuda_ms(kernel, TIMING_ITERS),
            "plain_ms": cuda_ms(plain, PLAIN_ITERS), "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "pipes_ms": pipes_ms}



def kernel_times(x, eb: float) -> dict[str, dict]:
    """Device ms of each kernel (CUDA-graph replays) and its plain version's
    event-timed ms at the main path's 256^3 shape, beside the bound from
    this run's bytes and operations (for K6 and K7 the operations of this
    run's headers, :func:`zfp_ops`; :func:`timed`)."""
    xp = pad_to_tile(x)
    shape = tuple(xp.shape)
    n = xp.numel()
    eb_i = lor.guarded_eb(xp, eb)
    delta = lor.lorenzo3d_quantize(xp, eb_i)
    packed = szf.fused_compress(xp, eb_i)
    used = 2 * int(packed.widths.to(torch.int64).sum())  # the words K4 must read for this data
    ops = {name: add_ops((n, OPS_PER_POINT[name])) for name in SZ_KERNELS}
    runs = {
        "lorenzo3d_quantize": (lambda: lor.lorenzo3d_quantize(xp, eb_i),
                               lambda: lor.lorenzo3d_quantize_plain(xp, eb_i), 8 * n),
        "lorenzo3d_reconstruct": (lambda: lor.lorenzo3d_reconstruct(delta, eb_i),
                                  lambda: lor.lorenzo3d_reconstruct_plain(delta, eb_i), 8 * n),
        "fused_compress": (lambda: szf.fused_compress(xp, eb_i),
                           lambda: szf.fused_compress_plain(xp, eb_i),
                           sz_stream_bytes(n, 1, used, decode=False)),
        "fused_decompress": (lambda: szf.fused_decompress(packed, shape, eb_i),
                             lambda: szf.fused_decompress_plain(packed, shape, eb_i),
                             sz_stream_bytes(n, 1, used, decode=True)),
    }
    # ZFP at the main path's rate; headers at the format's 11 B per block
    blocks = zfp_core._carve_blocks(x)
    zb = blocks.shape[0]
    zn = 64 * zb  # points of the carved blocks
    enc = zff.fused_compress_blocks(blocks, ZFP_RATE)
    ops.update(zfp_ops(enc[2], ZFP_RATE))
    stream_bytes = 4 * zfp_core.payload_words(ZFP_RATE) * zb + 11 * zb
    runs.update({
        "zfp3d_transform": (lambda: k5.zfp3d_transform(blocks),
                            lambda: k5.zfp3d_transform_plain(blocks), 8 * zn + 11 * zb),
        "fused_compress_blocks": (lambda: zff.fused_compress_blocks(blocks, ZFP_RATE),
                                  lambda: zff.fused_compress_blocks_plain(blocks, ZFP_RATE),
                                  4 * zn + stream_bytes),
        "fused_decompress_blocks": (lambda: zff.fused_decompress_blocks(*enc, ZFP_RATE),
                                    lambda: zff.fused_decompress_blocks_plain(*enc, ZFP_RATE),
                                    stream_bytes + 4 * zn),
    })
    return {name: timed(kernel, plain, nbytes, ops[name])
            for name, (kernel, plain, nbytes) in runs.items()}


def stage_times(x, eb: float) -> dict[str, float]:
    """Median ms of each stage of one compress and one decompress of ``x`` at
    the main path's shape, on both paths, beside the whole entry-point calls,
    and the peak device memory of one entry-point call each."""
    comp = get_compressor("tpu-sz")
    xp = pad_to_tile(x)
    shape = tuple(xp.shape)
    eb_i = lor.guarded_eb(xp, eb)
    packed = szf.fused_compress(xp, eb_i)
    delta = lor.lorenzo3d_quantize(xp, eb_i)
    r = comp.compress(x, eb=eb)
    stages = {
        "fused.compress": lambda: comp.compress(x, eb=eb),
        "fused.compress.guarded_eb": lambda: lor.guarded_eb(xp, eb),
        "fused.compress.K3": lambda: szf.fused_compress(xp, eb_i),
        "fused.compress.total_bits_readback": lambda: int(packed.total_bits),
        "fused.decompress": lambda: comp.decompress(r),
        "fused.decompress.K4": lambda: szf.fused_decompress(packed, shape, eb_i),
        "xla.compress.K1": lambda: lor.lorenzo3d_quantize(xp, eb_i),
        "xla.compress.pack_codes": lambda: bitpack.pack_codes(szf.tile_major_flatten(delta)),
        "xla.decompress.unpack_codes": lambda: szf.tile_major_unflatten(
            bitpack.unpack_codes(packed), shape),
        "xla.decompress.K2": lambda: lor.lorenzo3d_reconstruct(delta, eb_i),
    }
    out = {name: cuda_ms(fn, TIMING_ITERS) for name, fn in stages.items()}
    out["fused.compress.peak_mib"] = peak_mib(lambda: comp.compress(x, eb=eb))
    out["fused.decompress.peak_mib"] = peak_mib(lambda: comp.decompress(r))
    return out


# ------------------------------------------------------------ serving ----


def bf16_check(got, want, atol: float = 2e-6) -> int:
    """|got - want| <= one bf16 ulp of want plus ``atol`` (an element near 0,
    a sum that cancels, differs by several of its own tiny ulps at the f32
    rounding error of another summation order).  Returns the largest
    distance in ulps, for the record."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w.abs())[1] - 8)
    diff = (got.float() - w).abs()
    check(bool((diff <= torch.where(w == 0, 0.0, ulp) + atol).all()),
          f"K10 bf16 output beyond one ulp (+{atol}) of the plain version")
    return int(((diff / ulp.clamp_min(2.0 ** -133)).ceil()).max())


def kvc_inputs(b, s, h, hkv, d, qdtype, index, device, seed=SEED):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, h, d, generator=g, device=device).to(qdtype)
    kc, vc = (torch.randint(-127, 128, (b, s, hkv, d), generator=g, device=device,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, s, hkv, generator=g, device=device) * 1.9e-2 + 1e-3
              for _ in range(2))
    idx = torch.as_tensor(np.asarray(index, np.int32)).to(device)
    return q, kc, ks, vc, vs, idx


def serving_index(b: int, s: int, seed: int = SEED) -> list[int]:
    """Per-lane positions like a decode tick of phase 13: prompts of 256-1024
    tokens part-way through their 32 new ones; lane 0 is free (-1)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=b) + rng.integers(0, SERVE_NEW,
                                                                                  size=b)
    idx = np.minimum(idx, s - 1)
    idx[0] = -1
    return [int(i) for i in idx]


def long_index(b: int, s: int, seed: int = SEED) -> list[int]:
    rng = np.random.default_rng(seed + 1)
    idx = rng.integers(s // 2, s, size=b)
    idx[0], idx[-1] = -1, s - 1
    return [int(i) for i in idx]


def kvc_pool(b, s, h, hkv, d, qdtype, index, device, seed=SEED):
    """The paged form of :func:`kvc_inputs` (``data/kvc_cases.py``): 16-token
    pages every lane maps in a random order, one page id used twice, and an
    unmapped entry at the zero page."""
    return kvc_cases.paged_pool(b, s, h, hkv, d, qdtype, index, device, seed,
                                page=SERVE["page_size"])


def k10_vs_plain(device) -> float:
    """K10 against its plain version on the card (phase 12), both entries.
    Returns the largest |kernel - plain| of the paged entry (the main path's)
    at the serving shape with the bf16 query the main path gives it (the
    report row's ``max_abs_err``); the largest in float32 over every case is
    printed beside it."""
    worst, serving_err = 0.0, 0.0

    def hold_f32(label, b, s, h, hkv, d, index):
        nonlocal worst
        args = kvc_inputs(b, s, h, hkv, d, torch.float32, index, device)
        got, want = k10.kvc_decode_attention(*args), kref.kvc_decode_attention_ref(*args)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6, msg=f"K10 at {label}")
        dead = [i for i, n in enumerate(np.atleast_1d(index)) if n < 0]
        for i in dead:
            check(bool((got[i] == 0).all()), f"K10 lane {i} at index -1 is not exactly 0 ({label})")
        worst = max(worst, float((got - want).abs().max()))

    for b, s, h, d in ((1, 128, 4, 64), (2, 256, 8, 64), (2, 384, 2, 128)):
        hold_f32(f"({b}, {s}, {h}, {d}) index {s - 5}", b, s, h, h, d, s - 5)
    hold_f32("(4, 256, 4, 64) per-lane index", 4, 256, 4, 4, 64, [3, 100, 251, 17])
    hold_f32("(2, 128, 4, 64) dead lane", 2, 128, 4, 4, 64, [-1, 64])
    print("K10 vs plain at the reference tests' shapes (f32 q): within rtol 2e-5 / atol 2e-6")

    for label, s, index in (("serving", KVC_SERVE_SHAPE[1], serving_index),
                            ("decode_32k", KVC_LONG_S, long_index)):
        b, _, h, hkv, d = KVC_SERVE_SHAPE
        idx = index(b, s)
        q, kc, ks, vc, vs, ix = kvc_inputs(b, s, h, hkv, d, torch.bfloat16, idx, device)
        got = k10.kvc_decode_attention(q, kc, ks, vc, vs, ix)
        want = kref.kvc_decode_attention_ref(q, kc, ks, vc, vs, ix)
        check(bool((got[0] == 0).all()), f"K10 free lane not exactly 0 at {label}")
        ulps = bf16_check(got, want)
        q32 = q.float()
        got32 = k10.kvc_decode_attention(q32, kc, ks, vc, vs, ix)
        want32 = kref.kvc_decode_attention_ref(q32, kc, ks, vc, vs, ix)
        torch.testing.assert_close(got32, want32, rtol=2e-5, atol=2e-6, msg=f"K10 f32 at {label}")
        err = float((got32 - want32).abs().max())
        worst = max(worst, err)
        err16 = float((got.float() - want.float()).abs().max())
        if label == "serving":
            serving_err = err16
        print(f"K10 vs plain at {label} (B={b}, S={s}, H={h}, Hkv={hkv}, D={d}, bf16 q, "
              f"index {idx}): free lane exactly 0, largest distance {ulps} bf16 ulps "
              f"(max |diff| {err16:.3g}); f32 q max |diff| {err:.3g}")
        del q, kc, ks, vc, vs, got, want, got32, want32

    for label, s, index in (("serving", KVC_SERVE_SHAPE[1], serving_index),
                            ("decode_32k", KVC_LONG_S, long_index)):
        b, _, h, hkv, d = KVC_SERVE_SHAPE
        idx = index(b, s)
        errs = {}
        for qdtype in (torch.bfloat16, torch.float32):
            args = kvc_pool(b, s, h, hkv, d, qdtype, idx, device)
            got = k10.kvc_decode_attention_paged(*args)
            want = kref.kvc_decode_attention_paged_ref(*args)
            check(bool((got[0] == 0).all()), f"K10 paged free lane not exactly 0 at {label}")
            if qdtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6,
                                           msg=f"K10 paged f32 at {label}")
                worst = max(worst, float((got - want).abs().max()))
            else:
                errs["ulps"] = bf16_check(got, want)
            errs[str(qdtype)] = float((got.float() - want.float()).abs().max())
            del args, got, want
        if label == "serving":
            serving_err = errs[str(torch.bfloat16)]
        print(f"K10 paged vs plain (gather + plain K10) at {label} (B={b}, capacity {s} in "
              f"{SERVE['page_size']}-token pages, permuted table, a page id used twice): free "
              f"lane exactly 0, bf16 q within {errs['ulps']} ulps (max |diff| "
              f"{errs[str(torch.bfloat16)]:.3g}), f32 q max |diff| {errs[str(torch.float32)]:.3g}")
    torch.cuda.synchronize()
    print(f"K10 vs plain, largest |diff| with an f32 query over every case: {worst:.3g}")
    return serving_err


def prompts(n: int, vocab: int, lo: int, hi: int, seed: int = SEED) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def serve(model, params, ecfg: EngineConfig, reqs_in, new: int):
    """Submit ``reqs_in`` (prompts) to a fresh engine and drain it; the
    launch counts and the serving histograms are reset just before.
    Returns (engine, requests, kernel launches, prefill and tick stats, wall s)."""
    obs_metrics.reset()
    eng = ServingEngine(model, params, ecfg)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=new) for i, p in enumerate(reqs_in)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(done.drained, f"serving ({ecfg.attention}) did not drain")
    check(all(len(r.out_tokens) == new for r in reqs),
          f"serving ({ecfg.attention}): a request ended short of {new} tokens")
    stats = {"prefill": obs_metrics.histogram("serving.prefill_s").percentiles(),
             "tick": obs_metrics.histogram("serving.tick_s").percentiles()}
    return eng, reqs, counts, stats, wall


class GatherCount:
    """Counts the calls of ``models.layers._gather_pages`` (the dense copy of
    a paged cache that K10's paged entry makes unneeded) while active."""

    def __enter__(self):
        self.n, self._orig = 0, model_layers._gather_pages

        def counted(*args):
            self.n += 1
            return self._orig(*args)

        model_layers._gather_pages = counted
        return self

    def __exit__(self, *exc):
        model_layers._gather_pages = self._orig


def serving_full_width(device) -> dict:
    """Phase 13: starcoder2-3b at its published widths through the engine."""
    cfg = registry.get_config(ARCH)
    model = registry.build_model(cfg)
    check(model.device.type == "cuda", "the default model device is not CUDA")
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(model.specs(), gen, device, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = param_count(model.specs())
    print(f"{ARCH}: {n_params} parameters ({n_params * 2 / 1e9:.3f} GB bf16), "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
          f"init on the card {time.perf_counter() - t0:.2f} s")
    ps = prompts(SERVE_REQUESTS, cfg.vocab, *PROMPT_LEN)
    obs_metrics.enable()
    try:
        torch.cuda.reset_peak_memory_stats()
        with GatherCount() as gathers:
            eng, reqs, counts, stats, wall = serve(model, params, EngineConfig(**SERVE), ps,
                                                   SERVE_NEW)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(eng._fused, "attention='auto' did not pick K10 on the card")
        k10_n = counts["kvc_decode_attention"]
        check(k10_n == cfg.n_layers * eng.steps and k10_n > 0,
              f"K10 launched {k10_n} times in {eng.steps} decode steps of {cfg.n_layers} layers")
        # prefill attends through the plain path (4 gathers a layer); decode gathers nothing
        prefills = stats["prefill"]["count"]
        check(gathers.n == 4 * cfg.n_layers * prefills,
              f"{gathers.n} page gathers in {prefills} prefill calls and {eng.steps} decode "
              f"steps of {cfg.n_layers} layers: the fused decode path gathered pages")
        check(eng.check_kv_integrity(), "the KV pool is not clean after the drain")
        toks = [r.out_tokens for r in reqs]
        _, again, _, _, _ = serve(model, params, EngineConfig(**SERVE), ps, SERVE_NEW)
        check([r.out_tokens for r in again] == toks, "a second identical run gave other tokens")
        with GatherCount() as plain_gathers:
            plain_eng, plain, plain_counts, plain_stats, plain_wall = serve(
                model, params, EngineConfig(**SERVE, attention="xla"), ps, SERVE_NEW)
        check(plain_counts["kvc_decode_attention"] == 0, "attention='xla' launched K10")
        check(plain_gathers.n == 4 * cfg.n_layers * (plain_stats["prefill"]["count"]
                                                     + plain_eng.steps),
              f"the plain path gathered pages {plain_gathers.n} times")
        check(all(a.out_tokens[0] == b[0] for a, b in zip(plain, toks)),
              "first tokens (from prefill) differ between attention auto and xla")
        rest = [(a, b) for r, tk in zip(plain, toks) for a, b in zip(r.out_tokens[1:], tk[1:])]
        agree = sum(a == b for a, b in rest) / len(rest)
        profiled = tick_profile(model, params, ps)
    finally:
        obs_metrics.disable()
        obs_metrics.reset()
    pre, tick = stats["prefill"], stats["tick"]
    decode_s = tick["mean"] * tick["count"] - pre["mean"] * pre["count"]
    decode_tokens = SERVE_REQUESTS * (SERVE_NEW - 1)
    out = {"steps": eng.steps, "ticks": eng.ticks, "k10_launches": k10_n,
           "page_gathers": gathers.n, "xla_page_gathers": plain_gathers.n,
           "prefill_calls": pre["count"], "prefill_ms_mean": pre["mean"] * 1e3,
           "prefill_ms_max": pre["max"] * 1e3, "tick_ms_median": tick["p50"] * 1e3,
           "decode_tokens_per_s": decode_tokens / decode_s, "wall_s": wall,
           "pool_bytes": eng.pool.nbytes(), "pool_pages": eng.pool.n_pages,
           "peak_gib": peak, "xla_tick_ms_median": plain_stats["tick"]["p50"] * 1e3,
           "xla_wall_s": plain_wall, "xla_agree_after_first": agree,
           "prompt_tokens": sum(len(p) for p in ps)}
    print(f"serving {ARCH} full width (auto = K10): " + json.dumps(out))
    print("decode tick profile (8 live lanes): " + json.dumps(profiled))
    del params, eng
    torch.cuda.empty_cache()
    return out


def on_device(tree, device):
    if isinstance(tree, dict):
        return {k: on_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def tick_profile(model, params, ps, ticks: int = 5) -> dict:
    """Where a decode tick's time goes: ``torch.profiler`` over ``ticks``
    decode ticks of 8 live lanes (after the prompts' prefill), with the
    device's busy share (kernel time over wall) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServingEngine(model, params, EngineConfig(**SERVE))
    for i, p in enumerate(ps[:SERVE["batch_slots"]]):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=SERVE_NEW))
    eng.tick()  # admission, prefill and the first decode step
    eng.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            GatherCount() as gathers:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(gathers.n == 0, f"{ticks} decode ticks gathered pages {gathers.n} times")
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:10]
    out = {"tick_ms": wall / ticks * 1e3, "device_ms_per_tick": device_us / ticks / 1e3,
           "device_busy_share": device_us / 1e6 / wall,
           "kernel_launches_per_tick": sum(e.count for e in events) / ticks,
           "top_kernels_ms_per_tick": {e.key[:60]: e.device_time_total / ticks / 1e3 for e in top}}
    eng.drain_requests()
    return out


def serving_card_vs_cpu(device) -> None:
    """Phase 14: SMOKE config, same parameters and prompts, card (K10)
    against the CPU (K10's plain version)."""
    cfg = registry.get_config(ARCH, smoke=True)
    specs = registry.build_model(cfg, device="cpu").specs()
    params = init_params(specs, torch.Generator().manual_seed(SEED), "cpu", torch.bfloat16)
    ps = prompts(SMOKE_REQUESTS, cfg.vocab, 3, 20)
    toks = {}
    for dev, attention in ((device, "auto"), (torch.device("cpu"), "fused"),
                           (torch.device("cpu"), "xla")):
        model = registry.build_model(cfg, device=dev)
        eng = ServingEngine(model, on_device(params, dev), EngineConfig(
            batch_slots=2, max_len=64, codec="blockfloat8", paged=True, attention=attention))
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=SMOKE_NEW) for i, p in enumerate(ps)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_launch_counts()
        check(eng.run_until_drained().drained, f"SMOKE serving on {dev.type} did not drain")
        n = kernels.launch_counts()["kvc_decode_attention"]
        check(n == (cfg.n_layers * eng.steps if dev.type == "cuda" else 0),
              f"SMOKE serving on {dev.type}: K10 launched {n} times")
        toks[f"{dev.type}-{attention}"] = [r.out_tokens for r in reqs]

    def agree(a, b):
        return [sum(x == y for x, y in zip(g, c)) for g, c in zip(toks[a], toks[b])]

    kernel_vs_plain = agree("cuda-auto", "cpu-fused")
    check(all(a >= 6 for a in kernel_vs_plain),
          f"card (K10) and CPU (plain K10) greedy tokens agree in {kernel_vs_plain} of 8")
    print(f"SMOKE serving card (K10) vs CPU (K10's plain version): tokens agree "
          f"{kernel_vs_plain} of {SMOKE_NEW}; vs the CPU's xla attention "
          f"{agree('cuda-auto', 'cpu-xla')} (bf16 attention logits there)")


def ptxas_resources(logs: dict[str, str]) -> dict[str, dict]:
    """Registers and spill bytes of K1 and of each K10 instantiation
    (``kvc_attention_kernel<D>``) from the build's ``-Xptxas=-v`` report;
    empty for a library that was not compiled in this run."""
    out, name = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k10m = re.search(r"kvc_attention_kernelILi(\d+)E", m.group(1))
                name = (f"kvc_attention_kernel<{k10m.group(1)}>" if k10m else
                        "lorenzo3d_quantize_kernel" if "lorenzo3d_quantize_kernel" in m.group(1)
                        else None)
                if name:
                    out[name] = {}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name]["registers"] = int(m.group(1))
    return out


def k10_times(device, serving: dict, resources: dict) -> tuple[dict, dict]:
    """K10's paged entry (the main path's: the row of the report), its dense
    entry on the gathered cache, the paged plain version (gather + plain
    K10) and the library yardstick, at the serving shape and at S=32768,
    with the bound from this run's positions (and at full capacity), the
    share of the bound, and the main instantiation's registers and spills.
    Each is timed on the device from a CUDA graph (:func:`graph_ms`): K10's
    wrapper spends more host time per call than the kernel spends on the
    card, so an event pair around one direct call (``call_ms``, also
    printed) times the host."""
    rows = {}
    b, s0, h, hkv, d = KVC_SERVE_SHAPE
    n_rep = h // hkv
    for label, s, index in (("serving", s0, serving_index), ("decode_32k", KVC_LONG_S, long_index)):
        idx = index(b, s)
        q, kp, ksp, vp, vsp, table, ix = kvc_pool(b, s, h, hkv, d, torch.bfloat16, idx, device)
        kc, ks, vc, vs = (kref.gather_pages(t, table) for t in (kp, ksp, vp, vsp))  # untimed
        kd = (kc.float() * ks[..., None]).to(torch.bfloat16)  # dequantized beforehand, not timed
        vd = (vc.float() * vs[..., None]).to(torch.bfloat16)
        mask = (torch.arange(s, device=device)[None, :] <= ix[:, None])[:, None, None, :]

        def library():
            kr = kd.repeat_interleave(n_rep, dim=2).transpose(1, 2)
            vr = vd.repeat_interleave(n_rep, dim=2).transpose(1, 2)
            return F.scaled_dot_product_attention(q[:, :, None, :], kr, vr, attn_mask=mask)

        live = sum(min(i + 1, s) for i in idx if i >= 0)
        qo_bytes = 2 * 2 * b * h * d + 4 * b  # q and out in bf16, index
        table_bytes = 4 * table.numel()
        nbytes = live * hkv * (2 * d + 8) + qo_bytes + table_bytes

        def ops_ms(positions: int) -> float:
            """The function's arithmetic: the one scale per position and KV head
            factors out of q.k and p.v, so no dequantize pass; q.k of a bf16
            query with int8 codes is exact in bf16 (the tensor cores' rate),
            p.v stays f32; 2 D flops each per position and query head."""
            flops = positions * h * 2 * d
            return (flops / BF16_OPS_PER_S + flops / F32_OPS_PER_S) * 1e3

        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3

        def paged():
            return k10.kvc_decode_attention_paged(q, kp, ksp, vp, vsp, table, ix)

        def dense():
            return k10.kvc_decode_attention(q, kc, ks, vc, vs, ix)

        t = {"ms": graph_ms(paged), "dense_ms": graph_ms(dense),
             "plain_ms": graph_ms(lambda: kref.kvc_decode_attention_paged_ref(
                 q, kp, ksp, vp, vsp, table, ix), iters=PLAIN_ITERS),
             "library_ms": graph_ms(library), "call_ms": cuda_ms(paged, TIMING_ITERS),
             "dense_call_ms": cuda_ms(dense, TIMING_ITERS)}
        bound = max(bytes_ms, ops_ms(live))
        t.update(bytes_ms=bytes_ms, ops_ms=ops_ms(live), bound_ms=bound,
                 bound_by="bytes" if bytes_ms >= ops_ms(live) else "operations", positions=live,
                 share_of_bound=bound / t["ms"],
                 dense_share_of_bound=(bound - table_bytes / HBM_BYTES_PER_S * 1e3) / t["dense_ms"],
                 full_bytes_ms=(b * s * hkv * (2 * d + 8) + qo_bytes + table_bytes)
                 / HBM_BYTES_PER_S * 1e3, full_ops_ms=ops_ms(b * s),
                 splits=k10.split_plan(b, hkv, s, torch.cuda.get_device_properties(
                     device).multi_processor_count)[0],
                 **resources.get(f"kvc_attention_kernel<{d}>", {}))
        rows[label] = t
        del q, kp, ksp, vp, vsp, kc, ks, vc, vs, kd, vd
    torch.cuda.empty_cache()
    row = rows["serving"]
    row["tick_share"] = row["ms"] * registry.get_config(ARCH).n_layers / serving["tick_ms_median"]
    print("K10 times (ms, paged entry, dense entry on the gathered cache; bound from this run's "
          "positions and at full capacity; registers and spill bytes of the "
          f"kvc_attention_kernel<{d}> instantiation): " + json.dumps(rows))
    print(f"K10 share of a decode tick: {row['ms']:.4f} ms x 30 / "
          f"{serving['tick_ms_median']:.3f} ms = {row['tick_share']:.4f}")
    return row, rows["decode_32k"]


# ------------------------------------------------- Foresight and in-situ ----

FORESIGHT_RELS = (1e-2, 1e-3, 1e-4)  # SZ bounds x value range: CBench sweep and guideline
FORESIGHT_RATES = (4, 8)  # ZFP rates of the CBench sweep
HALO_GRID = 64  # hacc_particles grid of the halo gate: 262144 particles
HALO_RATES = (8, 16)
HOST_WORKERS = 6  # processes for the host-side analyses (FoF catalogs, P(k) gates)
FORESIGHT_OUT = Path(__file__).resolve().parent / "chip_smoke_out" / "foresight"  # gitignored
INSITU_DIR = SNAPSHOT_DIR / "insitu"  # gitignored; removed at the end
INSITU_AXES = ("pod", "data", "model")
INSITU_POD = 2  # ranks of the two-process group, (128, 256, 256) shards at 256^3
# labels of the in-situ runs: codec and sharded_compress keywords
INSITU_CASES = {"sz-core": ("sz", {}), "sz-kernel": ("sz", {"backend": "kernel"}),
                "zfp": ("zfp", {"rate": ZFP_RATE})}
INSITU_LAUNCHES = {"sz-core": {}, "sz-kernel": {"fused_compress": 1, "fused_decompress": 1},
                   "zfp": {"fused_compress_blocks": 1, "fused_decompress_blocks": 1}}
FORESIGHT_KERNELS = ("fused_compress", "fused_decompress", "fused_compress_blocks",
                     "fused_decompress_blocks")
EVENT_MBS: dict = {}  # (compressor, field) -> phase 3 / 7 ratio and event-timed MB/s


def host_timed(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), its host seconds)``: run in the host pool."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def sz_configs(v) -> list[dict]:
    """The SZ configurations of the sweep: eb = rel x value range, as phase 3
    computes its bound (eb 1e-4 x range is phase 3's)."""
    return [{"eb": rel * float(v.max() - v.min())} for rel in FORESIGHT_RELS]


def read_counts(want: dict) -> dict[str, int]:
    """The launch counts of the path just driven, held to ``want`` exactly
    (kernels absent from ``want`` must not have launched)."""
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    got = {k: v for k, v in counts.items() if v}
    check(got == {k: v for k, v in want.items() if v},
          f"launches {got}, want {want}")
    return {k: counts[k] for k in FORESIGHT_KERNELS}


def cbench_sweep(fields: dict, device) -> tuple[dict, list]:
    """Foresight's CBench over the six 256^3 fields: tpu-sz at three bounds
    and tpu-zfp at two rates, warm-up 1 and 3 timed calls each way, so K3
    and K4 launch 72 times and K6 and K7 48."""
    spec = {"cases": [{"compressor": "tpu-sz", "fields": [name], "configs": sz_configs(v)}
                      for name, v in fields.items()]
            + [{"compressor": "tpu-zfp", "fields": list(fields),
                "configs": [{"rate": r} for r in FORESIGHT_RATES]}]}
    kernels.reset_launch_counts()
    rows = cbench.run_sweep(spec, fields, keep_reconstruction=True, device=device)
    n_sz, n_zfp = 6 * len(FORESIGHT_RELS), 6 * len(FORESIGHT_RATES)
    launches = read_counts({"fused_compress": 4 * n_sz, "fused_decompress": 4 * n_sz,
                            "fused_compress_blocks": 4 * n_zfp,
                            "fused_decompress_blocks": 4 * n_zfp})
    check(len(rows) == n_sz + n_zfp, f"{len(rows)} CBench rows")
    print("CBench (host perf_counter over 3 calls after 1 warm-up, each ended by "
          "torch.cuda.synchronize) beside phase 3 / 7's CUDA-event medians, MB/s:")
    for r in rows:
        ev = EVENT_MBS.get((r.compressor, r.field))
        if r.compressor == "tpu-sz":
            eb = r.config["eb"]
            check(r.max_abs_err <= eb * (1 + 1e-5), f"CBench {r.field} eb {eb}: max err "
                  f"{r.max_abs_err}")
            same_cfg = ev is not None and eb == ev["config"]["eb"]
        else:
            check(r.ratio == 32 / r.config["rate"], f"CBench ZFP ratio {r.ratio} at {r.config}")
            same_cfg = ev is not None and r.config["rate"] == ev["config"]["rate"]
        if same_cfg:
            check(r.ratio == ev["ratio"], f"CBench {r.compressor} {r.field} ratio {r.ratio} != "
                  f"the main path's {ev['ratio']}")
        event = (f"event compress={ev['compress']:.1f} decompress={ev['decompress']:.1f}"
                 if same_cfg else "event -")
        print(f"  {r.compressor:7s} {r.field:20s} {json.dumps(r.config):24s} ratio={r.ratio:.4f} "
              f"psnr={r.psnr:.4f}dB max_err={r.max_abs_err:.6g} cbench "
              f"compress={r.throughput_c_mbs:.1f} decompress={r.throughput_d_mbs:.1f} {event}")
    FORESIGHT_OUT.mkdir(parents=True, exist_ok=True)
    cbench.save_results(rows, FORESIGHT_OUT / "cbench.json")
    db = cinema.CinemaDatabase(FORESIGHT_OUT / "cinema_db", name="chip-smoke-cbench")
    for r in rows:
        db.add_case({k: v for k, v in r.row().items() if k != "config"} | {"config": str(r.config)})
    print(f"CBench rows and Cinema database written to {FORESIGHT_OUT} "
          f"({db.write().name}, {len(rows)} cases)")
    return launches, rows


def halo_recon(snap, comp, rate: int, device) -> tuple[np.ndarray, list]:
    """x, y, z through ``comp`` at ``rate``: the reconstructed positions
    and each coordinate's stream."""
    cols, parts = [], []
    for c in ("x", "y", "z"):
        v = torch.as_tensor(snap.fields[c], device=device)
        r = comp.compress(v, rate=rate)
        parts.append(r.payload["parts"][0])
        cols.append(comp.decompress(r).cpu().numpy())
    return np.stack(cols, axis=1), parts


def halo_start(pool, device) -> tuple[dict, dict]:
    """HACC positions through tpu-zfp on the card and on the CPU (bitwise
    equal), then the FoF catalogs and ``evaluate_gates`` handed to the host
    pool; :func:`halo_finish` reads them."""
    snap = cosmo.hacc_particles(grid=HALO_GRID)
    pos = snap.positions()
    gpu, cpu = get_compressor("tpu-zfp"), get_compressor("tpu-zfp", device="cpu")
    kernels.reset_launch_counts()
    card = {rate: halo_recon(snap, gpu, rate, device) for rate in HALO_RATES}
    n = 3 * len(HALO_RATES)
    launches = read_counts({"fused_compress_blocks": n, "fused_decompress_blocks": n})
    jobs = {"orig": pool.submit(host_timed, halos.fof_halos, pos, snap.box)}
    for rate in HALO_RATES:
        host, parts = halo_recon(snap, cpu, rate, "cpu")
        check(all(same_zfp(a, b) for a, b in zip(card[rate][1], parts)),
              f"halo gate rate {rate}: card and CPU streams differ")
        check(np.array_equal(card[rate][0].view(np.int32), host.view(np.int32)),
              f"halo gate rate {rate}: card and CPU reconstructions differ")
        jobs[("card", rate)] = pool.submit(host_timed, halos.fof_halos, card[rate][0], snap.box)
        jobs[("cpu", rate)] = pool.submit(host_timed, halos.fof_halos, host, snap.box)
        jobs[("gates", rate)] = pool.submit(host_timed, guideline.evaluate_gates, {}, {},
                                            particles=(pos, card[rate][0], snap.box))
    print(f"halo gate: hacc_particles(grid={HALO_GRID}) x, y, z ({len(pos)} particles) through "
          f"tpu-zfp at rates {HALO_RATES} on the card == on the CPU, bitwise; FoF on the host")
    return jobs, launches


def halo_finish(jobs: dict) -> None:
    t0 = time.perf_counter()
    results = {k: f.result() for k, f in jobs.items()}
    orig = results["orig"][0]
    for rate in HALO_RATES:
        card, host = results[("card", rate)][0], results[("cpu", rate)][0]
        check(np.array_equal(card.labels, host.labels) and np.array_equal(card.sizes, host.sizes)
              and card.n_halos == host.n_halos, f"halo catalogs of card and CPU differ at {rate}")
        ok, dev = halos.halo_gate(orig, card)
        passed, worst_pk, worst_halo = results[("gates", rate)][0]
        check(worst_halo == dev and worst_pk == 0.0 and passed == (dev <= 0.1),
              f"evaluate_gates at rate {rate}: {passed, worst_pk, worst_halo}, halo_gate {ok, dev}")
        print(f"halo gate rate {rate}: n_halos {card.n_halos} (original {orig.n_halos}), "
              f"worst halo deviation {worst_halo:.6f}, evaluate_gates passed={passed}")
    print(f"halo catalogs waited for {time.perf_counter() - t0:.2f} s after the guideline; "
          "host seconds (FoF in a pool process; evaluate_gates runs FoF twice): "
          + json.dumps({str(k): round(v[1], 3) for k, v in results.items()}))


def guideline_on_card(fields: dict, rows: list, pool, device) -> dict:
    """§V-D on the card: ``best_fit_per_field`` per 256^3 field over the
    three SZ bounds must pick the passing configuration with the highest
    ratio (the least-bad one where none passes), as the CBench sweep's
    reconstructions gated on the host say."""
    gates = {(r.field, r.config["eb"]): (r.ratio, pool.submit(host_timed, spectrum.pk_gate,
                                                              fields[r.field], r.reconstructed))
             for r in rows if r.compressor == "tpu-sz"}
    kernels.reset_launch_counts()
    picks = {name: guideline.best_fit_per_field({name: v}, "tpu-sz", sz_configs(v),
                                                device=device).field_results[name]
             for name, v in fields.items()}
    n = 6 * len(FORESIGHT_RELS)
    launches = read_counts({"fused_compress": 4 * n, "fused_decompress": 4 * n})
    for name, v in fields.items():
        cand = [(cfg, gates[(name, cfg["eb"])][0], gates[(name, cfg["eb"])][1].result()[0])
                for cfg in sz_configs(v)]
        passing = [c for c in cand if c[2][0]]
        want = (max(passing, key=lambda c: c[1]) if passing
                else min(cand, key=lambda c: c[2][1]))
        got = picks[name]
        check(got.config == want[0] and got.ratio == want[1] and got.passed == want[2][0]
              and got.worst_pk_dev == want[2][1],
              f"guideline {name}: picked {got.config} ({got.ratio}, {got.passed}), want {want}")
        print(f"guideline {name:20s} pick eb={got.config['eb']:.6g} ratio={got.ratio:.4f} "
              f"passed={got.passed} worst_pk_dev={got.worst_pk_dev:.6f} (gates: "
              + ", ".join(f"{c[1]:.3f}x {'PASS' if c[2][0] else 'fail'} {c[2][1]:.4f}"
                          for c in cand) + ")")
    pk_s = sorted(f.result()[1] for _ratio, f in gates.values())
    print(f"host pk_gate at {N}^3 in a pool process: median {statistics.median(pk_s):.3f} s "
          f"[{pk_s[0]:.3f}..{pk_s[-1]:.3f}] over {len(pk_s)}")
    return launches


def guideline_card_vs_cpu(small: dict, device) -> None:
    """The guideline at 64^3 on the card and on the CPU give the same picks
    and ratios.  The card's ``auto`` backend is the kernel and the CPU's the
    core coder, so the CPU run is pinned to the kernel backend's plain
    versions (the tests hold those to the JAX package)."""
    def fits(dev):
        return {name: guideline.best_fit_per_field({name: v}, "tpu-sz", sz_configs(v),
                                                   device=dev).field_results[name]
                for name, v in small.items()}

    card = fits(device)
    default = cbench.get_compressor
    cbench.get_compressor = lambda name, **kw: default(name, backend="kernel", **kw)
    try:
        host = fits("cpu")
    finally:
        cbench.get_compressor = default
    for name in small:
        a, b = card[name], host[name]
        check((a.config, a.ratio, a.passed, a.worst_pk_dev) == (b.config, b.ratio, b.passed,
                                                                b.worst_pk_dev),
              f"guideline {name} at {SMALL_N}^3: card {a} != CPU {b}")
    print(f"guideline at {SMALL_N}^3: card == CPU (kernel backend) picks and ratios, six fields")


def pat_workflow(device) -> dict:
    """The port's Foresight workflow example at n=64 on the card, locally,
    its SLURM submission script written beside the Cinema database."""
    path = Path(__file__).resolve().parent / "examples" / "torch_foresight_workflow.py"
    spec = importlib.util.spec_from_file_location("torch_foresight_workflow", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = FORESIGHT_OUT / "workflow"
    kernels.reset_launch_counts()
    res = example.main(["--device", device.type, "--out", str(out), "--n", str(SMALL_N)])
    launches = read_counts({"fused_compress": 20, "fused_decompress": 20,
                            "fused_compress_blocks": 16, "fused_decompress_blocks": 16})
    sbatch = sorted(p.name for p in (out / "foresight-demo_jobs").glob("*.sbatch"))
    check((out / "submit_all.sh").is_file() and len(sbatch) == 4, f"SLURM scripts {sbatch}")
    check(len(res["spectra"]) == 9 and res["cinema"].is_file(), "workflow results")
    print(f"PAT workflow example on {device.type} at n={SMALL_N}: SLURM submission script and {sbatch} "
          f"written, {len(res['spectra'])} Cinema cases")
    return launches


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def insitu_start(base: np.ndarray, eb: float) -> list:
    """Start the two-process gloo groups (``pod`` = 2) on the card (both
    ranks on cuda:0: NCCL refuses two ranks on one device) and on the CPU;
    each rank runs :func:`insitu_worker` in a fresh process of this script."""
    shutil.rmtree(INSITU_DIR, ignore_errors=True)
    INSITU_DIR.mkdir(parents=True)
    np.save(INSITU_DIR / "field.npy", base)
    procs = []
    for dev in ("cuda", "cpu"):
        port = free_port()
        for rank in range(INSITU_POD):
            log = open(INSITU_DIR / f"{dev}_r{rank}.log", "w")
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--insitu-rank", str(rank),
                 str(INSITU_POD), str(port), dev, str(INSITU_DIR), repr(eb)],
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def insitu_worker(argv: list[str]) -> int:
    """One rank of a two-process group: its (128, 256, 256) shard of the
    256^3 baryon density through the three in-situ runs; writes its decoded
    shard, launch counts, bytes sent and (rank 0) the gathered host stream."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    rank, world, port, dev, out, eb = (int(argv[0]), int(argv[1]), argv[2], argv[3],
                                       Path(argv[4]), float(argv[5]))
    torch.set_num_threads(2)
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        mesh = DeviceMesh(dev, torch.arange(world).reshape(world, 1, 1),
                          mesh_dim_names=INSITU_AXES)
        x = np.load(out / "field.npy", mmap_mode="r")
        spec = sharding.field_spec(x.shape, mesh)
        n = x.shape[0] // world
        local = torch.from_numpy(np.array(x[rank * n:(rank + 1) * n])).to(dev)
        field = DTensor.from_local(local, mesh, sharding.placements(spec, mesh), run_check=False,
                                   shape=x.shape, stride=(x.shape[1] * x.shape[2], x.shape[2], 1))
        res = {"spec": spec}
        for label, (codec, kw) in INSITU_CASES.items():
            kernels.reset_launch_counts()
            insitu.reset_sent_bytes()
            t0 = time.perf_counter()
            st = insitu.sharded_compress(field, codec, mesh, eb=eb if codec == "sz" else None,
                                         **kw)
            if dev == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            y = insitu.sharded_decompress(st, mesh).to_local()
            if dev == "cuda":
                torch.cuda.synchronize()
            seconds = (t1 - t0, time.perf_counter() - t1)
            launches = {k: v for k, v in kernels.launch_counts().items() if v}
            ratio = insitu.compression_ratio(st)
            hss = insitu.to_host(st)
            np.save(out / f"{dev}_{label}_r{rank}.npy", y.cpu().numpy())
            res[label] = {"launches": launches, "sent": dict(insitu.sent_bytes), "ratio": ratio,
                          "position": st.position, "hss": hss, "seconds": seconds}
        with open(out / f"{dev}_r{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def same_hss(a, b) -> bool:
    if (a.codec, a.shape, a.local_shape, a.grid, a.halo, a.backend, a.params) != \
            (b.codec, b.shape, b.local_shape, b.grid, b.halo, b.backend, b.params):
        return False
    return all(ia == ib and sorted(ba) == sorted(bb)
               and all(np.array_equal(np.asarray(ba[k]), np.asarray(bb[k])) for k in ba)
               for (ia, ba), (ib, bb) in zip(a.shards, b.shards))


def insitu_one_rank(base: torch.Tensor, eb: float, device) -> tuple[dict, dict, dict]:
    """A one-rank NCCL group in this process: the 256^3 baryon density
    through ``sz`` core + halo, ``sz`` kernel and ``zfp`` kernel equals the
    single-device entry points, stream and decode; each kernel launches once
    per shard.  Returns the single-device decodes, the host streams and the
    launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=INSITU_AXES)
        spec = sharding.field_spec(base.shape, mesh)
        single = {"sz-core": get_compressor("tpu-sz", backend="core"),
                  "sz-kernel": get_compressor("tpu-sz", backend="kernel"),
                  "zfp": get_compressor("tpu-zfp")}
        decodes, streams, total = {}, {}, dict.fromkeys(FORESIGHT_KERNELS, 0)
        for label, (codec, kw) in INSITU_CASES.items():
            comp = single[label]
            r = comp.compress(base, eb=eb) if codec == "sz" else comp.compress(base, **kw)
            decodes[label] = comp.decompress(r)
            kernels.reset_launch_counts()
            st = insitu.sharded_compress(base, codec, mesh, spec,
                                         eb=eb if codec == "sz" else None, **kw)
            y = insitu.sharded_decompress(st, mesh).to_local()
            for k, v in read_counts(INSITU_LAUNCHES[label]).items():
                total[k] += v
            if codec == "sz":
                p = r.payload["kpacked"] if label == "sz-kernel" else r.payload["parts"][0].packed
                check(same(st.words, p.words) and same(st.widths, p.widths)
                      and int(st.total_bits) == int(p.total_bits),
                      f"in-situ {label}: one-rank stream != the single-device entry point's")
            else:
                check(same_zfp(zfp_core.ZFPCompressed(st.words, st.emax, st.gtops, tuple(
                    base.shape), st.rate), r.payload["parts"][0]),
                    f"in-situ {label}: one-rank stream != the single-device entry point's")
            check(same(y, decodes[label]), f"in-situ {label}: one-rank decode != single-device")
            streams[label] = insitu.to_host(st)
        print("in-situ one-rank group (NCCL): sz core+halo, sz kernel and zfp kernel streams and "
              "decodes == the single-device entry points, bitwise; K3, K4, K6, K7 once each")
    finally:
        dist.destroy_process_group()
    return decodes, streams, total


def insitu_finish(procs: list, decodes: dict, one_rank: dict, device) -> dict:
    """Read the two-process groups: their gathered streams equal across card
    and CPU, each decoded shard and (every run) ``host_decode`` equal the
    single-device decode, each rank sends faces, scalars and its compressed
    payload only, and K3, K4, K6, K7 launch once per shard on the card.
    Then ``CheckpointManager`` saves and restores every host stream."""
    t0 = time.perf_counter()
    for p in procs:
        try:
            rc = p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = "timeout"
        if rc != 0:
            logs = "\n".join(q.read_text()[-3000:] for q in sorted(INSITU_DIR.glob("*.log")))
            raise RuntimeError(f"chip_smoke check failed: in-situ rank exited {rc}\n{logs}")
    print(f"in-situ two-process groups waited for {time.perf_counter() - t0:.2f} s")
    res = {(dev, r): pickle.load(open(INSITU_DIR / f"{dev}_r{r}.pkl", "rb"))
           for dev in ("cuda", "cpu") for r in range(INSITU_POD)}
    total = dict.fromkeys(FORESIGHT_KERNELS, 0)
    n = decodes["sz-core"].shape[0] // INSITU_POD
    face = 4 * decodes["sz-core"].shape[1] * decodes["sz-core"].shape[2]
    for label, (codec, _kw) in INSITU_CASES.items():
        hss = {dev: res[(dev, 0)][label]["hss"] for dev in ("cuda", "cpu")}
        check(same_hss(hss["cuda"], hss["cpu"]), f"in-situ {label}: card and CPU streams differ")
        check(hss["cuda"].grid == (INSITU_POD, 1, 1), f"in-situ {label}: grid {hss['cuda'].grid}")
        for (dev, r), out in res.items():
            got = out[label]
            want = INSITU_LAUNCHES[label] if dev == "cuda" else {}
            check(got["launches"] == want, f"in-situ {label} {dev} rank {r}: {got['launches']}")
            for k, v in got["launches"].items():
                total[k] += v
            y = np.load(INSITU_DIR / f"{dev}_{label}_r{r}.npy")
            check(np.array_equal(y.view(np.int32),
                                 decodes[label][r * n:(r + 1) * n].cpu().numpy().view(np.int32)),
                  f"in-situ {label} {dev} rank {r}: decoded shard != single-device decode")
            blobs = hss["cuda"].shards[r][1]
            sent = {"ppermute": face * (1 + 1) * (r == 0) if label == "sz-core" else 0,
                    "all_reduce": (4 + 8) if codec == "sz" else 0,
                    "gather": sum(np.asarray(a).nbytes for a in blobs.values()) if r else 0}
            check(got["sent"] == sent and sum(sent.values()) < 4 * decodes[label][:n].numel(),
                  f"in-situ {label} {dev} rank {r}: sent {got['sent']}, want {sent}")
        check(same(insitu.host_decode(hss["cuda"], device=device), decodes[label]),
              f"in-situ {label}: host_decode != single-device decode")
        print(f"in-situ {label} two-process gloo ({INSITU_POD} x {hss['cuda'].local_shape}): "
              f"card == CPU streams, decodes == single-device, ratio "
              f"{res[('cuda', 0)][label]['ratio']:.4f}, bytes sent by rank 0 / 1: "
              f"{res[('cuda', 0)][label]['sent']} / {res[('cuda', 1)][label]['sent']}; "
              "host s (compress, decompress; first call of the process) card "
              + ", ".join(f"{res[('cuda', r)][label]['seconds'][0]:.4f}/"
                          f"{res[('cuda', r)][label]['seconds'][1]:.4f}" for r in range(INSITU_POD))
              + " CPU " + ", ".join(f"{res[('cpu', r)][label]['seconds'][0]:.4f}/"
                                    f"{res[('cpu', r)][label]['seconds'][1]:.4f}"
                                    for r in range(INSITU_POD)))
    mgr = ckpt.CheckpointManager(INSITU_DIR / "ckpt", async_save=False)
    state = {"one_rank": one_rank,
             "two_rank": {lb: res[("cuda", 0)][lb]["hss"] for lb in INSITU_CASES}}
    mgr.save(1, state)
    saved = mgr.last_result
    back, _ = mgr.restore(state_like=state)
    for group in ("one_rank", "two_rank"):
        for label in INSITU_CASES:
            check(same(back[group][label], decodes[label]),
                  f"in-situ {group} {label}: restored leaf != single-device decode")
    files = sorted(p.name for p in (INSITU_DIR / "ckpt" / "step_000000001").glob("leaf_*"))
    print(f"CheckpointManager saved {len(files)} insitu-* shard files (ratio "
          f"{saved.ratio:.4f}) and restored all six leaves on the card, bitwise")
    return total


def foresight_and_insitu(fields: dict, small: dict, base, eb: float, device) -> dict:
    """The Foresight and in-situ phases, each timed; returns the launches of
    K3, K4, K6 and K7 over all of them (the two-process groups' included).
    The host analyses (FoF catalogs, P(k) gates) run in a pool of processes
    beside the card's phases, the two-process groups in their own."""
    total = dict.fromkeys(FORESIGHT_KERNELS, 0)

    def phase(label, t0, launches=None):
        for k, v in (launches or {}).items():
            total[k] += v
        print(f"phase {label}: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    launches, rows = cbench_sweep(fields, device)
    phase("CBench sweep (30 cases at 256^3)", t0, launches)
    t_all = time.perf_counter()
    procs = insitu_start(fields["baryon_density"], eb)
    pool = ProcessPoolExecutor(HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        t0 = time.perf_counter()
        jobs, launches = halo_start(pool, device)
        phase("halo gate, card and CPU reconstructions (FoF queued)", t0, launches)
        t0 = time.perf_counter()
        launches = guideline_on_card(fields, rows, pool, device)
        del rows
        phase("guideline at 256^3", t0, launches)
        t0 = time.perf_counter()
        guideline_card_vs_cpu(small, device)
        phase(f"guideline card vs CPU at {SMALL_N}^3", t0)
        t0 = time.perf_counter()
        phase("PAT workflow example", t0, pat_workflow(device))
        t0 = time.perf_counter()
        decodes, streams, launches = insitu_one_rank(base, eb, device)
        phase("in-situ one-rank group", t0, launches)
        t0 = time.perf_counter()
        phase("in-situ two-process groups and checkpoint", t0,
              insitu_finish(procs, decodes, streams, device))
        t0 = time.perf_counter()
        halo_finish(jobs)
        phase("halo gate, FoF results", t0)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(INSITU_DIR, ignore_errors=True)
    print(f"phase Foresight and in-situ after the sweep: {time.perf_counter() - t_all:.2f} s; "
          f"their launches: {json.dumps(total)}")
    return total


def run(device) -> dict:
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({len(logs)} sources compiled)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    resources = ptxas_resources(logs)

    t0 = time.perf_counter()
    fields = cosmo.nyx_fields(n=N, seed=SEED)
    print(f"nyx_fields(n={N}, seed={SEED}): {time.perf_counter() - t0:.2f} s")
    ebs = {k: REL_EB * float(v.max() - v.min()) for k, v in fields.items()}
    base = torch.from_numpy(fields["baryon_density"]).to(device)
    vx = torch.from_numpy(fields["vx"]).to(device)
    ragged = vx[: N - 56, : N - 126, : N - 6].contiguous()
    inputs = {f"{N}^3 baryon_density": (base, ebs["baryon_density"]),
              "ragged vx": (ragged, ebs["vx"])}
    worst = kernels_vs_plain(inputs, device)

    launches = main_path(fields, device)
    agrees_with_cpu(cosmo.nyx_fields(n=SMALL_N, seed=SEED), device)
    hacc = cosmo.hacc_particles(grid=HACC_GRID)
    core_backend(fields["baryon_density"], hacc.fields["vx"], device)

    worst.update(zfp_kernels_vs_plain({f"{N}^3 baryon_density": base, "ragged vx": ragged},
                                      device))
    launches.update(zfp_main_path(fields, device))
    zfp_nyx_512(base)
    zfp_agrees_with_cpu(cosmo.nyx_fields(n=SMALL_N, seed=SEED), device)
    zfp_hacc(hacc, device)

    names = list(fields)
    xb = torch.stack([torch.from_numpy(fields[k]).to(device) for k in names[:K_ROWS]])
    eb_rows = sz_core.internal_bound(xb.abs().amax(dim=(1, 2, 3)),
                                     torch.tensor([ebs[k] for k in names[:K_ROWS]], device=device))
    small3 = torch.stack([torch.from_numpy(fields[k][:16, :128, :256].copy()).to(device)
                          for k in ("vx", "vy", "vz")])
    eb3 = sz_core.internal_bound(small3.abs().amax(dim=(1, 2, 3)), torch.tensor(
        [REL_EB * 2e8, 1e-3 * 2e8, 1e-2 * 2e8], device=device))
    xr, ebr = sz_cases.rows()
    hard = sz_cases.cases(SEED)
    edge = torch.stack([torch.zeros(16, 64, 128), hard["full_width"][0].repeat(2, 1, 1), xr[0]])
    worst.update(batched_vs_plain({f"{K_ROWS} x {N}^3 Nyx": (xb, eb_rows),
                                   "3 x (16, 128, 256) vx/vy/vz": (small3, eb3),
                                   "sz_cases.rows (ratios > 4x apart)": (xr.to(device),
                                                                         ebr.to(device)),
                                   "rows at width 0, 32 and mixed": (edge.to(device), torch.tensor(
                                       [1e-2, 1.0, 0.5], device=device))}))
    small = cosmo.nyx_fields(n=SMALL_N, seed=SEED)
    try:
        launches.update(snapshot_path(fields, hacc, small, device))
        snapshot_agrees_with_cpu(fields, hacc, device)
    finally:
        shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)

    foresight = foresight_and_insitu(fields, small, base, ebs["baryon_density"], device)

    torch.backends.cuda.matmul.allow_tf32 = False  # the comparison phases run in full f32
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off from here: torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}")
    worst["kvc_decode_attention"] = k10_vs_plain(device)
    serving = serving_full_width(device)
    launches["kvc_decode_attention"] = serving["k10_launches"]
    serving_card_vs_cpu(device)

    stages = stage_times(base, ebs["baryon_density"])
    print(f"stages at {N}^3 baryon_density (median ms; peak MiB): " + json.dumps(stages))
    stages = zfp_stage_times(base)
    print(f"ZFP stages at {N}^3 baryon_density, rate {ZFP_RATE} (median ms; peak MiB): "
          + json.dumps(stages))
    times = kernel_times(base, ebs["baryon_density"])
    times.update(batched_kernel_times(xb, eb_rows))
    times["kvc_decode_attention"], _ = k10_times(device, serving, resources)
    k1 = times["lorenzo3d_quantize"]
    print("K1 (graph replay ms, bound ms, share of bound, registers and spill bytes): "
          + json.dumps({"ms": k1["ms"], "bound_ms": k1["bound_ms"],
                        "share_of_bound": k1["bound_ms"] / k1["ms"],
                        **resources.get("lorenzo3d_quantize_kernel", {})}))
    print("kernel bounds (ms: bytes, operations, per pipe) and event-timed direct calls (ms): "
          + json.dumps({name: [t["bytes_ms"], t["ops_ms"], t.get("pipes_ms"), t["call_ms"]]
                        for name, t in times.items()}))
    rows = []
    for name, (kid, source, replaces) in KERNELS.items():
        t = times[name]
        rows.append({"name": f"{kid} {name}", "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name] + foresight.get(name, 0),
                     "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t.get("library_ms")})
    return {"kernels": rows}


def main() -> int:
    if sys.argv[1:2] == ["--insitu-rank"]:  # one rank of a two-process group (insitu_start)
        return insitu_worker(sys.argv[2:])
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

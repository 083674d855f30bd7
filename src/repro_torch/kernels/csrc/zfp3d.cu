// K5: the TPU-ZFP block stage on Hopper (sm_90a): block-floating-point
// alignment + exact integer lifting + negabinary + per-group top planes.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   K5 zfp3d_transform  repro/kernels/zfp3d.py:116 (_zfp_kernel :101)
//
// In: f32 blocks (NB, 4, 4, 4), carved by repro_torch.core.zfp._carve_blocks.
// Out: uint32 negabinary coefficients [NB, 64] in index order (x fastest),
// uint8 emax [NB] (e + 128, or 0 for a zero block) and uint8 gtops [NB, 10]
// (the max bit length of each sequency group), the dtypes ZFPCompressed
// stores.  The embedded coder of this (xla) path runs outside, in PyTorch.
//
// Bound.  It reads 4 B/pt of f32 and writes 4 B/pt of coefficients plus 11
// header bytes per 64 points: ~8.17 B/pt, ~41 us for a 256^3 field at
// 3.35 TB/s.  The operations it needs (~21 a point: stages 1-3 and the group
// maxima, as chip_smoke.py counts them) take ~10 us at the INT32 rate, so
// the bytes bound it.
//
// Design.  One warp per ZFP block, 8 blocks per CTA: a warp reads its
// block's 256 contiguous bytes (lane l takes values l and l + 32), so a
// CTA's loads and stores are contiguous 2 KiB runs.  The shared stages
// (zfp_block.cuh) take |x|max with a warp max of the |x| bit patterns, lift
// in a 64-word shared scratch (16 lanes, one 4-line each, per axis), and the
// group maxima are 10 warp reductions.  Any NB is taken: warps past the last
// block return (the JAX package pads NB to its 256-block VMEM tile instead).
#include "zfp_block.cuh"

namespace {

__global__ void __launch_bounds__(zfp::WARPS * 32)
zfp3d_transform_kernel(const float* __restrict__ blocks, uint32_t* __restrict__ u,
                       uint8_t* __restrict__ emax, uint8_t* __restrict__ gtops, long long nb) {
  __shared__ int32_t scratch[zfp::WARPS][64];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * zfp::WARPS + warp;
  if (b >= nb) return;  // whole warps only: every warp op below sees 32 lanes

  const zfp::BlockFloat bf = zfp::block_float_negabinary(blocks + b * 64, lane, scratch[warp]);
  u[b * 64 + lane] = bf.u0;
  u[b * 64 + lane + 32] = bf.u1;
  int tops[zfp::N_GROUPS];
  zfp::group_tops(bf.u0, zfp::degree(lane), bf.u1, zfp::degree(lane + 32), bf.nonzero, tops);
#pragma unroll
  for (int g = 0; g < zfp::N_GROUPS; ++g)
    if (lane == g) gtops[b * zfp::N_GROUPS + g] = static_cast<uint8_t>(tops[g]);
  if (lane == 0) emax[b] = static_cast<uint8_t>(bf.nonzero ? bf.e + zfp::EMAX_BIAS : 0);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING()

// blocks: f32 (nb, 4, 4, 4); u: uint32 (nb, 64); emax: uint8 (nb);
// gtops: uint8 (nb, 10).  Launches on ``stream``, returns cudaGetLastError().
extern "C" int zfp3d_transform(const float* blocks, uint32_t* u, uint8_t* emax, uint8_t* gtops,
                               long long nb, cudaStream_t stream) {
  const long long grid = (nb + zfp::WARPS - 1) / zfp::WARPS;
  if (grid > 0)
    zfp3d_transform_kernel<<<static_cast<unsigned>(grid), zfp::WARPS * 32, 0, stream>>>(
        blocks, u, emax, gtops, nb);
  return static_cast<int>(cudaGetLastError());
}

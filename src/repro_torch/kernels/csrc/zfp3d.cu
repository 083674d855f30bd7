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
// 3.35 TB/s.  The operations it needs (~16.7 integer operations a point:
// stages 1-3 and the group tops, as chip_smoke.py counts them) take ~17 us
// at the INT32 pipe's rate and its conversions ~5 us, so the bytes bound it.
//
// Design.  K6's stages on K6's layout (zfp_block.cuh): one ZFP block per
// thread, 64 blocks per CTA; the CTA's contiguous span of floats comes in
// through the swizzled shared tile with 16-byte loads, each thread runs
// stages 1-3 on its block in registers and writes its 64 coefficients back
// into its row of the tile, and the tile goes out with 16-byte stores, the
// headers bytewise.  Any NB is taken: threads past the last block only help
// move the tile (the JAX package pads NB to its 256-block VMEM tile instead).
#include "zfp_block.cuh"

namespace {

using zfp::TILE;

__global__ void __launch_bounds__(TILE)
zfp3d_transform_kernel(const float* __restrict__ blocks, uint32_t* __restrict__ u_out,
                       uint8_t* __restrict__ emax, uint8_t* __restrict__ gtops, long long nb) {
  __shared__ __align__(16) uint32_t buf[TILE * 64];
  __shared__ uint8_t hdr[TILE * (zfp::N_GROUPS + 1)];  // gtops rows, then emax
  const long long b0 = static_cast<long long>(blockIdx.x) * TILE;
  const int nbc = static_cast<int>(min(static_cast<long long>(TILE), nb - b0));
  const int t = threadIdx.x;

  zfp::load_tile(buf, reinterpret_cast<const uint32_t*>(blocks + b0 * 64), nbc);
  __syncthreads();
  uint32_t u[64];
  if (t < nbc) {
    float v[64];
    zfp::Header h;
    zfp::read_row(buf, t, v, t & 7);
    zfp::forward_block(v, u, h);
#pragma unroll
    for (int g = 0; g < zfp::N_GROUPS; ++g)
      hdr[t * zfp::N_GROUPS + g] = static_cast<uint8_t>(h.tops[g]);
    hdr[TILE * zfp::N_GROUPS + t] = static_cast<uint8_t>(h.emax);
  }
  __syncthreads();  // every row is read: the tile takes the coefficients
  if (t < nbc) zfp::write_row(buf, t, u, t & 7);
  __syncthreads();
  zfp::store_tile(u_out + b0 * 64, buf, nbc);
  zfp::store_bytes(gtops + b0 * zfp::N_GROUPS, hdr, nbc * zfp::N_GROUPS);
  zfp::store_bytes(emax + b0, hdr + TILE * zfp::N_GROUPS, nbc);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING()

// blocks: f32 (nb, 4, 4, 4); u: uint32 (nb, 64); emax: uint8 (nb);
// gtops: uint8 (nb, 10).  Launches on ``stream``, returns cudaGetLastError().
extern "C" int zfp3d_transform(const float* blocks, uint32_t* u, uint8_t* emax, uint8_t* gtops,
                               long long nb, cudaStream_t stream) {
  const long long grid = (nb + TILE - 1) / TILE;
  if (grid > 0)
    zfp3d_transform_kernel<<<static_cast<unsigned>(grid), TILE, 0, stream>>>(
        blocks, u, emax, gtops, nb);
  return static_cast<int>(cudaGetLastError());
}

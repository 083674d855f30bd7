// K6 and K7: single-pass fused TPU-ZFP encode and decode on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   K6 fused encode  repro/kernels/zfp_fused.py:84 fused_compress_blocks
//                    (_fused_encode_kernel :76)
//   K7 fused decode  repro/kernels/zfp_fused.py:161 fused_decompress_blocks
//                    (_fused_decode_kernel :139)
//
// Stream (the contract, repro/core/zfp.py:395-469).  Per block: 10 group
// tops in a header; stream-major plane j (bit plane 31 - j) owns a payload
// of the bits of its present groups' coefficients (groups in order, each
// run in sequency order) at bit offset OFF[j] = sum over groups of
// size_g * max(0, gtops[g] + j - 32), cut to the budget rate*64 - 58 bits;
// the block's wpb = 2*rate - 1 words hold the payloads back to back.
//
// Bound.  K6 reads 4 B/pt of f32 and writes (8*rate + 7)/64 B/pt: the
// stream words plus the uint8 emax and 10 uint8 gtops (11 B per block).
// K7 moves the same bytes the other way.  At rate 8 that is 5.11 B/pt,
// ~26 us for a 256^3 field at 3.35 TB/s.  The operations the coder needs
// (chip_smoke.py zfp_ops): two 32x32 bit transposes at their scalar cost
// and the plane layout per block, then masks and placement per plane that
// keeps bits and shifts per group run in it, which the headers fix.  On
// Nyx at rate 8 that is ~52 operations a point for K6 (stages 1-3
// included) and ~48 for K7, ~26 and ~24 us at the INT32 rate: the same as
// the bytes' time.  The warp issues far more than that (64 full-warp
// ballots each way, lifts on 16 of 32 lanes), which is where its time
// goes; packing two blocks per warp is later work.
//
// Design.  One warp per ZFP block, 8 per CTA, as K5 (zfp_block.cuh gives
// stages 1-3).  K6: the index-order coefficients go through the warp's
// shared scratch to sequency order (PERM below), so lane l holds sequency
// coefficients l and l + 32.  The plane bit-matrix is 64 ballots: W0[j] =
// ballot of bit 31 - j of coefficients 0..31, bit c = coefficient c, which
// is what the reference's two 32x32 transposes compute (zfp.py:307-345).
// Lane j then owns plane j: it computes OFF[j] and keep[j] from the tops,
// compacts the 10 group runs (static starts, header-derived offsets), masks
// by keep and ORs its <= 3 words into a 64-word shared row.  No payload bit
// lies past word 63 (32 planes x 64 bits), so words 64.. of a long row are
// zero and any rate works.  The row is written out coalesced.  K7: lane j
// fetches its plane's <= 3 words straight from the block's row (0 past word
// wpb - 1, never past the tensor), extracts the runs back into the plane
// matrix, and 64 ballots with a bit reversal transpose it back to
// coefficients; then the inverse permutation through shared memory, inverse
// negabinary, inverse lift and x 2^(e - 25) built in exponent bits.
#include "zfp_block.cuh"

namespace {

// Sequency order: PERM[s] is the index-order position of sequency
// coefficient s (repro_torch.core.zfp.PERM; a CPU test holds the two equal).
__constant__ uint8_t PERM[64] = {
    0,  1,  4,  16, 2,  5,  8,  17, 20, 32, 3,  6,  9,  12, 18, 21,
    24, 33, 36, 48, 7,  10, 13, 19, 22, 25, 28, 34, 37, 40, 49, 52,
    11, 14, 23, 26, 29, 35, 38, 41, 44, 50, 53, 56, 15, 27, 30, 39,
    42, 45, 51, 54, 57, 60, 31, 43, 46, 55, 58, 61, 47, 59, 62, 63};

// Group sizes and their first sequency coefficient (zfp.GROUP_SIZES,
// zfp._FIXED_START: 0, 1, 4, 10, 20, 32, 44, 54, 60, 63): groups 0-4 fill
// coefficients 0..31, groups 5-9 32..63.  Functions, not arrays: device
// code may not index a host constexpr array; unrolled loops fold these.
__device__ __forceinline__ constexpr int group_size(int g) {
  return g == 0 || g == 9 ? 1 : g == 1 || g == 8 ? 3 : g == 2 || g == 7 ? 6
       : g == 3 || g == 6 ? 10 : 12;
}
__device__ __forceinline__ constexpr int group_start(int g) {
  int s = 0;
  for (int i = 0; i < g; ++i) s += group_size(i);
  return s;
}
constexpr int ROW_WORDS = 64;  // no payload bit lies past word 63

// Plane j's global bit offset OFF and kept bit count keep (zfp.py:278-299).
struct PlaneLayout {
  int off, keep;
};

__device__ __forceinline__ PlaneLayout plane_layout(const int (&tops)[zfp::N_GROUPS], int j,
                                                    int budget) {
  int off = 0, pw = 0;
#pragma unroll
  for (int g = 0; g < zfp::N_GROUPS; ++g) {
    const int t = tops[g] + j - 32;
    off += group_size(g) * max(t, 0);
    pw += t >= 0 ? group_size(g) : 0;
  }
  return {off, min(max(budget - off, 0), pw)};
}

__global__ void __launch_bounds__(zfp::WARPS * 32)
zfp_fused_encode_kernel(const float* __restrict__ blocks, uint32_t* __restrict__ words,
                        uint8_t* __restrict__ emax, uint8_t* __restrict__ gtops, long long nb,
                        int wpb, int budget) {
  __shared__ int32_t scratch[zfp::WARPS][64];
  __shared__ uint32_t rows[zfp::WARPS][ROW_WORDS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * zfp::WARPS + warp;
  if (b >= nb) return;  // whole warps only: every warp op below sees 32 lanes
  int32_t* s = scratch[warp];
  uint32_t* row = rows[warp];

  // stages 1-3, then sequency order through the scratch
  const zfp::BlockFloat bf = zfp::block_float_negabinary(blocks + b * 64, lane, s);
  __syncwarp();
  s[lane] = static_cast<int32_t>(bf.u0);
  s[lane + 32] = static_cast<int32_t>(bf.u1);
  row[lane] = 0u;
  row[lane + 32] = 0u;
  __syncwarp();
  const int p0 = PERM[lane], p1 = PERM[lane + 32];
  const uint32_t q0 = static_cast<uint32_t>(s[p0]), q1 = static_cast<uint32_t>(s[p1]);
  int tops[zfp::N_GROUPS];
  zfp::group_tops(q0, zfp::degree(p0), q1, zfp::degree(p1), bf.nonzero, tops);

  // plane bit-matrix: lane j keeps W0[j], W1[j]
  uint32_t w0 = 0u, w1 = 0u;
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    const uint32_t m0 = __ballot_sync(zfp::FULL, (q0 >> (31 - j)) & 1u);
    const uint32_t m1 = __ballot_sync(zfp::FULL, (q1 >> (31 - j)) & 1u);
    if (lane == j) {
      w0 = m0;
      w1 = m1;
    }
  }

  // lane j: compact plane j's group runs into its <= 64-bit payload
  const PlaneLayout pl = plane_layout(tops, lane, budget);
  uint32_t plo = 0u, phi = 0u;
  int woff = 0;
#pragma unroll
  for (int g = 0; g < zfp::N_GROUPS; ++g) {
    const uint32_t src = group_start(g) < 32 ? w0 : w1;
    const uint32_t run = (src >> (group_start(g) & 31)) & zfp::code_mask(group_size(g));
    const uint32_t o1 = static_cast<uint32_t>(woff & 31);
    const uint32_t lo_c = run << o1;
    const uint32_t hi_c = (run >> 1) >> (31u - o1);  // run >> (32 - o1); 0 at o1 == 0
    if (woff >= 32) {
      phi |= lo_c;
    } else {
      plo |= lo_c;
      phi |= hi_c;
    }
    woff += tops[g] + lane >= 32 ? group_size(g) : 0;
  }
  plo &= zfp::code_mask(min(pl.keep, 32));
  phi &= zfp::code_mask(min(max(pl.keep - 32, 0), 32));

  // place the payload at OFF: it touches words OFF >> 5 .. + 2
  const uint32_t sh = static_cast<uint32_t>(pl.off & 31);
  const int first = pl.off >> 5;
  const uint32_t c[3] = {plo << sh, ((plo >> 1) >> (31u - sh)) | (phi << sh),
                         (phi >> 1) >> (31u - sh)};
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (c[k] != 0u && first + k < ROW_WORDS) atomicOr(row + first + k, c[k]);
  __syncwarp();

  uint32_t* dst = words + b * wpb;
  for (int k = lane; k < wpb; k += 32) dst[k] = k < ROW_WORDS ? row[k] : 0u;
#pragma unroll
  for (int g = 0; g < zfp::N_GROUPS; ++g)
    if (lane == g) gtops[b * zfp::N_GROUPS + g] = static_cast<uint8_t>(tops[g]);
  if (lane == 0) emax[b] = static_cast<uint8_t>(bf.nonzero ? bf.e + zfp::EMAX_BIAS : 0);
}

__global__ void __launch_bounds__(zfp::WARPS * 32)
zfp_fused_decode_kernel(const uint32_t* __restrict__ words, const uint8_t* __restrict__ emax,
                        const uint8_t* __restrict__ gtops, float* __restrict__ out, long long nb,
                        int wpb, int budget) {
  __shared__ int32_t scratch[zfp::WARPS][64];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * zfp::WARPS + warp;
  if (b >= nb) return;  // whole warps only
  int32_t* s = scratch[warp];

  const int mine = lane < zfp::N_GROUPS ? __ldg(gtops + b * zfp::N_GROUPS + lane) : 0;
  int tops[zfp::N_GROUPS];
#pragma unroll
  for (int g = 0; g < zfp::N_GROUPS; ++g) tops[g] = __shfl_sync(zfp::FULL, mine, g);

  // lane j: fetch plane j's <= 3 words from the block's row (0 past its end)
  const PlaneLayout pl = plane_layout(tops, lane, budget);
  const uint32_t* row = words + b * wpb;
  const int first = pl.off >> 5;
  uint32_t g3[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) g3[k] = first + k < wpb ? __ldg(row + first + k) : 0u;
  const uint32_t sh = static_cast<uint32_t>(pl.off & 31);
  uint32_t plo = (g3[0] >> sh) | ((g3[1] << 1) << (31u - sh));
  uint32_t phi = (g3[1] >> sh) | ((g3[2] << 1) << (31u - sh));
  plo &= zfp::code_mask(min(pl.keep, 32));
  phi &= zfp::code_mask(min(max(pl.keep - 32, 0), 32));

  // the group runs back to their static places in the plane bit-matrix
  uint32_t w0 = 0u, w1 = 0u;
  int woff = 0;
#pragma unroll
  for (int g = 0; g < zfp::N_GROUPS; ++g) {
    const uint32_t o1 = static_cast<uint32_t>(woff & 31);
    const bool in_hi = woff >= 32;
    const uint32_t base_lo = in_hi ? phi : plo;
    const uint32_t base_hi = in_hi ? 0u : phi;
    const int wg = tops[g] + lane >= 32 ? group_size(g) : 0;
    const uint32_t run =
        ((base_lo >> o1) | ((base_hi << 1) << (31u - o1))) & zfp::code_mask(wg);
    if (group_start(g) < 32) {
      w0 |= run << group_start(g);
    } else {
      w1 |= run << (group_start(g) - 32);
    }
    woff += wg;
  }

  // transpose back: coefficient c's bit 31 - j is bit c of plane j's word
  uint32_t q0 = 0u, q1 = 0u;
#pragma unroll 4
  for (int c = 0; c < 32; ++c) {
    const uint32_t m0 = __ballot_sync(zfp::FULL, (w0 >> c) & 1u);
    const uint32_t m1 = __ballot_sync(zfp::FULL, (w1 >> c) & 1u);
    if (lane == c) {
      q0 = __brev(m0);
      q1 = __brev(m1);
    }
  }

  // inverse permutation, inverse negabinary, inverse lift, scale
  s[PERM[lane]] = zfp::inv_negabinary(q0);
  s[PERM[lane + 32]] = zfp::inv_negabinary(q1);
  __syncwarp();
  zfp::inv_lift3d(s, lane);
  const int em = __ldg(emax + b);
  const int k = min(max(em - zfp::EMAX_BIAS - zfp::Q, -126), 127);
  const float scale = em > 0 ? __uint_as_float(static_cast<uint32_t>(k + 127) << 23) : 0.0f;
  out[b * 64 + lane] = static_cast<float>(s[lane]) * scale;
  out[b * 64 + lane + 32] = static_cast<float>(s[lane + 32]) * scale;
}

}  // namespace

REPRO_DEFINE_ERROR_STRING()

// blocks: f32 (nb, 4, 4, 4); words: uint32 (nb, wpb), wpb = 2*rate - 1;
// emax: uint8 (nb); gtops: uint8 (nb, 10); budget = rate*64 - 58 bits.
extern "C" int zfp_fused_encode(const float* blocks, uint32_t* words, uint8_t* emax,
                                uint8_t* gtops, long long nb, int wpb, int budget,
                                cudaStream_t stream) {
  const long long grid = (nb + zfp::WARPS - 1) / zfp::WARPS;
  if (grid > 0)
    zfp_fused_encode_kernel<<<static_cast<unsigned>(grid), zfp::WARPS * 32, 0, stream>>>(
        blocks, words, emax, gtops, nb, wpb, budget);
  return static_cast<int>(cudaGetLastError());
}

// The inverse: words/emax/gtops as zfp_fused_encode writes them -> f32
// blocks (nb, 4, 4, 4).
extern "C" int zfp_fused_decode(const uint32_t* words, const uint8_t* emax, const uint8_t* gtops,
                                float* blocks, long long nb, int wpb, int budget,
                                cudaStream_t stream) {
  const long long grid = (nb + zfp::WARPS - 1) / zfp::WARPS;
  if (grid > 0)
    zfp_fused_decode_kernel<<<static_cast<unsigned>(grid), zfp::WARPS * 32, 0, stream>>>(
        words, emax, gtops, blocks, nb, wpb, budget);
  return static_cast<int>(cudaGetLastError());
}

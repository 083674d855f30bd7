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
// K7 moves the same bytes the other way: at rate 8, 5.11 B/pt, ~26 us for a
// 256^3 field at 3.35 TB/s.  The least integer work the functions need
// (chip_smoke.py zfp_ops: stages 1-3, the group tops as ORs and a bit
// length, two 32x32 bit transposes, the layout once per block, and per
// kept plane (~9 of 32 on Nyx) the payload's placement plus a squeeze per
// absent group run) is ~27.5 operations a point for K6 and ~24.3 for K7
// on Nyx at rate 8: ~28 and ~24 us at the INT32 pipe's 16.7 T/s.  The
// float<->int32 conversions (1 a point, 16 per SM per clock) take ~5 us.
// So K6's bound is integer issue, a little above the bytes', and K7's is
// the bytes'; both kernels run at under half of it (PERF.md).
//
// Design: one ZFP block per thread, TILE = 64 blocks per CTA, so the work a
// thread issues is the coder's scalar work with no idle lanes and no warp
// collectives (a warp per block spends several warp instructions per scalar
// step: lanes idle in the lifts, a warp reduction per group top, a ballot
// per bit plane each way).  cuZFP also gives a block a thread.
//  - The floats are read and written in place in the field itself (zfp_block.cuh
//    Field), in the blocks' order of core/zfp.py _carve_blocks, so no carved
//    copy is made: the padding is replicated on read and cropped on write.
//    Carved (nb, 4, 4, 4) blocks, the snapshot arena's, are the field
//    (4 nb, 4, 4).  16-byte quads move with coalesced accesses, through a
//    swizzled tile in shared memory where a CTA's floats are one run (each
//    thread then reads its own 256-byte row with conflict-free 16-byte
//    loads), else straight to a thread's registers, a warp's quads running
//    along z.
//  - Stages 1-3 run on 64 registers (forward_block); the sequency
//    permutation is a renaming; a group's top plane is the bit length of
//    the OR of its members.
//  - Two 32x32 bit transposes in registers (two byte-permute rounds, three
//    shift-and-select rounds) turn coefficients into plane rows.
//  - The plane loop is unrolled over the 32 planes (plane rows stay in
//    registers) and does work only from the first plane a group enters to
//    the plane that spends the budget: ~9 of 32 per block on Nyx at rate 8.
//    A plane's compaction squeezes out the (zero) runs of its absent groups
//    with constant shifts and masks, a branch per group; absent groups are
//    ~1.6 of 10 per kept plane there.  The payload goes to OFF in the
//    thread's own row of shared memory, whose stride is wpb (always odd) or
//    65, so the rows a warp writes are bank-conflict free and no atomics are
//    needed; the row's current word is carried in a register, so the row is
//    written and never read back.
//  - The CTA's rows are then one contiguous run of its words: stored with
//    16-byte stores (rates up to 32; above, words 64 on of a row are zero).
//    emax and gtops go through shared memory the same way, bytewise.
// K7 mirrors it: rows in, each plane's <= 3 words fetched at OFF (a
// thread's fetch may read past its row; those bits lie past keep and are
// masked, as the reference reads 0 past the row), the absent runs put back
// with no branch (a zero-width insertion where a group is present), the
// inverse transposes, the inverse permutation by renaming, stages 1-3
// inverted, the floats out to the field the way K6 read them.
// Every index into a thread's arrays is a compile-time constant, so nothing
// goes to local memory: ptxas reports 0 spill bytes for both kernels (K6
// 112 registers, K7 96; chip_smoke.py prints the report at each build).
#include "zfp_block.cuh"

namespace {

using zfp::TILE;

__global__ void __launch_bounds__(TILE)
zfp_fused_encode_kernel(const float* __restrict__ x, zfp::Field f, uint32_t* __restrict__ words,
                        uint8_t* __restrict__ emax, uint8_t* __restrict__ gtops, long long nb,
                        int wpb, int budget) {
  __shared__ __align__(16) uint32_t buf[zfp::BUF_WORDS];
  __shared__ uint8_t hdr[TILE * (zfp::N_GROUPS + 1)];  // gtops rows, then emax
  const long long b0 = static_cast<long long>(blockIdx.x) * TILE;
  const int nbc = static_cast<int>(min(static_cast<long long>(TILE), nb - b0));
  const int t = threadIdx.x;
  const int cap = min(wpb, zfp::ROW_WORDS), rs = min(wpb, zfp::ROW_WORDS + 1);

  float v[64];
  f.load(buf, x, b0, nbc, v);  // the buffer is free again: its rows become stream rows
  if (t < nbc) {
    uint32_t u[64];
    zfp::Header h;
    zfp::forward_block(v, u, h);
    zfp::encode_planes(u, h, budget, cap, rs, buf + t * rs);
#pragma unroll
    for (int g = 0; g < zfp::N_GROUPS; ++g)
      hdr[t * zfp::N_GROUPS + g] = static_cast<uint8_t>(h.tops[g]);
    hdr[TILE * zfp::N_GROUPS + t] = static_cast<uint8_t>(h.emax);
  }
  __syncthreads();

  uint32_t* dst = words + b0 * wpb;
  if (rs == wpb) {
    zfp::store_words(dst, buf, nbc * wpb);
  } else {  // rate > 32: rows of 65 words here; words 64.. of a block are 0
    for (int i = t; i < nbc * wpb; i += TILE) {
      const int b = i / wpb, k = i - b * wpb;
      dst[i] = k < zfp::ROW_WORDS ? buf[b * rs + k] : 0u;
    }
  }
  zfp::store_bytes(gtops + b0 * zfp::N_GROUPS, hdr, nbc * zfp::N_GROUPS);
  zfp::store_bytes(emax + b0, hdr + TILE * zfp::N_GROUPS, nbc);
}

__global__ void __launch_bounds__(TILE)
zfp_fused_decode_kernel(const uint32_t* __restrict__ words, const uint8_t* __restrict__ emax,
                        const uint8_t* __restrict__ gtops, float* __restrict__ x, zfp::Field f,
                        long long nb, int wpb, int budget) {
  __shared__ __align__(16) uint32_t buf[zfp::BUF_WORDS];
  __shared__ uint8_t hdr[TILE * (zfp::N_GROUPS + 1)];
  const long long b0 = static_cast<long long>(blockIdx.x) * TILE;
  const int nbc = static_cast<int>(min(static_cast<long long>(TILE), nb - b0));
  const int t = threadIdx.x;
  const int rs = min(wpb, zfp::ROW_WORDS + 1);

  const uint32_t* src = words + b0 * wpb;
  if (rs == wpb) {
    zfp::load_words(buf, src, nbc * wpb);
  } else {  // rate > 32: only words 0..63 of a row can hold payload bits
    for (int i = t; i < nbc * zfp::ROW_WORDS; i += TILE) {
      const int b = i >> 6, k = i & 63;
      buf[b * rs + k] = __ldg(src + static_cast<long long>(b) * wpb + k);
    }
  }
  if (t < 2) buf[nbc * rs + t] = 0u;  // what the last row's fetch may read past it
  zfp::load_bytes(hdr, gtops + b0 * zfp::N_GROUPS, nbc * zfp::N_GROUPS);
  zfp::load_bytes(hdr + TILE * zfp::N_GROUPS, emax + b0, nbc);
  __syncthreads();
  float v[64];
  if (t < nbc) {
    zfp::Header h;
#pragma unroll
    for (int g = 0; g < zfp::N_GROUPS; ++g) h.tops[g] = hdr[t * zfp::N_GROUPS + g];
    h.emax = hdr[TILE * zfp::N_GROUPS + t];
    uint32_t u[64];
    zfp::decode_planes(buf + t * rs, h, budget, u);
    zfp::inverse_block(u, h.emax, v);
  }
  f.store(buf, x, b0, nbc, v);
}

// The Field of a contiguous (X, Y, Z) f32 field at p (see zfp_block.cuh).
zfp::Field field_layout(const void* p, long long X, long long Y, long long Z) {
  zfp::Field f{X, Y, Z, (Y + 3) / 4, (Z + 3) / 4, false, false, 0, 0, 0, {}};
  f.vec = Z % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const long long per_slab = f.gy * f.gz;
  if (f.vec && Y % 4 == 0 && per_slab > 0 && TILE % per_slab == 0) {
    f.slab = true;
    f.lgy = __builtin_ctzll(f.gy);
    f.lgz = __builtin_ctzll(f.gz);
    // A line's 8 quads: the low 3 bits of j are bz's lgz bits, then i2's
    // (chunk bits 0, 1), then by's or i1's; rotating the row's bits so that
    // the varying ones reach the bank bits left free gives 8 banks.
    f.rot = f.lgz >= 3 ? 0 : f.lgz == 2 ? 1 : 2;
    for (int k = 0; k < 16; ++k) f.step[k] = static_cast<uint16_t>(f.slab_tile(64 * k));
  }
  return f;
}

}  // namespace

REPRO_DEFINE_ERROR_STRING()

// x: f32 (X, Y, Z) contiguous, whose blocks are those of core/zfp.py
// _carve_blocks(x), nb = ceil(X/4) * ceil(Y/4) * ceil(Z/4) of them in that
// order (carved blocks: X = 4 nb, Y = Z = 4); words: uint32 (nb, wpb),
// wpb = 2*rate - 1; emax: uint8 (nb); gtops: uint8 (nb, 10); budget =
// rate*64 - 58 bits.
extern "C" int zfp_fused_encode(const float* x, uint32_t* words, uint8_t* emax, uint8_t* gtops,
                                long long X, long long Y, long long Z, int wpb, int budget,
                                cudaStream_t stream) {
  const zfp::Field f = field_layout(x, X, Y, Z);
  const long long nb = (X + 3) / 4 * f.gy * f.gz;
  const long long grid = (nb + TILE - 1) / TILE;
  if (grid > 0)
    zfp_fused_encode_kernel<<<static_cast<unsigned>(grid), TILE, 0, stream>>>(
        x, f, words, emax, gtops, nb, wpb, budget);
  return static_cast<int>(cudaGetLastError());
}

// The inverse: words/emax/gtops as zfp_fused_encode writes them -> the
// field x, f32 (X, Y, Z) contiguous; only its points are written
// (_uncarve_blocks' crop).
extern "C" int zfp_fused_decode(const uint32_t* words, const uint8_t* emax, const uint8_t* gtops,
                                float* x, long long X, long long Y, long long Z, int wpb,
                                int budget, cudaStream_t stream) {
  const zfp::Field f = field_layout(x, X, Y, Z);
  const long long nb = (X + 3) / 4 * f.gy * f.gz;
  const long long grid = (nb + TILE - 1) / TILE;
  if (grid > 0)
    zfp_fused_decode_kernel<<<static_cast<unsigned>(grid), TILE, 0, stream>>>(
        words, emax, gtops, x, f, nb, wpb, budget);
  return static_cast<int>(cudaGetLastError());
}

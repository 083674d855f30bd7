// Device code shared by the TPU-ZFP kernels (zfp3d.cu: K5, zfp_fused.cu: K6
// and K7).  One thread owns one 4x4x4 ZFP block: stages 1-3 (block-floating-
// point, the exact integer lifts, negabinary), the group top planes, the two
// 32x32 bit transposes, the plane-parallel embedded coder and its inverse
// all run on the block's 64 values in the thread's registers.  A CTA owns a
// contiguous span of TILE blocks and moves it between device memory and
// shared memory with coalesced 16-byte accesses (the tile helpers at the
// end).  K5 and K6 must agree bit for bit (the xla and fused paths emit the
// same stream), so, as the JAX package shares block_float_negabinary between
// its two kernels (repro/kernels/zfp3d.py:75-98), these stages exist once.
//
// Index order: value c = 16*i1 + 4*i2 + i3 of a block over its (4, 4, 4)
// axes (x fastest).  Every index into a thread's arrays below is a
// compile-time constant once the loops are unrolled, so the arrays live in
// registers; the sequency permutation is a renaming of registers.
//
// Arithmetic.  The lifts add, subtract and shift left in uint32_t (defined
// wrap, equal to the reference's int32 arithmetic mod 2^32) and shift right
// on int32_t, which is arithmetic, as jnp's >> on int32 and the floor shift
// the lift needs.  Rounding is __float2int_rn: half to even, saturating,
// NaN to 0, as the reference's jnp.round(...).astype(jnp.int32) converts on
// XLA (and repro_torch.core.bitpack.round_i32 on the CPU).  Never build with
// --use_fast_math or -ftz=true: the scale multiplies must stay IEEE.
//
// Subnormals.  The reference runs where subnormals are flushed (the TPU,
// XLA on the CPU), so a block whose |x|max is subnormal is a zero block
// there.  Here a block is nonzero iff |x|max is a normal float or inf (not
// NaN), as repro_torch.core.zfp states; subnormal values quantize to 0 anyway.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace zfp {

constexpr int Q = 25;            // fixed-point fractional bits
constexpr int EMAX_BIAS = 128;   // stored emax = e + bias; 0 = zero block
constexpr int N_GROUPS = 10;     // sequency groups: total degree 0..9
constexpr int TILE = 64;         // ZFP blocks per CTA, one thread each
constexpr int ROW_WORDS = 64;    // no payload bit lies past word 63 (32 planes x 64 bits)
// A CTA's shared buffer: TILE rows of up to 65 words (64 floats in, or a
// stream row), and 2 words that a decoder's fetch may read past the last row.
constexpr int BUF_WORDS = TILE * (ROW_WORDS + 1) + 2;
constexpr uint32_t NBMASK = 0xaaaaaaaau;

// Sequency group (total degree) of index-order coefficient c.
__host__ __device__ constexpr int degree(int c) { return (c & 3) + ((c >> 2) & 3) + (c >> 4); }

// Group sizes and their first sequency coefficient (zfp.GROUP_SIZES,
// zfp._FIXED_START: 0, 1, 4, 10, 20, 32, 44, 54, 60, 63): groups 0-4 fill
// coefficients 0..31, groups 5-9 fill 32..63, so no group straddles a word.
__host__ __device__ constexpr int group_size(int g) {
  return g == 0 || g == 9 ? 1 : g == 1 || g == 8 ? 3 : g == 2 || g == 7 ? 6
       : g == 3 || g == 6 ? 10 : 12;
}
// Loop-free, so that it folds to a constant inside unrolled code (a loop
// here was left as a runtime loop with jump tables by the unroller).
__host__ __device__ constexpr int group_start(int g) {
  return g == 0 ? 0 : g == 1 ? 1 : g == 2 ? 4 : g == 3 ? 10 : g == 4 ? 20 : g == 5 ? 32
       : g == 6 ? 44 : g == 7 ? 54 : g == 8 ? 60 : 63;
}

// Sequency order: perm(s) is the index-order position of sequency
// coefficient s (repro_torch.core.zfp.PERM; a CPU test holds the two equal).
__host__ __device__ constexpr int perm(int s) {
  constexpr uint8_t PERM[64] = {
      0,  1,  4,  16, 2,  5,  8,  17, 20, 32, 3,  6,  9,  12, 18, 21,
      24, 33, 36, 48, 7,  10, 13, 19, 22, 25, 28, 34, 37, 40, 49, 52,
      11, 14, 23, 26, 29, 35, 38, 41, 44, 50, 53, 56, 15, 27, 30, 39,
      42, 45, 51, 54, 57, 60, 31, 43, 46, 55, 58, 61, 47, 59, 62, 63};
  return PERM[s];
}

// The low n bits set, for any n (0 below 0, all 32 from 32 up).
__host__ __device__ constexpr uint32_t low_bits(int n) {
  return n <= 0 ? 0u : n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t shl1(int32_t a) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) << 1);
}

__device__ __forceinline__ uint32_t negabinary(int32_t i) {
  return (static_cast<uint32_t>(i) + NBMASK) ^ NBMASK;
}
__device__ __forceinline__ int32_t inv_negabinary(uint32_t u) {
  return static_cast<int32_t>((u ^ NBMASK) - NBMASK);
}

// ZFP fwd_lift / inv_lift on one 4-line.
__device__ __forceinline__ void fwd_lift(int32_t& x, int32_t& y, int32_t& z, int32_t& w) {
  x = add(x, w); x >>= 1; w = sub(w, x);
  z = add(z, y); z >>= 1; y = sub(y, z);
  x = add(x, z); x >>= 1; z = sub(z, x);
  w = add(w, y); w >>= 1; y = sub(y, w);
  w = add(w, y >> 1); y = sub(y, w >> 1);
}

__device__ __forceinline__ void inv_lift(int32_t& x, int32_t& y, int32_t& z, int32_t& w) {
  y = add(y, w >> 1); w = sub(w, y >> 1);
  y = add(y, w); w = shl1(w); w = sub(w, y);
  z = add(z, x); x = shl1(x); x = sub(x, z);
  y = add(y, z); z = shl1(z); z = sub(z, y);
  w = add(w, x); x = shl1(x); x = sub(x, w);
}

// First element and stride of line l (0..15) along block axis 3, 2 or 1.
__host__ __device__ constexpr int line_base(int axis, int l) {
  return axis == 3 ? 4 * l : axis == 2 ? (l >> 2) * 16 + (l & 3) : l;
}
__host__ __device__ constexpr int line_stride(int axis) {
  return axis == 3 ? 1 : axis == 2 ? 4 : 16;
}

// Forward lift on axes 3, 2, 1; the inverse on axes 1, 2, 3.
__device__ __forceinline__ void fwd_lift3d(int32_t (&p)[64]) {
#pragma unroll
  for (int axis = 3; axis >= 1; --axis) {
#pragma unroll
    for (int l = 0; l < 16; ++l) {
      const int b = line_base(axis, l), s = line_stride(axis);
      fwd_lift(p[b], p[b + s], p[b + 2 * s], p[b + 3 * s]);
    }
  }
}

__device__ __forceinline__ void inv_lift3d(int32_t (&p)[64]) {
#pragma unroll
  for (int axis = 1; axis <= 3; ++axis) {
#pragma unroll
    for (int l = 0; l < 16; ++l) {
      const int b = line_base(axis, l), s = line_stride(axis);
      inv_lift(p[b], p[b + s], p[b + 2 * s], p[b + 3 * s]);
    }
  }
}

struct Header {
  int tops[N_GROUPS];  // top bit plane (max bit length) of each group; 0 for a zero block
  int emax;            // e + EMAX_BIAS, or 0 for a zero block
};

// Stages 1-3 of one block: u[c] = negabinary coefficient c (index order),
// and the block's header.  The exponent comes from the IEEE bits of |x|max
// (|x| bit patterns order as the values do, and NaN's sort above inf, as
// max propagates NaN), the scale 2^(Q - e) is built in exponent bits, and a
// group's top plane is the bit length of the OR of its coefficients.
__device__ __forceinline__ void forward_block(const float (&v)[64], uint32_t (&u)[64], Header& h) {
  uint32_t maxbits = 0u;
#pragma unroll
  for (int c = 0; c < 64; ++c) maxbits = max(maxbits, __float_as_uint(v[c]) & 0x7fffffffu);
  const int e = min(max(static_cast<int>(maxbits >> 23) - 126, -100), 127);  // |x|max < 2^e
  const bool nonzero = maxbits >= 0x00800000u && maxbits <= 0x7f800000u;    // normal, or inf
  const float scale = __uint_as_float(static_cast<uint32_t>(Q - e + 127) << 23);
  int32_t p[64];
#pragma unroll
  for (int c = 0; c < 64; ++c) p[c] = __float2int_rn(v[c] * scale);
  fwd_lift3d(p);
  uint32_t any[N_GROUPS] = {};
#pragma unroll
  for (int c = 0; c < 64; ++c) {
    u[c] = negabinary(p[c]);
    any[degree(c)] |= u[c];
  }
#pragma unroll
  for (int g = 0; g < N_GROUPS; ++g)
    h.tops[g] = nonzero ? 32 - __clz(static_cast<int>(any[g])) : 0;
  h.emax = nonzero ? e + EMAX_BIAS : 0;
}

// Stages 1-3 inverted: index-order negabinary coefficients -> floats,
// x 2^(e - Q) built in exponent bits (0 for a zero block).
__device__ __forceinline__ void inverse_block(const uint32_t (&u)[64], int emax, float (&v)[64]) {
  int32_t p[64];
#pragma unroll
  for (int c = 0; c < 64; ++c) p[c] = inv_negabinary(u[c]);
  inv_lift3d(p);
  const int k = min(max(emax - EMAX_BIAS - Q, -126), 127);
  const float scale = emax > 0 ? __uint_as_float(static_cast<uint32_t>(k + 127) << 23) : 0.0f;
#pragma unroll
  for (int c = 0; c < 64; ++c) v[c] = static_cast<float>(p[c]) * scale;
}

// One round of the bit transpose: rows r and r + J (r & J == 0) swap the
// bits of a's columns k & J != 0 with b's columns k & J == 0; m holds the
// columns k & J == 0.
template <int J>
__device__ __forceinline__ void swap_round(uint32_t (&a)[32], uint32_t m) {
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    if ((r & J) == 0) {
      const uint32_t x = a[r], y = a[r + J];
      a[r] = (x & m) | ((y << J) & ~m);
      a[r + J] = ((x >> J) & m) | (y & ~m);
    }
  }
}

// In-place 32x32 bit transpose: afterwards a[k] bit r is the old a[r] bit k
// (Hacker's Delight 7-3, as core.zfp._bit_transpose32, in least-significant-
// bit-first orientation).  The rounds that move whole bytes are byte
// permutes; the transpose is an involution.
__device__ __forceinline__ void transpose32(uint32_t (&a)[32]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const uint32_t x = a[r], y = a[r + 16];
    a[r] = __byte_perm(x, y, 0x5410);
    a[r + 16] = __byte_perm(x, y, 0x7632);
  }
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    if ((r & 8) == 0) {
      const uint32_t x = a[r], y = a[r + 8];
      a[r] = __byte_perm(x, y, 0x6240);
      a[r + 8] = __byte_perm(x, y, 0x7351);
    }
  }
  swap_round<4>(a, 0x0f0f0f0fu);
  swap_round<2>(a, 0x33333333u);
  swap_round<1>(a, 0x55555555u);
}

// A plane's 64-bit bit row (hi:lo, bit s = sequency coefficient s).  Group
// g absent from a plane has only zero bits there; squeeze removes n of them
// at the group's start (the bits above move down), expand inserts n zeros
// there.  n = 0 leaves the row as it is, so the decoder passes the group's
// size where it is absent and 0 where it is present, with no branch.  The
// masks are constants once g is.
__device__ __forceinline__ void squeeze(uint32_t& lo, uint32_t& hi, int g, int n) {
  const int s = group_start(g);
  if (s >= 32) {
    const uint32_t below = low_bits(s - 32);
    hi = (hi & below) | ((hi >> n) & ~below);
  } else {
    const uint32_t below = low_bits(s);
    lo = (lo & below) | (__funnelshift_r(lo, hi, n) & ~below);
    hi >>= n;
  }
}

__device__ __forceinline__ void expand(uint32_t& lo, uint32_t& hi, int g, int n) {
  const int s = group_start(g);
  if (s >= 32) {
    const uint32_t below = low_bits(s - 32);
    hi = (hi & below) | ((hi & ~below) << n);
  } else {
    const uint32_t below = low_bits(s);
    hi = __funnelshift_l(lo, hi, n);  // s + size <= 32: lo's top n bits lie above s
    lo = (lo & below) | ((lo & ~below) << n);
  }
}

// Plane layout (repro_torch.core.zfp._plane_offsets): group g is present in
// stream-major plane j (bit plane 31 - j) iff j >= entry[g] = 32 - tops[g];
// plane j's payload is the present groups' bits, groups in order, pw[j]
// bits at OFF[j] = pw[0] + ... + pw[j - 1], of which the first
// keep[j] = min(max(budget - OFF[j], 0), pw[j]) are stored.  Planes before
// the first entry are empty and planes from the one that spends the budget
// on store nothing, so the coder visits only the planes in between.
struct Layout {
  int entry[N_GROUPS];
  int first;  // min over g of entry[g]
};

__device__ __forceinline__ Layout layout(const Header& h) {
  Layout l;
  l.first = 32;
#pragma unroll
  for (int g = 0; g < N_GROUPS; ++g) {
    l.entry[g] = 32 - h.tops[g];
    l.first = min(l.first, l.entry[g]);
  }
  return l;
}

// The embedded encoder of one block: index-order coefficients u and the
// header -> the block's stream words in row[0, rs).  cap = min(wpb, 64) is
// the number of words that can hold payload bits; words from cap to rs are
// zero.  Each plane's payload lands at OFF[j]: the word OFF >> 5 so far is
// carried in a register (cur) and rewritten with the new bits, the next two
// words are written fresh (no earlier plane reaches them), so the row is
// never read back.
__device__ __forceinline__ void encode_planes(const uint32_t (&u)[64], const Header& h,
                                              int budget, int cap, int rs, uint32_t* row) {
  uint32_t w0[32], w1[32];
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    w0[s] = u[perm(s)];
    w1[s] = u[perm(s + 32)];
  }
  transpose32(w0);  // w0[k] bit s: bit k of sequency coefficient s < 32
  transpose32(w1);  // w1[k] bit s: bit k of sequency coefficient 32 + s
  const Layout l = layout(h);
  int off = 0, filled = 0;
  uint32_t cur = 0u;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j < l.first || off >= budget) continue;
    uint32_t lo = w0[31 - j], hi = w1[31 - j];
    int pw = 64;
#pragma unroll
    for (int g = N_GROUPS - 1; g >= 0; --g) {
      if (j < l.entry[g]) {  // a branch per group: cheaper here than a select
        if (g < N_GROUPS - 1) squeeze(lo, hi, g, group_size(g));  // 9 is bit 63: none above
        pw -= group_size(g);
      }
    }
    const int keep = min(budget - off, pw);
    if (keep < pw) {  // the plane that spends the budget
      lo &= low_bits(keep);
      hi &= low_bits(keep - 32);
    }
    const uint32_t sh = static_cast<uint32_t>(off & 31);
    const int w = off >> 5;
    const uint32_t c0 = cur | (lo << sh);
    const uint32_t c1 = __funnelshift_l(lo, hi, sh);
    const uint32_t c2 = __funnelshift_l(hi, 0u, sh);
    row[w] = c0;
    if (w + 1 < cap) row[w + 1] = c1;
    if (w + 2 < cap) row[w + 2] = c2;
    filled = min(w + 3, cap);
    off += pw;
    const int d = (off >> 5) - w;
    cur = d == 0 ? c0 : d == 1 ? c1 : c2;
  }
  for (int k = filled; k < rs; ++k) row[k] = 0u;
}

// The inverse: the block's stream row (at least 2 readable words past the
// last one that can hold payload: their bits lie past keep and are masked
// off, as the reference reads 0 past the row) and its header -> index-order
// coefficients u.
__device__ __forceinline__ void decode_planes(const uint32_t* row, const Header& h, int budget,
                                              uint32_t (&u)[64]) {
  uint32_t w0[32], w1[32];
  const Layout l = layout(h);
  int off = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    w0[31 - j] = 0u;
    w1[31 - j] = 0u;
    if (j < l.first || off >= budget) continue;
    int n[N_GROUPS], pw = 64;
#pragma unroll
    for (int g = 0; g < N_GROUPS; ++g) {
      n[g] = j < l.entry[g] ? group_size(g) : 0;
      pw -= n[g];
    }
    const int keep = min(budget - off, pw);
    const uint32_t sh = static_cast<uint32_t>(off & 31);
    const int w = off >> 5;
    const uint32_t g0 = row[w], g1 = row[w + 1], g2 = row[w + 2];
    uint32_t lo = __funnelshift_r(g0, g1, sh) & low_bits(keep);
    uint32_t hi = __funnelshift_r(g1, g2, sh) & low_bits(keep - 32);
#pragma unroll
    for (int g = 0; g < N_GROUPS - 1; ++g) expand(lo, hi, g, n[g]);  // 9: bit 63, past pw
    w0[31 - j] = lo;
    w1[31 - j] = hi;
    off += pw;
  }
  transpose32(w0);  // w0[s]: sequency coefficient s
  transpose32(w1);
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    u[perm(s)] = w0[s];
    u[perm(s + 32)] = w1[s];
  }
}

// ---------------------------------------------------- CTA tile movement ---
//
// A tile is the CTA's nbc <= TILE blocks of 64 words (floats in for K5 and
// K6, floats out of K7, coefficients out of K5).  In shared memory row t
// (block t) holds its 16 chunks of 16 bytes with chunk c at c ^ (t & 7):
// a thread's 16-byte reads of its own row and the CTA's 16-byte copies of
// consecutive chunks both touch 8 distinct bank groups per 8 threads.

__device__ __forceinline__ int swizzle4(int q) { return q ^ ((q >> 4) & 7); }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Device memory -> the swizzled tile (16-byte loads when src is aligned).
__device__ __forceinline__ void load_tile(uint32_t* buf, const uint32_t* __restrict__ src,
                                          int nbc) {
  const int n4 = nbc * 16;
  if (aligned16(src)) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* b4 = reinterpret_cast<uint4*>(buf);
    for (int q = threadIdx.x; q < n4; q += TILE) b4[swizzle4(q)] = __ldg(s4 + q);
  } else {
    for (int i = threadIdx.x; i < n4 * 4; i += TILE)
      buf[(swizzle4(i >> 2) << 2) | (i & 3)] = __ldg(src + i);
  }
}

// The swizzled tile -> device memory.
__device__ __forceinline__ void store_tile(uint32_t* __restrict__ dst, const uint32_t* buf,
                                           int nbc) {
  const int n4 = nbc * 16;
  if (aligned16(dst)) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* b4 = reinterpret_cast<const uint4*>(buf);
    for (int q = threadIdx.x; q < n4; q += TILE) d4[q] = b4[swizzle4(q)];
  } else {
    for (int i = threadIdx.x; i < n4 * 4; i += TILE)
      dst[i] = buf[(swizzle4(i >> 2) << 2) | (i & 3)];
  }
}

// Row t of the swizzled tile <-> a thread's 64 registers: chunk c of the row
// at c ^ sw, where sw takes 8 distinct values over any 8 consecutive rows
// (t & 7 above; the field layout's slab rows permute those bits).
__device__ __forceinline__ void read_row(const uint32_t* buf, int t, float (&v)[64], int sw) {
  const uint4* row = reinterpret_cast<const uint4*>(buf) + t * 16;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const uint4 q = row[c ^ sw];
    v[4 * c] = __uint_as_float(q.x);
    v[4 * c + 1] = __uint_as_float(q.y);
    v[4 * c + 2] = __uint_as_float(q.z);
    v[4 * c + 3] = __uint_as_float(q.w);
  }
}

__device__ __forceinline__ void write_row(uint32_t* buf, int t, const uint32_t (&v)[64], int sw) {
  uint4* row = reinterpret_cast<uint4*>(buf) + t * 16;
#pragma unroll
  for (int c = 0; c < 16; ++c)
    row[c ^ sw] = make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
}

// n contiguous words between device memory and shared memory (16-byte
// accesses when the device pointer is aligned; buf always is).
__device__ __forceinline__ void load_words(uint32_t* buf, const uint32_t* __restrict__ src,
                                           int n) {
  int done = 0;
  if (aligned16(src)) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* b4 = reinterpret_cast<uint4*>(buf);
    for (int q = threadIdx.x; q < n / 4; q += TILE) b4[q] = __ldg(s4 + q);
    done = n / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < n; i += TILE) buf[i] = __ldg(src + i);
}

__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst, const uint32_t* buf,
                                            int n) {
  int done = 0;
  if (aligned16(dst)) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* b4 = reinterpret_cast<const uint4*>(buf);
    for (int q = threadIdx.x; q < n / 4; q += TILE) d4[q] = b4[q];
    done = n / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < n; i += TILE) dst[i] = buf[i];
}

__device__ __forceinline__ void load_bytes(uint8_t* buf, const uint8_t* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += TILE) buf[i] = __ldg(src + i);
}

__device__ __forceinline__ void store_bytes(uint8_t* __restrict__ dst, const uint8_t* buf, int n) {
  for (int i = threadIdx.x; i < n; i += TILE) dst[i] = buf[i];
}

// ------------------------------------------------ where the floats live ---
//
// K6 reads a CTA's nbc blocks of floats into each thread's v[64] (thread t
// owns block b0 + t) and K7 writes them back, through a Field's load and
// store.  Both are called by every thread of the CTA (they may hold
// barriers), leave the shared buffer free, and touch v only for t < nbc.
// Carved (nb, 4, 4, 4) blocks are the field (4 nb, 4, 4): block b at x =
// 4 b, its values in the same order, a CTA's blocks one run (the slab path).

// The field itself, (X, Y, Z) contiguous with z fastest, in the blocks'
// order of core/zfp.py _carve_blocks: block b = (bx * gy + by) * gz + bz of
// the grid padded to multiples of 4, its value c = 16 * i1 + 4 * i2 + i3 at
// (4 bx + i1, 4 by + i2, 4 bz + i3).  So quad q = 4 * i1 + i2 of a block
// (v[4q .. 4q + 3]) is 4 consecutive z values of the field.  Reads clamp
// each coordinate to its side - 1 (the replicate padding, F.pad's value);
// writes drop the points past a side (the crop).  Offsets are 64-bit.
struct Field {
  long long X, Y, Z;
  long long gy, gz;  // blocks along y and z
  bool vec;          // Z % 4 == 0 and the field 16-byte aligned: every quad is whole and aligned
  // vec, Y % 4 == 0 and gy * gz divides TILE (so both are powers of two): a
  // CTA's blocks are whole x slabs of blocks, one contiguous run of the
  // field (HACC's (N/64, 8, 8): 16 KB), moved in address order through the
  // swizzled tile.  Otherwise, where vec, each thread moves its own block's
  // quads between the field and its registers: a warp's 32 blocks lie along
  // z, so a quad's accesses are runs of up to 512 bytes (a Nyx box's 256 x
  // 256 x 512: 16 runs of 1 KB a CTA).  Else each thread moves its block
  // point by point, in a loop, through its own row of the tile.
  bool slab;
  int lgy, lgz;  // log2 of gy and gz, when slab
  // A slab CTA's tile: row t (block b0 + t) keeps chunk c at c ^ sw(t), sw(t)
  // t's low 3 bits rotated left by rot (chosen by lgz), so that 8
  // consecutive quads of the run (one 128-byte line) land in 8 distinct bank
  // groups, as 8 consecutive rows' chunks do for read_row and write_row.
  // Thread t copies quads j = t + 64 k of the run, k < 16, in address order;
  // their tile quads are slab_tile(j) = slab_tile(t) ^ step[k], slab_tile
  // being linear in j's bits (step[k] = slab_tile(64 k), a kernel parameter
  // read at constant k): one XOR a copy.  No parameter array is indexed at
  // run time here (a table of sw per row, so indexed, slowed both kernels
  // by 10-15% on an H100).
  int rot;
  uint16_t step[16];

  __host__ __device__ int sw(int t) const { return ((t << rot) | ((t & 7) >> (3 - rot))) & 7; }

  // The tile quad (t * 16 + chunk) of quad j of a slab CTA's run.
  __host__ __device__ int slab_tile(int j) const {
    const int bz = j & ((1 << lgz) - 1), yy = (j >> lgz) & ((4 << lgy) - 1);
    const int xx = j >> (lgz + lgy + 2);
    const int t = ((((xx >> 2) << lgy) | (yy >> 2)) << lgz) | bz;
    return ((t << 4) | ((xx & 3) << 2) | (yy & 3)) ^ sw(t);
  }

  __device__ __forceinline__ void corner(long long b, long long& x, long long& y,
                                         long long& z) const {
    z = 4 * (b % gz);
    b /= gz;
    y = 4 * (b % gy);
    x = 4 * (b / gy);
  }

  // A slab CTA's run: from x0 = 4 * (b0 >> (lgy + lgz)), nbc * 16 quads, of
  // which the quads of x planes inside the field are the first (X - x0) *
  // Y * Z / 4.  Full CTAs whose planes all lie in the field (all but the
  // last at most) copy with no guard, so all 16 loads of a thread are in
  // flight at once.
  __device__ __forceinline__ int run_quads(long long x0, int nbc) const {
    return static_cast<int>(min(static_cast<long long>(nbc) * 16, ((X - x0) * Y * Z) >> 2));
  }

  __device__ __forceinline__ void load(uint32_t* buf, const float* __restrict__ src, long long b0,
                                       int nbc, float (&v)[64]) const {
    const int t = threadIdx.x;
    if (slab) {
      const long long x0 = 4 * (b0 >> (lgy + lgz)), plane = Y * Z;
      const uint4* s4 = reinterpret_cast<const uint4*>(src) + ((x0 * plane) >> 2);
      uint4* b4 = reinterpret_cast<uint4*>(buf);
      if (run_quads(x0, nbc) == TILE * 16) {
        const int own = slab_tile(t);
#pragma unroll
        for (int k = 0; k < 16; ++k) b4[own ^ step[k]] = __ldg(s4 + t + 64 * k);
      } else {  // x clamped to X - 1: a plane's quads again
        const int lplane = lgz + lgy + 2;  // log2 of the quads in an x plane
        for (int j = t; j < nbc * 16; j += TILE) {
          const long long x = min(x0 + (j >> lplane), X - 1);
          b4[slab_tile(j)] = __ldg(s4 + (((x - x0) * plane) >> 2) + (j & ((1 << lplane) - 1)));
        }
      }
      __syncthreads();
      if (t < nbc) read_row(buf, t, v, sw(t));
      __syncthreads();
    } else if (vec) {
      if (t < nbc) {
        long long x, y, z;
        corner(b0 + t, x, y, z);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(
              src + (min(x + (q >> 2), X - 1) * Y + min(y + (q & 3), Y - 1)) * Z + z));
          v[4 * q] = __uint_as_float(w.x);
          v[4 * q + 1] = __uint_as_float(w.y);
          v[4 * q + 2] = __uint_as_float(w.z);
          v[4 * q + 3] = __uint_as_float(w.w);
        }
      }
    } else {  // point by point into the thread's own tile row (a loop: little code)
      if (t < nbc) {
        long long x, y, z;
        corner(b0 + t, x, y, z);
#pragma unroll 1
        for (int i = 0; i < 64; ++i) {
          const int q = i >> 2;
          buf[((t * 16 + (q ^ (t & 7))) << 2) | (i & 3)] = __float_as_uint(__ldg(
              src + (min(x + (q >> 2), X - 1) * Y + min(y + (q & 3), Y - 1)) * Z +
              min(z + (i & 3), Z - 1)));
        }
        read_row(buf, t, v, t & 7);
      }
      __syncthreads();  // every row is read: the buffer's rows become stream rows
    }
  }

  __device__ __forceinline__ void store(uint32_t* buf, float* __restrict__ dst, long long b0,
                                        int nbc, const float (&v)[64]) const {
    const int t = threadIdx.x;
    if (slab) {
      __syncthreads();  // the buffer's stream rows are read
      if (t < nbc) {
        uint32_t bits[64];
#pragma unroll
        for (int c = 0; c < 64; ++c) bits[c] = __float_as_uint(v[c]);
        write_row(buf, t, bits, sw(t));
      }
      __syncthreads();
      const long long x0 = 4 * (b0 >> (lgy + lgz)), plane = Y * Z;
      uint4* d4 = reinterpret_cast<uint4*>(dst) + ((x0 * plane) >> 2);
      const uint4* b4 = reinterpret_cast<const uint4*>(buf);
      const int n4 = run_quads(x0, nbc);
      if (n4 == TILE * 16) {
        const int own = slab_tile(t);
#pragma unroll
        for (int k = 0; k < 16; ++k) d4[t + 64 * k] = b4[own ^ step[k]];
      } else {
        for (int j = t; j < n4; j += TILE) d4[j] = b4[slab_tile(j)];
      }
    } else if (vec) {
      if (t < nbc) {
        long long x, y, z;
        corner(b0 + t, x, y, z);
#pragma unroll
        for (int q = 0; q < 16; ++q)
          if (x + (q >> 2) < X && y + (q & 3) < Y)
            *reinterpret_cast<uint4*>(dst + ((x + (q >> 2)) * Y + y + (q & 3)) * Z + z) =
                make_uint4(__float_as_uint(v[4 * q]), __float_as_uint(v[4 * q + 1]),
                           __float_as_uint(v[4 * q + 2]), __float_as_uint(v[4 * q + 3]));
      }
    } else {  // point by point from the thread's own tile row
      __syncthreads();  // the buffer's stream rows are read
      if (t < nbc) {
        uint32_t bits[64];
#pragma unroll
        for (int c = 0; c < 64; ++c) bits[c] = __float_as_uint(v[c]);
        write_row(buf, t, bits, t & 7);
        long long x, y, z;
        corner(b0 + t, x, y, z);
#pragma unroll 1
        for (int i = 0; i < 64; ++i) {
          const int q = i >> 2;
          if (x + (q >> 2) < X && y + (q & 3) < Y && z + (i & 3) < Z)
            dst[((x + (q >> 2)) * Y + y + (q & 3)) * Z + z + (i & 3)] =
                __uint_as_float(buf[((t * 16 + (q ^ (t & 7))) << 2) | (i & 3)]);
        }
      }
    }
  }
};

}  // namespace zfp

// The entry point that turns a returned cudaError_t into its text (one per
// library; lorenzo_tile.cuh defines the same for the SZ kernels).
#ifndef REPRO_DEFINE_ERROR_STRING
#define REPRO_DEFINE_ERROR_STRING()                                   \
  extern "C" const char* repro_error_string(int code) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(code));        \
  }
#endif

// Device code shared by the TPU-ZFP kernels (zfp3d.cu: K5, zfp_fused.cu: K6
// and K7): the block-floating-point stages 1-3 of a 4x4x4 block and the
// per-group top bit planes.  K5 and K6 must agree bit for bit (the xla and
// fused paths emit the same stream), so, as the JAX package shares
// block_float_negabinary between its two kernels (repro/kernels/zfp3d.py:
// 75-98), these stages exist once.
//
// One warp owns one ZFP block: lane l holds the block's values l and l + 32
// (index order, x fastest: c = 16*i1 + 4*i2 + i3 over the (4, 4, 4) axes),
// and the warp's 64-word shared scratch holds the block while the lifts run.
//
// Arithmetic.  The lifts add, subtract and shift left in uint32_t (defined
// wrap, equal to the reference's int32 arithmetic mod 2^32) and shift right
// on int32_t, which is arithmetic, as jnp's >> on int32 and the floor shift
// the lift needs.  Rounding is __float2int_rn (half to even, as jnp.round).
// Never build with --use_fast_math or -ftz=true: the scale multiplies must
// stay IEEE.
//
// Subnormals.  The reference runs where subnormals are flushed (the TPU,
// XLA on the CPU), so a block whose |x|max is subnormal is a zero block
// there.  Here a block is nonzero iff |x|max is a normal float (not NaN),
// as repro_torch.core.zfp states; subnormal values quantize to 0 anyway.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace zfp {

constexpr int Q = 25;            // fixed-point fractional bits
constexpr int EMAX_BIAS = 128;   // stored emax = e + bias; 0 = zero block
constexpr int N_GROUPS = 10;     // sequency groups: total degree 0..9
constexpr int HEADER_BITS = 8 + 5 * N_GROUPS;
constexpr int WARPS = 8;         // ZFP blocks per CTA, one warp each
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t NBMASK = 0xaaaaaaaau;

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t shl1(int32_t a) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) << 1);
}

// Sequency group (total degree) of index-order coefficient c.
__device__ __forceinline__ int degree(int c) { return (c & 3) + ((c >> 2) & 3) + (c >> 4); }

__device__ __forceinline__ uint32_t negabinary(int32_t i) {
  return (static_cast<uint32_t>(i) + NBMASK) ^ NBMASK;
}
__device__ __forceinline__ int32_t inv_negabinary(uint32_t u) {
  return static_cast<int32_t>((u ^ NBMASK) - NBMASK);
}

// Mask of the low w bits, exact for w in [0, 32] (a shift by 32 is undefined).
__device__ __forceinline__ uint32_t code_mask(int w) {
  return w == 0 ? 0u : (0xffffffffu >> (32 - w));
}

// ZFP fwd_lift / inv_lift on the 4-line p[0], p[s], p[2s], p[3s].
__device__ __forceinline__ void fwd_lift(int32_t* p, int s) {
  int32_t x = p[0], y = p[s], z = p[2 * s], w = p[3 * s];
  x = add(x, w); x >>= 1; w = sub(w, x);
  z = add(z, y); z >>= 1; y = sub(y, z);
  x = add(x, z); x >>= 1; z = sub(z, x);
  w = add(w, y); w >>= 1; y = sub(y, w);
  w = add(w, y >> 1); y = sub(y, w >> 1);
  p[0] = x; p[s] = y; p[2 * s] = z; p[3 * s] = w;
}

__device__ __forceinline__ void inv_lift(int32_t* p, int s) {
  int32_t x = p[0], y = p[s], z = p[2 * s], w = p[3 * s];
  y = add(y, w >> 1); w = sub(w, y >> 1);
  y = add(y, w); w = shl1(w); w = sub(w, y);
  z = add(z, x); x = shl1(x); x = sub(x, z);
  y = add(y, z); z = shl1(z); z = sub(z, y);
  w = add(w, x); x = shl1(x); x = sub(x, w);
  p[0] = x; p[s] = y; p[2 * s] = z; p[3 * s] = w;
}

// First element and stride of line l (0..15) along block axis 3, 2 or 1.
__device__ __forceinline__ int line_base(int axis, int l) {
  return axis == 3 ? 4 * l : axis == 2 ? (l >> 2) * 16 + (l & 3) : l;
}
__device__ __forceinline__ int line_stride(int axis) { return axis == 3 ? 1 : axis == 2 ? 4 : 16; }

// Forward lift on axes 3, 2, 1 of the block in s (16 lanes, a line each).
__device__ __forceinline__ void lift3d(int32_t* s, int lane) {
#pragma unroll
  for (int axis = 3; axis >= 1; --axis) {
    if (lane < 16) fwd_lift(s + line_base(axis, lane), line_stride(axis));
    __syncwarp();
  }
}

// Inverse lift on axes 1, 2, 3 (the forward pass reversed).
__device__ __forceinline__ void inv_lift3d(int32_t* s, int lane) {
#pragma unroll
  for (int axis = 1; axis <= 3; ++axis) {
    if (lane < 16) inv_lift(s + line_base(axis, lane), line_stride(axis));
    __syncwarp();
  }
}

struct BlockFloat {
  uint32_t u0, u1;  // negabinary coefficients lane and lane + 32, index order
  int e;            // block exponent, clipped to [-100, 127]
  bool nonzero;
};

// Stages 1-3 of the block at src (64 floats): exponent from the IEEE bits of
// |x|max, scale 2^(Q - e) built in exponent bits, round half to even, the
// three lifts, negabinary.  Leaves the lifted int32 coefficients in s.
__device__ __forceinline__ BlockFloat block_float_negabinary(const float* __restrict__ src,
                                                             int lane, int32_t* s) {
  const float v0 = __ldg(src + lane), v1 = __ldg(src + lane + 32);
  // |x| bit patterns order as the values do, so the max of the bits is the
  // bits of the max (NaN bits sort above every number, as max propagates NaN)
  const uint32_t a = max(__float_as_uint(v0) & 0x7fffffffu, __float_as_uint(v1) & 0x7fffffffu);
  const uint32_t maxbits = __reduce_max_sync(FULL, a);
  BlockFloat r;
  r.e = min(max(static_cast<int>(maxbits >> 23) - 126, -100), 127);  // frexp: |x|max < 2^e
  r.nonzero = maxbits >= 0x00800000u && maxbits <= 0x7f800000u;      // normal, or inf
  const float scale = __uint_as_float(static_cast<uint32_t>(Q - r.e + 127) << 23);
  s[lane] = __float2int_rn(v0 * scale);
  s[lane + 32] = __float2int_rn(v1 * scale);
  __syncwarp();
  lift3d(s, lane);
  r.u0 = negabinary(s[lane]);
  r.u1 = negabinary(s[lane + 32]);
  return r;
}

// Top bit plane of each group: tops[g] = max bit length of the group's
// coefficients (0 for a zero block), in every lane.  (u0, g0) and (u1, g1)
// are the lane's two coefficients and their groups.
__device__ __forceinline__ void group_tops(uint32_t u0, int g0, uint32_t u1, int g1,
                                           bool nonzero, int (&tops)[N_GROUPS]) {
  const int len0 = 32 - __clz(static_cast<int>(u0)), len1 = 32 - __clz(static_cast<int>(u1));
#pragma unroll
  for (int g = 0; g < N_GROUPS; ++g) {
    const unsigned m = max(g0 == g ? len0 : 0, g1 == g ? len1 : 0);
    const int top = static_cast<int>(__reduce_max_sync(FULL, m));  // every lane calls it
    tops[g] = nonzero ? top : 0;
  }
}

}  // namespace zfp

// The entry point that turns a returned cudaError_t into its text (one per
// library; lorenzo_tile.cuh defines the same for the SZ kernels).
#ifndef REPRO_DEFINE_ERROR_STRING
#define REPRO_DEFINE_ERROR_STRING()                                   \
  extern "C" const char* repro_error_string(int code) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(code));        \
  }
#endif

// Device code shared by the tile-blocked Lorenzo kernels (lorenzo3d.cu and
// sz_fused.cu): the prediction tile, the quantizer, and the per-tile
// three-fold prefix sum with dequantization.
//
// The prediction tile is (8, 64, 128) in (z, y, x) whatever the CTA shape:
// prediction resets at every tile edge, and that is stream semantics
// (repro/kernels/lorenzo3d.py:4-9), not a choice of this code.
//
// All integer arithmetic on residuals and sums is uint32_t, so wrap is
// defined; mod 2^32 it equals the reference's int32 arithmetic.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int TZ = 8;
constexpr int TY = 64;
constexpr int TX = 128;
constexpr int SCAN_THREADS = 512;                     // one CTA per tile
constexpr int PLANE_PER_THREAD = TY * TX / SCAN_THREADS;  // 16

// 1 / (2 eb) with IEEE division (no fast math), as the reference's
// reciprocal-multiply quantizer computes it in f32.
__device__ __forceinline__ float inv_two_eb(const float* eb) {
  return 1.0f / (2.0f * __ldg(eb));
}

// round_half_even(v * inv2eb): __float2int_rn rounds half to even, as
// jnp.round does (roundf would round half away from zero).
__device__ __forceinline__ uint32_t quantize(float v, float inv2eb) {
  return static_cast<uint32_t>(__float2int_rn(v * inv2eb));
}

// Inverse of the residual for one (8, 64, 128) tile: inclusive prefix sums
// along x, y and z, then f32 * (2 eb).  A tile's 256 KiB of int32 does not
// fit shared memory, so the CTA walks it plane by plane (64 x 128 uint32 =
// 32 KiB): scan each row along x with warp scans, scan each column along y,
// and add the plane into a running z sum held in registers.  ``load(zl, yl,
// xl)`` gives the residual of a tile point.  Must run with SCAN_THREADS.
template <typename Load>
__device__ void scan_tile_dequant(Load load, const float* __restrict__ eb, float* __restrict__ out,
                                  int Y, int X, int tz, int ty, int tx) {
  __shared__ __align__(16) uint32_t plane[TY][TX];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float scale = 2.0f * __ldg(eb);
  uint32_t zsum[PLANE_PER_THREAD];
#pragma unroll
  for (int k = 0; k < PLANE_PER_THREAD; ++k) zsum[k] = 0u;

  for (int zl = 0; zl < TZ; ++zl) {
#pragma unroll
    for (int k = 0; k < PLANE_PER_THREAD; ++k) {
      const int e = tid + k * SCAN_THREADS;
      plane[e / TX][e % TX] = load(zl, e / TX, e % TX);
    }
    __syncthreads();

    // x: each warp scans whole rows, four consecutive words per lane.
    for (int row = warp; row < TY; row += SCAN_THREADS / 32) {
      uint4 v = reinterpret_cast<uint4*>(plane[row])[lane];
      v.y += v.x;
      v.z += v.y;
      v.w += v.z;
      uint32_t incl = v.w;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const uint32_t up = __shfl_up_sync(0xffffffffu, incl, s);
        if (lane >= s) incl += up;
      }
      const uint32_t excl = incl - v.w;
      v.x += excl;
      v.y += excl;
      v.z += excl;
      v.w += excl;
      reinterpret_cast<uint4*>(plane[row])[lane] = v;
    }
    __syncthreads();

    // y: one thread per column walks down the plane.
    if (tid < TX) {
      uint32_t s = 0u;
      for (int yl = 0; yl < TY; ++yl) {
        s += plane[yl][tid];
        plane[yl][tid] = s;
      }
    }
    __syncthreads();

    // z: running sum per point, then dequantize and store (coalesced in x).
    const size_t zoff = static_cast<size_t>(tz * TZ + zl) * Y;
#pragma unroll
    for (int k = 0; k < PLANE_PER_THREAD; ++k) {
      const int e = tid + k * SCAN_THREADS;
      const int yl = e / TX, xl = e % TX;
      zsum[k] += plane[yl][xl];
      out[(zoff + ty * TY + yl) * X + tx * TX + xl] =
          __int2float_rn(static_cast<int32_t>(zsum[k])) * scale;
    }
    __syncthreads();  // the next plane overwrites shared memory
  }
}

}  // namespace repro

// Each library exports the CUDA error text for the codes its entry points return.
#define REPRO_DEFINE_ERROR_STRING()                                   \
  extern "C" const char* repro_error_string(int code) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(code));        \
  }

// K1 and K2: tile-blocked dual quantization + 3-D Lorenzo residual, and its
// inverse, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   K1 lorenzo3d_quantize     repro/kernels/lorenzo3d.py:72 (_lorenzo_kernel :58)
//   K2 lorenzo3d_reconstruct  repro/kernels/lorenzo3d.py:101 (_reconstruct_kernel :93)
//
// Bound.  Both are memory passes: K1 reads 4 B of f32 and writes 4 B of
// int32 per point, K2 reads 4 B and writes 4 B, so 8 B/pt, which is 40 us
// for a 256^3 field at the H100's 3.35 TB/s; the arithmetic (one multiply,
// one conversion and seven adds per point) is far below the pipes' peaks.
//
// Design.  K1: a warp per 8 rows of a tile column (8 rows x 128 columns,
// walking the tile's 8 z-planes), 8 warps a CTA.  A lane holds 4
// consecutive columns: 16-byte float4 loads of the plane's 8 rows and the
// row above them (the tile's row above the warp, if any), each value
// quantized once per plane (9/8 conversions a point), the z difference
// against the previous plane's quantized rows kept in registers, the x
// difference with one shuffle per row (a lane's left neighbour is the .w of
// the lane before; lane 0 sits on the tile edge), the y difference between
// the warp's rows in registers, and 16-byte int4 stores.  No shared memory,
// no barrier and no 64-bit division per point.  K2 is one CTA per (8, 64,
// 128) tile that walks the tile plane by plane through 32 KiB of shared
// memory (lorenzo_tile.cuh): the tile's prefix sums never reach device
// memory.
#include "lorenzo_tile.cuh"

namespace {

constexpr int Q_ROWS = 8;                  // rows of a tile column a warp owns
constexpr int Q_WARPS = 8;                 // warps per CTA
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint4 quantize4(float4 v, float inv) {
  return make_uint4(repro::quantize(v.x, inv), repro::quantize(v.y, inv),
                    repro::quantize(v.z, inv), repro::quantize(v.w, inv));
}

__device__ __forceinline__ uint4 sub4(uint4 a, uint4 b) {
  return make_uint4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__global__ void __launch_bounds__(32 * Q_WARPS)
lorenzo3d_quantize_kernel(const float* __restrict__ x, const float* __restrict__ eb,
                          int32_t* __restrict__ out, int Z, int Y, int X) {
  const int lane = threadIdx.x & 31;
  const int gx = X / repro::TX, gy = Y / Q_ROWS;
  const long long w = static_cast<long long>(blockIdx.x) * Q_WARPS + (threadIdx.x >> 5);
  const int tx = static_cast<int>(w % gx);
  const long long r = w / gx;
  const int y0 = static_cast<int>(r % gy) * Q_ROWS;
  const long long z0 = r / gy * repro::TZ;
  if (z0 >= Z) return;  // warp-uniform: the grid is rounded up to whole CTAs
  const float inv = repro::inv_two_eb(eb);
  const bool halo = y0 % repro::TY != 0;  // the row above lies in the same tile
  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t base = (static_cast<size_t>(z0) * Y + y0) * X + tx * repro::TX + 4 * lane;

  // q of the previous plane (0 before the tile's first), row 0 the one above
  uint4 prev[Q_ROWS + 1];
#pragma unroll
  for (int i = 0; i <= Q_ROWS; ++i) prev[i] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int zl = 0; zl < repro::TZ; ++zl) {
    const float* src = x + base + zl * plane;
    float4 v[Q_ROWS + 1];
    v[0] = halo ? __ldg(reinterpret_cast<const float4*>(src - X)) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < Q_ROWS; ++i) v[i + 1] = __ldg(reinterpret_cast<const float4*>(src + i * X));
    uint4 c[Q_ROWS + 1];  // z then x differences
#pragma unroll
    for (int i = 0; i <= Q_ROWS; ++i) {
      const uint4 q = i || halo ? quantize4(v[i], inv) : make_uint4(0u, 0u, 0u, 0u);
      const uint4 d = sub4(q, prev[i]);
      prev[i] = q;
      uint32_t left = __shfl_up_sync(FULL, d.w, 1);
      if (lane == 0) left = 0u;
      c[i] = make_uint4(d.x - left, d.y - d.x, d.z - d.y, d.w - d.z);
    }
    int32_t* dst = out + base + zl * plane;
#pragma unroll
    for (int i = 0; i < Q_ROWS; ++i)
      *reinterpret_cast<uint4*>(dst + i * X) = sub4(c[i + 1], c[i]);
  }
}

__global__ void __launch_bounds__(repro::SCAN_THREADS)
lorenzo3d_reconstruct_kernel(const int32_t* __restrict__ delta, const float* __restrict__ eb,
                             float* __restrict__ out, int Z, int Y, int X) {
  const int gx = X / repro::TX, gy = Y / repro::TY;
  const int t = blockIdx.x;
  const int tx = t % gx, ty = (t / gx) % gy, tz = t / (gx * gy);
  auto load = [&](int zl, int yl, int xl) -> uint32_t {
    const size_t i = (static_cast<size_t>(tz * repro::TZ + zl) * Y + ty * repro::TY + yl) * X
                     + tx * repro::TX + xl;
    return static_cast<uint32_t>(__ldg(delta + i));
  };
  repro::scan_tile_dequant(load, eb, out, Y, X, tz, ty, tx);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING()

// x: f32 (Z, Y, X), TILE-padded; eb: device f32 scalar (the guarded bound);
// out: int32 (Z, Y, X).  Launches on ``stream`` and returns cudaGetLastError().
extern "C" int lorenzo3d_quantize(const float* x, const float* eb, int32_t* out,
                                  int Z, int Y, int X, cudaStream_t stream) {
  const long long warps = static_cast<long long>(Z / repro::TZ) * (Y / Q_ROWS) * (X / repro::TX);
  const long long grid = (warps + Q_WARPS - 1) / Q_WARPS;
  if (grid > 0)
    lorenzo3d_quantize_kernel<<<static_cast<unsigned>(grid), 32 * Q_WARPS, 0, stream>>>(
        x, eb, out, Z, Y, X);
  return static_cast<int>(cudaGetLastError());
}

// delta: int32 (Z, Y, X), TILE-padded; out: f32 (Z, Y, X).
extern "C" int lorenzo3d_reconstruct(const int32_t* delta, const float* eb, float* out,
                                     int Z, int Y, int X, cudaStream_t stream) {
  const int tiles = (Z / repro::TZ) * (Y / repro::TY) * (X / repro::TX);
  if (tiles > 0)
    lorenzo3d_reconstruct_kernel<<<tiles, repro::SCAN_THREADS, 0, stream>>>(delta, eb, out, Z, Y, X);
  return static_cast<int>(cudaGetLastError());
}

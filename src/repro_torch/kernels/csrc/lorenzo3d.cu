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
// one conversion and seven adds per point) is far below the FP32 peak.
//
// Design.  K1 is one thread per point with coalesced x-fastest stores; a
// point's seven neighbours are re-quantized from x, whose re-reads hit L1/L2,
// so device memory sees each input byte about once.  K2 is one CTA per
// (8, 64, 128) tile that walks the tile plane by plane through 32 KiB of
// shared memory (lorenzo_tile.cuh): the tile's prefix sums never reach
// device memory.  Simple and right first; staging the input with TMA and a
// finer CTA than the tile are later work.
#include "lorenzo_tile.cuh"

namespace {

__global__ void __launch_bounds__(256)
lorenzo3d_quantize_kernel(const float* __restrict__ x, const float* __restrict__ eb,
                          int32_t* __restrict__ out, int Z, int Y, int X) {
  const float inv = repro::inv_two_eb(eb);
  const long long n = static_cast<long long>(Z) * Y * X;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int xx = static_cast<int>(i % X);
    const long long r = i / X;
    const int y = static_cast<int>(r % Y);
    const int z = static_cast<int>(r / Y);
    out[i] = static_cast<int32_t>(repro::residual_at(
        x, Y, X, z, y, xx, z % repro::TZ, y % repro::TY, xx % repro::TX, inv));
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
  const long long n = static_cast<long long>(Z) * Y * X;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  const int grid = static_cast<int>(blocks < (1LL << 30) ? blocks : (1LL << 30));
  if (grid > 0) lorenzo3d_quantize_kernel<<<grid, threads, 0, stream>>>(x, eb, out, Z, Y, X);
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

// K3, K4, K8 and K9: single-pass fused TPU-SZ encode and decode on Hopper
// (sm_90a), for one field (K3, K4) or a batch of same-shape fields (K8, K9).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   K3 fused encode          repro/kernels/sz_fused.py:177 _fused_encode (_fused_encode_kernel :165)
//   K4 fused decode          repro/kernels/sz_fused.py:336 fused_decompress (_fused_decode_kernel :312)
//   K8 batched fused encode  repro/kernels/sz_fused.py:238 _fused_encode_batched
//                            (_fused_encode_kernel_batched :169)
//   K9 batched fused decode  repro/kernels/sz_fused.py:361 fused_decompress_batched
//                            (_fused_decode_kernel_batched :316)
//
// Stream layout (the contract): codes are the tile-blocked Lorenzo residuals
// in tile-major order (tiles in raster order, each (8, 64, 128) tile
// flattened C-order), zigzagged, in blocks of 64.  Block b has width w_b =
// max bit length of its codes and a payload of 2*w_b words: code i sits at
// bit i*w_b.  K3 writes every block's 64-word row (zeros past 2*w_b) and
// its int32 width; the dense stream is assembled around it in PyTorch (an
// exclusive scan of 2*w_b and a gather), and disassembled back into rows
// before K4, as the JAX package does around its Pallas kernels.
//
// Batches.  The reference's batched grid (b, i, j, k) numbers tiles
// ((b*gz + i)*gy + j)*gx + k: the tile-major order of one (B*Z, Y, X)
// field.  Prediction resets at every tile edge and Z % 8 == 0, so no tile
// spans two rows, and K8 is K3 over (B*Z, Y, X) with row b's bound read
// from eb[block / blocks_per_row]; K9 is K4 the same way with
// eb[tile / tiles_per_row].  K3 and K4 are the B = 1 launches of the same
// kernels, and a bucket is one launch whatever its row count.
//
// Bound.  K3 reads 4 B/pt of f32 and writes the 64-word rows (4 B/pt) plus
// 4 B of width per 64 points: ~8.06 B/pt, ~40 us for a 256^3 field at
// 3.35 TB/s (K8: ~0.16 ms for four).  K4 reads only the 2*w_b payload words
// a block needs (br/8 B/pt at br bits per value) plus the widths, and
// writes 4 B/pt of f32; K9 the same per row.
//
// Design.  K3: one warp per 64-code block, two codes per lane; the residual
// comes from lorenzo_tile.cuh, the width from a warp max reduction of
// 32 - __clz(u), and the payload is OR-ed into a 65-word shared-memory row
// with atomicOr (a code touches words (i*w)>>5 and +1; the high part uses
// the reference's two-step shift (u >> 1) >> (31 - off), since a shift by
// 32 is undefined), then written out coalesced.  K4: one CTA per tile walks
// it plane by plane like K2, decoding each point straight from its block's
// payload words (masked by code_mask(w), exact at w = 0 and w = 32), then
// runs K2's scan and dequantization: the int32 codes never reach device
// memory.  Block and tile indices are 64-bit where they address the batch.
// Assembling the stream in-kernel (a decoupled look-back scan) and TMA
// staging are later work.
#include "lorenzo_tile.cuh"

namespace {

constexpr int BLOCK = 64;             // codes per packing block
constexpr int WORDS_PER_BLOCK = 64;   // a block's row: at most 2 * 32 words
constexpr int BLOCKS_PER_TILE = repro::TZ * repro::TY * repro::TX / BLOCK;  // 1024
constexpr int ENCODE_WARPS = 8;       // blocks per CTA in K3

__device__ __forceinline__ uint32_t zigzag(uint32_t d) {
  return (d << 1) ^ static_cast<uint32_t>(static_cast<int32_t>(d) >> 31);
}

__device__ __forceinline__ uint32_t unzigzag(uint32_t u) { return (u >> 1) ^ (0u - (u & 1u)); }

__device__ __forceinline__ uint32_t code_mask(int w) {
  return w == 0 ? 0u : (0xffffffffu >> (32 - w));
}

__global__ void __launch_bounds__(ENCODE_WARPS * 32)
sz_fused_encode_kernel(const float* __restrict__ x, const float* __restrict__ eb,
                       uint32_t* __restrict__ words, int32_t* __restrict__ widths,
                       int Y, int X, long long n_blocks, long long blocks_per_row) {
  __shared__ uint32_t rows[ENCODE_WARPS][WORDS_PER_BLOCK + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * ENCODE_WARPS + warp;
  if (b >= n_blocks) return;  // whole warps only: every warp op below sees 32 lanes

  const int gx = X / repro::TX, gy = Y / repro::TY;
  const long long t = b / BLOCKS_PER_TILE;
  const int c = static_cast<int>(b % BLOCKS_PER_TILE);
  const int tx = static_cast<int>(t % gx), ty = static_cast<int>((t / gx) % gy);
  const int tz = static_cast<int>(t / (static_cast<long long>(gx) * gy));
  const int zl = c >> 7, yl = (c >> 1) & (repro::TY - 1), x0 = (c & 1) * BLOCK;
  const int z = tz * repro::TZ + zl, y = ty * repro::TY + yl;
  const float inv = repro::inv_two_eb(eb + b / blocks_per_row);

  uint32_t u[2];
  int bits = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int xl = x0 + lane + 32 * h;
    u[h] = zigzag(repro::residual_at(x, Y, X, z, y, tx * repro::TX + xl, zl, yl, xl, inv));
    bits = max(bits, 32 - __clz(u[h]));
  }
  const int w = static_cast<int>(__reduce_max_sync(0xffffffffu, static_cast<unsigned>(bits)));

  uint32_t* row = rows[warp];
  row[lane] = 0u;
  row[lane + 32] = 0u;
  if (lane == 0) row[WORDS_PER_BLOCK] = 0u;
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int bitpos = (lane + 32 * h) * w;
    const int wlo = bitpos >> 5;
    const uint32_t off = static_cast<uint32_t>(bitpos & 31);
    atomicOr(row + wlo, u[h] << off);
    atomicOr(row + wlo + 1, (u[h] >> 1) >> (31u - off));  // u >> (32 - off), 0 at off == 0
  }
  __syncwarp();
  uint32_t* dst = words + b * WORDS_PER_BLOCK;
  dst[lane] = row[lane];
  dst[lane + 32] = row[lane + 32];
  if (lane == 0) widths[b] = w;
}

__global__ void __launch_bounds__(repro::SCAN_THREADS)
sz_fused_decode_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ widths,
                       const float* __restrict__ eb, float* __restrict__ out, int Y, int X,
                       int tiles_per_row) {
  const int gx = X / repro::TX, gy = Y / repro::TY;
  const int t = blockIdx.x;
  const int tx = t % gx, ty = (t / gx) % gy, tz = t / (gx * gy);
  const size_t tile_block0 = static_cast<size_t>(t) * BLOCKS_PER_TILE;
  auto load = [&](int zl, int yl, int xl) -> uint32_t {
    const size_t b = tile_block0 + zl * (repro::TY * 2) + yl * 2 + (xl >> 6);
    const int w = __ldg(widths + b);
    const int bitpos = (xl & (BLOCK - 1)) * w;
    const int wlo = bitpos >> 5;
    const uint32_t off = static_cast<uint32_t>(bitpos & 31);
    const uint32_t* row = words + b * WORDS_PER_BLOCK;
    uint32_t u = __ldg(row + wlo) >> off;
    // The high word only matters when the code straddles; then wlo + 1 < 2w.
    if (static_cast<int>(off) + w > 32) u |= (__ldg(row + wlo + 1) << 1) << (31u - off);
    return unzigzag(u & code_mask(w));
  };
  repro::scan_tile_dequant(load, eb + t / tiles_per_row, out, Y, X, tz, ty, tx);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING()

// x: f32 (B, Z, Y, X), TILE-padded rows; eb: device f32 [B] (each row's
// guarded bound); words: uint32 (B*Z*Y*X/64, 64); widths: int32
// (B*Z*Y*X/64), tile-major blocks of row 0, then row 1, ...
extern "C" int sz_fused_encode_batched(const float* x, const float* eb, uint32_t* words,
                                       int32_t* widths, int B, int Z, int Y, int X,
                                       cudaStream_t stream) {
  const long long blocks_per_row = static_cast<long long>(Z) * Y * X / BLOCK;
  const long long n_blocks = blocks_per_row * B;
  const long long grid = (n_blocks + ENCODE_WARPS - 1) / ENCODE_WARPS;
  if (grid > 0)
    sz_fused_encode_kernel<<<static_cast<unsigned>(grid), ENCODE_WARPS * 32, 0, stream>>>(
        x, eb, words, widths, Y, X, n_blocks, blocks_per_row);
  return static_cast<int>(cudaGetLastError());
}

// K3: one field, eb a device f32 scalar.
extern "C" int sz_fused_encode(const float* x, const float* eb, uint32_t* words, int32_t* widths,
                               int Z, int Y, int X, cudaStream_t stream) {
  return sz_fused_encode_batched(x, eb, words, widths, 1, Z, Y, X, stream);
}

// words/widths as sz_fused_encode_batched writes them (rows zero past
// 2*w); eb: device f32 [B]; out: f32 (B, Z, Y, X), TILE-padded rows.
extern "C" int sz_fused_decode_batched(const uint32_t* words, const int32_t* widths,
                                       const float* eb, float* out, int B, int Z, int Y, int X,
                                       cudaStream_t stream) {
  const int tiles_per_row = (Z / repro::TZ) * (Y / repro::TY) * (X / repro::TX);
  const long long tiles = static_cast<long long>(tiles_per_row) * B;
  if (tiles > 0)
    sz_fused_decode_kernel<<<static_cast<unsigned>(tiles), repro::SCAN_THREADS, 0, stream>>>(
        words, widths, eb, out, Y, X, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}

// K4: one field, eb a device f32 scalar.
extern "C" int sz_fused_decode(const uint32_t* words, const int32_t* widths, const float* eb,
                               float* out, int Z, int Y, int X, cudaStream_t stream) {
  return sz_fused_decode_batched(words, widths, eb, out, 1, Z, Y, X, stream);
}

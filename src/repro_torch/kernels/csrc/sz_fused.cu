// K3, K4, K8 and K9: single-pass fused TPU-SZ encode and decode on Hopper
// (sm_90a) that write and read the dense stream themselves, for one field
// (K3, K4) or a batch of same-shape fields (K8, K9).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   K3 fused encode          repro/kernels/sz_fused.py:177 _fused_encode (_fused_encode_kernel :165)
//   K4 fused decode          repro/kernels/sz_fused.py:336 fused_decompress (_fused_decode_kernel :312)
//   K8 batched fused encode  repro/kernels/sz_fused.py:238 _fused_encode_batched
//                            (_fused_encode_kernel_batched :169)
//   K9 batched fused decode  repro/kernels/sz_fused.py:361 fused_decompress_batched
//                            (_fused_decode_kernel_batched :316)
// The function each computes is the stream-level one around the Pallas call
// (fused_compress, fused_decompress and their batched forms): the TPU emits
// a 64-word row per block because it cannot scatter, and the stream is then
// compacted (and disassembled) in jnp; here the kernels do both.
//
// Stream layout (the contract): codes are the tile-blocked Lorenzo residuals
// in tile-major order (tiles in raster order, each (8, 64, 128) tile
// flattened C-order), zigzagged, in blocks of 64.  Block b has width w_b =
// max bit length of its codes and a payload of 2*w_b words at the exclusive
// prefix sum of 2*w: code i sits at bit i*w_b of it.  Words past the payload
// are zero.
//
// Offsets: a chunk is one z-plane of one tile, 64 x 128 points = 128
// blocks, whose payload is one contiguous span of at most 8192 words; chunk
// k = tile * 8 + z holds blocks k*128 .. k*128 + 127.  The encoder works a
// chunk per CTA, the decoder a tile.  A unit's word offset is the prefix sum
// of the spans before it, found in one pass by a decoupled look-back over
// per-unit flags: each CTA takes its unit from an atomic ticket (so every
// unit before it has been scheduled), publishes its span, then sums its
// predecessors' spans back to the nearest one that has published its
// inclusive prefix.  The flags and the ticket live in a scratch buffer the
// wrapper zeroes with torch.zeros on every call, so the launch captures in a
// CUDA graph.  Batches: rows lie back to back (no tile spans two rows, since
// Z % 8 == 0), so K8/K9 are K3/K4 over (B*Z, Y, X) with row b's bound, and
// rows' streams are dense one after another.
//
// Encoder (K3, K8), one CTA of 256 threads per chunk:
//   1. 16-byte loads of plane z and z - 1 of x; each value quantized
//      (__float2int_rn(v / 2eb)) and d = q(z) - q(z - 1) stored to shared
//      memory (q(z - 1) = 0 on the tile's first plane);
//   2. a warp per 16 blocks forms each residual from d (Lorenzo along y and
//      x: four shared loads), zigzags it, takes the block's width with one
//      max reduction, and keeps its 32 codes in registers;
//   3. one warp scans the 128 widths (offsets of 2w inside the chunk),
//      writes them as bytes and publishes the chunk's span;
//   4. every warp packs its blocks into shared memory without atomics: a
//      half block's 32 codes fill exactly w words, each code's low part goes
//      to word (i*w)>>5 and its high part ((u >> 1) >> (31 - off), the
//      reference's two-step shift) to the next, where the next lane's code
//      starts, so one shuffle moves it and a segmented OR scan over lanes
//      of equal word index (5 shuffles) leaves each word in the last lane
//      of its segment;
//   5. warp 0 looks back for the chunk's offset; the CTA then writes the
//      span coalesced, and a share of the zero tail that it can place
//      without knowing where the stream ends (step 6 in the code), so every
//      CTA writes 8192 words and the buffer needs no memset.  The last
//      chunk of a row waits for its row's first chunk's inclusive flag and
//      writes the row's counts and total_bits (K8 also offsets and used),
//      so nothing is read back by the host.
// Decoder (K4, K9), one CTA of 512 threads per tile (8 planes).  The
// widths are an input, so a tile's whole span is known up front and one
// look-back per tile (not per plane) finds its offset:
//   1. the ticket gives the tile; its 1024 widths are scanned (offsets of
//      2w inside the tile) and the tile's span published and looked back;
//   2. the CTA walks the planes, plane z + 1's span copying into a second
//      shared buffer (16-byte cp.async for the whole lines, 4-byte ones for
//      the at most three words on either side) while plane z decodes: each
//      lane decodes 4 consecutive codes of a row from shared memory (a
//      funnel shift of two words, masked by code_mask(w), exact at w = 0 and
//      w = 32), so no global load waits on another;
//   3. prefix sums: x by a warp scan, y over a warp's 4 rows in registers
//      plus the carries of the warps above (one barrier), z as a running sum
//      in registers across the planes;
//   4. dequantize (__int2float_rn(int32(s)) * 2eb) and store coalesced in x.
// Two barriers per plane; two CTAs (32 warps) fit an SM, so the 256 tiles
// of a 256^3 field run in one wave.  (A cluster of 8 CTAs per tile, a plane
// each, with the z-scan through distributed shared memory, read 0.113 ms at
// 256^3: the cluster barriers and per-plane look-backs cost more than the
// parallelism gave.)
// All residual and prefix arithmetic is uint32_t, so wrap is defined; mod
// 2^32 it equals the reference's int32 arithmetic.
//
// Bound (the least the functions need).  Encode: 4 B/pt of f32 in, the
// payload (4 * 2 * sum(w) bytes), 1 B of width per block, the zero tail
// (4 * (capacity - used)) and 8 B of flag per chunk: ~8 B/pt at the main
// path's ~6 bits a value, ~0.04 ms for a 256^3 field at 3.35 TB/s (K8 ~0.16
// ms for four).  Decode: the payload, 1 B per block and 4 B/pt of f32 out:
// ~4.8 B/pt, ~0.024 ms at 256^3.
#include "lorenzo_tile.cuh"

namespace {

constexpr int BLOCK = 64;                                // codes per packing block
constexpr int CHUNK_POINTS = repro::TY * repro::TX;      // 8192: one z-plane of a tile
constexpr int CHUNK_BLOCKS = CHUNK_POINTS / BLOCK;       // 128
constexpr int CHUNK_WORDS = 2 * 32 * CHUNK_BLOCKS;       // 8192: the most a chunk's span holds
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = repro::TY / WARPS;         // 8
constexpr int VEC_PER_THREAD = CHUNK_POINTS / 4 / THREADS;  // 8 float4 of a plane
constexpr unsigned FULL = 0xffffffffu;

// Look-back flag of a chunk (encoder) or a tile (decoder): status in bits
// 62-63, its span (<= 65536 words) in bits 32-52 and, once inclusive, its
// exclusive prefix in bits 0-31.
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 62;
constexpr unsigned long long FLAG_INCLUSIVE = 2ull << 62;

__device__ __forceinline__ unsigned long long flag_word(unsigned long long status, uint32_t span,
                                                        uint32_t prefix) {
  return status | (static_cast<unsigned long long>(span) << 32) | prefix;
}

__device__ __forceinline__ void publish(unsigned long long* flags, long long k,
                                        unsigned long long word) {
  *reinterpret_cast<volatile unsigned long long*>(flags + k) = word;
}

// Exclusive prefix of chunk k's span over chunks 0 .. k-1.  One whole warp
// calls it and every lane gets the prefix: 32 predecessors are read at once,
// spinning until each has published, and summed back to the nearest one
// that is inclusive.  Chunks before k hold earlier tickets, so they run.
__device__ uint32_t look_back(const unsigned long long* flags, long long k) {
  const volatile unsigned long long* f = flags;
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0;
  for (long long last = k - 1;; last -= 32) {
    const long long j = last - lane;
    unsigned long long word = j >= 0 ? f[j] : FLAG_INCLUSIVE;  // before chunk 0: nothing
    while (__any_sync(FULL, (word >> 62) == 0)) {
      if ((word >> 62) == 0) word = f[j];
    }
    const unsigned inclusive = __ballot_sync(FULL, (word >> 62) == 2);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 32;  // the nearest inclusive chunk
    uint32_t v = 0;
    if (lane <= stop) v = static_cast<uint32_t>(word >> 32) & 0x1fffffu;
    if (lane == stop) v += static_cast<uint32_t>(word);
    prefix += __reduce_add_sync(FULL, v);
    if (inclusive) return prefix;
  }
}

// Warp 0: exclusive offsets (in words) of the chunk's 128 blocks from their
// widths w[] (shared), written to off[]; returns the chunk's span.  Lane l
// holds blocks 4l .. 4l + 3, and packs their widths into one word.
__device__ __forceinline__ uint32_t chunk_offsets(const int* w, uint32_t* off, uint32_t* packed) {
  const int lane = threadIdx.x & 31;
  uint32_t ex[4], s = 0, bytes = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int wj = w[4 * lane + j];
    ex[j] = s;
    s += 2u * static_cast<uint32_t>(wj);
    bytes |= static_cast<uint32_t>(wj) << (8 * j);
  }
  uint32_t incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) off[4 * lane + j] = incl - s + ex[j];
  *packed = bytes;
  return __shfl_sync(FULL, incl, 31);
}

__device__ __forceinline__ uint32_t zigzag(uint32_t d) {
  return (d << 1) ^ static_cast<uint32_t>(static_cast<int32_t>(d) >> 31);
}

__device__ __forceinline__ uint32_t unzigzag(uint32_t u) { return (u >> 1) ^ (0u - (u & 1u)); }

__device__ __forceinline__ uint32_t code_mask(int w) {
  return w == 0 ? 0u : (0xffffffffu >> (32 - w));
}

// Tile coordinates of tile t of a (B*Z, Y, X) field of (8, 64, 128) tiles.
struct TileAt {
  long long z0;  // first plane
  int y0, x0;
};

__device__ __forceinline__ TileAt tile_at(long long t, int Y, int X) {
  const int gx = X / repro::TX, gy = Y / repro::TY;
  return {t / (static_cast<long long>(gx) * gy) * repro::TZ,
          static_cast<int>((t / gx) % gy) * repro::TY, static_cast<int>(t % gx) * repro::TX};
}

// ------------------------------------------------------------- encode -----

__global__ void __launch_bounds__(THREADS, 3)
sz_stream_encode_kernel(const float* __restrict__ x, const float* __restrict__ eb,
                        uint32_t* __restrict__ words, uint8_t* __restrict__ widths,
                        unsigned long long* flags, unsigned* ticket,
                        int32_t* __restrict__ row_meta, long long* __restrict__ row_bits,
                        int B, int Y, int X, long long chunks_per_row) {
  // d of the plane, then the chunk's packed span (every read of d is behind
  // the barrier that ends the residual pass)
  __shared__ __align__(16) uint32_t plane[repro::TY][repro::TX];
  __shared__ int s_w[CHUNK_BLOCKS];
  __shared__ uint32_t s_off[CHUNK_BLOCKS];
  __shared__ long long s_k;
  __shared__ uint32_t s_span, s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_k = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long k = s_k;
  const int zl = static_cast<int>(k % repro::TZ);
  const TileAt tile = tile_at(k / repro::TZ, Y, X);
  const long long row = k / chunks_per_row;
  const float inv = repro::inv_two_eb(eb + row);

  // 1. d = q(z) - q(z - 1), each point quantized once per plane it enters
  {
    const float* src = x + ((tile.z0 + zl) * Y + tile.y0) * static_cast<long long>(X) + tile.x0;
    const long long below = static_cast<long long>(Y) * X;
    float4 cur[VEC_PER_THREAD], prev[VEC_PER_THREAD];
#pragma unroll
    for (int i = 0; i < VEC_PER_THREAD; ++i) {
      const int e = tid + i * THREADS;  // float4 e of the plane: row e / 32, columns 4 (e % 32) ..
      const float* p = src + static_cast<long long>(e / (repro::TX / 4)) * X + 4 * (e % (repro::TX / 4));
      cur[i] = __ldg(reinterpret_cast<const float4*>(p));
      prev[i] = zl ? __ldg(reinterpret_cast<const float4*>(p - below)) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < VEC_PER_THREAD; ++i) {
      uint4 d = make_uint4(repro::quantize(cur[i].x, inv), repro::quantize(cur[i].y, inv),
                           repro::quantize(cur[i].z, inv), repro::quantize(cur[i].w, inv));
      if (zl) {
        d.x -= repro::quantize(prev[i].x, inv);
        d.y -= repro::quantize(prev[i].y, inv);
        d.z -= repro::quantize(prev[i].z, inv);
        d.w -= repro::quantize(prev[i].w, inv);
      }
      reinterpret_cast<uint4*>(&plane[0][0])[tid + i * THREADS] = d;
    }
  }
  __syncthreads();

  // 2. residuals, codes and widths: warp w owns rows 8w .. 8w + 7, a row's
  //    two blocks (h), codes lane and lane + 32 of each (c)
  uint32_t u[ROWS_PER_WARP][2][2];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int yl = warp * ROWS_PER_WARP + r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned bits = 0;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int xl = h * BLOCK + c * 32 + lane;
        uint32_t v = plane[yl][xl];
        if (xl) v -= plane[yl][xl - 1];
        if (yl) {
          v -= plane[yl - 1][xl];
          if (xl) v += plane[yl - 1][xl - 1];
        }
        u[r][h][c] = zigzag(v);
        bits = max(bits, static_cast<unsigned>(32 - __clz(u[r][h][c])));
      }
      const int w = static_cast<int>(__reduce_max_sync(FULL, bits));
      if (lane == 0) s_w[2 * yl + h] = w;
    }
  }
  __syncthreads();

  // 3. offsets inside the chunk, the widths out, the span published
  if (warp == 0) {
    uint32_t bytes;
    const uint32_t span = chunk_offsets(s_w, s_off, &bytes);
    reinterpret_cast<uint32_t*>(widths + k * CHUNK_BLOCKS)[lane] = bytes;
    if (lane == 0) {
      s_span = span;
      publish(flags, k, flag_word(k == 0 ? FLAG_INCLUSIVE : FLAG_AGGREGATE, span, 0));
    }
  }
  __syncthreads();

  // 4. pack into shared memory: a half block's 32 codes fill w words
  uint32_t* pay = &plane[0][0];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int yl = warp * ROWS_PER_WARP + r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // no branch around the shuffles: the compiler cannot see that w is
      // warp-uniform, and would emulate each one in divergent code
      const int w = s_w[2 * yl + h];
      const uint32_t base = s_off[2 * yl + h];
      const int wlo = (lane * w) >> 5;
      const uint32_t off = static_cast<uint32_t>(lane * w) & 31u;
      // an all-zero block (w = 0) has no payload word to write
      const bool last = w && (lane == 31 || (((lane + 1) * w) >> 5) != wlo);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t v = u[r][h][c];
        // the high part lands in the word where the next lane's code starts
        const uint32_t up = __shfl_up_sync(FULL, (v >> 1) >> (31u - off), 1);
        uint32_t acc = (v << off) | (lane ? up : 0u);
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const uint32_t o = __shfl_up_sync(FULL, acc, d);
          if (lane >= d && (((lane - d) * w) >> 5) == wlo) acc |= o;
        }
        if (last) pay[base + c * w + wlo] = acc;
      }
    }
  }

  // 5. the chunk's offset; the row's descriptors from its last chunk
  if (warp == 0) {
    const uint32_t span = s_span;
    const uint32_t prefix = k == 0 ? 0u : look_back(flags, k);
    if (lane == 0) {
      s_prefix = prefix;
      if (k) publish(flags, k, flag_word(FLAG_INCLUSIVE, span, prefix));
      const long long first = row * chunks_per_row;
      if (row_meta && k == first) row_meta[row] = static_cast<int32_t>(prefix);
      if (k == first + chunks_per_row - 1) {
        const volatile unsigned long long* f = flags;
        unsigned long long head = f[first];
        while ((head >> 62) != 2) head = f[first];
        const uint32_t end = prefix + span;
        const uint32_t count = end - static_cast<uint32_t>(head);
        const long long nbits = 32ll * count + 8ll * chunks_per_row * CHUNK_BLOCKS;
        if (row_meta) {
          row_meta[B + row] = static_cast<int32_t>(count);
          row_meta[2 * B + row] = static_cast<int32_t>(nbits);
          if (row == B - 1) row_meta[3 * B] = static_cast<int32_t>(end);
        }
        if (row_bits) row_bits[row] = nbits;
      }
    }
  }
  __syncthreads();

  // 6. the span, then this chunk's share of the zero tail: with C chunks,
  //    used <= u_k = prefix + span + (C - 1 - k) * 8192 (every later chunk
  //    at most full), and the ranges [u_k, u_(k-1)) = [u_k, u_k + 8192 -
  //    span) tile [used, C * 8192) exactly; the last chunk also zeroes each
  //    row's 2 slack words.  Every CTA writes 8192 words.
  const uint32_t prefix = s_prefix, span = s_span;
  const long long chunks = gridDim.x;
  uint32_t* zeros = words + prefix + (chunks - 1 - k) * CHUNK_WORDS;  // zeros[span] is u_k
  for (uint32_t i = tid; i < CHUNK_WORDS; i += THREADS) {
    if (i < span)
      words[prefix + i] = pay[i];
    else
      zeros[i] = 0u;
  }
  if (k == chunks - 1 && tid < 2 * B) words[chunks * CHUNK_WORDS + tid] = 0u;
}

// ------------------------------------------------------------- decode -----

constexpr int DEC_THREADS = 512;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_ROWS = repro::TY / DEC_WARPS;  // 4 rows of a plane per warp
constexpr int TILE_BLOCKS = CHUNK_BLOCKS * repro::TZ;  // 1024
constexpr int STAGE_WORDS = CHUNK_WORDS + 8;  // a plane's span rounded out to 16 B

struct DecodeSmem {
  uint32_t stage[2][STAGE_WORDS];  // plane z's span, and plane z + 1's arriving
  uint4 carry[DEC_WARPS][repro::TX / 4];  // each warp's last row, for the warps below
  uint32_t off[TILE_BLOCKS + 1];   // block offsets in the tile's span (words)
  uint8_t w[TILE_BLOCKS];
  uint32_t warp_sum[DEC_WARPS];
  long long tile;
  uint32_t prefix;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Word p of ``words`` sits at buf[shift] with shift = p's position in its
// 16-byte line, so that whole lines copy as 16-byte cp.async.
__device__ __forceinline__ int line_shift(const uint32_t* words, long long p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(words + p) >> 2) & 3u);
}

// Stage words [p, p + span) at buf[shift ..] without waiting: 16-byte
// cp.async for the whole lines, 4-byte ones for the at most three words on
// either side (clamped to the buffer, as the plain version's gather
// clamps), then one commit.
__device__ __forceinline__ void stage_span(uint32_t* buf, const uint32_t* __restrict__ words,
                                           long long n_words, long long p, long long span) {
  const int shift = line_shift(words, p);
  const long long a0 = p - shift;  // 16-byte aligned word index
  const long long end_in = min(p + span, n_words);
  const long long v_lo = shift ? 1 : 0;  // first whole line, in lines from a0
  const long long v_hi = max((end_in - a0) / 4, v_lo);
  for (long long m = v_lo + threadIdx.x; m < v_hi; m += DEC_THREADS)
    cp_async16(buf + 4 * m, words + a0 + 4 * m);
  const long long head = min(a0 + 4 * v_lo, p + span) - p;  // words before the first line
  const long long tail = max(a0 + 4 * v_hi - p, head);     // words from the last line on
  for (long long i = threadIdx.x; i < head; i += DEC_THREADS)
    cp_async4(buf + shift + i, words + min(p + i, n_words - 1));
  for (long long i = tail + threadIdx.x; i < span; i += DEC_THREADS)
    cp_async4(buf + shift + i, words + min(p + i, n_words - 1));
  cp_async_commit();
}

__device__ __forceinline__ void add4(uint32_t (&v)[4], uint4 a) {
  v[0] += a.x;
  v[1] += a.y;
  v[2] += a.z;
  v[3] += a.w;
}

__global__ void __launch_bounds__(DEC_THREADS, 2)
sz_stream_decode_kernel(const uint32_t* __restrict__ words, long long n_words,
                        const uint8_t* __restrict__ widths, const float* __restrict__ eb,
                        float* __restrict__ out, unsigned long long* flags, unsigned* ticket,
                        int Y, int X, long long tiles_per_row) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DecodeSmem& S = *reinterpret_cast<DecodeSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. the tile; its 1024 widths and their offsets (exclusive scan of 2w,
  //    two blocks a thread); its span published and its offset looked up
  if (tid == 0) S.tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long t = S.tile;
  const uint8_t* tw = widths + t * TILE_BLOCKS;
  const uint32_t w0 = min(static_cast<uint32_t>(tw[2 * tid]), 32u);
  const uint32_t w1 = min(static_cast<uint32_t>(tw[2 * tid + 1]), 32u);
  S.w[2 * tid] = static_cast<uint8_t>(w0);
  S.w[2 * tid + 1] = static_cast<uint8_t>(w1);
  uint32_t incl = 2 * (w0 + w1);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) S.warp_sum[warp] = incl;
  __syncthreads();
  uint32_t base = 0;
  for (int q = 0; q < warp; ++q) base += S.warp_sum[q];
  const uint32_t ex = base + incl - 2 * (w0 + w1);
  S.off[2 * tid] = ex;
  S.off[2 * tid + 1] = ex + 2 * w0;
  if (tid == DEC_THREADS - 1) S.off[TILE_BLOCKS] = ex + 2 * (w0 + w1);
  __syncthreads();
  if (warp == 0) {
    const uint32_t span = S.off[TILE_BLOCKS];
    if (t == 0) {
      if (lane == 0) {
        publish(flags, 0, flag_word(FLAG_INCLUSIVE, span, 0));
        S.prefix = 0;
      }
    } else {
      if (lane == 0) publish(flags, t, flag_word(FLAG_AGGREGATE, span, 0));
      const uint32_t prefix = look_back(flags, t);
      if (lane == 0) {
        publish(flags, t, flag_word(FLAG_INCLUSIVE, span, prefix));
        S.prefix = prefix;
      }
    }
  }
  __syncthreads();

  // 2. walk the tile's 8 planes, plane z + 1's span arriving while plane z
  //    decodes: x by a warp scan (4 codes a lane), y over a warp's 4 rows in
  //    registers plus the carries of the warps above, z in registers
  const long long p = S.prefix;
  const TileAt tile = tile_at(t, Y, X);
  const float scale = 2.0f * __ldg(eb + t / tiles_per_row);
  const int half = lane >> 4, i0 = 4 * (lane & 15);
  uint32_t zsum[DEC_ROWS][4] = {};
  stage_span(S.stage[0], words, n_words, p, S.off[CHUNK_BLOCKS]);
#pragma unroll 1
  for (int zl = 0; zl < repro::TZ; ++zl) {
    const uint32_t plane0 = S.off[zl * CHUNK_BLOCKS];
    if (zl + 1 < repro::TZ) {
      const uint32_t next0 = S.off[(zl + 1) * CHUNK_BLOCKS];
      stage_span(S.stage[(zl + 1) & 1], words, n_words, p + next0,
                 S.off[(zl + 2) * CHUNK_BLOCKS] - next0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // plane zl staged by every thread

    const uint32_t* stage = S.stage[zl & 1] + line_shift(words, p + plane0);
    uint32_t run[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r) {
      const int blk = zl * CHUNK_BLOCKS + 2 * (warp * DEC_ROWS + r) + half;
      const int w = S.w[blk];
      const uint32_t mask = code_mask(w);
      const uint32_t* b = stage + (S.off[blk] - plane0);
      uint32_t c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bp = (i0 + j) * w;
        c[j] = unzigzag(__funnelshift_r(b[bp >> 5], b[(bp >> 5) + 1], bp & 31) & mask);
      }
      c[1] += c[0];
      c[2] += c[1];
      c[3] += c[2];
      uint32_t xincl = c[3];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t up = __shfl_up_sync(FULL, xincl, d);
        if (lane >= d) xincl += up;
      }
      const uint32_t xex = xincl - c[3];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        run[j] += c[j] + xex;
        zsum[r][j] += run[j];  // the carries of the warps above follow the barrier
      }
    }
    S.carry[warp][lane] = make_uint4(run[0], run[1], run[2], run[3]);
    __syncthreads();  // every carry written; every read of this plane's stage done
    uint32_t add[4] = {0u, 0u, 0u, 0u};
    for (int q = 0; q < warp; ++q) add4(add, S.carry[q][lane]);

    // 3. dequantize and store, 512 B per row and warp
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) zsum[r][j] += add[j];
      const int yl = warp * DEC_ROWS + r;
      float* dst = out + ((tile.z0 + zl) * Y + tile.y0 + yl) * static_cast<long long>(X) + tile.x0;
      reinterpret_cast<float4*>(dst)[lane] =
          make_float4(__int2float_rn(static_cast<int32_t>(zsum[r][0])) * scale,
                      __int2float_rn(static_cast<int32_t>(zsum[r][1])) * scale,
                      __int2float_rn(static_cast<int32_t>(zsum[r][2])) * scale,
                      __int2float_rn(static_cast<int32_t>(zsum[r][3])) * scale);
    }
  }
}

}  // namespace

REPRO_DEFINE_ERROR_STRING()

// x: f32 (B, Z, Y, X), TILE-padded rows, 16-byte aligned; eb: device f32 [B]
// (each row's guarded bound); words: uint32 [B * (Z*Y*X + 2)];
// widths: uint8 [B * Z*Y*X / 64]; scratch: uint64 [chunks + 1], zeroed
// (flags, then the ticket); row_meta: int32 [3B + 1] (offsets, counts,
// total_bits, used) or null; row_bits: int64 [B] (total_bits) or null.
extern "C" int sz_stream_encode(const float* x, const float* eb, uint32_t* words,
                                uint8_t* widths, unsigned long long* scratch, int32_t* row_meta,
                                long long* row_bits, int B, int Z, int Y, int X,
                                cudaStream_t stream) {
  const long long chunks_per_row = static_cast<long long>(Z) * Y * X / CHUNK_POINTS;
  const long long chunks = chunks_per_row * B;
  if (chunks > 0)
    sz_stream_encode_kernel<<<static_cast<unsigned>(chunks), THREADS, 0, stream>>>(
        x, eb, words, widths, scratch, reinterpret_cast<unsigned*>(scratch + chunks), row_meta,
        row_bits, B, Y, X, chunks_per_row);
  return static_cast<int>(cudaGetLastError());
}

// words: the dense stream(s), n_words long; widths: uint8 [B * Z*Y*X / 64];
// eb: device f32 [B]; out: f32 (B, Z, Y, X), TILE-padded rows; scratch:
// uint64 [tiles + 1], zeroed.
extern "C" int sz_stream_decode(const uint32_t* words, long long n_words, const uint8_t* widths,
                                const float* eb, float* out, unsigned long long* scratch, int B,
                                int Z, int Y, int X, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(DecodeSmem));
  cudaError_t err = cudaFuncSetAttribute(sz_stream_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_per_row =
      static_cast<long long>(Z / repro::TZ) * (Y / repro::TY) * (X / repro::TX);
  const long long tiles = tiles_per_row * B;
  if (tiles > 0)
    sz_stream_decode_kernel<<<static_cast<unsigned>(tiles), DEC_THREADS, smem, stream>>>(
        words, n_words, widths, eb, out, scratch, reinterpret_cast<unsigned*>(scratch + tiles),
        Y, X, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}

// K10: one-token decode attention over a blockfloat8 KV cache, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   K10 kvc_decode_attention (_kvc_kernel)  repro/kernels/kvc_attention.py:68
// called from repro/models/layers.py:430-439 (_attend_cached) on every
// decode tick, once per layer.
//
// Function.  q (B, H, D) f32 or bf16 attends over int8 K/V codes
// (B, S, Hkv, D) with one f32 scale per (token, kv head); lane b sees
// positions 0..index[b].  Logits are (q . (code * scale)) * D^-0.5, the
// softmax is online with the reference's -1e30 start and max(l, 1e-30)
// guard, sums are f32 and the output is cast to q's dtype at the end.  A
// lane with index -1 reads nothing and writes exactly 0.  Query head h uses
// KV head h / n_rep: the reference's caller repeats the codes n_rep times
// first (12x the bytes at starcoder2-3b's 24/2 heads); here the codes are
// read once for all n_rep heads of a block.
//
// Bound.  Bytes: every code and scale of positions 0..index[b] is read once
// (2 D + 8 bytes per position and KV head), plus q and the output.  The
// function's arithmetic is smaller: the one scale per (token, KV head)
// factors out of q.k and p.v, q.k of a bf16 query with int8 codes is exact
// in bf16 (tensor-core rate), and only p.v (2 D flops per position and
// query head) needs f32.  So the function is bound by device memory
// (3.35 TB/s).  This kernel scores on the f32 pipes (4 D flops per position
// and query head, about 1.2x the byte time at 12 query heads per KV head);
// tensor-core scoring is later work.
//
// Design.  A block per (lane, KV head, split of S), one warp per query head
// of the group.  The block walks its positions in tiles of 64, staging the
// tile's K and V codes and scales in shared memory once for its n_rep
// warps (K rows at an odd word stride, so the lanes of a warp read 32
// different rows conflict-free).  In a warp, lane j scores positions j and
// j + 32 of the tile, one max and one sum reduce per tile update the running
// (m, l), and each lane accumulates its own D / 32 output dimensions.  The
// TPU kernel's sequential grid over chunks becomes this loop; positions past
// index[b] are never read (the TPU kernel reads every chunk).  At the
// serving shape (B, Hkv) = (8, 2) gives only 16 blocks for 132 SMs, so S is
// split: each block keeps its own (m, l, acc) and a second small kernel
// merges the splits.  Simple and right first: TMA staging, cp.async double
// buffering and reading through the page table are later work.  No fast
// math: expf and IEEE division keep the result within the plain version's
// tolerance.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;                 // positions staged per step
constexpr int PER_LANE = TILE / 32;      // positions a lane scores per tile
constexpr int MAX_D = 256;
constexpr int MAX_DPL = MAX_D / 32;      // output dims a lane accumulates
constexpr float NEG = -1e30f;            // the reference's mask value

struct Shape {
  int B, S, H, Hkv, D, n_rep, splits, chunk;
  float scale;  // D ** -0.5, rounded to f32 on the host as the reference does
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int k_row_words(int D) { return D / 4 + 1; }

__host__ __device__ size_t smem_bytes(int D, int n_rep) {
  return sizeof(float) * (static_cast<size_t>(n_rep) * D + n_rep * TILE + 2 * TILE)
         + sizeof(uint32_t) * TILE * k_row_words(D) + static_cast<size_t>(TILE) * D;
}

template <typename T>
__global__ void kvc_split_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                                 const float* __restrict__ ks, const int8_t* __restrict__ vc,
                                 const float* __restrict__ vs, const int32_t* __restrict__ index,
                                 T* __restrict__ out, float* __restrict__ part_m,
                                 float* __restrict__ part_l, float* __restrict__ part_acc,
                                 Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = s.D, n_rep = s.n_rep, dw = D / 4, kw = k_row_words(D);
  float* qs = reinterpret_cast<float*>(smem);  // n_rep x D, q as f32
  float* ps = qs + n_rep * D;                  // n_rep x TILE, probabilities
  float* kss = ps + n_rep * TILE;              // TILE K scales
  float* vss = kss + TILE;                     // TILE V scales
  uint32_t* kcs = reinterpret_cast<uint32_t*>(vss + TILE);    // TILE x kw words
  uint32_t* vcs = kcs + TILE * kw;                            // TILE x dw words

  const int b = blockIdx.x / s.Hkv, g = blockIdx.x % s.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = g * n_rep + warp;
  const int len = min(index[b] + 1, s.S);  // <= 0 for a free lane
  const int begin = blockIdx.y * s.chunk;
  const int end = min(begin + s.chunk, len);

  const T* qb = q + (static_cast<size_t>(b) * s.H + g * n_rep) * D;
  for (int i = threadIdx.x; i < n_rep * D; i += blockDim.x) qs[i] = to_f32(qb[i]);

  // position 0 of (b, :, g, :); consecutive positions are Hkv * D bytes apart
  const size_t base = (static_cast<size_t>(b) * s.S * s.Hkv + g) * D;
  const size_t row = static_cast<size_t>(s.Hkv) * D;
  float m = NEG, l = 0.f, acc[MAX_DPL];
#pragma unroll
  for (int i = 0; i < MAX_DPL; ++i) acc[i] = 0.f;
  __syncthreads();

  const float* qh = qs + warp * D;
  float* ph = ps + warp * TILE;
  for (int t0 = begin; t0 < end; t0 += TILE) {
    const int n = min(TILE, end - t0);
    for (int w = threadIdx.x; w < n * dw; w += blockDim.x) {
      const int r = w / dw, c = w - r * dw;
      const size_t off = base + (t0 + r) * row;
      kcs[r * kw + c] = reinterpret_cast<const uint32_t*>(kc + off)[c];
      vcs[r * dw + c] = reinterpret_cast<const uint32_t*>(vc + off)[c];
    }
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const size_t si = (static_cast<size_t>(b) * s.S + t0 + r) * s.Hkv + g;
      kss[r] = ks[si];
      vss[r] = vs[si];
    }
    __syncthreads();

    float lg[PER_LANE];
    float tmax = NEG;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int j = lane + 32 * u;
      lg[u] = NEG;
      if (j < n) {
        const uint32_t* kr = kcs + j * kw;
        const float sc = kss[j];
        float dot = 0.f;
        for (int c = 0; c < dw; ++c) {
          const uint32_t wv = kr[c];
          dot = fmaf(qh[4 * c + 0], static_cast<float>(static_cast<int8_t>(wv)) * sc, dot);
          dot = fmaf(qh[4 * c + 1], static_cast<float>(static_cast<int8_t>(wv >> 8)) * sc, dot);
          dot = fmaf(qh[4 * c + 2], static_cast<float>(static_cast<int8_t>(wv >> 16)) * sc, dot);
          dot = fmaf(qh[4 * c + 3], static_cast<float>(static_cast<int8_t>(wv >> 24)) * sc, dot);
        }
        lg[u] = dot * s.scale;
      }
      tmax = fmaxf(tmax, lg[u]);
    }
    const float m_new = fmaxf(m, warp_max(tmax));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int j = lane + 32 * u;
      const float p = j < n ? expf(lg[u] - m_new) : 0.f;
      ph[j] = p;
      psum += p;
    }
    l = l * alpha + warp_sum(psum);
    m = m_new;
    __syncwarp();

    const int8_t* vb = reinterpret_cast<const int8_t*>(vcs);
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) acc[i] *= alpha;
    for (int j = 0; j < n; ++j) {
      const float p = ph[j], sc = vss[j];
      const int8_t* vr = vb + j * D;
#pragma unroll
      for (int i = 0; i < MAX_DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(p, static_cast<float>(vr[d]) * sc, acc[i]);
      }
    }
    __syncthreads();  // the next tile overwrites shared memory
  }

  if (s.splits == 1) {
    T* o = out + (static_cast<size_t>(b) * s.H + h) * D;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) from_f32(o + d, acc[i] / den);
    }
    return;
  }
  const size_t pi = (static_cast<size_t>(b) * s.H + h) * s.splits + blockIdx.y;
  if (lane == 0) {
    part_m[pi] = m;
    part_l[pi] = l;
  }
#pragma unroll
  for (int i = 0; i < MAX_DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) part_acc[pi * D + d] = acc[i];
  }
}

// Merge the splits of one (lane, head): rescale each split's (l, acc) to the
// largest running max.  An empty split has (m, l, acc) = (-1e30, 0, 0) and
// weighs nothing; a lane whose splits are all empty gets 0 / 1e-30 = 0.
template <typename T>
__global__ void kvc_combine_kernel(const float* __restrict__ part_m,
                                   const float* __restrict__ part_l,
                                   const float* __restrict__ part_acc, T* __restrict__ out,
                                   int splits, int D) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  float M = NEG;
  for (int sp = 0; sp < splits; ++sp) M = fmaxf(M, part_m[bh * splits + sp]);
  float L = 0.f, O = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const size_t pi = bh * splits + sp;
    const float w = expf(part_m[pi] - M);
    L = fmaf(w, part_l[pi], L);
    if (d < D) O = fmaf(w, part_acc[pi * D + d], O);
  }
  if (d < D) from_f32(out + bh * D + d, O / fmaxf(L, 1e-30f));
}

template <typename T>
int launch(const void* q, const int8_t* kc, const float* ks, const int8_t* vc, const float* vs,
           const int32_t* index, void* out, float* part_m, float* part_l, float* part_acc,
           Shape s, cudaStream_t stream) {
  const size_t smem = smem_bytes(s.D, s.n_rep);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kvc_split_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(s.B * s.Hkv, s.splits);
  kvc_split_kernel<T><<<grid, 32 * s.n_rep, smem, stream>>>(
      static_cast<const T*>(q), kc, ks, vc, vs, index, static_cast<T*>(out), part_m, part_l,
      part_acc, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || s.splits == 1) return static_cast<int>(e);
  const int threads = (s.D + 31) / 32 * 32;
  kvc_combine_kernel<T><<<s.B * s.H, threads, 0, stream>>>(part_m, part_l, part_acc,
                                                           static_cast<T*>(out), s.splits, s.D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (B, H, D) f32 (q_bf16 = 0) or bf16 (1); kc, vc: int8 (B, S, Hkv, D);
// ks, vs: f32 (B, S, Hkv); index: int32 (B,); out: (B, H, D) in q's dtype.
// With splits > 1, part_m and part_l hold B*H*splits floats and part_acc
// B*H*splits*D.  Needs H = n_rep * Hkv, n_rep <= 32, D % 4 == 0, D <= 256,
// chunk % 64 == 0 and 4-byte aligned codes; the wrapper checks all of it.
// Launches on ``stream`` and returns cudaGetLastError().
extern "C" int kvc_attention(const void* q, int q_bf16, const int8_t* kc, const float* ks,
                             const int8_t* vc, const float* vs, const int32_t* index, void* out,
                             float* part_m, float* part_l, float* part_acc, int B, int S, int H,
                             int Hkv, int D, int splits, int chunk, float scale,
                             cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  const Shape s{B, S, H, Hkv, D, H / Hkv, splits, chunk, scale};
  if (q_bf16)
    return launch<__nv_bfloat16>(q, kc, ks, vc, vs, index, out, part_m, part_l, part_acc, s,
                                 stream);
  return launch<float>(q, kc, ks, vc, vs, index, out, part_m, part_l, part_acc, s, stream);
}

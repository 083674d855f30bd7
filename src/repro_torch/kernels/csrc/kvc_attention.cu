// K10: one-token decode attention over a blockfloat8 KV cache, on Hopper
// (sm_90a), read through the page table of the paged pool or from a dense
// cache.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   K10 kvc_decode_attention (_kvc_kernel)  repro/kernels/kvc_attention.py:68
// called from repro/models/layers.py:430-439 (_attend_cached) on every
// decode tick, once per layer, after cache_codes has gathered the pages.
//
// Function.  q (B, H, D) f32 or bf16 attends over int8 K/V codes with one
// f32 scale per (token, kv head); lane b sees positions 0..index[b].
// Logits are (q . code) * scale_k * D^-0.5, the softmax is online with the
// reference's -1e30 start and max(l, 1e-30) guard, sums are f32 and the
// output is cast to q's dtype at the end.  A lane with index -1 reads
// nothing and writes exactly 0.  Query head h uses KV head h / n_rep: the
// reference's caller repeats the codes n_rep times first; here the codes
// are read once for all n_rep heads of a block.  The codes are a pool
// (n_pages, page, Hkv, D) and position p of lane b lies in page
// table[b, p / page], row p % page; a dense (B, S, Hkv, D) cache is the
// pool of B pages of S rows with table[b] = b (table = nullptr), so both
// entries run this one kernel.  Positions past index[b] are never read,
// whatever the zero page or stale pages hold.  A cache whose sequence is
// split over ranks passes its block's first global position (``offset``):
// row r holds position offset + r, and the kernel can also write each
// row's m + log l (``lse``, -inf for a lane with no position in the block),
// so the blocks' partial softmaxes combine exactly.
//
// Bound.  Bytes: every code and scale of positions 0..index[b] is read once
// (2 D + 8 bytes per position and KV head), plus q, the output and the
// table.  The arithmetic is smaller: the scale factors out of q.k and p.v,
// q.k of a bf16 query with int8 codes is exact in bf16 (tensor-core rate),
// and only p.v (2 D flops per position and query head) needs f32.  So the
// function is bound by device memory (3.35 TB/s).
//
// Design.  A block of 4 warps per (lane, KV head, split of the capacity);
// each warp runs its own pipeline over 16 of every 64 positions, with no
// block barrier until the merge.
//   * Loads: a ring of 3 stages per warp in shared memory, filled by 16-byte
//     cp.async (8 lanes copy a 128-byte code row, so a copy instruction
//     moves whole rows; 4-byte copies for the scales, which are strided by
//     Hkv) while the warp computes an earlier stage.  Each lane looks up the
//     page of one position a stage ahead of its copy, so the table load
//     never waits in line; the rows' offsets pass to the copying lanes by
//     shuffles.  K rows have their 16-byte chunks swizzled by the row's
//     parity and V rows by bits 1-2 of the row, so both fragment loads
//     below hit 32 different banks (D = 128).
//   * q.k on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out): A =
//     the group's n_rep query rows padded to 16, built once per block into
//     shared memory in fragment order; B = the K codes of 8 positions,
//     converted int8 -> bf16 once per block (exact: 128 + the low 7 bits
//     minus 128 or 256, one bf16x2 subtraction per two codes), with the k
//     order inside an MMA permuted (the same permutation on A) so that a
//     thread's fragments for 4 k-steps are one 16-byte shared load.  A bf16
//     query is one term; an f32 query is split exactly into three bf16
//     terms (hi, mid, lo), three MMAs, whose products are exact in f32.  The
//     f32 logits are then multiplied by the position's scale and D^-0.5.
//   * Softmax per warp in the MMA's accumulator layout (a quad of lanes
//     holds a query row's 16 positions): two shuffles a max, the running
//     (m, l) per row.
//   * p.v on the tensor cores too: P' = p * scale_v stays in registers (the
//     score accumulators are the next MMA's A fragment) and is split exactly
//     into three bf16 terms by truncation, so the three MMAs carry its 24
//     bits (f32 accuracy, no rounding of p to bf16); B = the V codes of 16
//     positions, each word of a row holding one output column of 4 MMA
//     tiles.  The output accumulates in the MMAs' f32 registers.
//   * One launch: the 4 warps' (m, l, O) merge in shared memory; with one
//     split the block writes the output, else it writes its partial, and
//     the last block of the (lane, KV head) to take a ticket merges the
//     splits that hold positions and resets its ticket to 0, so the next
//     call (or graph replay) finds it clean.
// No fast math: expf and IEEE division keep the result within the plain
// version's tolerance.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int WROWS = 16;              // positions a warp takes per tile
constexpr int TILE = WARPS * WROWS;    // positions per tile (kvc_attention.py's TILE)
constexpr int STAGES = 3;              // stages of each warp's ring
constexpr int Q_TERMS = 3;             // bf16 terms of an f32 query or of P'
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;          // the reference's mask value

struct Args {
  const void* q;
  const int8_t* kc;
  const float* ks;
  const int8_t* vc;
  const float* vs;
  const int32_t* table;  // (B, max_pages); nullptr: page b of lane b
  const int32_t* index;  // (B,)
  void* out;
  float* part_m;
  float* part_l;
  float* part_acc;
  unsigned* tickets;     // (B * Hkv,), zero between calls
  float* lse;            // (B, H) m + log l of the positions read, or nullptr
  int B, H, Hkv, n_rep, page, max_pages, splits, chunk, q_bf16;
  int offset;            // the global position of the cache's row 0 (a sequence block)
  float scale;           // D ** -0.5, rounded to f32 on the host as the reference does
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

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// (x & m) | k in one LOP3: the compiler splits it in two when m and k are
// both immediates, and this runs four times per pair of codes.
__device__ __forceinline__ uint32_t and_or(uint32_t x, uint32_t m, uint32_t k) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(x), "r"(m), "r"(k));
  return d;
}

// Two int8 codes, bytes 0 and 2 of x, as an exact bf16 pair: 0x4300 | low 7
// bits is 128 + low7, and 0x4300 | the sign bit (bit 7) is 128 or 256.
__device__ __forceinline__ uint32_t pair_bf16(uint32_t x) {
  return bf16x2_sub(and_or(x, 0x007f007fu, 0x43004300u), and_or(x, 0x00800080u, 0x43004300u));
}

// A code word as the B fragment of one k-step: codes 0, 1 the first k pair
// and codes 2, 3 the second.
__device__ __forceinline__ void codes_bf16(uint32_t w, uint32_t (&b)[2]) {
  b[0] = pair_bf16(__byte_perm(w, 0u, 0x4140));
  b[1] = pair_bf16(__byte_perm(w, 0u, 0x4342));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a, const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]));
}

// Term t of the exact split of v into bf16 terms (t = 0: round to nearest;
// each next term rounds what is left, and the subtraction is exact).
__device__ __forceinline__ uint32_t q_term(float v, int t) {
  __nv_bfloat16 h = __float2bfloat16_rn(v);
  for (int i = 0; i < t; ++i) {
    v -= __bfloat162float(h);
    h = __float2bfloat16_rn(v);
  }
  return __bfloat16_as_ushort(h);
}

// The three bf16 terms of v by truncation, as f32 words whose upper halves
// are the terms: each is the top 8 significant bits of what is left, and
// the last is what is left of 24 (exact while what is left stays a normal
// f32: P' below 2^-100 loses its last bits, far under the f32 sum's).
__device__ __forceinline__ void trunc_terms(float v, uint32_t (&t)[Q_TERMS]) {
  const uint32_t t0 = __float_as_uint(v) & 0xffff0000u;
  const float r1 = v - __uint_as_float(t0);
  const uint32_t t1 = __float_as_uint(r1) & 0xffff0000u;
  t[0] = t0;
  t[1] = t1;
  t[2] = __float_as_uint(r1 - __uint_as_float(t1));
}

// bf16 pair (lo, hi) from the upper halves of two f32 words
__device__ __forceinline__ uint32_t pack_hi(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

template <int D>
struct Layout {
  static constexpr int CPR = D / 16;               // 16-byte chunks per code row
  static constexpr int KG = CPR < 4 ? CPR : 4;     // k-steps per B-fragment load
  static constexpr int GROUPS = CPR / KG;          // B-fragment loads per K row
  static constexpr int KSTEPS = D / 16;
  static constexpr int NT = D / 8;                 // output MMA tiles
  static constexpr int RPI = 32 / CPR;             // rows one copy instruction moves
  static constexpr int WSTAGE = 2 * WROWS * D + 2 * WROWS * 4;  // a warp's K, V codes and scales
  static constexpr int QF1 = KSTEPS * 32 * 16;     // A fragments of one term
  // physical 16-byte chunk of chunk c of K row r, and of V row r
  __device__ static int kchunk(int r, int c) { return CPR == 8 ? c ^ ((r & 1) << 2) : c; }
  __device__ static int vchunk(int r, int c) { return c ^ ((((r >> 1) & 3) << 1) & (CPR - 1)); }
  // logical byte of k-step s's word for quad lane t4 in B-fragment group gk
  __host__ __device__ static constexpr int dim(int gk, int t4, int s) {
    return gk * 16 * KG + t4 * 4 * KG + 4 * s;
  }
};

template <int D>
size_t smem_bytes(int terms) {
  return static_cast<size_t>(WARPS) * STAGES * Layout<D>::WSTAGE
         + static_cast<size_t>(terms) * Layout<D>::QF1;
}

// out[i .. i + 3] = O / den, rounded to q's dtype (to nearest even, as
// torch's .to(bf16)).
__device__ __forceinline__ void store_out4(const Args& a, size_t i, float4 O, float den) {
  const float4 v = make_float4(O.x / den, O.y / den, O.z / den, O.w / den);
  if (a.q_bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) + i;
    o[0] = __float2bfloat16_rn(v.x);
    o[1] = __float2bfloat16_rn(v.y);
    o[2] = __float2bfloat16_rn(v.z);
    o[3] = __float2bfloat16_rn(v.w);
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(a.out) + i) = v;
  }
}

// m + log l of a row's merged (max, sum): -inf where no position was read
__device__ __forceinline__ float block_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : -INFINITY;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 4)
kvc_attention_kernel(const Args a) {
  using L = Layout<D>;
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  static_assert(WARPS * WROWS * (D + 3) * 4 + 2 * WROWS * 4 <= WARPS * STAGES * L::WSTAGE,
                "merge scratch fits the rings");
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* qf = reinterpret_cast<uint4*>(smem + WARPS * STAGES * L::WSTAGE);

  const int bg = blockIdx.x, b = bg / a.Hkv, g = bg - b * a.Hkv, split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, t4 = lane & 3;
  // local rows 0 .. len - 1 hold global positions offset .. index[b]
  const int len = min(__ldg(a.index + b) + 1 - a.offset, a.page * a.max_pages);  // <= 0: none
  const int begin = split * a.chunk;
  const int end = min(begin + a.chunk, len);
  const int tiles = end > begin ? (end - begin + TILE - 1) / TILE : 0;
  const int n_terms = a.q_bf16 ? 1 : Q_TERMS;

  // This warp's ring: stage s holds K rows, V rows, K scales, V scales of
  // its 16 positions of a tile.
  unsigned char* ring = smem + warp * STAGES * L::WSTAGE;
  auto kst = [&](int st) { return ring + st * L::WSTAGE; };
  auto vst = [&](int st) { return ring + st * L::WSTAGE + WROWS * D; };
  auto kss = [&](int st) { return reinterpret_cast<float*>(ring + st * L::WSTAGE + 2 * WROWS * D); };
  auto vss = [&](int st) { return kss(st) + WROWS; };

  // Row of the pool (page row * Hkv + g) of this lane's position lane / 2 of
  // tile t, or -1 past the split's live positions.  The table load does not
  // wait for ``end`` (the lane's index): its slot is clamped into the table.
  auto row_of = [&](int t) -> int {
    const int pos = begin + t * TILE + warp * WROWS + (lane >> 1);
    const int slot = min(pos / a.page, a.max_pages - 1);
    const int pid = a.table ? __ldg(a.table + static_cast<size_t>(b) * a.max_pages + slot) : b;
    return pos < end ? (pid * a.page + (pos - slot * a.page)) * a.Hkv + g : -1;
  };
  // Stage tile t, whose rows ``row`` holds (lane 2j: row j): 8 lanes a code
  // row, each lane its own row's K or V scale.
  auto load = [&](int t, int row) {
    const int st = t % STAGES;
#pragma unroll
    for (int k = 0; k < (L::CPR + 1) / 2; ++k) {
      const int j = k * L::RPI + lane / L::CPR, c = lane % L::CPR;
      const int rr = __shfl_sync(FULL, row, (2 * j) & 31);
      if (j < WROWS && rr >= 0) {
        const size_t off = static_cast<size_t>(rr) * D + 16 * c;
        cp_async16(kst(st) + j * D + 16 * L::kchunk(j, c), a.kc + off);
        cp_async16(vst(st) + j * D + 16 * L::vchunk(j, c), a.vc + off);
      }
    }
    if (row >= 0) {
      if (lane & 1) cp_async4(vss(st) + (lane >> 1), a.vs + row);
      else cp_async4(kss(st) + (lane >> 1), a.ks + row);
    }
    cp_async_commit();
  };

  // The prologue's global loads all go out together: the query values of
  // this thread's A fragments (row r = query head g * n_rep + r, zero past
  // n_rep), the first stages' pages, and the lane's index.
  constexpr int QE = (L::KSTEPS * 32 + THREADS - 1) / THREADS;
  const size_t qrow = (static_cast<size_t>(b) * a.H + static_cast<size_t>(g) * a.n_rep) * D;
  float qv[QE][8];
#pragma unroll
  for (int k = 0; k < QE; ++k) {
    const int e = tid + k * THREADS, ks = e / 32, ln = e % 32;
    const int d0 = L::dim(ks / L::KG, ln & 3, ks % L::KG);
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // rows gid, gid + 8; dims d0, d0 + 1, then d0 + 2, d0 + 3
      const int r = (ln >> 2) + 8 * ((j >> 1) & 1), d = d0 + 2 * (j >> 2) + (j & 1);
      const size_t i = qrow + static_cast<size_t>(r) * D + d;
      qv[k][j] = e >= L::KSTEPS * 32 || r >= a.n_rep ? 0.f
                 : a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[i])
                            : static_cast<const float*>(a.q)[i];
    }
  }
  int first[STAGES];
#pragma unroll
  for (int t = 0; t < STAGES; ++t) first[t] = row_of(t);
  int next_row = first[STAGES - 1];
  if (tiles) {
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < tiles) load(t, first[t]);
      else cp_async_commit();
    }
#pragma unroll
    for (int k = 0; k < QE; ++k) {
      const int e = tid + k * THREADS;
      if (e >= L::KSTEPS * 32) break;
      for (int term = 0; term < n_terms; ++term) {
        uint32_t reg[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          reg[j] = q_term(qv[k][2 * j], term) | (q_term(qv[k][2 * j + 1], term) << 16);
        qf[term * L::KSTEPS * 32 + e] = make_uint4(reg[0], reg[1], reg[2], reg[3]);
      }
    }
  }
  __syncthreads();  // the A fragments are complete

  // Per warp: the running max and this lane's share of the sum for query
  // rows gid and gid + 8, and the output tiles in MMA accumulator layout.
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[L::NT][4];
#pragma unroll
  for (int n = 0; n < L::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();  // every lane's copies of stage t are visible to the warp
    const int row = next_row;
    if (t + STAGES - 1 < tiles) {
      load(t + STAGES - 1, row);
      next_row = row_of(t + STAGES);  // a stage ahead: the table load waits for nothing
    } else {
      cp_async_commit();
    }

    const int st = t % STAGES;
    const int p0 = begin + t * TILE + warp * WROWS;  // this warp's first position
    if (p0 >= end) continue;                         // warp-uniform

    // scores: rows x positions p0 .. p0 + 15 as two n8 tiles
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const uint8_t* kt = kst(st);
#pragma unroll
    for (int gk = 0; gk < L::GROUPS; ++gk) {
      uint32_t w[2][L::KG];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int r = nt * 8 + gid;
        const int d = L::dim(gk, t4, 0);
        const uint8_t* src = kt + r * D + 16 * L::kchunk(r, d >> 4) + (d & 15);
        if constexpr (L::KG == 4) {
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          w[nt][0] = v.x; w[nt][1] = v.y; w[nt][2] = v.z; w[nt][3] = v.w;
        } else if constexpr (L::KG == 2) {
          const uint2 v = *reinterpret_cast<const uint2*>(src);
          w[nt][0] = v.x; w[nt][1] = v.y;
        } else {
          w[nt][0] = *reinterpret_cast<const uint32_t*>(src);
        }
      }
#pragma unroll
      for (int s = 0; s < L::KG; ++s) {
        uint32_t bf[2][2];
        codes_bf16(w[0][s], bf[0]);
        codes_bf16(w[1][s], bf[1]);
        for (int term = 0; term < n_terms; ++term) {
          const uint4 af = qf[(term * L::KSTEPS + gk * L::KG + s) * 32 + lane];
          mma_bf16(c[0], af, bf[0]);
          mma_bf16(c[1], af, bf[1]);
        }
      }
    }

    // online softmax for rows gid (hh = 0) and gid + 8 (hh = 1); P' = p *
    // scale_v in c's place (0 past the live positions: a stale scale never
    // enters)
    const float* ksc = kss(st);
    const float* vsc = vss(st);
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lg[4];
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // positions 8 (i / 2) + 2 t4 + (i % 2)
        const int j = 8 * (i >> 1) + 2 * t4 + (i & 1);
        lg[i] = p0 + j < end ? c[i >> 1][2 * hh + (i & 1)] * ksc[j] * a.scale : NEG;
        mx = fmaxf(mx, lg[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float mn = fmaxf(m[hh], mx);
      alpha[hh] = expf(m[hh] - mn);
      m[hh] = mn;
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 8 * (i >> 1) + 2 * t4 + (i & 1);
        const bool live = p0 + j < end;
        const float p = live ? expf(lg[i] - mn) : 0.f;
        ps += p;
        c[i >> 1][2 * hh + (i & 1)] = live ? p * vsc[j] : 0.f;
      }
      l[hh] = l[hh] * alpha[hh] + ps;
    }
    if (!__all_sync(FULL, alpha[0] == 1.f && alpha[1] == 1.f)) {  // a running max moved
#pragma unroll
      for (int n = 0; n < L::NT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // P' as three exact bf16 terms of the A fragment: k = the warp's 16
    // positions in order (c[0]: 2 t4, 2 t4 + 1; c[1]: 8 + 2 t4, 9 + 2 t4)
    uint4 pa[Q_TERMS];
    {
      uint32_t tm[2][4][Q_TERMS];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) trunc_terms(c[nt][e], tm[nt][e]);
#pragma unroll
      for (int k = 0; k < Q_TERMS; ++k)
        pa[k] = make_uint4(pack_hi(tm[0][0][k], tm[0][1][k]), pack_hi(tm[0][2][k], tm[0][3][k]),
                           pack_hi(tm[1][0][k], tm[1][1][k]), pack_hi(tm[1][2][k], tm[1][3][k]));
    }

    // p.v: B = V rows 2 t4, 2 t4 + 1 (first k pair) and 8 + 2 t4, 9 + 2 t4
    const uint8_t* vt = vst(st);
    const int vr[4] = {2 * t4, 2 * t4 + 1, 8 + 2 * t4, 9 + 2 * t4};
    if constexpr (D >= 32) {
      // tile n = 4 grp + sub, column gid <-> dim 32 grp + 4 gid + sub: one
      // code word per row feeds 4 tiles
#pragma unroll
      for (int grp = 0; grp < D / 32; ++grp) {
        const int cw = 2 * grp + (gid >> 2);  // the word's logical chunk
        uint32_t wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[i] = *reinterpret_cast<const uint32_t*>(vt + vr[i] * D + 16 * L::vchunk(vr[i], cw)
                                                     + 4 * (gid & 3));
#pragma unroll
        for (int sub = 0; sub < 4; ++sub) {
          // k pair h: code sub of rows vr[2h] and vr[2h + 1], to bytes 0 and 2
          const uint32_t bb[2] = {pair_bf16(__byte_perm(wv[0], wv[1], 0x0400 + 0x0101 * sub)),
                                  pair_bf16(__byte_perm(wv[2], wv[3], 0x0400 + 0x0101 * sub))};
#pragma unroll
          for (int k = 0; k < Q_TERMS; ++k) mma_bf16(o[4 * grp + sub], pa[k], bb);
        }
      }
    } else {
      // D = 16: tile n, column gid <-> dim 8 n + gid, one byte per row
#pragma unroll
      for (int n = 0; n < L::NT; ++n) {
        uint32_t by[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) by[i] = vt[vr[i] * D + 16 * L::vchunk(vr[i], 0) + 8 * n + gid];
        const uint32_t bb[2] = {pair_bf16(by[0] | (by[1] << 16)),
                                pair_bf16(by[2] | (by[3] << 16))};
#pragma unroll
        for (int k = 0; k < Q_TERMS; ++k) mma_bf16(o[n], pa[k], bb);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: they hold the merge scratch from here

  // The block's 4 warps merged in shared memory: each warp's (m, l) per
  // row and its output rows.
  float* sm_m = reinterpret_cast<float*>(smem);  // [WARPS][16]
  float* sm_l = sm_m + WARPS * WROWS;            // [WARPS][16]
  float* sm_o = sm_l + WARPS * WROWS;            // [WARPS][16][D]
  float* sm_wt = sm_o + WARPS * WROWS * D;       // [WARPS][16]
  float* sm_ml = sm_wt + WARPS * WROWS;          // [2][16]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(FULL, l[hh], 1);
    l[hh] += __shfl_xor_sync(FULL, l[hh], 2);
    const int r = gid + 8 * hh;
    if (t4 == 0) {
      sm_m[warp * WROWS + r] = m[hh];
      sm_l[warp * WROWS + r] = l[hh];
    }
    float* orow = sm_o + (warp * WROWS + r) * D;
    if constexpr (D >= 32) {  // tile 4 grp + sub, column 2 t4 + e <-> dim 32 grp + 8 t4 + 4 e + sub
#pragma unroll
      for (int grp = 0; grp < D / 32; ++grp)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float4*>(orow + 32 * grp + 8 * t4 + 4 * e) =
              make_float4(o[4 * grp][2 * hh + e], o[4 * grp + 1][2 * hh + e],
                          o[4 * grp + 2][2 * hh + e], o[4 * grp + 3][2 * hh + e]);
    } else {  // tile n, column 2 t4 + e <-> dim 8 n + 2 t4 + e
#pragma unroll
      for (int n = 0; n < L::NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) orow[8 * n + 2 * t4 + e] = o[n][2 * hh + e];
    }
  }
  __syncthreads();
  if (tid < a.n_rep) {  // per row: the warps' weights and the block's (M, L)
    float M = NEG, Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w * WROWS + tid]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(sm_m[w * WROWS + tid] - M);
      sm_wt[w * WROWS + tid] = wt;
      Lsum = fmaf(wt, sm_l[w * WROWS + tid], Lsum);
    }
    sm_ml[tid] = M;
    sm_ml[WROWS + tid] = Lsum;
  }
  __syncthreads();

  constexpr int D4 = D / 4;
  const size_t head0 = static_cast<size_t>(b) * a.H + static_cast<size_t>(g) * a.n_rep;
  if (a.splits == 1 || tiles) {
    for (int i = tid; i < a.n_rep * D4; i += THREADS) {
      const int h = i / D4, d4 = i - h * D4;
      float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float wt = sm_wt[w * WROWS + h];
        const float4 v = reinterpret_cast<const float4*>(sm_o + (w * WROWS + h) * D)[d4];
        O = make_float4(fmaf(wt, v.x, O.x), fmaf(wt, v.y, O.y), fmaf(wt, v.z, O.z),
                        fmaf(wt, v.w, O.w));
      }
      if (a.splits == 1) {
        store_out4(a, (head0 + h) * D + 4 * d4, O, fmaxf(sm_ml[WROWS + h], 1e-30f));
        if (a.lse && d4 == 0) a.lse[head0 + h] = block_lse(sm_ml[h], sm_ml[WROWS + h]);
      } else {
        const size_t pi = (head0 + h) * a.splits + split;
        reinterpret_cast<float4*>(a.part_acc + pi * D)[d4] = O;
        if (d4 == 0) {
          a.part_m[pi] = sm_ml[h];
          a.part_l[pi] = sm_ml[WROWS + h];
        }
      }
    }
  }
  if (a.splits == 1) return;

  // The last block of (b, g) to finish merges the splits that hold
  // positions; an empty split wrote nothing and weighs nothing.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(a.tickets + bg, 1u) == static_cast<unsigned>(a.splits - 1);
    if (last) atomicExch(a.tickets + bg, 0u);  // clean for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int used = len > 0 ? min(a.splits, (len + a.chunk - 1) / a.chunk) : 0;
  // Each row's max and sum over the splits, a warp per row, a lane per
  // split of each 32, so that their (m, l) loads go out at once.
  for (int h = warp; h < a.n_rep; h += WARPS) {
    const size_t p0 = (head0 + h) * a.splits;
    float M = NEG, Lsum = 0.f;
    for (int s0 = 0; s0 < used; s0 += 32) {
      const bool in = s0 + lane < used;
      const float ms = in ? __ldcg(a.part_m + p0 + s0 + lane) : NEG;
      const float ls = in ? __ldcg(a.part_l + p0 + s0 + lane) : 0.f;
      const float mn = fmaxf(M, warp_max(ms));
      Lsum = Lsum * expf(M - mn) + warp_sum(ls * expf(ms - mn));
      M = mn;
    }
    if (lane == 0) {
      sm_ml[h] = M;
      sm_ml[WROWS + h] = Lsum;
      if (a.lse) a.lse[head0 + h] = block_lse(M, Lsum);
    }
  }
  __syncthreads();
  // Each output (row, 4 dims) summed over the splits: a thread keeps the
  // same 4 dims of every RG-th row, and no split's loads wait on the sums.
  constexpr int RG = THREADS / D4, RPT = (WROWS + RG - 1) / RG;
  const int d4 = tid % D4, h0 = tid / D4;
  float4 O[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) O[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int sp = 0; sp < used; ++sp) {
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int h = h0 + k * RG;
      if (h < a.n_rep) {
        const size_t pi = (head0 + h) * a.splits + sp;
        const float wt = expf(__ldcg(a.part_m + pi) - sm_ml[h]);
        const float4 v = __ldcg(reinterpret_cast<const float4*>(a.part_acc + pi * D) + d4);
        O[k] = make_float4(fmaf(wt, v.x, O[k].x), fmaf(wt, v.y, O[k].y), fmaf(wt, v.z, O[k].z),
                           fmaf(wt, v.w, O[k].w));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int h = h0 + k * RG;
    if (h < a.n_rep) store_out4(a, (head0 + h) * D + 4 * d4, O[k], fmaxf(sm_ml[WROWS + h], 1e-30f));
  }
}

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(a.q_bf16 ? 1 : Q_TERMS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kvc_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.B * a.Hkv, a.splits);
  kvc_attention_kernel<D><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (B, H, D) f32 (q_bf16 = 0) or bf16 (1); kc, vc: int8 (n_pages, page,
// Hkv, D); ks, vs: f32 (n_pages, page, Hkv); table: int32 (B, max_pages)
// page ids below n_pages, or nullptr for a dense (B, S, Hkv, D) cache
// (page = S, max_pages = 1); index: int32 (B,); out: (B, H, D) in q's
// dtype.  ``offset``: the global position of row 0 (a block of a cache
// whose sequence is split; 0 for a whole cache): lane b reads rows whose
// position offset + row is at most index[b].  ``lse``: nullptr, or (B, H)
// f32 written with m + log l of the rows read (-inf where none).  With splits > 1, part_m and part_l hold B*H*splits floats,
// part_acc B*H*splits*D, and tickets B*Hkv zeros (left zero).  Needs H =
// n_rep * Hkv, n_rep <= 16, D in {16, 32, 64, 128}, chunk % 64 == 0, fewer
// than 2^31 pool rows (n_pages * page * Hkv) and 16-byte aligned codes; the
// wrapper checks all of it.  Launches on ``stream`` and returns
// cudaGetLastError().
extern "C" int kvc_attention(const void* q, int q_bf16, const int8_t* kc, const float* ks,
                             const int8_t* vc, const float* vs, const int32_t* table,
                             const int32_t* index, void* out, float* part_m, float* part_l,
                             float* part_acc, unsigned* tickets, float* lse, int B, int H,
                             int Hkv, int D, int page, int max_pages, int splits, int chunk,
                             int offset, float scale, cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  const Args a{q, kc, ks, vc, vs, table, index, out, part_m, part_l, part_acc, tickets, lse,
               B, H, Hkv, H / Hkv, page, max_pages, splits, chunk, q_bf16, offset, scale};
  switch (D) {
    case 16: return launch<16>(a, stream);
    case 32: return launch<32>(a, stream);
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

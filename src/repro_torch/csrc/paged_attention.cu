// Single-token paged-attention decode for Hopper (sm_90a), over fp pages or
// binary-coded pages.
//
// Replaces the reference's Pallas TPU kernels
// src/repro/kernels/paged_attention.py: `paged_attention` (body `_kernel`,
// page fold `_fold`) and `paged_attention_quant` (body `_kernel_quant`,
// page expansion `_expand_page`). For each sequence b and KV head h both
// compute
//     out[b, h, r] = softmax_j(q[b, h, r] . k_j * hd^-0.5) @ v_j
// over the sequence's tokens j < ctx_lens[b], whose K/V live in a shared
// page pool at page block_tables[b, j / page], offset j % page. Optional
// tanh logit cap (cap * tanh(x / cap)) and sliding window
// ((ctx - 1 - j) < window), fp32 logits and softmax, output in q's dtype,
// l clamped at 1e-30 like the reference.
//
// Pools. fp: k/v (P, page, Hkv, hd) in q's dtype. Binary-coded (the
// reference's quant/kv.py layout): codes (P, page, Hkv, bits, hd/32) 32-bit
// sign words packed along hd (bit j of word w is entry w*32 + j, a 1 bit is
// +1), alphas (P, page, Hkv, G, bits) fp32, betas (P, page, Hkv, G) fp32;
// entry d of group g = d / (hd / G) expands to beta_g + sum_i (+-alpha_gi),
// added in plane order as `_expand_page` does.
//
// What bounds it on the H100: bandwidth. Each live token's K and V vector
// is read once (2 * hd values, or 2 * (bits * hd / 8 + 4 * G * (bits + 1))
// bytes binary-coded); the arithmetic is ~4 * rep * hd flops per token.
// The design:
// * One block per (KV head, sequence, group of up to kRepBlock query
//   heads); the block reads its own block-table row (the TPU kernel
//   received it by scalar prefetch).
// * The block's warps take interleaved tokens; a warp reads one token's K
//   and V vector as 32 lanes x hd/32 contiguous entries and keeps its own
//   online-softmax state (running max, denominator, accumulator) for the
//   block's query heads, so K/V is read once per GQA group. The warps'
//   states are merged in shared memory at the end.
// * Binary-coded pages: a lane loads the `bits` code words that cover its
//   hd/32 entries (they never straddle a word: hd/32 divides 32) and the
//   alphas and betas of the groups those entries fall in, and expands them
//   to fp32 in registers; nothing is expanded into device memory.
// * Query heads per block: REP (a template bucket 1/2/4/8/16) keeps the
//   state in registers, with REP * hd/32 <= 64 accumulators a lane; wider
//   GQA groups (Qwen3-MoE's 16 query heads per KV head at hd 128 fit one
//   block) spread over gridDim.z blocks, each reading the group's K/V.
// * Tokens are visited by index, j in [max(0, ctx - window), min(ctx,
//   T * page)), so pages at or past ctx are never touched and masked tokens
//   (which the reference weights by exp(-1e30 - m) = 0) are skipped. A
//   table may name the same page many times (inactive rows all point at
//   the null page 0); nothing assumes distinct pages.
// Later PRs: vector loads, splitting long contexts over blocks, bf16 K/V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxRegs = 64;  // REP * EPL accumulators a lane at most
constexpr int kMaxBits = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// fp pages: a lane's EPL entries of the (token, head) row `row`.
template <typename T, int EPL>
struct FpPages {
  const T* k;
  const T* v;
  __device__ __forceinline__ void load(long long row, int lane,
                                       float (&kv)[EPL],
                                       float (&vv)[EPL]) const {
    const long long base = row * (EPL * 32) + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kv[e] = to_f32(k[base + e]);
      vv[e] = to_f32(v[base + e]);
    }
  }
};

// Binary-coded pages: expand a lane's EPL entries of row `row` in registers.
template <int EPL>
struct QuantPages {
  const uint32_t *kc, *vc;
  const float *ka, *kb, *va, *vb;
  int bits, G;

  __device__ __forceinline__ void expand(const uint32_t* codes,
                                         const float* alphas,
                                         const float* betas, long long row,
                                         int lane, float (&out)[EPL]) const {
    const int first = lane * EPL;         // first entry of the lane
    const int shift = first & 31;         // its bit in the word
    const int gs = (EPL * 32) / G;        // entries per scale group
    const uint32_t* cw = codes + row * bits * EPL + (first >> 5);
    uint32_t w[kMaxBits];
#pragma unroll
    for (int i = 0; i < kMaxBits; ++i) w[i] = i < bits ? cw[i * EPL] : 0u;
    float a[kMaxBits];
    float beta = 0.f;
    int g_loaded = -1;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int g = (first + e) / gs;
      if (g != g_loaded) {
        const float* ag = alphas + (row * G + g) * bits;
#pragma unroll
        for (int i = 0; i < kMaxBits; ++i) a[i] = i < bits ? ag[i] : 0.f;
        beta = betas[row * G + g];
        g_loaded = g;
      }
      float x = beta;
#pragma unroll
      for (int i = 0; i < kMaxBits; ++i)
        if (i < bits) x += ((w[i] >> (shift + e)) & 1u) ? a[i] : -a[i];
      out[e] = x;
    }
  }

  __device__ __forceinline__ void load(long long row, int lane,
                                       float (&kv)[EPL],
                                       float (&vv)[EPL]) const {
    expand(kc, ka, kb, row, lane, kv);
    expand(vc, va, vb, row, lane, vv);
  }
};

// EPL = hd / 32 entries per lane; REP query heads per block (>= the
// block's share, gridDim.z blocks per (head, sequence)).
template <typename TQ, typename Pages, int EPL, int REP>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_kernel(const TQ* __restrict__ q, Pages pages,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ ctx_lens,
                           TQ* __restrict__ out, int Hkv, int rep, int page,
                           int n_table, float scale, int window, float cap) {
  constexpr int HD = EPL * 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * REP;        // first query head of the block
  const int nrep = min(REP, rep - r0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int ctx_raw = ctx_lens[b];
  const int ctx = min(ctx_raw, n_table * page);
  const int j0 = window > 0 ? max(0, ctx_raw - window) : 0;
  const int* bt = block_tables + (long long)b * n_table;
  const long long qo = ((long long)b * Hkv + h) * rep + r0;  // first q row

  float qr[REP][EPL];
  float m_run[REP], l_run[REP], acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[r][e] = 0.f;
      qr[r][e] = r < nrep ? to_f32(q[(qo + r) * HD + lane * EPL + e]) : 0.f;
    }
  }

  for (int j = j0 + warp; j < ctx; j += kWarps) {
    const long long pid = bt[j / page];
    float kv[EPL], vv[EPL];
    pages.load((pid * page + (j % page)) * Hkv + h, lane, kv, vv);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= nrep) break;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(qr[r][e], kv[e], d);
      float s = warp_sum(d) * scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      const float m_new = fmaxf(m_run[r], s);
      const float corr = expf(m_run[r] - m_new);
      const float p = expf(s - m_new);
      l_run[r] = l_run[r] * corr + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(acc[r][e], corr, p * vv[e]);
      m_run[r] = m_new;
    }
  }

  // merge the warps' states, one query head at a time
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][HD];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r >= nrep) break;
    if (lane == 0) {
      sm_m[warp] = m_run[r];
      sm_l[warp] = l_run[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][lane * EPL + e] = acc[r][e];
    __syncthreads();
    for (int d = threadIdx.x; d < HD; d += blockDim.x) {
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
      float l = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(sm_m[w] - mx);
        l += sm_l[w] * f;
        o += sm_acc[w][d] * f;
      }
      out[(qo + r) * HD + d] = from_f32<TQ>(o / fmaxf(l, 1e-30f));
    }
    __syncthreads();
  }
}

// Query heads per block: the smallest bucket that holds `rep`, capped so a
// lane keeps at most kMaxRegs accumulators.
int rep_bucket(int rep, int epl) {
  int r = 1;
  while (r < rep && r < 16 && (2 * r) * epl <= kMaxRegs) r *= 2;
  return r;
}

struct Geometry {
  int B, Hkv, rep, page, n_table, window;
  float scale, cap;
};

template <typename TQ, typename Pages, int EPL>
void launch_epl(const TQ* q, const Pages& pages, const int* bt,
                const int* ctx, TQ* out, const Geometry& g, cudaStream_t st) {
  const int rb = rep_bucket(g.rep, EPL);
  const dim3 grid(g.Hkv, g.B, (g.rep + rb - 1) / rb), block(kWarps * 32);
#define PA_LAUNCH(R)                                                        \
  paged_attention_kernel<TQ, Pages, EPL, R><<<grid, block, 0, st>>>(       \
      q, pages, bt, ctx, out, g.Hkv, g.rep, g.page, g.n_table, g.scale,    \
      g.window, g.cap)
  switch (rb) {
    case 1: PA_LAUNCH(1); break;
    case 2: PA_LAUNCH(2); break;
    case 4: PA_LAUNCH(4); break;
    case 8: if constexpr (8 * EPL <= kMaxRegs) PA_LAUNCH(8); break;
    default: if constexpr (16 * EPL <= kMaxRegs) PA_LAUNCH(16); break;
  }
#undef PA_LAUNCH
}

// hd -> EPL; `make(epl tag)` builds the page reader for that EPL.
template <typename TQ, template <int> class MakePages, typename... A>
void launch_hd(int hd, const void* q, const int* bt, const int* ctx,
               void* out, const Geometry& g, cudaStream_t st, A... args) {
  const TQ* qt = static_cast<const TQ*>(q);
  TQ* ot = static_cast<TQ*>(out);
  switch (hd) {
    case 32: launch_epl<TQ, typename MakePages<1>::type, 1>(qt, MakePages<1>::make(args...), bt, ctx, ot, g, st); break;
    case 64: launch_epl<TQ, typename MakePages<2>::type, 2>(qt, MakePages<2>::make(args...), bt, ctx, ot, g, st); break;
    case 128: launch_epl<TQ, typename MakePages<4>::type, 4>(qt, MakePages<4>::make(args...), bt, ctx, ot, g, st); break;
    case 256: launch_epl<TQ, typename MakePages<8>::type, 8>(qt, MakePages<8>::make(args...), bt, ctx, ot, g, st); break;
  }
}

template <typename T>
struct MakeFp {
  template <int EPL>
  struct at {
    using type = FpPages<T, EPL>;
    static type make(const void* k, const void* v) {
      return type{static_cast<const T*>(k), static_cast<const T*>(v)};
    }
  };
};

template <int EPL>
struct MakeQuant {
  using type = QuantPages<EPL>;
  static type make(const void* kc, const void* ka, const void* kb,
                   const void* vc, const void* va, const void* vb, int bits,
                   int G) {
    return type{static_cast<const uint32_t*>(kc),
                static_cast<const uint32_t*>(vc),
                static_cast<const float*>(ka), static_cast<const float*>(kb),
                static_cast<const float*>(va), static_cast<const float*>(vb),
                bits, G};
  }
};

}  // namespace

// Plain C entry points (loaded with ctypes); the Python wrappers check
// shapes, dtypes, hd in {32, 64, 128, 256} and (binary-coded) bits <= 8
// and G dividing hd. window <= 0 and cap <= 0 mean "none". Each returns
// cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* ctx_lens, void* out, int B,
                                      int Hkv, int rep, int hd, int page,
                                      int n_table, float scale, int window,
                                      float cap, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(ctx_lens);
  const Geometry g{B, Hkv, rep, page, n_table, window, scale, cap};
  if (bf16)
    launch_hd<__nv_bfloat16, MakeFp<__nv_bfloat16>::at>(
        hd, q, bt, cl, out, g, st, k_pages, v_pages);
  else
    launch_hd<float, MakeFp<float>::at>(hd, q, bt, cl, out, g, st, k_pages,
                                        v_pages);
  return (int)cudaGetLastError();
}

extern "C" int paged_attention_quant_launch(
    const void* q, const void* k_codes, const void* k_alphas,
    const void* k_betas, const void* v_codes, const void* v_alphas,
    const void* v_betas, const void* block_tables, const void* ctx_lens,
    void* out, int B, int Hkv, int rep, int hd, int page, int n_table,
    int bits, int G, float scale, int window, float cap, int bf16,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(ctx_lens);
  const Geometry g{B, Hkv, rep, page, n_table, window, scale, cap};
  if (bf16)
    launch_hd<__nv_bfloat16, MakeQuant>(hd, q, bt, cl, out, g, st, k_codes,
                                        k_alphas, k_betas, v_codes, v_alphas,
                                        v_betas, bits, G);
  else
    launch_hd<float, MakeQuant>(hd, q, bt, cl, out, g, st, k_codes, k_alphas,
                                k_betas, v_codes, v_alphas, v_betas, bits, G);
  return (int)cudaGetLastError();
}

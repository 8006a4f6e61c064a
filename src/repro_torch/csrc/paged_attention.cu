// Single-token paged-attention decode for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/paged_attention.py (`paged_attention`: body `_kernel`,
// page fold `_fold`). For each sequence b and KV head h it computes
//     out[b, h, r] = softmax_j(q[b, h, r] . k_j * hd^-0.5) @ v_j
// over the sequence's tokens j < ctx_lens[b], whose K/V live in a shared
// page pool (P, page, Hkv, hd) at page block_tables[b, j / page], offset
// j % page. Optional tanh logit cap (cap * tanh(x / cap)) and sliding
// window ((ctx - 1 - j) < window), fp32 logits and softmax, output in q's
// dtype, l clamped at 1e-30 like the reference.
//
// What bounds it on the H100: bandwidth. Each live token's K and V vector
// (2 * hd values per KV head) is read once; the arithmetic is ~4 * rep * hd
// flops per token. The design:
// * One block per (KV head, sequence); the block reads its own block-table
//   row (the TPU kernel received it by scalar prefetch).
// * The block's warps take interleaved tokens; a warp reads one token's K
//   and V vector as 32 lanes x hd/32 contiguous values and keeps its own
//   online-softmax state (running max, denominator, accumulator) for all
//   rep query heads of the KV head, so K/V is read once per GQA group.
//   The warps' states are merged in shared memory at the end.
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
constexpr int kMaxRep = 8;
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

// EPL = hd / 32 values per lane.
template <typename T, int EPL>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ ctx_lens,
                           T* __restrict__ out, int Hkv, int rep, int page,
                           int n_table, float scale, int window, float cap) {
  constexpr int HD = EPL * 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int ctx_raw = ctx_lens[b];
  const int ctx = min(ctx_raw, n_table * page);
  const int j0 = window > 0 ? max(0, ctx_raw - window) : 0;
  const int* bt = block_tables + (long long)b * n_table;

  float qr[kMaxRep][EPL];
  float m_run[kMaxRep], l_run[kMaxRep], acc[kMaxRep][EPL];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[r][e] = 0.f;
      qr[r][e] = r < rep ? to_f32(q[(((long long)b * Hkv + h) * rep + r) * HD +
                                    lane * EPL + e])
                         : 0.f;
    }
  }

  for (int j = j0 + warp; j < ctx; j += kWarps) {
    const long long pid = bt[j / page];
    const long long base =
        ((pid * page + (j % page)) * Hkv + h) * HD + lane * EPL;
    float kv[EPL], vv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kv[e] = to_f32(k_pages[base + e]);
      vv[e] = to_f32(v_pages[base + e]);
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) break;
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
  for (int r = 0; r < rep; ++r) {
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
      out[(((long long)b * Hkv + h) * rep + r) * HD + d] =
          from_f32<T>(o / fmaxf(l, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T>
void launch(const void* q, const void* kp, const void* vp, const int* bt,
            const int* ctx, void* out, int B, int Hkv, int rep, int hd,
            int page, int n_table, float scale, int window, float cap,
            cudaStream_t st) {
  const dim3 grid(Hkv, B), block(kWarps * 32);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(kp);
  const T* vt = static_cast<const T*>(vp);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 32:
      paged_attention_kernel<T, 1><<<grid, block, 0, st>>>(qt, kt, vt, bt, ctx, ot, Hkv, rep, page, n_table, scale, window, cap);
      break;
    case 64:
      paged_attention_kernel<T, 2><<<grid, block, 0, st>>>(qt, kt, vt, bt, ctx, ot, Hkv, rep, page, n_table, scale, window, cap);
      break;
    case 128:
      paged_attention_kernel<T, 4><<<grid, block, 0, st>>>(qt, kt, vt, bt, ctx, ot, Hkv, rep, page, n_table, scale, window, cap);
      break;
    case 256:
      paged_attention_kernel<T, 8><<<grid, block, 0, st>>>(qt, kt, vt, bt, ctx, ot, Hkv, rep, page, n_table, scale, window, cap);
      break;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes); the Python wrapper checks
// shapes, dtypes and hd in {32, 64, 128, 256}, rep <= 8. window <= 0 and
// cap <= 0 mean "none". Returns cudaGetLastError().
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
  if (bf16)
    launch<__nv_bfloat16>(q, k_pages, v_pages, bt, cl, out, B, Hkv, rep, hd,
                          page, n_table, scale, window, cap, st);
  else
    launch<float>(q, k_pages, v_pages, bt, cl, out, B, Hkv, rep, hd, page,
                  n_table, scale, window, cap, st);
  return (int)cudaGetLastError();
}

// Dequant-fused binary-coded (BCQ) GEMV and GEMM for Hopper (sm_90a), for one
// weight matrix or a stack of experts.
//
// Replaces the reference's Pallas TPU kernels src/repro/kernels/bcq_matmul.py
// (`bcq_matmul`: body `_kernel`, tile expansion `_expand_w`; `bcq_gemv`,
// the same kernel with an 8-row tile; `bcq_expert_matmul`: body
// `_expert_kernel`, the same GEMM batched over an expert stack). All compute
//     y = x @ W,  W[k, n] = sum_i alphas[g(k), n, i] * s_i[k, n] + betas[g(k), n]
// with g(k) = k / gs, the sign planes s_i packed 32 per 32-bit word along K
// (bit j of word w is K index w*32 + j, a 1 bit is +1), fp32 accumulation,
// scales fp32 or bf16 expanded in fp32, and W rounded to x's dtype before
// the product, as the reference rounds its expanded tile before the dot.
//
// What bounds them on the H100, and what the design does about it:
//
// * GEMV (M <= 8 rows, every decode step). Bandwidth: the packed codes are
//   bits/8 bytes per weight and are read exactly once; x and y are tiny.
//   A warp owns 32 adjacent output columns, so each code load is one
//   128-byte line of one plane (codes are N-minor). The warps of a block
//   split the K words of their columns and reduce in shared memory; the
//   wrapper also splits K across blocks (`splits`) so that a 4096-wide N,
//   which gives only 128 column blocks, still fills 132 SMs, and a second
//   pass sums the fp32 partials in a fixed order (deterministic, no
//   atomics). x is read as one coalesced 32-value slice per word and
//   broadcast by warp shuffles. The per-weight dequant (bits adds) is ALU
//   work that a later PR can cut with a lookup table.
// * GEMM (M > 8, prefill). Arithmetic on CUDA cores in fp32: a 64x64
//   output tile per block, one packed word (32 K rows) per step. Each step
//   dequantizes the (32, 64) W tile once into shared memory and stages the
//   (64, 32) x tile, then 256 threads each accumulate a 4x4 register tile.
//   wgmma, TMA and a multi-stage pipeline are left for a later PR.
// * Expert stacks (MoE layers). One launch covers the whole stack: the
//   expert is blockIdx.z, and each operand advances by its per-expert
//   stride (x (E, M, K), codes (E, bits, K/32, N), alphas (E, G, N, bits),
//   betas (E, G, N), y (E, M, N), split-K partials (E, splits, M, N)). A
//   single matrix is the stack of one expert, so both run the same code
//   with the same split, and each expert's slice of y equals, bit for
//   bit, the single-matrix kernel run on that expert alone.
//
// A word never straddles a scale group: the wrapper only launches for
// G == 1 or gs % 32 == 0 (the reference's `_kernel_groups_ok`), so the
// group of word kw is kw / (gs / 32). Pad bits past k_in are 0 (-1 signs)
// and cancel only because the caller zero-pads x to the packed K, which the
// wrapper checks; ragged N edges are masked, never padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWord = 32;
constexpr int kMaxBits = 8;
constexpr int kGemvWarps = 8;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kGemmThreads = 256;

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

// W rounded to the activation dtype (a no-op for fp32).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float load_scale(const void* p, long long i,
                                            int bf16) {
  return bf16 ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

// Scales of group g, column n: alphas (G, N, bits), betas (G, N).
__device__ __forceinline__ void load_group(const void* alphas,
                                           const void* betas, int g, int n,
                                           int N, int bits, int bf16,
                                           float (&a)[kMaxBits],
                                           float& beta) {
  const long long base = (long long)g * N + n;
#pragma unroll
  for (int i = 0; i < kMaxBits; ++i)
    a[i] = i < bits ? load_scale(alphas, base * bits + i, bf16) : 0.f;
  beta = load_scale(betas, base, bf16);
}

// Per-expert element strides of the operands (all 0 for one matrix).
struct ExpertStrides {
  long long x, codes, alphas, betas;
};

// A scale pointer advanced by `off` elements of its dtype.
__device__ __forceinline__ const void* scale_at(const void* p, long long off,
                                                int bf16) {
  return bf16 ? static_cast<const void*>(
                    reinterpret_cast<const __nv_bfloat16*>(p) + off)
              : static_cast<const void*>(reinterpret_cast<const float*>(p) +
                                         off);
}

// One weight from its sign bits at position j of each plane word:
// beta + sum_i (+-alpha_i), added in plane order like the reference.
template <int BITS>
__device__ __forceinline__ float expand(const uint32_t (&c)[kMaxBits],
                                        const float (&a)[kMaxBits],
                                        float beta, int j, int bits) {
  float w = beta;
  if (BITS > 0) {
#pragma unroll
    for (int i = 0; i < BITS; ++i) w += ((c[i] >> j) & 1u) ? a[i] : -a[i];
  } else {
#pragma unroll
    for (int i = 0; i < kMaxBits; ++i)
      if (i < bits) w += ((c[i] >> j) & 1u) ? a[i] : -a[i];
  }
  return w;
}

// ---------------------------------------------------------------------------
// GEMV: grid (ceil(N/32), splits, experts), block kGemvWarps warps.
// MR rows are computed (MR >= M; rows past M read as 0 and are not stored).
// ---------------------------------------------------------------------------
template <typename TX, int MR, int BITS>
__global__ void __launch_bounds__(kGemvWarps * 32)
    bcq_gemv_kernel(const TX* __restrict__ x, const uint32_t* __restrict__ codes,
                    const void* __restrict__ alphas,
                    const void* __restrict__ betas, TX* __restrict__ y,
                    float* __restrict__ partial, int M, int KW, int N,
                    int bits, long long plane_stride, int words_per_group,
                    int words_per_split, int scale_bf16, ExpertStrides es) {
  const int ex = blockIdx.z;
  x += ex * es.x;
  codes += ex * es.codes;
  alphas = scale_at(alphas, ex * es.alphas, scale_bf16);
  betas = scale_at(betas, ex * es.betas, scale_bf16);
  y += (long long)ex * M * N;
  partial += (long long)ex * gridDim.y * M * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int nc = n < N ? n : N - 1;  // clamped column for loads
  const int K = KW * kWord;
  const int kw_begin = blockIdx.y * words_per_split;
  const int kw_end = min(KW, kw_begin + words_per_split);

  float acc[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m] = 0.f;
  float a[kMaxBits];
  float beta = 0.f;
  int g_loaded = -1;
  uint32_t c[kMaxBits];
#pragma unroll
  for (int i = 0; i < kMaxBits; ++i) c[i] = 0u;

  for (int kw = kw_begin + warp; kw < kw_end; kw += kGemvWarps) {
    float xr[MR];
#pragma unroll
    for (int m = 0; m < MR; ++m)
      xr[m] = m < M ? to_f32(x[(long long)m * K + (long long)kw * kWord + lane])
                    : 0.f;
    const int g = words_per_group > 0 ? kw / words_per_group : 0;
    if (g != g_loaded) {
      load_group(alphas, betas, g, nc, N, bits, scale_bf16, a, beta);
      g_loaded = g;
    }
    const uint32_t* cw = codes + (long long)kw * N + nc;
#pragma unroll
    for (int i = 0; i < kMaxBits; ++i)
      if (i < (BITS > 0 ? BITS : bits)) c[i] = cw[i * plane_stride];
#pragma unroll
    for (int j = 0; j < kWord; ++j) {
      const float w = round_to<TX>(expand<BITS>(c, a, beta, j, bits));
#pragma unroll
      for (int m = 0; m < MR; ++m)
        acc[m] = fmaf(__shfl_sync(0xffffffffu, xr[m], j), w, acc[m]);
    }
  }

  __shared__ float red[kGemvWarps][MR][32];
#pragma unroll
  for (int m = 0; m < MR; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  for (int idx = threadIdx.x; idx < MR * 32; idx += blockDim.x) {
    const int m = idx / 32;
    const int col = blockIdx.x * 32 + (idx % 32);
    if (m >= M || col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) s += red[w][m][idx % 32];
    if (gridDim.y == 1)
      y[(long long)m * N + col] = from_f32<TX>(s);
    else
      partial[((long long)blockIdx.y * M + m) * N + col] = s;
  }
}

// Sum the split-K partials (E, splits, M, N) in split order into y (E, M, N).
template <typename TX>
__global__ void bcq_splitk_reduce(const float* __restrict__ partial,
                                  TX* __restrict__ y, int splits,
                                  long long MN, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long ex = i / MN;
  const float* p = partial + ex * splits * MN + (i - ex * MN);
  float s = 0.f;
  for (int t = 0; t < splits; ++t) s += p[t * MN];
  y[i] = from_f32<TX>(s);
}

// ---------------------------------------------------------------------------
// GEMM: grid (ceil(N/64), ceil(M/64), experts), 256 threads, one word per
// K step.
// ---------------------------------------------------------------------------
template <typename TX, int BITS>
__global__ void __launch_bounds__(kGemmThreads)
    bcq_gemm_kernel(const TX* __restrict__ x, const uint32_t* __restrict__ codes,
                    const void* __restrict__ alphas,
                    const void* __restrict__ betas, TX* __restrict__ y, int M,
                    int KW, int N, int bits, long long plane_stride,
                    int words_per_group, int scale_bf16, ExpertStrides es) {
  const int ex = blockIdx.z;
  x += ex * es.x;
  codes += ex * es.codes;
  alphas = scale_at(alphas, ex * es.alphas, scale_bf16);
  betas = scale_at(betas, ex * es.betas, scale_bf16);
  y += (long long)ex * M * N;
  __shared__ float xs[kBM][kWord + 1];                      // x tile (m, k)
  __shared__ __align__(16) float ws[kWord][kBN + 4];        // W tile (k, n)

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int K = KW * kWord;
  const int tx = tid % 16;  // 4 output columns: n0 + 4*tx ..
  const int ty = tid / 16;  // 4 output rows:    m0 + 4*ty ..
  // dequant role: column dc of the tile, rows dr .. dr+7 of the word
  const int dc = tid % kBN;
  const int dr = (tid / kBN) * 8;
  const int dn = n0 + dc;
  const bool dn_ok = dn < N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float a[kMaxBits];
  float beta = 0.f;
  int g_loaded = -1;
  uint32_t c[kMaxBits];
#pragma unroll
  for (int i = 0; i < kMaxBits; ++i) c[i] = 0u;

  for (int kw = 0; kw < KW; ++kw) {
    // stage x (64 rows x 32 k), coalesced along k
#pragma unroll
    for (int t = 0; t < (kBM * kWord) / kGemmThreads; ++t) {
      const int idx = tid + t * kGemmThreads;
      const int m = idx / kWord;
      const int k = idx % kWord;
      const int gm = m0 + m;
      xs[m][k] = gm < M ? to_f32(x[(long long)gm * K + (long long)kw * kWord + k])
                        : 0.f;
    }
    // expand 8 weights of column dn into the W tile
    if (dn_ok) {
      const int g = words_per_group > 0 ? kw / words_per_group : 0;
      if (g != g_loaded) {
        load_group(alphas, betas, g, dn, N, bits, scale_bf16, a, beta);
        g_loaded = g;
      }
      const uint32_t* cw = codes + (long long)kw * N + dn;
#pragma unroll
      for (int i = 0; i < kMaxBits; ++i)
        if (i < (BITS > 0 ? BITS : bits)) c[i] = cw[i * plane_stride];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        ws[dr + r][dc] = round_to<TX>(expand<BITS>(c, a, beta, dr + r, bits));
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) ws[dr + r][dc] = 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kWord; ++k) {
      const float4 b4 = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = xs[ty * 4 + i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) y[(long long)gm * N + gn] = from_f32<TX>(acc[i][j]);
    }
  }
}

template <typename TX, int MR>
void launch_gemv_rows(dim3 grid, cudaStream_t st, const TX* x,
                      const uint32_t* codes, const void* alphas,
                      const void* betas, TX* y, float* partial, int M, int KW,
                      int N, int bits, long long ps, int wpg, int wps,
                      int sbf, ExpertStrides es) {
  const dim3 block(kGemvWarps * 32);
  switch (bits) {
    case 2:
      bcq_gemv_kernel<TX, MR, 2><<<grid, block, 0, st>>>(
          x, codes, alphas, betas, y, partial, M, KW, N, bits, ps, wpg, wps, sbf, es);
      break;
    case 3:
      bcq_gemv_kernel<TX, MR, 3><<<grid, block, 0, st>>>(
          x, codes, alphas, betas, y, partial, M, KW, N, bits, ps, wpg, wps, sbf, es);
      break;
    case 4:
      bcq_gemv_kernel<TX, MR, 4><<<grid, block, 0, st>>>(
          x, codes, alphas, betas, y, partial, M, KW, N, bits, ps, wpg, wps, sbf, es);
      break;
    default:
      bcq_gemv_kernel<TX, MR, 0><<<grid, block, 0, st>>>(
          x, codes, alphas, betas, y, partial, M, KW, N, bits, ps, wpg, wps, sbf, es);
  }
}

template <typename TX>
void launch_gemv(const void* x, const void* codes, const void* alphas,
                 const void* betas, void* y, void* partial, int M, int KW,
                 int N, int bits, long long ps, int wpg, int splits, int sbf,
                 int E, ExpertStrides es, cudaStream_t st) {
  const dim3 grid((N + 31) / 32, splits, E);
  const int wps = (KW + splits - 1) / splits;
  const TX* xt = static_cast<const TX*>(x);
  const uint32_t* ct = static_cast<const uint32_t*>(codes);
  TX* yt = static_cast<TX*>(y);
  float* pt = static_cast<float*>(partial);
  if (M <= 1)
    launch_gemv_rows<TX, 1>(grid, st, xt, ct, alphas, betas, yt, pt, M, KW, N, bits, ps, wpg, wps, sbf, es);
  else if (M <= 2)
    launch_gemv_rows<TX, 2>(grid, st, xt, ct, alphas, betas, yt, pt, M, KW, N, bits, ps, wpg, wps, sbf, es);
  else if (M <= 4)
    launch_gemv_rows<TX, 4>(grid, st, xt, ct, alphas, betas, yt, pt, M, KW, N, bits, ps, wpg, wps, sbf, es);
  else
    launch_gemv_rows<TX, 8>(grid, st, xt, ct, alphas, betas, yt, pt, M, KW, N, bits, ps, wpg, wps, sbf, es);
  if (splits > 1) {
    const long long MN = (long long)M * N;
    const long long total = MN * E;
    bcq_splitk_reduce<TX><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        pt, yt, splits, MN, total);
  }
}

template <typename TX>
void launch_gemm(const void* x, const void* codes, const void* alphas,
                 const void* betas, void* y, int M, int KW, int N, int bits,
                 long long ps, int wpg, int sbf, int E, ExpertStrides es,
                 cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
  const dim3 block(kGemmThreads);
  const TX* xt = static_cast<const TX*>(x);
  const uint32_t* ct = static_cast<const uint32_t*>(codes);
  TX* yt = static_cast<TX*>(y);
  switch (bits) {
    case 2:
      bcq_gemm_kernel<TX, 2><<<grid, block, 0, st>>>(xt, ct, alphas, betas, yt, M, KW, N, bits, ps, wpg, sbf, es);
      break;
    case 3:
      bcq_gemm_kernel<TX, 3><<<grid, block, 0, st>>>(xt, ct, alphas, betas, yt, M, KW, N, bits, ps, wpg, sbf, es);
      break;
    case 4:
      bcq_gemm_kernel<TX, 4><<<grid, block, 0, st>>>(xt, ct, alphas, betas, yt, M, KW, N, bits, ps, wpg, sbf, es);
      break;
    default:
      bcq_gemm_kernel<TX, 0><<<grid, block, 0, st>>>(xt, ct, alphas, betas, yt, M, KW, N, bits, ps, wpg, sbf, es);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Shapes and dtypes are checked
// by the Python wrappers; these only launch on `stream` and return
// cudaGetLastError() so a refused launch is reported. E experts with the
// given per-expert element strides of x, codes, alphas and betas (E = 1
// and strides 0 for one matrix); y and the partials are (E, ...) dense.
extern "C" int bcq_gemv_launch(const void* x, const void* codes,
                               const void* alphas, const void* betas,
                               void* y, void* partial, int M, int KW, int N,
                               int bits, long long plane_stride,
                               int words_per_group, int splits, int x_bf16,
                               int scale_bf16, int E, long long x_es,
                               long long codes_es, long long alphas_es,
                               long long betas_es, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ExpertStrides es{x_es, codes_es, alphas_es, betas_es};
  if (x_bf16)
    launch_gemv<__nv_bfloat16>(x, codes, alphas, betas, y, partial, M, KW, N,
                               bits, plane_stride, words_per_group, splits,
                               scale_bf16, E, es, st);
  else
    launch_gemv<float>(x, codes, alphas, betas, y, partial, M, KW, N, bits,
                       plane_stride, words_per_group, splits, scale_bf16, E,
                       es, st);
  return (int)cudaGetLastError();
}

extern "C" int bcq_gemm_launch(const void* x, const void* codes,
                               const void* alphas, const void* betas,
                               void* y, int M, int KW, int N, int bits,
                               long long plane_stride, int words_per_group,
                               int x_bf16, int scale_bf16, int E,
                               long long x_es, long long codes_es,
                               long long alphas_es, long long betas_es,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ExpertStrides es{x_es, codes_es, alphas_es, betas_es};
  if (x_bf16)
    launch_gemm<__nv_bfloat16>(x, codes, alphas, betas, y, M, KW, N, bits,
                               plane_stride, words_per_group, scale_bf16, E,
                               es, st);
  else
    launch_gemm<float>(x, codes, alphas, betas, y, M, KW, N, bits,
                       plane_stride, words_per_group, scale_bf16, E, es, st);
  return (int)cudaGetLastError();
}

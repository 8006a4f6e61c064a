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
// * GEMV (M <= 8 rows, every decode step). One launch, no scratch. The
//   packed codes are bits/8 bytes per weight, read once (16.9 MB at w3 on
//   llama2-7b's 4096 x 11008, 5.0 us at 3.35 TB/s); the function's own 2M
//   flops a weight on the CUDA cores bound it at M >= 3. What the design
//   does about each cost of a weight:
//   - the dequant is one read of a per-column table of the scale group's
//     2^bits levels (2-4 bits; built per group in shared memory, each
//     level added in plane order like the per-plane expansion, so bit for
//     bit the same weight), laid out [level][column slot] so a warp's 32
//     reads hit 32 banks; a weight's level is a nibble of its planes' bits,
//     interleaved once a word, and becomes a byte offset with one shift
//     and one masked OR into the table's aligned base (5-8 bits, and 1,
//     expand plane by plane in registers: beta + (+-alpha_i));
//   - x is staged in shared memory as [k/4][rows][4], so one 16-byte
//     broadcast read serves 4 k of a row for a lane's 4 columns;
//   - a lane owns 4 adjacent columns, so a plane's codes come as one
//     16-byte load (512 B a warp), the next word's in flight while the
//     current one is multiplied;
//   - K splits over the blocks of a thread-block cluster (at most 8, from
//     (K, N) alone); each block sums its warps in warp order, then each
//     rank adds its share of the outputs from every rank's shared memory
//     in rank order (distributed shared memory): deterministic, one launch.
//   On the H100 it is issue-bound, not bandwidth-bound: ~9 instructions a
//   weight-lane at 4 rows (4 FMAs, a table read, its shift and OR, a share
//   of the bit interleave and the x reads) at an issue rate well under one
//   a cycle. An expert holding one token runs the one-row body.
// * GEMM (M > 8, prefill). Tensor cores: wgmma m64nNk8 in TF32 with the
//   operands swapped, Y^T = W^T X^T, so the dequantized weight columns are
//   the 64-row M side and the tokens the N side: a token tile is M rounded
//   up to 8 (at most 128; more tokens split over blocks along M), and a
//   16-token prefill multiplies no padding rows. A block is two
//   warpgroups, 128 weight columns. Each thread expands its 16 weights of
//   a packed word (two columns x 8 k) straight into the register A operand
//   (a column's 32 sign bits are 32 consecutive k: K-major, as TF32
//   requires), any bit count up to 8 by a loop on the uniform count; x is
//   a K-major shared tile with the 128-byte swizzle (one word is one
//   128-byte row). fp32 activations keep fp32 accuracy with three TF32
//   passes (3xTF32): each operand splits as v = hi + lo, both rounded to
//   TF32 to nearest, and the tensor cores take lo*hi + hi*lo + hi*hi;
//   bf16 activations take one pass (W rounds to bf16 first, and bf16
//   values are exact in TF32). x is split once per call (bcq_split_x),
//   every column block loads the parts. The tensor cores sum one word (12
//   wgmmas) at a time, into a fresh accumulator that is then added to an
//   fp32 total, so that the tensor cores' own sums, which do not round as
//   an fp32 add does, stay one word long. cp.async keeps the B tiles and
//   the code words of the next
//   S - 1 words in flight, one barrier a word. A K split chosen from
//   (M, K, N) alone fills the SMs when the column blocks are few; its
//   second pass is the GEMV's fixed-order reduce.
//   What bounds it: not the tensor cores, whose three passes are the
//   smaller part of a word's time even at 128 tokens, but each word's
//   serial path through a block: a barrier, the expansion of 16 weights a
//   thread (a sign flip and an add a plane, then the TF32 split), the
//   wgmmas and their wait. Tiles of up to 32 tokens run two blocks an SM,
//   so that one block's expansion overlaps the other's wgmmas; tiles of 40
//   to 96 tokens overlap their own, word it + 1 expanding into a second A
//   buffer while word it's wgmmas run; wider tiles have no registers for
//   that beside their two accumulators. Left for later: a cheaper
//   expansion (a per-column table of the 2^bits levels), and the overlap
//   at 128 tokens.
// * Expert stacks (MoE layers). One launch covers the whole stack: the
//   expert is blockIdx.z, and each operand advances by its per-expert
//   stride (x (E, M, K), codes (E, bits, K/32, N), alphas (E, G, N, bits),
//   betas (E, G, N), y (E, M, N), the GEMM's split-K partials (E, splits,
//   M, N)). A single matrix is the stack of one expert, so both run the
//   same code with the same split and token tile, and each expert's slice
//   of y equals, bit for bit, the single-matrix kernel run on that expert
//   alone (a row's sums do not depend on how many rows a block computes).
//   An optional rows (E,) int32 gives the live leading rows of each
//   expert: rows past it read as zero and are stored as exact zeros, and a
//   block whose expert (or token tile) holds no live row loads nothing.
//
// A word never straddles a scale group: the wrapper only launches for
// G == 1 or gs % 32 == 0 (the reference's `_kernel_groups_ok`), so the
// group of word kw is kw / (gs / 32). Pad bits past k_in are 0 (-1 signs)
// and cancel only because the caller zero-pads x to the packed K, which the
// wrapper checks; ragged N edges are masked, never padded.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWord = 32;
constexpr int kMaxBits = 8;
// The GEMM's tile constants are hw.py's (GEMM_COLS, GEMM_TILE_MAX,
// GEMM_PAIRED_TILE), which the Python launch arithmetic reads too; the
// build (kernels/build.py) passes them as these macros.
#if !defined(BCQ_GEMM_COLS) || !defined(BCQ_GEMM_TILE_MAX) || \
    !defined(BCQ_GEMM_PAIRED_TILE)
#error "build with src/repro_torch/kernels/build.py (it passes hw.py's GEMM tile constants)"
#endif
constexpr int kTcCols = BCQ_GEMM_COLS;            // weight columns a block
constexpr int kTcMaxTile = BCQ_GEMM_TILE_MAX;     // widest token tile
constexpr int kTcPairedTile = BCQ_GEMM_PAIRED_TILE;  // two blocks an SM
static_assert(kTcCols == 2 * 64,
              "a GEMM block is two warpgroups, each a 64-row wgmma M side");
static_assert(kTcMaxTile == 128,
              "bcq_gemm_launch instantiates token tiles 8, 16, ..., 128");
static_assert(kTcPairedTile % 8 == 0 && kTcPairedTile <= 96,
              "a paired tile is a multiple of 8 with room for two blocks");

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Live leading rows of expert ex: rows[ex] clamped to [0, M], or M.
__device__ __forceinline__ int live_rows(const int* rows, int ex, int M) {
  return rows ? min(max(rows[ex], 0), M) : M;
}

// ---------------------------------------------------------------------------
// GEMV: grid (splits, ceil(N / kGemvCols), experts) in clusters of `splits`
// blocks along x (cluster rank = K split), kGemvThreads threads a block.
// A lane owns kLaneCols adjacent columns; the block's warps take its K words
// in turn (word kw to warp (kw - first word) % kGemvWarps, each warp in
// increasing order), so the summation order is fixed by (KW, N, splits).
// MR rows are held (MR >= M; rows past M, or past the expert's live
// rows, read as 0 and are stored as 0 or not at all).
// ---------------------------------------------------------------------------
#if !defined(BCQ_GEMV_COLS) || !defined(BCQ_GEMV_WARPS)
#error "build with src/repro_torch/kernels/build.py (it passes hw.py's GEMV block shape)"
#endif
constexpr int kGemvWarps = BCQ_GEMV_WARPS;       // warps taking the K words
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvCols = BCQ_GEMV_COLS;         // columns a block owns
constexpr int kLaneCols = kGemvCols / 32;        // adjacent columns a lane owns
static_assert(kLaneCols == 4, "a lane loads one 16-byte vector of 4 columns a plane");
constexpr int kLevelShift = 9;                   // a table level: 128 floats
static_assert(kGemvCols * 4 == 1 << kLevelShift, "");
constexpr int kGemvMaxChunk = 64;                // K words of x staged at a time
constexpr int kGemvSmemBudget = 112 * 1024;      // two blocks an SM
constexpr int kGemvMaxSplits = 8;                // portable cluster size

// One GEMV launch (E experts share every field; per-expert strides in es).
struct GemvArgs {
  const void* x;
  const uint32_t* codes;
  const void* alphas;
  const void* betas;
  void* y;
  const int* rows;
  int M, KW, N, bits;
  long long plane_stride;
  int words_per_group;  // 0: one scale group
  int words_per_split;
  int chunk;            // K words of x staged at a time (a multiple of 8)
  int tab_slots;        // level tables held at a time
  int vec;              // codes load as 16-byte vectors (N % 4 == 0, aligned)
  int scale_bf16;
  ExpertStrides es;
};

__device__ __forceinline__ float4 load_x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_x4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Shared memory of one launch: tables (tab_slots x 2^bits levels x
// kGemvCols floats), then x of a chunk ([k/4][MR][4] floats; after the K
// loop the warps' sums), then the block's sums that the cluster reads.
__host__ __device__ __forceinline__ int gemv_x_floats(int MR, int chunk) {
  const int x = MR * chunk * kWord, red = kGemvWarps * MR * kGemvCols;
  return x > red ? x : red;
}
__host__ __device__ __forceinline__ int gemv_tab_floats(int tab_bits) {
  return tab_bits ? (1 << tab_bits) * kGemvCols : 0;
}
// A table's byte offset of a level is its index in bits kLevelShift and up;
// the tables start on a multiple of their size, so a lane's address is
// (offset | base) with no add.

// The GEMV of one block computing R rows (R <= MR, the rows the launch's
// shared memory holds; rows at or past R are past the live ones). Each
// row's sums are the same whatever R is: its own FMAs in the same order.
// BITS 2..4: each weight is one read of a per-column table of the 2^BITS
// levels of its scale group; BITS 0: any count up to 8, expanded plane by
// plane in registers.
template <typename TX, int MR, int R, int BITS>
__device__ __forceinline__ void gemv_body(const GemvArgs& a, int live) {
  constexpr int P = BITS > 0 ? BITS : kMaxBits;  // plane words a column
  constexpr int kTab = BITS > 0 ? (1 << BITS) * kGemvCols : 0;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;
  const int splits = gridDim.x;
  const int ex = blockIdx.z;
  const int n0 = blockIdx.y * kGemvCols;
  const int M = a.M, N = a.N, KW = a.KW;
  TX* y = static_cast<TX*>(a.y) + (long long)ex * M * N;
  const TX* x = static_cast<const TX*>(a.x) + ex * a.es.x;
  const uint32_t* codes = a.codes + ex * a.es.codes;
  const void* alphas = scale_at(a.alphas, ex * a.es.alphas, a.scale_bf16);
  const void* betas = scale_at(a.betas, ex * a.es.betas, a.scale_bf16);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int K = KW * kWord;
  const int kb = rank * a.words_per_split;
  const int ke = min(KW, kb + a.words_per_split);
  const int wpg = a.words_per_group;

  extern __shared__ float4 gemv_smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(gemv_smem4);
  if constexpr (BITS > 0)  // the host allocates kTab floats more for this
    smem += (4 * kTab - (smem_u32(smem) & (4 * kTab - 1))) & (4 * kTab - 1);
  float* tabs = reinterpret_cast<float*>(smem);
  float* xs = tabs + a.tab_slots * kTab;
  float* part = xs + gemv_x_floats(MR, a.chunk);  // as every rank places it

  // The lane's plane words of word kw: one 16-byte load a plane (or four
  // 4-byte loads when N is ragged), columns past N clamped to valid ones.
  const int lc = n0 + lane * kLaneCols;
  auto load_codes = [&](int kw, uint32_t(&p)[P][kLaneCols]) {
    const uint32_t* src = codes + (long long)kw * N;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (BITS == 0 && i >= a.bits) break;
      const uint32_t* s = src + i * a.plane_stride;
      if (a.vec) {
        const uint4 v =
            __ldcs(reinterpret_cast<const uint4*>(s + min(lc, N - kLaneCols)));
        p[i][0] = v.x;
        p[i][1] = v.y;
        p[i][2] = v.z;
        p[i][3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < kLaneCols; ++c) p[i][c] = __ldcs(s + min(lc + c, N - 1));
      }
    }
  };

  // x rows of words [c0, c1) into xs as [k/4][R][4] fp32, rows past the
  // live ones zero: one 16-byte broadcast read then serves R rows' 4 k.
  auto stage_x = [&](int c0, int c1) {
    const int n4 = (c1 - c0) * (kWord / 4);
    for (int i = threadIdx.x; i < R * n4; i += kGemvThreads) {
      const int m = i / n4, t = i % n4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < live)
        v = load_x4(x + (long long)m * K + (long long)c0 * kWord + 4 * t);
      reinterpret_cast<float4*>(xs)[t * R + m] = v;
    }
  };

  // Level tables of groups g0 .. g0 + ng - 1: level l of a column is
  // beta + sum_i (bit i of l ? alpha_i : -alpha_i), added in plane order
  // like the per-plane expansion (so bit for bit the same weight), rounded
  // to x's dtype. Laid out [level][slot], slot c * 32 + lane holding the
  // lane's column c, so a warp's reads fall in 32 distinct banks.
  auto build_tables = [&](int g0, int ng) {
    if constexpr (BITS > 0) {
      for (int i = threadIdx.x; i < ng * kGemvCols; i += kGemvThreads) {
        const int s = i / kGemvCols, slot = i % kGemvCols;
        const int n = min(n0 + (slot % 32) * kLaneCols + slot / 32, N - 1);
        const long long gb = (long long)(g0 + s) * N + n;
        float lv[1 << BITS];
        lv[0] = load_scale(betas, gb, a.scale_bf16);
#pragma unroll
        for (int b = 0; b < BITS; ++b) {
          const float al = load_scale(alphas, gb * BITS + b, a.scale_bf16);
#pragma unroll
          for (int j = 0; j < (1 << b); ++j) {
            lv[j | (1 << b)] = lv[j] + al;
            lv[j] = lv[j] - al;
          }
        }
        float* t = tabs + s * kTab + slot;
#pragma unroll
        for (int l = 0; l < (1 << BITS); ++l)
          t[l * kGemvCols] = round_to<TX>(lv[l]);
      }
    }
  };

  float acc[R][kLaneCols];
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) acc[m][c] = 0.f;

  // Table path: the planes' bits interleaved once a word into nibbles
  // (idx[q][c] nibble t = the level of k = 4t + q), then per weight one
  // shift-and for the level's byte offset and one table read.
  auto word_lut = [&](const uint32_t(&p)[P][kLaneCols], const float* xw,
                      const float* tab) {
    uint32_t idx[4][kLaneCols];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) {
        uint32_t v = 0;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const uint32_t s = i >= q ? p[i][c] << (i - q) : p[i][c] >> (q - i);
          v |= s & (0x11111111u << i);
        }
        idx[q][c] = v;
      }
    const uint32_t tl = smem_u32(tab) | (lane * 4);
    constexpr uint32_t kMask = ((1u << (BITS > 0 ? BITS : 1)) - 1) << kLevelShift;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float4 xv[R];
#pragma unroll
      for (int m = 0; m < R; ++m)
        xv[m] = reinterpret_cast<const float4*>(xw)[t * R + m];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < kLaneCols; ++c) {
          const uint32_t v = idx[q][c];
          const uint32_t sh = 4 * t <= kLevelShift ? v << (kLevelShift - 4 * t)
                                                   : v >> (4 * t - kLevelShift);
          float w;  // 32-bit shared address, the column's slot an immediate
          asm volatile("ld.shared.f32 %0, [%1];"
                       : "=f"(w)
                       : "r"(((sh & kMask) | tl) + c * 128));
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const float xq = q == 0 ? xv[m].x : q == 1 ? xv[m].y
                             : q == 2 ? xv[m].z : xv[m].w;
            acc[m][c] = fmaf(xq, w, acc[m][c]);
          }
        }
    }
  };

  // Per-plane path (BITS 0, 5..8 bits): beta + (+-alpha_i) in plane order.
  float al[kLaneCols][kMaxBits], be[kLaneCols];
  int g_loaded = -1;
  auto word_planes = [&](const uint32_t(&p)[P][kLaneCols], const float* xw,
                         int g) {
    if (g != g_loaded) {
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c)
        load_group(alphas, betas, g, min(lc + c, N - 1), N, a.bits,
                   a.scale_bf16, al[c], be[c]);
      g_loaded = g;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float4 xv[R];
#pragma unroll
      for (int m = 0; m < R; ++m)
        xv[m] = reinterpret_cast<const float4*>(xw)[t * R + m];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < kLaneCols; ++c) {
          float w = be[c];
#pragma unroll
          for (int i = 0; i < P; ++i)
            if (i < a.bits)
              w += ((p[i][c] >> (4 * t + q)) & 1u) ? al[c][i] : -al[c][i];
          w = round_to<TX>(w);
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const float xq = q == 0 ? xv[m].x : q == 1 ? xv[m].y
                             : q == 2 ? xv[m].z : xv[m].w;
            acc[m][c] = fmaf(xq, w, acc[m][c]);
          }
        }
    }
  };

  uint32_t cur[P][kLaneCols], nxt[P][kLaneCols];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) cur[i][c] = nxt[i][c] = 0u;

  // The block's K words in chunks: the warp's first code words are loaded
  // before the chunk's x and tables are staged, the next word's while the
  // current one is multiplied.
  for (int c0 = kb; c0 < ke; c0 += a.chunk) {
    const int c1 = min(ke, c0 + a.chunk);
    int kw = c0 + warp;
    if (kw < c1) load_codes(kw, cur);
    stage_x(c0, c1);
    int g0 = 0;
    if (wpg > 0) {
      g0 = c0 / wpg;
      build_tables(g0, (c1 - 1) / wpg - g0 + 1);
    } else if (c0 == kb) {
      build_tables(0, 1);
    }
    __syncthreads();
    for (; kw < c1; kw += kGemvWarps) {
      const bool more = kw + kGemvWarps < c1;
      if (more) load_codes(kw + kGemvWarps, nxt);
      const float* xw = xs + (kw - c0) * kWord * R;
      if constexpr (BITS > 0)
        word_lut(cur, xw, tabs + (wpg > 0 ? kw / wpg - g0 : 0) * kTab);
      else
        word_planes(cur, xw, wpg > 0 ? kw / wpg : 0);
      if (more) {
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
          for (int c = 0; c < kLaneCols; ++c) cur[i][c] = nxt[i][c];
      }
    }
    __syncthreads();
  }

  // The warps' sums in warp order, then the cluster's in rank order: each
  // rank adds its share of the block's outputs from every rank's shared
  // memory (distributed shared memory) and stores them.
  float* red = xs;
#pragma unroll
  for (int m = 0; m < R; ++m)
    reinterpret_cast<float4*>(red)[(warp * R + m) * 32 + lane] =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < R * kGemvCols; i += kGemvThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) s += red[w * R * kGemvCols + i];
    part[i] = s;
  }
  cluster.sync();
  const int total = M * kGemvCols;
  const int per = (total + splits - 1) / splits;
  const int hi = min(total, (rank + 1) * per);
  for (int i = rank * per + threadIdx.x; i < hi; i += kGemvThreads) {
    const int m = i / kGemvCols, n = n0 + i % kGemvCols;
    float s = 0.f;
    if (m < live)
      for (int r = 0; r < splits; ++r) s += cluster.map_shared_rank(part, r)[i];
    if (n < N) y[(long long)m * N + n] = from_f32<TX>(s);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// grid (splits, ceil(N / kGemvCols), experts): an empty expert's cluster
// loads nothing and its rank 0 stores the zeros; an expert holding one
// token computes one row (an expert decode's common case).
template <typename TX, int MR, int BITS>
__global__ void __launch_bounds__(kGemvThreads, BITS > 0 ? 2 : 1)
    bcq_gemv_kernel(const GemvArgs a) {
  const int live = live_rows(a.rows, blockIdx.z, a.M);
  if (live == 0) {  // uniform over the cluster: no cluster barrier waits
    if (blockIdx.x == 0) {
      TX* y = static_cast<TX*>(a.y) + (long long)blockIdx.z * a.M * a.N;
      const int n0 = blockIdx.y * kGemvCols;
      for (int i = threadIdx.x; i < a.M * kGemvCols; i += kGemvThreads) {
        const int n = n0 + i % kGemvCols;
        if (n < a.N)
          y[(long long)(i / kGemvCols) * a.N + n] = from_f32<TX>(0.f);
      }
    }
    return;
  }
  if constexpr (MR > 1) {
    if (live == 1) {
      gemv_body<TX, MR, 1, BITS>(a, live);
      return;
    }
  }
  gemv_body<TX, MR, MR, BITS>(a, live);
}

// Sum the split-K partials (E, splits, M, N) in split order into y (E, M, N);
// rows past an expert's live rows are written as zeros without a read.
template <typename TX>
__global__ void bcq_splitk_reduce(const float* __restrict__ partial,
                                  TX* __restrict__ y,
                                  const int* __restrict__ rows, int splits,
                                  int M, int N, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long MN = (long long)M * N;
  const long long ex = i / MN;
  if ((i - ex * MN) / N >= live_rows(rows, (int)ex, M)) {
    y[i] = from_f32<TX>(0.f);
    return;
  }
  const float* p = partial + ex * splits * MN + (i - ex * MN);
  float s = 0.f;
  for (int t = 0; t < splits; ++t) s += p[t * MN];
  y[i] = from_f32<TX>(s);
}

// ---------------------------------------------------------------------------
// GEMM on tensor cores: PTX helpers
// ---------------------------------------------------------------------------

// 16 (or 4) bytes global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy shared-memory writes made visible to wgmma's async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses to wgmma's registers across the
// asynchronous instructions.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// fp32 -> TF32 with round-to-nearest, ties away from zero, as a 32-bit
// pattern: what cvt.rna.tf32.f32 gives for every finite value short of
// the top binade, in two integer operations (the cvt has no single SASS
// instruction on sm_90 and expands to a longer sequence).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes (32 fp32 = one word of K), 8-row core groups
// 1024 bytes apart (SBO), the leading offset unused; the tile starts on a
// 1024-byte boundary so the base offset is 0. Advancing K by 8 TF32 (32
// bytes) adds 2 to the start field; advancing 8 rows adds 64.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// Float offset of 16-byte chunk `chunk` of row r in a 128-byte-swizzled
// (rows x 32) fp32 tile: it sits at chunk position chunk ^ (r % 8).
__device__ __forceinline__ int sw128_chunk(int r, int chunk) {
  return r * 32 + ((chunk ^ (r & 7)) << 2);
}

// m64nNk8 TF32 wgmma, A from registers, B a K-major shared tile, fp32 D:
// D = A B (scale_d = 0) or D += A B (scale_d = 1).
// D (64 x 8) += A (64 x 8, registers) * B (8 x 8, shared, K-major)
__device__ __forceinline__ void wgmma_n8(float* d, const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3"
      "}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d)
      : "memory");
}

// D (64 x 16) += A (64 x 8, registers) * B (16 x 8, shared, K-major)
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d)
      : "memory");
}

// D (64 x 32) += A (64 x 8, registers) * B (32 x 8, shared, K-major)
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d)
      : "memory");
}

// D (64 x 64) += A (64 x 8, registers) * B (64 x 8, shared, K-major)
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d)
      : "memory");
}

// D (64 x 128) += A (64 x 8, registers) * B (128 x 8, shared, K-major)
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d)
      : "memory");
}

// One m64 x n x k8 product for a token tile of NT rows, issued as wgmmas of
// the widest power-of-two widths that sum to NT (their accumulators are
// consecutive slices of `acc`, their B rows consecutive 8-row groups).
template <int C>
__device__ __forceinline__ void wgmma_chunk(float* d, const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  if constexpr (C == 128) wgmma_n128(d, a, b, scale_d);
  else if constexpr (C == 64) wgmma_n64(d, a, b, scale_d);
  else if constexpr (C == 32) wgmma_n32(d, a, b, scale_d);
  else if constexpr (C == 16) wgmma_n16(d, a, b, scale_d);
  else wgmma_n8(d, a, b, scale_d);
}

template <int R, int REM>
struct TokenChunks {
  static constexpr int C = REM >= 128 ? 128 : REM >= 64 ? 64 : REM >= 32 ? 32
                           : REM >= 16 ? 16 : 8;
  __device__ __forceinline__ static void mma(float* acc,
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    // accumulator slice: C/2 floats a thread; B rows R.. : 128 B a row
    wgmma_chunk<C>(acc + R / 2, a, b + (uint64_t)((R * 128) >> 4), scale_d);
    TokenChunks<R + C, REM - C>::mma(acc, a, b, scale_d);
  }
};
template <int R>
struct TokenChunks<R, 0> {
  __device__ __forceinline__ static void mma(float*, const uint32_t (&)[4],
                                             uint64_t, int) {}
};

// x split once per call into its TF32 parts: hi = x rounded to TF32 and,
// for fp32 x, lo = (x - hi) rounded to TF32 (bf16 x is exact in TF32: hi
// alone). Every column block of the GEMM then loads the parts as they are.
__global__ void bcq_split_x(const void* __restrict__ x, float* __restrict__ hi,
                            float* __restrict__ lo, long long n, int x_bf16) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (x_bf16) {
      hi[i] = __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
    } else {
      const float v = static_cast<const float*>(x)[i];
      const float h = __uint_as_float(tf32_rna(v));
      hi[i] = h;
      lo[i] = __uint_as_float(tf32_rna(v - h));
    }
  }
}

// The NT-token GEMM block: two warpgroups of 64 weight columns each.
// Shared memory: S stages, each the hi and lo B tiles of one packed word
// (NT x 32 k fp32, K-major, 128-byte swizzle) and the code words of the
// block's columns; then two slots of a scale group of the block's columns
// (alphas negated, at a stride of 9 floats so that a warp's 8 columns fall
// in distinct banks, then betas), alternating from group to group.
constexpr int kTcThreads = 256;
constexpr int kScaleStride = kMaxBits + 1;
constexpr int kScaleFloats = (kScaleStride + 1) * kTcCols;
template <int NT>
struct TcCfg {
  // Tiles of up to 32 tokens run two blocks an SM, so that one block's
  // expansion overlaps the other's wgmmas; wider tiles take the SM and, up
  // to 96 tokens, overlap their own: word it + 1 expands into a second A
  // buffer while word it's wgmmas run (past 96 tokens the second buffer
  // does not fit the registers beside the two accumulators).
  static constexpr int kMinBlocks = NT <= kTcPairedTile ? 2 : 1;
  static constexpr bool kPipe = NT > kTcPairedTile && NT <= 96;
  static constexpr int kTileBytes = NT * 128;
  static constexpr int kCodeBytes = kMaxBits * kTcCols * 4;
  static constexpr int kStageBytes = 2 * kTileBytes + kCodeBytes;
  static constexpr int kFit =
      ((kMinBlocks == 2 ? 113 : 226) * 1024 - 1024 - 2 * 4 * kScaleFloats) /
      kStageBytes;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + 2 * 4 * kScaleFloats;
  static_assert(kStages >= 3, "the load ring needs three stages");
};

// ---------------------------------------------------------------------------
// GEMM: grid (ceil(N/128), ntiles * splits, experts), 256 threads. Block
// (column block bx, token tile t, split s) computes y[t*NT .. +NT,
// bx*128 .. +128] over the K words of split s from the split x (xh, and
// xl for fp32 x). Each thread expands its 16 weights of a word into the
// register A operand; cp.async keeps the B tiles and code words of the
// next words in flight; one barrier a word.
// ---------------------------------------------------------------------------
template <int NT>
__global__ void __launch_bounds__(kTcThreads, TcCfg<NT>::kMinBlocks)
    bcq_tc_gemm_kernel(const float* __restrict__ xh,
                       const float* __restrict__ xl,
                       const uint32_t* __restrict__ codes,
                       const void* __restrict__ alphas,
                       const void* __restrict__ betas, void* __restrict__ y,
                       float* __restrict__ partial,
                       const int* __restrict__ rows, int M, int KW, int N,
                       int bits, long long plane_stride, int words_per_group,
                       int words_per_split, int ntiles, int x_bf16,
                       int scale_bf16, ExpertStrides es) {
  using Cfg = TcCfg<NT>;
  constexpr int S = Cfg::kStages;
  constexpr int kAcc = NT / 2;  // accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stage0 = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* scales0 = reinterpret_cast<float*>(stage0 + S * Cfg::kStageBytes);

  const int tid = threadIdx.x;
  const int ex = blockIdx.z;
  const int tile = blockIdx.y % ntiles;
  const int split = blockIdx.y / ntiles;
  const int splits = gridDim.y / ntiles;
  const int t0 = tile * NT;
  const int n0 = blockIdx.x * kTcCols;
  const int live = live_rows(rows, ex, M);
  const long long MN = (long long)M * N;

  if (t0 >= live) {  // no live token in this tile: no loads
    if (splits == 1)
      for (int idx = tid; idx < NT * kTcCols; idx += kTcThreads) {
        const int tok = t0 + idx / kTcCols;
        const int col = n0 + idx % kTcCols;
        if (tok < M && col < N) {
          const long long o = ex * MN + (long long)tok * N + col;
          if (x_bf16)
            static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16_rn(0.f);
          else
            static_cast<float*>(y)[o] = 0.f;
        }
      }
    return;
  }

  const int K = KW * kWord;
  xh += ex * es.x;
  xl += ex * es.x;
  codes += ex * es.codes;
  alphas = scale_at(alphas, ex * es.alphas, scale_bf16);
  betas = scale_at(betas, ex * es.betas, scale_bf16);
  const int kb = split * words_per_split;
  const int nwords = max(0, min(KW, kb + words_per_split) - kb);

  // Word kb + it into stage it % S: the B tiles straight into their
  // swizzled places (rows past the live ones zero-filled) and the code
  // words of the block's columns; one commit group per call, empty past
  // the last word.
  auto load = [&](int it) {
    if (it < nwords) {
      uint8_t* hi = stage0 + (it % S) * Cfg::kStageBytes;
      const long long k0 = (long long)(kb + it) * kWord;
      for (int q = tid; q < NT * 8 * (x_bf16 ? 1 : 2); q += kTcThreads) {
        const int part = q / (NT * 8), qq = q % (NT * 8);
        const int r = qq >> 3, c = qq & 7;
        const bool ok = t0 + r < live;
        cp_async16(hi + part * Cfg::kTileBytes + sw128_chunk(r, c) * 4,
                   (part ? xl : xh) + (ok ? t0 + r : 0) * (long long)K + k0 +
                       c * 4,
                   ok ? 16 : 0);
      }
      uint32_t* cs = reinterpret_cast<uint32_t*>(hi + 2 * Cfg::kTileBytes);
      const uint32_t* src = codes + (long long)(kb + it) * N;
      for (int q = tid; q < bits * kTcCols; q += kTcThreads) {
        const int i = q / kTcCols, c = q % kTcCols;
        const bool ok = n0 + c < N;
        cp_async4(cs + q, src + i * plane_stride + (ok ? n0 + c : 0),
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  // The stage of word it has landed for every thread, for wgmma too.
  auto ready = [&]() {
    fence_proxy_async();
    __syncthreads();
  };

  // A word that starts a scale group writes the group's scales into the
  // slot of its parity (read after the next barrier; the other slot may
  // still be read for the previous group).
  int g_cur = -1;
  auto scales = [&](int it) {
    const int g = words_per_group > 0 ? (kb + it) / words_per_group : 0;
    if (g == g_cur) return;
    float* sc = scales0 + (g & 1) * kScaleFloats;
    for (int q = tid; q < kTcCols * (bits + 1); q += kTcThreads) {
      const int c = q % kTcCols, i = q / kTcCols;
      const long long base = (long long)g * N + min(n0 + c, N - 1);
      if (i < bits)
        sc[c * kScaleStride + i] =
            -load_scale(alphas, base * bits + i, scale_bf16);
      else
        sc[kScaleStride * kTcCols + c] = load_scale(betas, base, scale_bf16);
    }
    g_cur = g;
  };

  // This thread's A rows (weight columns) in the wgmma fragment layout:
  // warp w of warpgroup wg holds rows 16w.. of its 64; lane (grp, tig)
  // rows grp and grp + 8, K offsets tig and tig + 4 of each k8 step.
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int col0 = wg * 64 + warp * 16 + grp;  // and col0 + 8

  // Word it's W fragments: W[k = tig + 4q, columns col0 and col0 + 8],
  // q = 0..7, beta + (+-alpha_i) in plane order like the reference (a set
  // bit flips the negated alpha), rounded to bf16 for bf16 x (exact in
  // TF32) or split hi + lo; as A fragments of the 4 k8 steps {W(col0, k),
  // W(col0+8, k), W(col0, k+4), W(col0+8, k+4)}, k = 8 ks + tig.
  auto expand = [&](int it, uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
    const uint32_t* cs = reinterpret_cast<const uint32_t*>(
        stage0 + (it % S) * Cfg::kStageBytes + 2 * Cfg::kTileBytes);
    const int g = words_per_group > 0 ? (kb + it) / words_per_group : 0;
    const float* sc = scales0 + (g & 1) * kScaleFloats;
    float w[2][8];
    {
      const float b0 = sc[kScaleStride * kTcCols + col0];
      const float b1 = sc[kScaleStride * kTcCols + col0 + 8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        w[0][q] = b0;
        w[1][q] = b1;
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxBits; ++i) {
      if (i < bits) {
        const uint32_t c0 = cs[i * kTcCols + col0] >> tig;
        const uint32_t c1 = cs[i * kTcCols + col0 + 8] >> tig;
        const uint32_t m0 = __float_as_uint(sc[col0 * kScaleStride + i]);
        const uint32_t m1 =
            __float_as_uint(sc[(col0 + 8) * kScaleStride + i]);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          w[0][q] += __uint_as_float(m0 ^ ((c0 << (31 - 4 * q)) & 0x80000000u));
          w[1][q] += __uint_as_float(m1 ^ ((c1 << (31 - 4 * q)) & 0x80000000u));
        }
      }
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = w[j & 1][2 * ks + (j >> 1)];
        ah[ks][j] = x_bf16 ? __float_as_uint(round_to<__nv_bfloat16>(v))
                           : tf32_rna(v);
        al[ks][j] = tf32_rna(v - __uint_as_float(ah[ks][j]));
      }
  };

  // acc: the tensor cores' sum over one word, added into the fp32 total
  // once the word's wgmmas are done (the tensor cores' own fp32 sums are
  // kept short: 3 x 4 steps a word instead of 3 K / 8 over the split)
  float acc[kAcc], total[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = total[i] = 0.f;

  // Word it's wgmmas on (ah, al), committed and left in flight.
  auto mma = [&](int it, uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
    uint8_t* st = stage0 + (it % S) * Cfg::kStageBytes;
    const uint64_t bhi = sw128_desc(st);
    const uint64_t blo = sw128_desc(st + Cfg::kTileBytes);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) fence_reg(acc[i]);
    wgmma_fence();
    if (x_bf16) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        TokenChunks<0, NT>::mma(acc, ah[ks], bhi + 2 * ks, ks > 0);
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        TokenChunks<0, NT>::mma(acc, al[ks], bhi + 2 * ks, ks > 0);
        TokenChunks<0, NT>::mma(acc, ah[ks], blo + 2 * ks, 1);
        TokenChunks<0, NT>::mma(acc, ah[ks], bhi + 2 * ks, 1);
      }
    }
    wgmma_commit();
  };
  auto done = [&]() {
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      fence_reg(acc[i]);
      total[i] += acc[i];
    }
  };

  uint32_t ahi[2][4][4], alo[2][4][4];
#pragma unroll 1
  for (int s = 0; s < S - 1; ++s) load(s);
  if constexpr (Cfg::kPipe) {
    // iteration it: wait for word it + 1, refill the stage of word it - 1,
    // run word it's wgmmas while word it + 1 expands
    auto step = [&](int it, uint32_t(&ch)[4][4], uint32_t(&cl)[4][4],
                    uint32_t(&nh)[4][4], uint32_t(&nl)[4][4]) {
      if (it + 1 < nwords) scales(it + 1);
      cp_async_wait<S - 3>();
      ready();
      load(it + S - 1);
      mma(it, ch, cl);
      if (it + 1 < nwords) expand(it + 1, nh, nl);
      done();
    };
    if (nwords > 0) {
      scales(0);
      cp_async_wait<S - 2>();
      ready();
      expand(0, ahi[0], alo[0]);
    }
#pragma unroll 1
    for (int it = 0; it < nwords; it += 2) {
      step(it, ahi[0], alo[0], ahi[1], alo[1]);
      if (it + 1 < nwords) step(it + 1, ahi[1], alo[1], ahi[0], alo[0]);
    }
  } else {
#pragma unroll 1
    for (int it = 0; it < nwords; ++it) {
      scales(it);
      cp_async_wait<S - 2>();
      ready();  // word it landed; word it - 1's wgmmas are done
      load(it + S - 1);  // into the stage of word it - 1
      expand(it, ahi[0], alo[0]);
      mma(it, ahi[0], alo[0]);
      done();
    }
  }
  cp_async_wait<0>();

  // D fragment: total[4j + r] is weight column col0 + 8 (r >> 1), token
  // t0 + 8j + 2 tig + (r & 1)
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int tok = t0 + 8 * j + 2 * tig + (r & 1);
      const int col = n0 + col0 + 8 * (r >> 1);
      if (tok >= M || col >= N) continue;
      const float v = tok < live ? total[4 * j + r] : 0.f;
      if (splits == 1) {
        const long long o = ex * MN + (long long)tok * N + col;
        if (x_bf16)
          static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16_rn(v);
        else
          static_cast<float*>(y)[o] = v;
      } else if (tok < live) {
        partial[((ex * splits + split) * (long long)M + tok) * N + col] = v;
      }
    }
}

template <typename TX>
void launch_reduce(const float* partial, void* y, const int* rows, int splits,
                   int M, int N, int E, cudaStream_t st) {
  const long long total = (long long)M * N * E;
  bcq_splitk_reduce<TX><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      partial, static_cast<TX*>(y), rows, splits, M, N, total);
}

// The chunk of K words staged at a time and the table slots of one GEMV
// launch, within kGemvSmemBudget (a chunk of 8 words at the least); returns
// the dynamic shared memory bytes.
int gemv_plan(int MR, int tab_bits, int wpg, int wps, int& chunk, int& slots) {
  chunk = min(kGemvMaxChunk, (wps + kGemvWarps - 1) / kGemvWarps * kGemvWarps);
  for (;;) {
    slots = tab_bits == 0 ? 0 : wpg == 0 ? 1 : (chunk - 1) / wpg + 2;
    // (one table more: room to start the tables on a multiple of their size)
    const int bytes = 4 * ((slots + (slots > 0)) * gemv_tab_floats(tab_bits) +
                           gemv_x_floats(MR, chunk) + MR * kGemvCols);
    if (bytes <= kGemvSmemBudget || chunk <= kGemvWarps) return bytes;
    chunk -= kGemvWarps;
  }
}

// One launch in clusters of `splits` blocks; a refused attribute or launch
// (too much shared memory, a cluster the card cannot place) is returned.
template <typename TX, int MR, int BITS>
cudaError_t launch_gemv_t(GemvArgs a, int splits, int E, cudaStream_t st) {
  const int smem = gemv_plan(MR, BITS, a.words_per_group, a.words_per_split,
                             a.chunk, a.tab_slots);
  auto kern = bcq_gemv_kernel<TX, MR, BITS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (a.N + kGemvCols - 1) / kGemvCols, E);
  cfg.blockDim = dim3(kGemvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a);
}

template <typename TX, int MR>
cudaError_t launch_gemv_bits(const GemvArgs& a, int splits, int E,
                             cudaStream_t st) {
  switch (a.bits) {
    case 2: return launch_gemv_t<TX, MR, 2>(a, splits, E, st);
    case 3: return launch_gemv_t<TX, MR, 3>(a, splits, E, st);
    case 4: return launch_gemv_t<TX, MR, 4>(a, splits, E, st);
    default: return launch_gemv_t<TX, MR, 0>(a, splits, E, st);
  }
}

template <typename TX>
cudaError_t launch_gemv(const GemvArgs& a, int splits, int E,
                        cudaStream_t st) {
  if (a.M <= 1) return launch_gemv_bits<TX, 1>(a, splits, E, st);
  if (a.M <= 2) return launch_gemv_bits<TX, 2>(a, splits, E, st);
  if (a.M <= 4) return launch_gemv_bits<TX, 4>(a, splits, E, st);
  return launch_gemv_bits<TX, 8>(a, splits, E, st);
}

template <int NT>
cudaError_t launch_tc_gemm(const void* x, float* xsplit, const void* codes,
                           const void* alphas, const void* betas, void* y,
                           void* partial, const int* rows, int M, int KW,
                           int N, int bits, long long ps, int wpg, int ntiles,
                           int splits, int xbf, int sbf, int E,
                           ExpertStrides es, cudaStream_t st) {
  constexpr int smem = TcCfg<NT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      bcq_tc_gemm_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long n = (long long)E * M * KW * kWord;
  float* xl = xbf ? xsplit : xsplit + n;
  bcq_split_x<<<(unsigned)min((n + 255) / 256, 4096ll), 256, 0, st>>>(
      x, xsplit, xl, n, xbf);
  const dim3 grid((N + kTcCols - 1) / kTcCols, ntiles * splits, E);
  const int wps = (KW + splits - 1) / splits;
  bcq_tc_gemm_kernel<NT><<<grid, kTcThreads, smem, st>>>(
      xsplit, xl, static_cast<const uint32_t*>(codes), alphas, betas, y,
      static_cast<float*>(partial), rows, M, KW, N, bits, ps, wpg, wps,
      ntiles, xbf, sbf, es);
  if (splits > 1) {
    if (xbf)
      launch_reduce<__nv_bfloat16>(static_cast<const float*>(partial), y,
                                   rows, splits, M, N, E, st);
    else
      launch_reduce<float>(static_cast<const float*>(partial), y, rows,
                           splits, M, N, E, st);
  }
  return cudaSuccess;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Shapes and dtypes are checked
// by the Python wrappers; these only launch on `stream` and return the
// launch's error or cudaGetLastError() so a refused launch is reported. E
// experts with the given per-expert element strides of x, codes, alphas and
// betas (E = 1 and strides 0 for one matrix); y and the partials are
// (E, ...) dense. rows is null (every row live) or an (E,) int32 device
// array.
//
// The GEMV: one launch, K split over the `splits` blocks of a cluster
// (1..8); `vec` says the code planes may be read as 16-byte vectors (N a
// multiple of 4, 16-byte aligned planes and experts).
extern "C" int bcq_gemv_launch(const void* x, const void* codes,
                               const void* alphas, const void* betas,
                               void* y, const void* rows, int M, int KW,
                               int N, int bits, long long plane_stride,
                               int words_per_group, int splits, int vec,
                               int x_bf16, int scale_bf16, int E,
                               long long x_es, long long codes_es,
                               long long alphas_es, long long betas_es,
                               void* stream) {
  if (splits < 1 || splits > kGemvMaxSplits || M < 1 || M > 8 || bits < 1 ||
      bits > kMaxBits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GemvArgs a{};
  a.x = x;
  a.codes = static_cast<const uint32_t*>(codes);
  a.alphas = alphas;
  a.betas = betas;
  a.y = y;
  a.rows = static_cast<const int*>(rows);
  a.M = M;
  a.KW = KW;
  a.N = N;
  a.bits = bits;
  a.plane_stride = plane_stride;
  a.words_per_group = words_per_group;
  a.words_per_split = (KW + splits - 1) / splits;
  a.vec = vec;
  a.scale_bf16 = scale_bf16;
  a.es = ExpertStrides{x_es, codes_es, alphas_es, betas_es};
  const cudaError_t err = x_bf16 ? launch_gemv<__nv_bfloat16>(a, splits, E, st)
                                 : launch_gemv<float>(a, splits, E, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The tensor-core GEMM with a token tile of `tile` rows (a multiple of 8,
// at most 128), `ntiles` tiles along M and `splits` K splits (the
// partials (E, splits, M, N) fp32 are summed by a second pass). xsplit is
// fp32 scratch for the TF32 parts of x: 2 E M K floats (E M K for bf16 x).
extern "C" int bcq_gemm_launch(const void* x, void* xsplit,
                               const void* codes, const void* alphas,
                               const void* betas, void* y, void* partial,
                               const void* rows,
                               int M, int KW, int N, int bits,
                               long long plane_stride, int words_per_group,
                               int tile, int ntiles, int splits, int x_bf16,
                               int scale_bf16, int E, long long x_es,
                               long long codes_es, long long alphas_es,
                               long long betas_es, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ExpertStrides es{x_es, codes_es, alphas_es, betas_es};
  const int* r = static_cast<const int*>(rows);
  if (tile < 8 || tile > kTcMaxTile || tile % 8 || ntiles < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
#define BCQ_TILE_CASE(T)                                                   \
  case T:                                                                  \
    err = launch_tc_gemm<T>(x, static_cast<float*>(xsplit), codes, alphas,  \
                            betas, y, partial, r, M, KW, N, bits,          \
                            plane_stride, words_per_group, ntiles, splits, \
                            x_bf16, scale_bf16, E, es, st);                \
    break;
  switch (tile) {
    BCQ_TILE_CASE(8) BCQ_TILE_CASE(16) BCQ_TILE_CASE(24) BCQ_TILE_CASE(32)
    BCQ_TILE_CASE(40) BCQ_TILE_CASE(48) BCQ_TILE_CASE(56) BCQ_TILE_CASE(64)
    BCQ_TILE_CASE(72) BCQ_TILE_CASE(80) BCQ_TILE_CASE(88) BCQ_TILE_CASE(96)
    BCQ_TILE_CASE(104) BCQ_TILE_CASE(112) BCQ_TILE_CASE(120)
    BCQ_TILE_CASE(128)
  }
#undef BCQ_TILE_CASE
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

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
// What bounds it on the H100: at decode sizes, latency. Each live token's K
// and V vector is read once (2 * hd values, or 2 * (bits * hd / 8 + 4 * G *
// (bits + 1)) bytes binary-coded), ~4 * rep * hd flops a token: a few MB a
// call at most, microseconds of bandwidth, so what costs is how many SMs
// work at once and how long each one's chain of dependent steps is (the
// table row, the K/V rows, the compute, the cluster's merge). The
// design (flash-decoding):
// * The context splits into partitions of kTile tokens. A thread-block
//   cluster of `clusters` blocks (at most 8) serves one (sequence, KV head,
//   group of up to kMaxRep query heads); block p takes partitions t_lo + p,
//   t_lo + p + clusters, ... of the live ones [t_lo, t_hi). The wrapper
//   sizes the cluster so that B * Hkv * head groups * clusters blocks reach
//   every SM with each block's partitions in flight at once (`stages`
//   staged partitions, from the bytes one stage holds): 2 blocks of 3
//   stages at llama2-7b's batch 4 (256 blocks), 6 of 1 at Qwen3-MoE's 4 KV
//   heads (96 blocks, where one block a head gave 16). A partition wholly
//   outside [max(0, ctx - window), ctx) is not visited; pages at or past
//   ctx are never touched.
// * Each block keeps one online-softmax state (max, denominator,
//   accumulator) per query head; the cluster's blocks merge theirs through
//   distributed shared memory in rank order (deterministic), each rank
//   storing its share of the outputs: one launch, no scratch.
// * The block reads its block-table row once into shared memory, then
//   copies its partitions' K and V rows into a ring of `stages` slots by
//   cp.async, all `stages` partitions' copies in flight at once, each slot
//   refilled once its partition no longer needs it. A page reader fills
//   the slot and says what the compute reads:
//   - `FpPages`: the K and V tiles themselves (16-byte copies); a slot is
//     free once its partition is computed.
//   - `QuantPages`: the raw binary-coded rows, three pieces a (token, head)
//     and side: code words, alphas and betas, each row in its own
//     shared-memory stride, copied 16, 8 or 4 bytes at a time (the widest
//     the piece's size and the pool's address allow; the host works out
//     each piece's width and count, so the card divides nothing). After
//     the wait the block expands the slot into one fp32 K/V tile pair (a
//     warp a run of up to 32 entries of one side, a lane a token; each
//     row's scales read once, each entry beta + sum_i +-alpha_i in plane
//     order as `_expand_page` forms it, plane 0 a choice of beta +-
//     alpha_0), and the slot takes its next partition at once, so the
//     copies stay in flight through the compute. A stage is a few KB
//     (7,168 bytes at hd 128, 4-bit, G=1, against the 33,792 of the fp32
//     tile pair). Scale rows wider than PA_QUANT_SCALES_MAX bytes (groups
//     of a few entries at many bits) are not staged: the expansion reads
//     them from the pool.
// * One softmax rescale per partition, not per token: the scores of a
//   partition are a (heads x hd) . (hd x kTile) product (a lane a token,
//   the 8 warps over heads or parts of hd), the softmax a warp a head, and
//   P . V a (heads x kTile) . (kTile x hd) product (a thread 4 adjacent hd
//   entries of its heads, for one group of the partition's tokens), all on
//   the CUDA cores in fp32.
// A table may name the same page many times (inactive rows all point at the
// null page 0); nothing assumes distinct pages.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#if !defined(PA_TILE) || !defined(PA_MAX_CLUSTER) || !defined(PA_MAX_REP) || \
    !defined(PA_MAX_STAGES) || !defined(PA_QUANT_SCALES_MAX)
#error "build with src/repro_torch/kernels/build.py (it passes hw.py's ATTN_* constants)"
#endif
constexpr int kTile = PA_TILE;  // tokens a partition
static_assert(kTile == 32, "a partition's tokens are the lanes of a warp");
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRep = PA_MAX_REP;          // query heads a block at most
constexpr int kMaxCluster = PA_MAX_CLUSTER;  // at most the portable 8
constexpr int kMaxStages = PA_MAX_STAGES;    // partitions a block stages
// bytes of a binary-coded row's alphas and betas staged at most
constexpr int kQuantScalesMax = PA_QUANT_SCALES_MAX;
static_assert(kMaxRep == 16 && kMaxCluster <= 8 && kMaxStages == 4,
              "launch_pages buckets heads up to 16; the waits count to 3");
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
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 4 consecutive tile entries as fp32 (16 bytes fp32, 8 bytes bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 16, 8 or 4 bytes (n, the same for the whole block) global -> shared; ok
// false zero-fills the destination and reads nothing.
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, int n,
                                           bool ok) {
  const uint32_t d = smem_u32(dst);
  if (n == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else if (n == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 8 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements of one tile row in shared memory: hd and 16 bytes of padding, so
// that the lanes' rows start in different banks.
template <typename Elem, int HD>
__host__ __device__ constexpr int tile_row() {
  return HD + 16 / (int)sizeof(Elem);
}

// Where the tokens of the partition starting at token t0 live. The table
// entry and offset of t0 are divided once; token t0 + j is found from them
// with one compare for pages of a partition or more (the main paths'), a
// division only for smaller pages.
struct PartitionRows {
  int t0, j0, ctx, q0, r0, page, Hkv, h;
  const int* bt_s;
  __device__ __forceinline__ PartitionRows(int t0_, int j0_, int ctx_,
                                           const int* bt, int page_,
                                           int Hkv_, int h_)
      : t0(t0_), j0(j0_), ctx(ctx_), q0(t0_ / page_), r0(t0_ % page_),
        page(page_), Hkv(Hkv_), h(h_), bt_s(bt) {}
  // whether token t0 + j lies in [j0, ctx)
  __device__ __forceinline__ bool live(int j) const {
    const int tok = t0 + j;
    return tok >= j0 && tok < ctx;
  }
  // token t0 + j's pool row, or -1 when it is not live
  __device__ __forceinline__ long long row(int j) const {
    if (!live(j)) return -1;
    int e = q0, r = r0 + j;
    if (page >= kTile) {
      if (r >= page) {
        r -= page;
        ++e;
      }
    } else {
      e += r / page;
      r %= page;
    }
    return ((long long)bt_s[e] * page + r) * Hkv + h;
  }
};

// fp pages: a partition's K and V rows copied into the slot's tile pair
// by 16-byte cp.async (tokens outside the window zero-filled, nothing
// read); the compute reads the slot itself.
template <typename T, int HD>
struct FpPages {
  using Elem = T;
  static constexpr int kHd = HD;
  static constexpr bool kExpands = false;
  const T* k;
  const T* v;
  __host__ __device__ int stage_bytes() const {
    return 2 * kTile * tile_row<T, HD>() * (int)sizeof(T);
  }
  __device__ __forceinline__ void stage(uint8_t* slot,
                                        const PartitionRows& rows) const {
    constexpr int kVec = 16 / sizeof(T);   // elements a copy
    constexpr int kCh = HD / kVec;         // copies a row
    constexpr int kRow = tile_row<T, HD>();
    T* sk = reinterpret_cast<T*>(slot);
    T* sv = sk + kTile * kRow;
    for (int i = threadIdx.x; i < 2 * kTile * kCh; i += kThreads) {
      const int side = i / (kTile * kCh), j = (i / kCh) % kTile,
                c = i % kCh;
      const long long row = rows.row(j);
      const T* src = side ? v : k;
      cp_async16((side ? sv : sk) + j * kRow + c * kVec,
                 src + (row < 0 ? 0 : row * HD + c * kVec), row < 0 ? 0 : 16);
    }
  }
};

// Shared-memory stride of a staged piece of `bytes` a row: whole 16-byte
// units (cp.async's alignment), an odd number of them, so that 32 rows'
// words fall at most 4 to a bank.
__host__ __device__ constexpr int staged_row(int bytes) {
  return ((bytes + 15) / 16 + ((bytes + 15) / 16 + 1) % 2) * 16;
}

// Binary-coded pages. A slot holds, for K then V, the partition's 32 code
// rows, alpha rows and beta rows (strides cs, as, bs); `stage` copies them
// by cp.async, a lane a token, the warps over the rows' chunks. `expand`
// turns a slot into the fp32 tile pair the compute reads.
template <int HD>
struct QuantPages {
  using Elem = float;
  static constexpr int kHd = HD;
  static constexpr bool kExpands = true;
  static constexpr int EPL = HD / 32;                   // words a plane
  static constexpr int EU = HD / 4 < 32 ? HD / 4 : 32;  // entries a unit
  static constexpr int kChunks = HD / EU;               // units a side
  const uint32_t *kc, *vc;
  const float *ka, *kb, *va, *vb;
  int bits, G;
  int cs, as, bs;  // staged strides (bytes); as = bs = 0: scales unstaged
  int cw, aw, bw;  // bytes of one copy of codes, alphas, betas
  int cn, an, bn;  // copies of a row's codes, alphas, betas (0: unstaged)

  __host__ __device__ int side_bytes() const { return kTile * (cs + as + bs); }
  __host__ __device__ int stage_bytes() const { return 2 * side_bytes(); }

  __device__ __forceinline__ void stage(uint8_t* slot,
                                        const PartitionRows& rows) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long row = rows.row(lane);
    const bool ok = row >= 0;
    const long long r = ok ? row : 0;
    const int stride[3] = {cs, as, bs};
    const int width[3] = {cw, aw, bw};
    const int count[3] = {cn, an, bn};
    const int at[3] = {0, kTile * cs, kTile * (cs + as)};  // in a side
    int t = warp;  // this warp's next copy, counted over the six pieces
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const int side = s / 3, p = s % 3, n = count[p];
      const void* pool = p == 0   ? (const void*)(side ? vc : kc)
                         : p == 1 ? (const void*)(side ? va : ka)
                                  : (const void*)(side ? vb : kb);
      const uint8_t* src =
          static_cast<const uint8_t*>(pool) + r * (n * width[p]);
      uint8_t* dst = slot + side * side_bytes() + at[p] + lane * stride[p];
      for (; t < n; t += kWarps)
        cp_async_n(dst + t * width[p], src + t * width[p], width[p], ok);
      t -= n;
    }
  }

  // Warp-units (side, run of EU entries) over the slot, a lane a token:
  // the run's words of each plane and its group's scales read once, each
  // entry beta + sum_i +-alpha_i in plane order, stored as float4s. A
  // token outside the window expands to 0: its staged rows are zeros.
  __device__ __forceinline__ void expand(const uint8_t* slot, float* tk,
                                         float* tv,
                                         const PartitionRows& rows) const {
    constexpr int kRow = tile_row<float, HD>();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const bool live = rows.live(lane);
    const int sh = __ffs(HD / G) - 1;  // log2 of the group size
    for (int u = warp; u < 2 * kChunks; u += kWarps) {
      const int side = u / kChunks, first = (u % kChunks) * EU;
      const uint8_t* base = slot + side * side_bytes();
      const uint32_t* code =
          reinterpret_cast<const uint32_t*>(base + lane * cs) + (first >> 5);
      const float *al, *be;
      if (as) {
        al = reinterpret_cast<const float*>(base + kTile * cs + lane * as);
        be = reinterpret_cast<const float*>(base + kTile * (cs + as) +
                                            lane * bs);
      } else {  // scale rows too wide to stage: read from the pool
        const long long r = live ? rows.row(lane) : 0;
        al = (side ? va : ka) + r * G * bits;
        be = (side ? vb : kb) + r * G;
      }
      float x[EU];
      if ((first >> sh) == ((first + EU - 1) >> sh)) {  // one scale group
        const int g = first >> sh;
        // plane 0 picks beta + alpha_0 or beta - alpha_0, the sum the
        // entry forms first
        const float b = be[g], a0 = al[g * bits];
        const float bp = b + a0, bm = b + -a0;
        const uint32_t w0 = code[0] >> (first & 31);
#pragma unroll
        for (int e = 0; e < EU; ++e) x[e] = ((w0 >> e) & 1u) ? bp : bm;
        for (int i = 1; i < bits; ++i) {
          const uint32_t w = code[i * EPL] >> (first & 31);
          const float a = al[g * bits + i];
#pragma unroll
          for (int e = 0; e < EU; ++e) x[e] += ((w >> e) & 1u) ? a : -a;
        }
      } else {
#pragma unroll
        for (int e = 0; e < EU; ++e) x[e] = be[(first + e) >> sh];
        for (int i = 0; i < bits; ++i) {
          const uint32_t w = code[i * EPL] >> (first & 31);
#pragma unroll
          for (int e = 0; e < EU; ++e) {
            const float a = al[((first + e) >> sh) * bits + i];
            x[e] += ((w >> e) & 1u) ? a : -a;
          }
        }
      }
      if (!as && !live) {  // the pool's row 0 was read in its place
#pragma unroll
        for (int e = 0; e < EU; ++e) x[e] = 0.f;
      }
      float* dst = (side ? tv : tk) + lane * kRow + first;
#pragma unroll
      for (int e = 0; e < EU; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }
};

// Shared memory of one block (floats unless said): the block-table row
// (n_table ints), the ring of `stages` slots (the page reader's
// stage_bytes each), binary-coded pages' expanded K/V tile pair, q (REP x
// HD), the score parts (DP x REP x kTile), P ([kTile][REP]), the running
// max, denominator and correction (REP each, in 4 REP floats to keep
// 16-byte alignment), and the state the cluster reads (REP x HD).
template <typename Elem, int HD, int REP>
struct PaCfg {
  static constexpr int kRow = tile_row<Elem, HD>();
  static constexpr int kTileBytes = kTile * kRow * (int)sizeof(Elem);
  // scores: warps over NRG row groups of RS heads and DP parts of hd
  static constexpr int NRG = REP < kWarps ? REP : kWarps;
  static constexpr int RS = REP / NRG;
  static constexpr int DP = kWarps / NRG;
  static constexpr int DPL = HD / DP;
  // P . V: a thread holds 4 adjacent entries (d-chunk) of RT heads, for
  // one of JG groups of the partition's tokens
  static constexpr int NDC = HD / 4;
  static constexpr int F = kThreads / NDC;
  static constexpr int RG = REP < F ? REP : F;
  static constexpr int RT = REP / RG;
  static constexpr int JG = F / RG;
  static constexpr int JPT = kTile / JG;
  static_assert(NDC * F == kThreads && RG * RT == REP && JG * JPT == kTile,
                "thread mapping");
  static_assert(DP * kTile >= 2 * kMaxCluster + 1,
                "the merge reuses the score parts for the ranks' states");
  static constexpr int kFloats =
      REP * HD + DP * REP * kTile + kTile * REP + 4 * REP + REP * HD;
  static int bytes(int n_table, int stages, int stage_bytes, bool expands) {
    return ((n_table * 4 + 15) / 16) * 16 + stages * stage_bytes +
           (expands ? 2 * kTileBytes : 0) + 4 * kFloats;
  }
};

// grid (clusters, Hkv * head groups, B), clusters along x; kThreads threads.
template <typename TQ, typename Pages, int REP>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const TQ* __restrict__ q, const Pages pages,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ ctx_lens,
                           TQ* __restrict__ out, int Hkv, int rep, int page,
                           int n_table, float scale, int window, float cap,
                           int stages) {
  using Elem = typename Pages::Elem;
  constexpr int HD = Pages::kHd;
  using C = PaCfg<Elem, HD, REP>;
  cg::cluster_group cluster = cg::this_cluster();
  const int prank = blockIdx.x;
  const int NP = gridDim.x;
  const int groups = gridDim.y / Hkv;
  const int h = blockIdx.y / groups;
  const int r0 = (blockIdx.y % groups) * REP;  // first query head
  const int nrep = min(REP, rep - r0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int ctx_raw = ctx_lens[b];
  const int ctx = min(ctx_raw, n_table * page);
  const int j0 = window > 0 ? max(0, ctx_raw - window) : 0;
  // live partitions [t_lo, t_hi); this block's: t_lo + prank + i * NP
  const int t_lo = j0 / kTile, t_hi = (ctx + kTile - 1) / kTile;
  const int first = t_lo + prank;
  const int ntiles = first < t_hi ? (t_hi - first + NP - 1) / NP : 0;
  const long long qo = ((long long)b * Hkv + h) * rep + r0;  // first q row

  extern __shared__ float4 pa_smem4[];
  int* bt_s = reinterpret_cast<int*>(pa_smem4);
  const int sb = pages.stage_bytes();
  uint8_t* ring =
      reinterpret_cast<uint8_t*>(pa_smem4) + ((n_table * 4 + 15) / 16) * 16;
  float* xt = reinterpret_cast<float*>(ring + stages * sb);  // expanded K/V
  float* q_s = xt + (Pages::kExpands ? 2 * kTile * C::kRow : 0);
  float* s_part = q_s + REP * HD;
  float* p_s = s_part + C::DP * REP * kTile;
  float* m_s = p_s + kTile * REP;
  float* l_s = m_s + REP;
  float* corr_s = l_s + REP;
  float* acc_s = m_s + 4 * REP;

  // the sequence's block-table row (read beside its context length, not
  // after it: the entries past the context name valid pages too), q, and
  // the empty states
  const int* bt = block_tables + (long long)b * n_table;
  for (int e = tid; e < n_table; e += kThreads) bt_s[e] = bt[e];
  for (int i = tid; i < REP * HD; i += kThreads)
    q_s[i] = i / HD < nrep ? to_f32(q[qo * HD + i]) : 0.f;
  for (int r = tid; r < REP; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  auto issue = [&](int it) {
    pages.stage(ring + (it % stages) * sb,
                PartitionRows((first + it * NP) * kTile, j0, ctx, bt_s, page,
                              Hkv, h));
    cp_async_commit();
  };

  // this thread's P . V share: d-chunk dc, heads rg * RT .., tokens of group jg
  const int dc = tid % C::NDC, rg = (tid / C::NDC) % C::RG,
            jg = tid / C::NDC / C::RG;
  float acc[C::RT][4];
#pragma unroll
  for (int i = 0; i < C::RT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // the first `stages` partitions' loads all in flight at once; partition
  // it + stages refills the slot of partition it once that is free
  for (int it = 0; it < min(stages, ntiles); ++it) issue(it);
  for (int it = 0; it < ntiles; ++it) {
    switch (min(stages, ntiles - it) - 1) {  // newer loads that may pend
      case 0: cp_async_wait<0>(); break;
      case 1: cp_async_wait<1>(); break;
      case 2: cp_async_wait<2>(); break;
      default: cp_async_wait<3>(); break;
    }
    __syncthreads();
    const uint8_t* slot = ring + (it % stages) * sb;
    const int t0 = (first + it * NP) * kTile;
    const Elem* sk = reinterpret_cast<const Elem*>(slot);
    if constexpr (Pages::kExpands) {
      pages.expand(slot, xt, xt + kTile * C::kRow,
                   PartitionRows(t0, j0, ctx, bt_s, page, Hkv, h));
      __syncthreads();
      // the raw rows are expanded: their slot takes partition it + stages
      if (it + stages < ntiles) issue(it + stages);
      sk = xt;
    }
    const Elem* sv = sk + kTile * C::kRow;

    {  // scores: lane = token, warp = (row group, hd part)
      const int grp = warp % C::NRG, dp = warp / C::NRG;
      const Elem* kr = sk + lane * C::kRow + dp * C::DPL;
      const float* qr = q_s + grp * C::RS * HD + dp * C::DPL;
      float s[C::RS];
#pragma unroll
      for (int i = 0; i < C::RS; ++i) s[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < C::DPL; d += 4) {
        const float4 kv = load4(kr + d);
#pragma unroll
        for (int i = 0; i < C::RS; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + i * HD + d);
          s[i] = fmaf(qv.x, kv.x, s[i]);
          s[i] = fmaf(qv.y, kv.y, s[i]);
          s[i] = fmaf(qv.z, kv.z, s[i]);
          s[i] = fmaf(qv.w, kv.w, s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < C::RS; ++i)
        s_part[(dp * REP + grp * C::RS + i) * kTile + lane] = s[i];
    }
    __syncthreads();

    // softmax of the partition, a warp a head: one rescale per partition
    for (int r = warp; r < REP; r += kWarps) {
      float sc = 0.f;
#pragma unroll
      for (int dp = 0; dp < C::DP; ++dp)
        sc += s_part[(dp * REP + r) * kTile + lane];
      sc *= scale;
      if (cap > 0.f) sc = cap * tanhf(sc / cap);
      const int j = t0 + lane;
      const bool ok = j >= j0 && j < ctx;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(ok ? sc : kNegInf));
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float psum = warp_sum(p);
      p_s[lane * REP + r] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    {  // acc = acc * corr + P . V
#pragma unroll
      for (int i = 0; i < C::RT; ++i) {
        const float c = corr_s[rg * C::RT + i];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= c;
      }
#pragma unroll 4
      for (int jj = 0; jj < C::JPT; ++jj) {
        const int j = jg * C::JPT + jj;
        const float4 vv = load4(sv + j * C::kRow + dc * 4);
#pragma unroll
        for (int i = 0; i < C::RT; ++i) {
          const float p = p_s[j * REP + rg * C::RT + i];
          acc[i][0] = fmaf(p, vv.x, acc[i][0]);
          acc[i][1] = fmaf(p, vv.y, acc[i][1]);
          acc[i][2] = fmaf(p, vv.z, acc[i][2]);
          acc[i][3] = fmaf(p, vv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // fp: the slot is free for partition it + stages
    if constexpr (!Pages::kExpands)
      if (it + stages < ntiles) issue(it + stages);
  }

  // the block's state: the token groups' accumulators added in group order
  // (through the free tile pair), then the cluster's merge in rank order
  float* dst = C::JG == 1           ? acc_s
               : Pages::kExpands ? xt
                                 : reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < C::RT; ++i)
    *reinterpret_cast<float4*>(dst + ((jg * REP) + rg * C::RT + i) * HD +
                               dc * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (C::JG > 1) {
    __syncthreads();
    for (int i = tid; i < REP * HD; i += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < C::JG; ++g) s += dst[g * REP * HD + i];
      acc_s[i] = s;
    }
  }
  cluster.sync();
  // every rank's max and denominator, read once (into the free score
  // parts): rank p's weight of head r is exp(m_p - max_p m_p)
  float* w_s = s_part;                 // [p][r]
  float* l_all = s_part + kMaxCluster * REP;
  float* l_sum = l_all + kMaxCluster * REP;
  for (int i = tid; i < NP * REP; i += kThreads) {
    w_s[i] = cluster.map_shared_rank(m_s, i / REP)[i % REP];
    l_all[i] = cluster.map_shared_rank(l_s, i / REP)[i % REP];
  }
  __syncthreads();
  for (int r = tid; r < REP; r += kThreads) {
    float mx = kNegInf;
    for (int p = 0; p < NP; ++p) mx = fmaxf(mx, w_s[p * REP + r]);
    float l = 0.f;
    for (int p = 0; p < NP; ++p) {
      const float f = expf(w_s[p * REP + r] - mx);
      w_s[p * REP + r] = f;
      l += l_all[p * REP + r] * f;
    }
    l_sum[r] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const int total = nrep * HD;
  const int per = (total + NP - 1) / NP;
  const int hi = min(total, (prank + 1) * per);
  for (int i = prank * per + tid; i < hi; i += kThreads) {
    const int r = i / HD;
    float a[kMaxCluster];
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p)  // the ranks' loads in flight together
      a[p] = p < NP ? cluster.map_shared_rank(acc_s, p)[i] : 0.f;
    float o = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p)
      if (p < NP) o += a[p] * w_s[p * REP + r];
    out[qo * HD + i] = from_f32<TQ>(o / l_sum[r]);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Query heads a block: the smallest power of two that holds `rep`, at most
// kMaxRep (wider groups take several blocks, each reading the K/V).
int rep_bucket(int rep) {
  int r = 1;
  while (r < rep && r < kMaxRep) r *= 2;
  return r;
}

struct Geometry {
  int B, Hkv, rep, page, n_table, window, clusters, stages;
  float scale, cap;
};

template <typename TQ, typename Pages, int REP>
cudaError_t launch_rep(const TQ* q, const Pages& pages, const int* bt,
                       const int* ctx, TQ* out, const Geometry& g,
                       cudaStream_t st) {
  const int smem = PaCfg<typename Pages::Elem, Pages::kHd, REP>::bytes(
      g.n_table, g.stages, pages.stage_bytes(), Pages::kExpands);
  auto kern = paged_attention_kernel<TQ, Pages, REP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // all shared memory, no L1 preference: the tiles are the cache
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.clusters, g.Hkv * ((g.rep + REP - 1) / REP), g.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, q, pages, bt, ctx, out, g.Hkv, g.rep,
                            g.page, g.n_table, g.scale, g.window, g.cap,
                            g.stages);
}

template <typename TQ, typename Pages>
cudaError_t launch_pages(const void* q, const Pages& pages, const int* bt,
                         const int* ctx, void* out, const Geometry& g,
                         cudaStream_t st) {
  const TQ* qt = static_cast<const TQ*>(q);
  TQ* ot = static_cast<TQ*>(out);
  switch (rep_bucket(g.rep)) {
    case 1: return launch_rep<TQ, Pages, 1>(qt, pages, bt, ctx, ot, g, st);
    case 2: return launch_rep<TQ, Pages, 2>(qt, pages, bt, ctx, ot, g, st);
    case 4: return launch_rep<TQ, Pages, 4>(qt, pages, bt, ctx, ot, g, st);
    case 8: return launch_rep<TQ, Pages, 8>(qt, pages, bt, ctx, ot, g, st);
    default:
      return launch_rep<TQ, Pages, 16>(qt, pages, bt, ctx, ot, g, st);
  }
}

template <typename TQ, int HD>
FpPages<TQ, HD> fp_pages(const void* k, const void* v) {
  return FpPages<TQ, HD>{static_cast<const TQ*>(k), static_cast<const TQ*>(v)};
}

template <typename TQ>
cudaError_t launch_fp(int hd, const void* q, const void* k, const void* v,
                      const int* bt, const int* ctx, void* out,
                      const Geometry& g, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_pages<TQ>(q, fp_pages<TQ, 32>(k, v), bt, ctx, out, g, st);
    case 64: return launch_pages<TQ>(q, fp_pages<TQ, 64>(k, v), bt, ctx, out, g, st);
    case 128: return launch_pages<TQ>(q, fp_pages<TQ, 128>(k, v), bt, ctx, out, g, st);
    case 256: return launch_pages<TQ>(q, fp_pages<TQ, 256>(k, v), bt, ctx, out, g, st);
  }
  return cudaErrorInvalidValue;
}

// Bytes of one cp.async copy of a piece of `bytes` a row in the pools at a
// and b: 16, 8 or 4, the widest that divides the size and both addresses.
int copy_width(int bytes, const void* a, const void* b) {
  const uintptr_t m = reinterpret_cast<uintptr_t>(a) |
                      reinterpret_cast<uintptr_t>(b) | (uintptr_t)bytes;
  return m % 16 == 0 ? 16 : m % 8 == 0 ? 8 : 4;
}

// The reader of binary-coded pools and its stage layout (staged_row
// strides; scales staged when a row's alphas and betas take at most
// kQuantScalesMax bytes).
template <int HD>
QuantPages<HD> quant_pages(const void* kc, const void* ka, const void* kb,
                           const void* vc, const void* va, const void* vb,
                           int bits, int G) {
  const int cb = bits * HD / 8, ab = 4 * G * bits, bb = 4 * G;
  const bool scales = ab + bb <= kQuantScalesMax;
  const int cw = copy_width(cb, kc, vc), aw = copy_width(ab, ka, va),
            bw = copy_width(bb, kb, vb);
  return QuantPages<HD>{static_cast<const uint32_t*>(kc),
                        static_cast<const uint32_t*>(vc),
                        static_cast<const float*>(ka),
                        static_cast<const float*>(kb),
                        static_cast<const float*>(va),
                        static_cast<const float*>(vb),
                        bits,
                        G,
                        staged_row(cb),
                        scales ? staged_row(ab) : 0,
                        scales ? staged_row(bb) : 0,
                        cw,
                        aw,
                        bw,
                        cb / cw,
                        scales ? ab / aw : 0,
                        scales ? bb / bw : 0};
}

template <typename TQ>
cudaError_t launch_quant(int hd, const void* q, const void* kc,
                         const void* ka, const void* kb, const void* vc,
                         const void* va, const void* vb, int bits, int G,
                         const int* bt, const int* ctx, void* out,
                         const Geometry& g, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_pages<TQ>(q, quant_pages<32>(kc, ka, kb, vc, va, vb, bits, G), bt, ctx, out, g, st);
    case 64: return launch_pages<TQ>(q, quant_pages<64>(kc, ka, kb, vc, va, vb, bits, G), bt, ctx, out, g, st);
    case 128: return launch_pages<TQ>(q, quant_pages<128>(kc, ka, kb, vc, va, vb, bits, G), bt, ctx, out, g, st);
    case 256: return launch_pages<TQ>(q, quant_pages<256>(kc, ka, kb, vc, va, vb, bits, G), bt, ctx, out, g, st);
  }
  return cudaErrorInvalidValue;
}

int finish(cudaError_t err) {
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool geometry_ok(const Geometry& g) {
  return g.clusters >= 1 && g.clusters <= kMaxCluster && g.stages >= 1 &&
         g.stages <= kMaxStages;
}

}  // namespace

// Plain C entry points (loaded with ctypes); the Python wrappers check
// shapes, dtypes, hd in {32, 64, 128, 256} and (binary-coded) bits <= 8
// and G dividing hd, and choose `clusters` (blocks splitting a context,
// 1..8) and `stages` (partitions a block stages, 1..4: those whose loads
// are in flight at once). window <= 0 and cap <= 0 mean "none". Each
// returns the launch's error or cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* ctx_lens, void* out, int B,
                                      int Hkv, int rep, int hd, int page,
                                      int n_table, int clusters, int stages,
                                      float scale, int window, float cap,
                                      int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(ctx_lens);
  const Geometry g{B, Hkv, rep, page, n_table, window, clusters, stages,
                   scale, cap};
  if (!geometry_ok(g)) return (int)cudaErrorInvalidValue;
  return finish(bf16 ? launch_fp<__nv_bfloat16>(hd, q, k_pages, v_pages, bt,
                                                cl, out, g, st)
                     : launch_fp<float>(hd, q, k_pages, v_pages, bt, cl, out,
                                        g, st));
}

extern "C" int paged_attention_quant_launch(
    const void* q, const void* k_codes, const void* k_alphas,
    const void* k_betas, const void* v_codes, const void* v_alphas,
    const void* v_betas, const void* block_tables, const void* ctx_lens,
    void* out, int B, int Hkv, int rep, int hd, int page, int n_table,
    int clusters, int stages, int bits, int G, float scale, int window,
    float cap, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(ctx_lens);
  const Geometry g{B, Hkv, rep, page, n_table, window, clusters, stages,
                   scale, cap};
  if (!geometry_ok(g)) return (int)cudaErrorInvalidValue;
  return finish(bf16 ? launch_quant<__nv_bfloat16>(
                           hd, q, k_codes, k_alphas, k_betas, v_codes,
                           v_alphas, v_betas, bits, G, bt, cl, out, g, st)
                     : launch_quant<float>(hd, q, k_codes, k_alphas, k_betas,
                                           v_codes, v_alphas, v_betas, bits,
                                           G, bt, cl, out, g, st));
}

// Tensor-core attention body (bf16, hd 64 or 128) for Hopper (sm_90a): the
// paged and dense chunked-prefill kernels, and the paged and dense
// chunk-verify and tree-verify kernels.
//
// Replaces, with the FMA body of paged_attention.cuh that fp32 and other
// head dims keep, the TPU kernels repro/kernels/prefill_attention.py
// `prefill_attention` and repro/kernels/paged_prefill_attention.py
// `paged_prefill_attention` (one Pallas body, `_prefill_kernel`),
// repro/kernels/paged_verify_attention.py `paged_verify_attention` and
// repro/kernels/paged_tree_verify_attention.py `paged_tree_verify_attention`
// (see verify_tc.cuh), and repro/kernels/verify_attention.py
// `verify_attention` and repro/kernels/tree_verify_attention.py
// `tree_verify_attention` (see verify_attention.cu).  Chunk row t of slot b
// attends the keys its visibility policy shows it (`CausalVis`: kpos <=
// start + t; `TreeVis`: the prefix kpos < start and the tree nodes of its
// ancestor mask), cut at kend; rows t >= clen and rows that see no key give
// exact zeros, never the mean of V.
//
// One CTA, one warpgroup of 128 threads, per (q tile of 64 rows, kv head,
// slot) -- and, for verify, per split of the slot's KV tiles.  The C * group
// rows of a kv head are numbered as in attend_block: row R is chunk row
// t = R / group of q head head * group + R % group, so a tile holds
// 64 / group chunk rows of every query head of the group (C = 32 at group 2
// is one tile; group 7 needs ceil(7 C / 64)).  Rows t >= clen load zero Q
// and store zeros; rows past C * group are never stored.
//
// What bounds it: at serving chunk sizes the bytes of the K / V rows a
// tile needs (each row read once per CTA; 64 rows of a kv head share it),
// and the latency of fetching them, since one CTA walks its tiles one after
// another.  The design:
//   * S = Q K^T and O += P V on the tensor cores (`wgmma` m64n64k16 from
//     shared memory; P rounded to bf16 as the register A operand of
//     m64n{hd}k16), fp32 accumulators and the online softmax in registers
//     (quad shuffles, exp2 with log2(e) folded into the scale);
//   * 64-key tiles (four 16-row pages, or 64 dense rows) up to the tile's
//     visibility bound, cut at kend, gathered row by row through the
//     address policy with 16-byte `cp.async` copies into the 128-byte
//     swizzled layout the `wgmma` descriptors read; rows past the bound are
//     zero-filled, not read.  `paged::PagedKV` first stages the CTA's
//     block-table entries in shared memory, so no dependent global load
//     stands between a tile and its copies;
//   * a kStages-deep ring: each tile's copies are issued before the math of
//     the tile ahead of it, so one tile's fetch overlaps another's math;
//   * three epilogues: normalised bf16 rows (`RowsOut`, the chunked
//     prefill, which walks every tile of its slot in one CTA); a split's
//     unnormalised fp32 state for `paged::combine_splits` (`SplitOut`, the
//     paged verify, whose CTAs each take a range of the slot's tiles and
//     whose combine is a second launch); or a split's state left in shared
//     memory for its thread-block cluster to merge through distributed
//     shared memory in the same launch (`ClusterOut`, the dense verify:
//     the cluster's CTAs are the slot's splits, so neither a second launch
//     nor fp32 partials in device memory stand between the walk and the
//     output).
// The chunked prefill does not split: the longest slot paces its launch, but
// at serving chunk sizes (8 tiles at max_seq 512) a split's second launch
// and fp32 partials would cost about what it saves.  No TMA: a page is 16
// rows behind a table entry, and tensor maps would be encoded on the host
// per call.
#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "paged_attention.cuh"

namespace prefill_tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // q rows per CTA: one wgmma m64 tile
constexpr int kKeys = 64;      // keys per KV tile
constexpr int kStages = 2;     // depth of the K / V ring
constexpr int kAllTiles = 1 << 30;  // a tile range's end that cuts nothing
constexpr float kLog2e = 1.4426950408889634f;

// Shared layout (byte offsets from a 1024-aligned base): the Q tile,
// kStages K tiles and kStages V tiles, then the CTA's block-table entries
// (PagedKV; `table_bytes` of them).  A [64, HD] tile is HD / 64 halves of
// [64, 64] bf16: 128-byte rows, swizzled in 1024-byte atoms of 8 rows
// (16-byte chunk c of row r at chunk c ^ (r & 7)).  The epilogue stages the
// output tile where Q was.  hd 128 takes 81 KB, hd 64 41 KB, plus the table.
template <int HD>
struct Smem {
  static constexpr int kHalf = kRows * 128;  // bytes of one 64-column half
  static constexpr int kTile = kHalf * (HD / 64);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kTable = kV + kStages * kTile;
  static size_t bytes(size_t table_bytes) {
    return kTable + table_bytes + 1024;  // + alignment slack
  }
};

// Byte offset of 16-byte chunk ch of row r in a swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return (ch / 8) * (kRows * 128) + r * 128 + (((ch % 8) ^ (r & 7)) << 4);
}

// d (64 x HD) += a (64 x 16, registers) b (16 x HD, MN-major in shared memory).
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (HD == 128) {
    hop::wgmma_rs_m64n128k16(d, a, desc_b, 1);
  } else {
    hop::wgmma_rs_m64n64k16(d, a, desc_b, 1);
  }
}

// Visibility policies.  Each names the end of a q tile's walk (one past the
// last key a real row t_first .. t_last of it sees), the first key at which
// some row of the tile needs the mask, and -- per thread, for its two rows
// t0 / t1 of the wgmma accumulator layout -- which keys are hidden.

// Chunk row t sees kpos <= start + t.
struct CausalVis {
  int lim[2];  // the thread's two rows see kpos < lim
  __device__ int end(int start, int t_last, int clen, int kend) const {
    return min(start + min(t_last + 1, clen), kend);
  }
  __device__ int mask_from(int start, int t_first, int kend) const {
    return min(start + t_first + 1, kend);
  }
  __device__ void rows(int start, int t0, int t1, int, int kend) {
    lim[0] = min(start + t0 + 1, kend);
    lim[1] = min(start + t1 + 1, kend);
  }
  __device__ bool hidden(int h, int kpos) const { return kpos >= lim[h]; }
};

// Row t (a packed-tree node; clen = N <= 31) sees the committed prefix
// kpos < start and node j = kpos - start (0 <= j < N) when bit j of anc[t]
// is set.  A chain's masks show each row the keys CausalVis shows it.
struct TreeVis {
  const int* anc;  // the slot's [N] ancestor bitmasks
  int start, end_;
  uint32_t bits[2];  // the thread's two rows' masks (0 for padding rows)
  __device__ int end(int s, int, int clen, int kend) const { return min(s + clen, kend); }
  __device__ int mask_from(int s, int, int kend) const { return min(s, kend); }
  __device__ void rows(int s, int t0, int t1, int clen, int kend) {
    start = s;
    end_ = min(s + clen, kend);
    bits[0] = t0 < clen ? (uint32_t)__ldg(anc + t0) : 0u;
    bits[1] = t1 < clen ? (uint32_t)__ldg(anc + t1) : 0u;
  }
  __device__ bool hidden(int h, int kpos) const {
    const int j = kpos - start;  // < N <= 31 wherever kpos < end_
    return kpos >= end_ || (j >= 0 && !((bits[h] >> min(j, 31)) & 1u));
  }
};

// Output policies.  RowsOut: the normalised bf16 rows into the slot's
// [C, H, HD] output.  SplitOut: one split's unnormalised state in the layout
// `paged::combine_splits` reads -- row R of this (slot, split, kv head) at
// acc + R * HD (fp32 O) and ml + 2 R (m in units of the scaled score, as
// the FMA body writes it, and l).  ClusterOut: one split of a thread-block
// cluster whose CTA of rank r holds split r; the splits merge through
// distributed shared memory into the slot's normalised bf16 [C, H, HD] rows.
struct RowsOut {
  bf16* out;
};
struct SplitOut {
  float* acc;
  float* ml;
};
struct ClusterOut {
  bf16* out;
  int rank;  // this CTA's rank in the cluster: its split
  int size;  // CTAs of the cluster (<= kMaxCluster)
};
constexpr int kMaxCluster = 8;  // the portable limit of a cluster's CTAs

// ClusterOut's shared layout, over the K / V ring once the walk is done: the
// split's fp32 O of the 64 rows (rows padded to HD + 8 floats, so a warp's
// fragment stores hit every bank once per 128 bytes), then (m, l) per row.
template <int HD>
struct MergeSmem {
  static constexpr int kLd = HD + 8;
  static constexpr int kO = Smem<HD>::kK;
  static constexpr int kML = kO + kRows * kLd * 4;
  static_assert(kML + kRows * 8 <= Smem<HD>::kTable, "merge state exceeds the K / V ring");
};

// One CTA's q tile qt of kv head `head` for one slot, over the slot's KV
// tiles tile_lo .. tile_hi - 1 that its visibility bound reaches: q is the
// slot's [C, H, HD]; kv names the slot's K / V rows (`page` is the pool's
// page size, unused by DenseKV).  A CTA whose range holds no such tile
// loads nothing: under SplitOut it writes (m, l) = (-inf, 0) for its rows
// and returns; under ClusterOut it must join its cluster's barriers, so it
// goes on to the merge with (m, l, O) = (-inf, 0, 0).
template <int HD, typename KV, typename Vis, typename Out>
__device__ void attend_tile(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                            const bf16* __restrict__ v_pool, KV kv, Vis vis, int page,
                            int start, int clen, int C, int H, int kvh, int head, int qt,
                            int tile_lo, int tile_hi, float scale, Out out) {
  constexpr bool kSplit = std::is_same<Out, SplitOut>::value;
  constexpr bool kCluster = std::is_same<Out, ClusterOut>::value;
  using L = Smem<HD>;
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hop::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const int tid = threadIdx.x, lane = tid % 32;
  const int group = H / kvh, rows = C * group;
  const int R0 = qt * kRows;
  const int t_first = R0 / group, t_last = (min(R0 + kRows, rows) - 1) / group;
  // one past the last key a real row of the tile sees
  const int kmax = t_first < clen ? vis.end(start, t_last, clen, kv.kend) : 0;
  const int nk = kmax > 0 ? (kmax + kKeys - 1) / kKeys : 0;
  const int j_lo = tile_lo, j_hi = min(tile_hi, nk);  // this CTA's tiles
  if constexpr (kSplit) {
    if (j_lo >= j_hi) {
      for (int R = R0 + tid; R < min(R0 + kRows, rows); R += kThreads) {
        out.ml[2 * R] = -INFINITY;
        out.ml[2 * R + 1] = 0.f;
      }
      return;
    }
  }
  // keys at or past this need the mask in some row of the tile
  const int mask_from = vis.mask_from(start, t_first, kv.kend);
  const size_t row_stride = (size_t)kvh * HD;

  if (j_lo < j_hi) {  // the tile's real Q rows; padding rows are zeros
    for (int i = tid; i < kRows * CH; i += kThreads) {
      const int r = i / CH, ch = i % CH, R = R0 + r, t = R / group;
      const bool real = t < clen;
      const bf16* src = real ? q + ((size_t)t * H + head * group + R % group) * HD + ch * 8 : q;
      hop::cp_async16(sQ + swz(r, ch), src, real ? 16 : 0);
    }
  }
  // the block-table entries the walk reads, once, while Q lands: a table
  // load per tile would sit between the tile's copies and their issue
  kv.stage(reinterpret_cast<int*>(gbase + L::kTable), j_lo * kKeys,
           min(j_hi * kKeys, kmax), page);
  __syncthreads();
  // K / V rows j * 64 .. j * 64 + 63 of this kv head into stage s; rows
  // past kmax are zeros.  A thread copies 16-byte chunk kc of NR rows,
  // tid / CH + n * (kThreads / CH).  Every address comes first, without a
  // branch: the copies' asm is a compiler barrier, and one warpgroup per SM
  // hides no latency, so the rows' table reads and address arithmetic
  // must overlap each other.  A row past kmax takes row kmax - 1's address
  // and copies nothing from it.
  constexpr int NR = kKeys * CH / kThreads;
  const int kc = tid % CH;
  auto load_kv = [&](int j, int s) {
    const uint32_t dk = sK + s * L::kTile, dv = sV + s * L::kTile;
    size_t off[NR];
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      const int kpos = min(j * kKeys + tid / CH + n * (kThreads / CH), kmax - 1);
      off[n] = kv.row(kpos, page, row_stride) + (size_t)head * HD + kc * 8;
    }
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      const int r = tid / CH + n * (kThreads / CH);
      const int bytes = j * kKeys + r < kmax ? 16 : 0;
      hop::cp_async16(dk + swz(r, kc), k_pool + off[n], bytes);
      hop::cp_async16(dv + swz(r, kc), v_pool + off[n], bytes);
    }
  };
  for (int i = 0; i < kStages - 1; ++i) {  // group i: tile j_lo + i (group 0 also Q)
    if (j_lo + i < j_hi) load_kv(j_lo + i, i);
    hop::cp_async_commit();
  }

  // wgmma accumulator layout: register 4 i + e holds row r0 + 8 (e / 2),
  // column 8 i + 2 (lane % 4) + e % 2
  const int r0 = 16 * (tid / 32) + lane / 4;
  vis.rows(start, (R0 + r0) / group, (R0 + r0 + 8) / group, clen, kv.kend);
  const float sl2 = scale * kLog2e;
  float o[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int s = (j - j_lo) % kStages, jn = j + kStages - 1, k0 = j * kKeys;
    if (jn < j_hi) load_kv(jn, (jn - j_lo) % kStages);
    hop::cp_async_commit();
    hop::cp_async_wait<kStages - 1>();  // tile j (and Q) landed for this thread
    hop::fence_proxy_async();
    __syncthreads();
    const uint32_t tk = sK + s * L::kTile, tv = sV + s * L::kTile;

    // S = Q K^T (64 x 64), both operands K-major in shared memory
    float sc[kKeys / 2];
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kHalf + (kk % 4) * 32;
      hop::wgmma_ss_m64n64k16(sc, hop::make_desc(sQ + off, 16, 1024),
                              hop::make_desc(tk + off, 16, 1024), kk > 0);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);

    // the mask, only on tiles that reach some row's first hidden key
    // (zero-filled keys past kmax are hidden from every real row)
    if (k0 + kKeys > mask_from) {
#pragma unroll
      for (int x = 0; x < kKeys / 8; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (vis.hidden(e / 2, k0 + 8 * x + 2 * (lane % 4) + (e & 1))) sc[4 * x + e] = -INFINITY;
    }

    // online softmax in registers: a row lives in the 4 threads of a quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int x = 0; x < kKeys / 8; ++x) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * x], sc[4 * x + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * x + 2], sc[4 * x + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // a row that has seen no key keeps m = -inf: subtract 0, not -inf (no NaN)
    const float b0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
    const float b1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
    const float c0 = exp2f(m0 * sl2 - b0), c1 = exp2f(m1 * sl2 - b1);
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int x = 0; x < kKeys / 8; ++x) {
      sc[4 * x] = exp2f(fmaf(sc[4 * x], sl2, -b0));
      sc[4 * x + 1] = exp2f(fmaf(sc[4 * x + 1], sl2, -b0));
      sc[4 * x + 2] = exp2f(fmaf(sc[4 * x + 2], sl2, -b1));
      sc[4 * x + 3] = exp2f(fmaf(sc[4 * x + 3], sl2, -b1));
      ls0 += sc[4 * x] + sc[4 * x + 1];
      ls1 += sc[4 * x + 2] + sc[4 * x + 3];
    }
    l0 = l0 * c0 + ls0;  // per-thread partial sums; the quad adds them at the end
    l1 = l1 * c1 + ls1;
#pragma unroll
    for (int x = 0; x < HD / 8; ++x) {
      o[4 * x] *= c0;
      o[4 * x + 1] *= c0;
      o[4 * x + 2] *= c1;
      o[4 * x + 3] *= c1;
    }
    // P rounded to bf16 as the A operand: the accumulator layout of columns
    // 16 kk .. 16 kk + 15 is the register-A layout of k-step kk
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = hop::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // O += P V: V [keys, HD] is MN-major for this product
    hop::fence_regs(o);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_pv<HD>(o, pa[kk], hop::make_desc(tv + kk * 16 * 128, L::kHalf, 1024));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
    __syncthreads();  // stage s is free for the copies of tile j + kStages
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if constexpr (kSplit) {
    // ---- epilogue: the split's O, m and l of the real rows, fp32 ----
    const int Ra = R0 + r0, Rb = Ra + 8;
    const int c = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      if (Ra < rows)
        *reinterpret_cast<float2*>(out.acc + (size_t)Ra * HD + 8 * i + c) =
            make_float2(o[4 * i], o[4 * i + 1]);
      if (Rb < rows)
        *reinterpret_cast<float2*>(out.acc + (size_t)Rb * HD + 8 * i + c) =
            make_float2(o[4 * i + 2], o[4 * i + 3]);
    }
    if (lane % 4 == 0) {  // m in raw scores here; combine_splits weighs e^(m scale - M)
      if (Ra < rows) {
        out.ml[2 * Ra] = m0 * scale;
        out.ml[2 * Ra + 1] = l0;
      }
      if (Rb < rows) {
        out.ml[2 * Rb] = m1 * scale;
        out.ml[2 * Rb + 1] = l1;
      }
    }
  } else if constexpr (kCluster) {
    // ---- epilogue: the splits' merge in distributed shared memory ----
    // This CTA's state goes where its K / V ring was (no copy is in flight
    // and the walk's last barrier has passed), a cluster barrier publishes
    // it, and rank r merges item share r of the tile's real rows (an item
    // is 4 columns of a row) from every rank's state, in rank order: M =
    // the largest m of the splits that saw a key (l != 0: a NaN l counts), then
    // sum exp2((m_s - M) scale log2 e) (O_s, l_s) -- m is in raw scores.
    // A row no split saw (M = -inf) gives zeros, as does a row t >= clen.
    // The last barrier keeps every CTA's shared memory alive until its
    // peers have read it; its arrive is relaxed, so the output's stores
    // need not complete before it (a release arrive would wait for them).
    using MS = MergeSmem<HD>;
    hop::cp_async_wait<0>();
    float* sO = reinterpret_cast<float*>(gbase + MS::kO);
    float* sML = reinterpret_cast<float*>(gbase + MS::kML);
    const int c = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      *reinterpret_cast<float2*>(sO + r0 * MS::kLd + 8 * i + c) =
          make_float2(o[4 * i], o[4 * i + 1]);
      *reinterpret_cast<float2*>(sO + (r0 + 8) * MS::kLd + 8 * i + c) =
          make_float2(o[4 * i + 2], o[4 * i + 3]);
    }
    if (lane % 4 == 0) {
      *reinterpret_cast<float2*>(sML + 2 * r0) = make_float2(m0, l0);
      *reinterpret_cast<float2*>(sML + 2 * (r0 + 8)) = make_float2(m1, l1);
    }
    hop::cluster_sync();
    constexpr int Q4 = HD / 4;  // items of a row
    const int items = (min(R0 + kRows, rows) - R0) * Q4;
    const int per = (items + out.size - 1) / out.size;
    const uint32_t aO = base + MS::kO, aML = base + MS::kML;
    for (int i = out.rank * per + tid; i < min(items, (out.rank + 1) * per); i += kThreads) {
      const int r = i / Q4, cc = i % Q4;
      // every peer's (m, l) and O first, then the sums: the loads overlap
      float mv[kMaxCluster], lv[kMaxCluster], M = -INFINITY;
      float4 xv[kMaxCluster];
#pragma unroll
      for (int s = 0; s < kMaxCluster; ++s) {
        const float2 ml = s < out.size ? hop::ld_dsmem_f2(hop::mapa(aML + 8 * r, s))
                                       : make_float2(-INFINITY, 0.f);
        mv[s] = ml.x;
        lv[s] = ml.y;
      }
#pragma unroll
      for (int s = 0; s < kMaxCluster; ++s)
        xv[s] = s < out.size ? hop::ld_dsmem_f4(hop::mapa(aO + 4 * (r * MS::kLd + 4 * cc), s))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < kMaxCluster; ++s)
        if (lv[s] != 0.f) M = fmaxf(M, mv[s]);
      float L = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < kMaxCluster; ++s) {
        if (lv[s] != 0.f) {
          const float w = exp2f((mv[s] - M) * sl2);
          L = fmaf(w, lv[s], L);
          acc.x = fmaf(w, xv[s].x, acc.x);
          acc.y = fmaf(w, xv[s].y, acc.y);
          acc.z = fmaf(w, xv[s].z, acc.z);
          acc.w = fmaf(w, xv[s].w, acc.w);
        }
      }
      const int R = R0 + r, t = R / group;
      // rows t >= clen: exact zeros, also where a NaN key reached their sum
      if (t >= clen) acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const float inv = L == 0.f ? 0.f : 1.f / L;
      *reinterpret_cast<uint2*>(out.out + ((size_t)t * H + head * group + R % group) * HD +
                                4 * cc) =
          make_uint2(hop::pack_bf16(acc.x * inv, acc.y * inv),
                     hop::pack_bf16(acc.z * inv, acc.w * inv));
    }
    hop::cluster_sync_relaxed();
  } else {
    // ---- epilogue: O / l as bf16 through the Q tile's space, 16-byte stores ----
    // rows t >= clen (zero Q) are exact zeros, also where a NaN key reached
    // their sum; a real row that saw no key (l == 0) gives zeros, a NaN l NaN
    const bool real0 = (R0 + r0) / group < clen, real1 = (R0 + r0 + 8) / group < clen;
    const float i0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float i1 = l1 == 0.f ? 0.f : 1.f / l1;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      uint8_t* p = gbase + L::kQ + swz(r0, i) + 4 * (lane % 4);  // r0 + 8: the same phase
      *reinterpret_cast<uint32_t*>(p) =
          real0 ? hop::pack_bf16(o[4 * i] * i0, o[4 * i + 1] * i0) : 0u;
      *reinterpret_cast<uint32_t*>(p + 8 * 128) =
          real1 ? hop::pack_bf16(o[4 * i + 2] * i1, o[4 * i + 3] * i1) : 0u;
    }
    __syncthreads();
    for (int i = tid; i < kRows * CH; i += kThreads) {
      const int r = i / CH, ch = i % CH, R = R0 + r;
      if (R >= rows) break;  // rows past C * group: padding, never stored
      const int t = R / group;
      *reinterpret_cast<uint4*>(out.out + ((size_t)t * H + head * group + R % group) * HD +
                                ch * 8) = *reinterpret_cast<const uint4*>(gbase + L::kQ + swz(r, ch));
    }
  }
}

// CTAs along x: the q tiles of one kv head's C * group rows.
inline int q_tiles(int C, int group) { return (C * group + kRows - 1) / kRows; }

// Dynamic shared memory of a CTA that stages `table_cols` block-table
// entries (0 for DenseKV).
template <int HD>
size_t smem_bytes(int table_cols) {
  return Smem<HD>::bytes(sizeof(int) * (size_t)table_cols);
}

}  // namespace prefill_tc

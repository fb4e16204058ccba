// The body of the paged and dense decode kernels (one query token per slot)
// for Hopper (sm_90a): one launch per call, no scratch in device memory.
//
// Grid (kv heads * passes, 1, slots * cluster), thread-block clusters of
// (1, 1, cluster) CTAs along z: the cluster's CTAs are one slot's splits.
// A CTA owns G of the GQA group's q heads of one kv head (`passes` CTAs
// cover a group wider than G) and the slot's 64-key tiles r * tpc ..
// r * tpc + tpc - 1, r its rank.  What bounds it on the card: the bytes of
// the K / V rows the slot's length reaches (each read once per kv head),
// and at serving sizes the latency of two dependent round trips and the
// launch.  At group 1-2 it does ~4 flops per K / V byte, far below the
// ridge, so the math runs on the CUDA cores in fp32 (which also holds fp32
// to the plain version's 1e-4) and the design is about bytes in flight and
// fixed cost:
//   * round trip 1 issues `lengths`, the G rows of q (into registers) and,
//     on the paged side, the block-table entries of every page the CTA's
//     tiles span (`PagedKV::stage`; entries past the slot's pages name the
//     sentinel page 0, so nothing here depends on the length);
//   * round trip 2 copies the K / V rows of the CTA's tiles below the
//     length by 16-byte `cp.async` into a 2-stage ring of tiles in the
//     cache's dtype: tile j + 1's copies are in flight under tile j's math.
//     A CTA whose tiles lie past the length copies nothing;
//   * a warp takes 16 keys of a tile; LPR lanes split a row's 16-byte
//     chunks (16 lanes x 8 bf16 = one 128-wide row) and hold the G q rows'
//     chunk in registers, so a warp reads 32 / LPR keys at once.  Dots are
//     reduced by shuffles; the warp's online softmax over its 16 scores and
//     its O stay in registers; at the end the warps merge in shared memory;
//   * the cluster merges its CTAs' (m, l, O) through distributed shared
//     memory: rank r merges a slice of the G x hd outputs from every rank,
//     every DSMEM load issued before any is used, and writes the
//     normalised rows.  The last cluster barrier's arrive is relaxed (it
//     only keeps each CTA's shared memory alive for its readers).
// Scores are kept in log2 units (q scaled by hd^-0.5 log2 e), so every
// weight is an exp2 of a difference of m's.  A row no key reached (length
// <= 0) gives zeros.  The partial form (PARTIAL) stores the cluster's
// merged state unnormalised instead, for a merge across sequence blocks
// (`paged::combine_splits` at C = 1): acc [.., hd] and (m, l) in natural-log
// units, m = M ln 2 (the cluster's log2 max), l the sum of exp2(s - M) =
// exp(s ln 2 - m); a row no key reached stores l = 0 (the merge skips it),
// a NaN key a NaN l and acc (the merge propagates it).  The plan (tpc, cluster) comes from the table width or
// S alone (`decode_plan` in decode_attention.py), so a captured CUDA graph
// stays valid whatever lengths it replays with.
//
// The K / V rows may hold 8-bit floats (TK = __nv_fp8_e4m3 or
// __nv_fp8_e5m2; the dense decode over the serve steps' fp8 cache) under
// fp32 or bf16 q and out (T).  A 16-byte chunk then holds 16 values, so a
// row is hd bytes, LPR follows from hd / 16, and a lane's q registers hold
// the chunk's 16 columns (two bf16 or four fp32 16-byte loads).  K and V
// pairs widen by `cvt.rn.f16x2.e4m3x2` / `.e5m2x2` (exact), then to fp32;
// the scores and the online softmax stay fp32.
#pragma once

#include <cuda_fp8.h>

#include <type_traits>  // std::integral_constant

#include "hopper.cuh"
#include "paged_attention.cuh"

namespace kern {

template <> struct Vec<__nv_fp8_e4m3> { static constexpr int N = 16; };
template <> struct Vec<__nv_fp8_e5m2> { static constexpr int N = 16; };

// 16 8-bit floats -> fp32 values, two at a time through f16x2 (every e4m3 /
// e5m2 value, NaN and inf included, is exact in f16).
__device__ __forceinline__ void load16_fp8(const void* src, float* dst,
                                           __nv_fp8_interpretation_t kind) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2 x2(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * h)), kind));
      const float2 f = __half22float2(x2);
      dst[4 * i + 2 * h] = f.x;
      dst[4 * i + 2 * h + 1] = f.y;
    }
}

__device__ __forceinline__ void load16(const __nv_fp8_e4m3* src, float* dst) {
  load16_fp8(src, dst, __NV_E4M3);
}

__device__ __forceinline__ void load16(const __nv_fp8_e5m2* src, float* dst) {
  load16_fp8(src, dst, __NV_E5M2);
}

}  // namespace kern

namespace decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;                  // keys per KV tile
constexpr int kWarpKeys = kKeys / kWarps;  // keys of a tile per warp
constexpr int kStages = 2;                 // depth of the K / V ring
constexpr int kMaxCluster = 8;             // the portable limit of a cluster's CTAs
constexpr int kMaxRowBytes = 512;          // hd * sizeof(TK): fp8 / bf16 / fp32 up to 512 / 256 / 128
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory of one CTA (bytes): the ring (kStages x K and V
// tiles of kKeys rows of `elem`-byte values), the warps' (m, l) [kWarps][G], then `table_ints`
// block-table entries.  After the walk the ring holds the warps' O
// [kWarps][G][hd], the CTA's O [G][hd] and its (m, l) [G], all fp32.
inline size_t smem_bytes(int G, int hd, int elem, int table_ints) {
  return (size_t)kStages * 2 * kKeys * hd * elem + sizeof(float) * kWarps * G * 2 +
         sizeof(int) * (size_t)table_ints;
}

// Block-table entries a CTA of `tpc` tiles stages (the pages its keys span).
inline int table_ints(int tpc, int page) { return tpc * kKeys / page + 2; }

// One CTA: q and out are the slot's [H, hd] rows of T; kv names the slot's
// K / V rows of TK (`page` is the pool's page size, unused by DenseKV);
// len_p points at the slot's length.  G is a power of two, >= the live rows
// (group - g0); LPR lanes share a key (a power of two >= hd / (16 /
// sizeof(TK))), so a warp reads KPW = 32 / LPR keys at once and each lane NI
// of its warp's 16.  PARTIAL: out is unused; part_acc / part_ml are the
// slot's [H, hd] / [H, 2] fp32 rows of the unnormalised state (see the
// header).
template <typename T, int G, int LPR, bool PARTIAL = false, typename TK, typename KV>
__device__ __forceinline__ void attend(const T* __restrict__ q, const TK* __restrict__ k_pool,
                                       const TK* __restrict__ v_pool, KV kv,
                                       const int* __restrict__ len_p, T* __restrict__ out,
                                       int group, int kvh, int hd, int page, int head, int g0,
                                       int tpc, int cluster, float sl2,
                                       float* __restrict__ part_acc = nullptr,
                                       float* __restrict__ part_ml = nullptr) {
  constexpr int VN = kern::Vec<TK>::N;  // K / V values per 16-byte chunk
  constexpr int VQ = kern::Vec<T>::N;   // q values per 16-byte load
  static_assert(VN % VQ == 0, "a K / V chunk spans whole q loads");
  constexpr int KPW = 32 / LPR;        // keys a warp reads at once
  constexpr int NI = kWarpKeys / KPW;  // keys of its warp's 16 a lane reads
  constexpr int RPT = kKeys * LPR / kThreads;  // K / V rows a thread copies per tile
  extern __shared__ __align__(16) uint8_t decode_smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = (int)hop::cluster_ctarank();
  const int CH = hd / VN;  // 16-byte chunks of a row (<= LPR)
  const int ks = lane / LPR, c = lane % LPR;
  const bool has_chunk = c < CH;
  const int row_bytes = hd * (int)sizeof(TK);
  const size_t row_stride = (size_t)kvh * hd;
  const int rows = min(G, group - g0);  // live q rows of this CTA

  uint8_t* ring = decode_smem;
  float* wm = reinterpret_cast<float*>(ring + (size_t)kStages * 2 * kKeys * row_bytes);
  float* wl = wm + kWarps * G;  // the warps' (m, l), for their merge
  int* table = reinterpret_cast<int*>(wl + kWarps * G);

  // ---- round trip 1: the length, q, the CTA's block-table entries ----
  const int k_lo = rank * tpc * kKeys;
  const int k_hi = min(k_lo + tpc * kKeys, kv.kend);  // the CTA's key range
  const int len = __ldg(len_p);
  float qv[G][VN];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < rows && has_chunk) {
#pragma unroll
      for (int u = 0; u < VN / VQ; ++u)
        kern::load16(q + (size_t)(head * group + g0 + g) * hd + c * VN + u * VQ, qv[g] + u * VQ);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) qv[g][e] = 0.f;
    }
  }
  if (k_hi > k_lo) kv.stage(table, k_lo, k_hi, page);
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < VN; ++e) qv[g][e] *= sl2;

  __syncthreads();  // the table entries

  // ---- round trip 2: the ring of K / V tiles below the length ----
  // Tile j's rows k0 .. k0 + kKeys - 1 into stage j % kStages, rows past the
  // length zero-filled (so 0 * V, never 0 * garbage) from the last live
  // row's address.  A thread copies chunk c of rows tid / LPR + n *
  // (kThreads / LPR); every address comes first.  Tile 0 waits for the
  // length on both layouts: issuing a dense CTA's first tile with the
  // length (its rows need no table) fetched whole tiles for CTAs past the
  // length and was slower (PERF.md).
  const int kend = min(k_hi, max(0, min(len, kv.kend)));  // keys k_lo .. kend - 1
  const int ntiles = kend > k_lo ? (kend - k_lo + kKeys - 1) / kKeys : 0;
  auto load_tile = [&](int j) {
    const int k0 = k_lo + j * kKeys;
    const uint32_t dk = hop::smem_addr(ring + (size_t)(j % kStages) * 2 * kKeys * row_bytes);
    const uint32_t dv = dk + kKeys * row_bytes;
    if (!has_chunk) return;
    size_t off[RPT];
#pragma unroll
    for (int n = 0; n < RPT; ++n) {
      const int kpos = min(k0 + tid / LPR + n * (kThreads / LPR), kend - 1);
      off[n] = kv.row(kpos, page, row_stride) + (size_t)head * hd + c * VN;
    }
#pragma unroll
    for (int n = 0; n < RPT; ++n) {
      const int r = tid / LPR + n * (kThreads / LPR);
      const int bytes = k0 + r < kend ? 16 : 0;
      hop::cp_async16(dk + r * row_bytes + c * 16, k_pool + off[n], bytes);
      hop::cp_async16(dv + r * row_bytes + c * 16, v_pool + off[n], bytes);
    }
  };
  static_assert(kStages == 2, "the prologue issues one tile");
  if (ntiles > 0) load_tile(0);
  hop::cp_async_commit();

  // the warp's online-softmax state (the same in every lane) and the lane's
  // O over the keys it reads
  float m[G], l[G], o[G][VN];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VN; ++e) o[g][e] = 0.f;
  }

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) load_tile(j + 1);
    hop::cp_async_commit();
    hop::cp_async_wait<kStages - 1>();  // tile j landed for this thread
    __syncthreads();                    // ... and for every thread
    const uint8_t* tk = ring + (size_t)(j % kStages) * 2 * kKeys * row_bytes +
                        (size_t)warp * kWarpKeys * row_bytes + c * 16;
    const uint8_t* tv = tk + (size_t)kKeys * row_bytes;
    // this warp's live keys of the tile (warp-uniform; <= 0: nothing to do)
    const int nvw = min(kWarpKeys, kend - (k_lo + j * kKeys) - warp * kWarpKeys);
    if (nvw > 0) {
      // scores of key i * KPW + ks, in log2 units: partial dots over the
      // lane's chunk, summed over the key's LPR lanes
      float s[NI][G];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float kf[VN];
        if (has_chunk) {
          kern::load16(reinterpret_cast<const TK*>(tk + (i * KPW + ks) * row_bytes), kf);
        } else {
#pragma unroll
          for (int e = 0; e < VN; ++e) kf[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          s[i][g] = 0.f;
#pragma unroll
          for (int e = 0; e < VN; ++e) s[i][g] = fmaf(qv[g][e], kf[e], s[i][g]);
        }
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off /= 2)
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int g = 0; g < G; ++g) s[i][g] += __shfl_xor_sync(0xffffffffu, s[i][g], off);
      // online softmax over the warp's 16 keys (a key past the length gets
      // -inf); a row that has seen no key keeps m = -inf and subtracts 0,
      // not -inf (no NaN)
      float mx[G], ps[G], corr[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        mx[g] = -INFINITY;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          if (i * KPW + ks >= nvw) s[i][g] = -INFINITY;
          mx[g] = fmaxf(mx[g], s[i][g]);
        }
      }
#pragma unroll
      for (int off = LPR; off < 32; off *= 2)
#pragma unroll
        for (int g = 0; g < G; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float m_new = fmaxf(m[g], mx[g]);
        const float b = m_new == -INFINITY ? 0.f : m_new;
        corr[g] = exp2f(m[g] - b);
        m[g] = m_new;
        ps[g] = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          s[i][g] = exp2f(s[i][g] - b);
          ps[g] += s[i][g];
        }
      }
#pragma unroll
      for (int off = LPR; off < 32; off *= 2)
#pragma unroll
        for (int g = 0; g < G; ++g) ps[g] += __shfl_xor_sync(0xffffffffu, ps[g], off);
      // O = O corr + P V (V rows past the length are zeros)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        l[g] = l[g] * corr[g] + ps[g];
#pragma unroll
        for (int e = 0; e < VN; ++e) o[g][e] *= corr[g];
      }
      if (has_chunk) {
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float vf[VN];
          kern::load16(reinterpret_cast<const TK*>(tv + (i * KPW + ks) * row_bytes), vf);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int e = 0; e < VN; ++e) o[g][e] = fmaf(s[i][g], vf[e], o[g][e]);
        }
      }
    }
    __syncthreads();  // stage j % kStages is free for tile j + kStages
  }

  // ---- the warps' merge in shared memory (over the ring) ----
  hop::cp_async_wait<0>();
  // the lanes of one chunk read different keys: sum them into lanes ks == 0
#pragma unroll
  for (int off = LPR; off < 32; off *= 2)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VN; ++e) o[g][e] += __shfl_xor_sync(0xffffffffu, o[g][e], off);
  float* sO = reinterpret_cast<float*>(ring);  // [kWarps][G][hd]
  float* cO = sO + kWarps * G * hd;            // the CTA's [G][hd]
  float* cML = cO + G * hd;                    // the CTA's (m, l) [G]
  if (ks == 0 && has_chunk)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VN; e += 4)
        *reinterpret_cast<float4*>(sO + (warp * G + g) * hd + c * VN + e) =
            make_float4(o[g][e], o[g][e + 1], o[g][e + 2], o[g][e + 3]);
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
  __syncthreads();
  // M = the largest m of the warps that saw a key (l != 0: a NaN l counts,
  // so a NaN key poisons the row as in the plain version), then
  // sum exp2(m_w - M) (O_w, l_w) in warp order
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (wl[w * G + g] != 0.f) M = fmaxf(M, wm[w * G + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (wl[w * G + g] != 0.f) {
        const float wt = exp2f(wm[w * G + g] - M);
        L = fmaf(wt, wl[w * G + g], L);
        O = fmaf(wt, sO[(w * G + g) * hd + i - g * hd], O);
      }
    }
    cO[i] = O;
    if (i == g * hd) *reinterpret_cast<float2*>(cML + 2 * g) = make_float2(M, L);
  }

  // ---- the cluster's merge in distributed shared memory ----
  // Rank r merges items r * per .. of the live rows (an item is 4 columns
  // of a row) from every rank's state, in rank order, the same weights as
  // the warps' merge; a row no rank saw (M = -inf) gives zeros.
  hop::cluster_sync();
  const int Q4 = hd / 4;
  const int items = rows * Q4;
  const int per = (items + cluster - 1) / cluster;
  const uint32_t aO = hop::smem_addr(cO), aML = hop::smem_addr(cML);
  for (int i = rank * per + tid; i < min(items, (rank + 1) * per); i += kThreads) {
    const int g = i / Q4, cc = i % Q4;
    float mv[kMaxCluster], lv[kMaxCluster];
    float4 xv[kMaxCluster];
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      const float2 ml = s < cluster ? hop::ld_dsmem_f2(hop::mapa(aML + 8 * g, s))
                                    : make_float2(-INFINITY, 0.f);
      mv[s] = ml.x;
      lv[s] = ml.y;
    }
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s)
      xv[s] = s < cluster ? hop::ld_dsmem_f4(hop::mapa(aO + 4 * (g * hd + 4 * cc), s))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    float M = -INFINITY;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s)
      if (lv[s] != 0.f) M = fmaxf(M, mv[s]);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      if (lv[s] != 0.f) {
        const float wt = exp2f(mv[s] - M);
        L = fmaf(wt, lv[s], L);
        acc.x = fmaf(wt, xv[s].x, acc.x);
        acc.y = fmaf(wt, xv[s].y, acc.y);
        acc.z = fmaf(wt, xv[s].z, acc.z);
        acc.w = fmaf(wt, xv[s].w, acc.w);
      }
    }
    if constexpr (PARTIAL) {
      const size_t row = (size_t)(head * group + g0 + g);
      *reinterpret_cast<float4*>(part_acc + row * hd + 4 * cc) = acc;
      if (cc == 0) *reinterpret_cast<float2*>(part_ml + 2 * row) = make_float2(M * kLn2, L);
      continue;
    }
    const float inv = L == 0.f ? 0.f : 1.f / L;
    T* dst = out + (size_t)(head * group + g0 + g) * hd + 4 * cc;
    kern::store1(dst, acc.x * inv);
    kern::store1(dst + 1, acc.y * inv);
    kern::store1(dst + 2, acc.z * inv);
    kern::store1(dst + 3, acc.w * inv);
  }
  hop::cluster_sync_relaxed();  // peers are done reading this CTA's state
}

// Lanes per key for rows of hd values of T: the next power of two of the
// row's 16-byte chunks, at least 2, at most 32 (rows of kMaxRowBytes).
inline int lanes_per_key(int hd, int elem) {
  int lpr = 2;
  while (lpr < hd * elem / 16) lpr *= 2;
  return lpr;
}

// G (q rows a CTA holds) for a GQA group: the next power of two, at most
// 4 (a lane keeps G x LPR / 2 scores of a tile in registers); a wider group
// takes ceil(group / G) CTAs per kv head.
inline int rows_per_cta(int group) {
  int g = 1;
  while (g < group && g < 4) g *= 2;
  return g;
}

// Calls launch(std::integral_constant<int, G>, std::integral_constant<int,
// LPR>, passes) for the group's G and the rows' LPR: the kernel over grid
// (kvh * passes, 1, B * cluster).  Returns its error.
template <typename Launch>
cudaError_t dispatch(int group, int hd, int elem, Launch&& launch) {
  using std::integral_constant;
  const int lpr = lanes_per_key(hd, elem);
  const int G = rows_per_cta(group);
  const int passes = (group + G - 1) / G;
  auto by_g = [&](auto l) {
    if (G == 1) return launch(integral_constant<int, 1>{}, l, passes);
    if (G == 2) return launch(integral_constant<int, 2>{}, l, passes);
    return launch(integral_constant<int, 4>{}, l, passes);
  };
  switch (lpr) {
    case 2: return by_g(integral_constant<int, 2>{});
    case 4: return by_g(integral_constant<int, 4>{});
    case 8: return by_g(integral_constant<int, 8>{});
    case 16: return by_g(integral_constant<int, 16>{});
    default: return by_g(integral_constant<int, 32>{});
  }
}

}  // namespace decode

// Shared body of the attention kernels over a KV cache: paged and dense
// decode, paged and dense chunked prefill, paged chunk-verify and paged
// tree-verify.
//
// One thread block owns one (slot, kv head, block of chunk rows) and a range
// of the slot's KV tiles.  It walks its tiles up to the last one its rows can
// see (the TPU kernels' kv_map clamp), stages each tile's K and V in shared
// memory as fp32, and keeps the online-softmax state (m, l, accumulator) of
// its rows -- the GQA group's query heads for every chunk row -- in shared
// memory.  On the TPU that state lived in VMEM scratch carried across the
// sequential KV axis of the grid; here the KV axis is a loop inside the
// block (and, for decode and verify, split over blocks whose partial states
// `combine_splits` merges), since blocks run in parallel and in no order.
//
// Two policies make the variants:
//   * the KV address (`PagedKV`: a tile is a page named by the slot's
//     block-table row; `DenseKV`: a tile is `page` consecutive rows of the
//     slot's [S, kvH, hd] cache, the last one possibly short);
//   * the visibility of key kpos from chunk row t (`Causal`: kpos <= start +
//     t; `TreeMask`: the prefix kpos < start, or node j = kpos - start of the
//     packed tree when bit j of the row's ancestor mask is set).
//
// Row r of a block is chunk row t = q0 + r / group, q head head*group + r % group
// (q head h maps to kv head h / group).  Rows t >= clen are padding and give
// zeros, as does a row that saw no key (l == 0): never the mean of V.
//
// Decode is the case C = 1, start = length - 1, clen = (length > 0); verify
// is C = clen = T, start = length - T.
//
// Bound: at serving batch sizes every variant is bound by device-memory
// bytes (each K/V row read once per kv head feeds 2 * group * hd FMAs per
// chunk row).  The design reads each needed tile once per block with 16-byte
// vector loads, stops at the last useful tile, and spreads the work over
// enough blocks to fill the SMs (decode and verify: tiles split over blocks;
// prefill: 8 chunk rows per block).  It does not overlap the next tile's
// loads with the current tile's math (no cp.async / TMA ring) and uses fp32
// FMAs, not the tensor cores -- later work.
#pragma once

#include "common.cuh"

namespace paged {

constexpr int kThreads = 128;

using kern::load16;
using kern::store1;
using kern::Vec;

// K/V of a slot in a pool of pages: tile `pi` is page table[pi].
struct PagedKV {
  const int* table;  // the slot's block-table row
  int n_tiles;       // real columns (the sentinel column excluded)
  int kend;          // key positions that exist: n_tiles * page
  __device__ size_t base(int pi, int page, size_t row_stride) const {
    return (size_t)table[pi] * page * row_stride;
  }
};

// K/V of a slot in a dense [B, S, kvH, hd] cache: tile `pi` is rows
// pi * page .. pi * page + page - 1, cut at S.
struct DenseKV {
  size_t slot_base;  // element offset of the slot's row 0
  int n_tiles;       // ceil(S / page)
  int kend;          // S
  __device__ size_t base(int pi, int page, size_t row_stride) const {
    return slot_base + (size_t)pi * page * row_stride;
  }
};

// Chunk row t sees kpos <= start + t.
struct Causal {
  __device__ bool sees(int t, int kpos, int start) const {
    return kpos <= start + t;
  }
  // one past the last key position rows q0 .. last_row - 1 can see
  __device__ int limit(int start, int last_row, int) const {
    return start + last_row;
  }
};

// Row t (a packed-tree node) sees the committed prefix kpos < start and the
// tree node j = kpos - start (0 <= j < n) when bit j of anc[t] is set.
struct TreeMask {
  const int* anc;  // the slot's [n] ancestor bitmasks
  int n;
  __device__ bool sees(int t, int kpos, int start) const {
    const int j = kpos - start;
    if (j < 0) return true;
    return j < n && ((__ldg(anc + t) >> min(j, 31)) & 1);
  }
  __device__ int limit(int start, int, int clen) const { return start + clen; }
};

// Dynamic shared memory of one block, in bytes (rows = rows_q * group).
inline size_t smem_bytes(int rows, int hd, int page) {
  const size_t ldk = hd + 1;  // padded row: conflict-free column reads
  return sizeof(float) * (rows * ldk + page * ldk + (size_t)page * hd +
                          (size_t)rows * page + (size_t)rows * hd + 3 * rows);
}

// Where a block's result goes: normalised rows into `out` (the q layout), or
// -- for a block that covers only part of the slot's pages -- the
// unnormalised accumulator and (m, l) of its rows into `part_acc` /
// `part_ml` for `combine_splits`.
template <typename T>
struct Epilogue {
  T* out;
  float* part_acc;  // [rows, hd] of this block, or nullptr
  float* part_ml;   // [rows, 2] of this block, or nullptr
};

// Template knobs, chosen per kernel:
//   SPLIT -- threads sharing one dot product (shuffle-reduced; divides 32);
//   KQ    -- keys per thread per dot-product pass (each q value loaded once
//            for KQ FMAs; divides page);
//   RQ    -- rows per thread in the P.V update (each V value loaded once for
//            RQ FMAs).
template <typename T, int SPLIT, int KQ, int RQ, typename KV, typename Vis>
__device__ void attend_block(const T* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool, KV kv, Vis vis,
                             int start, int clen, int q0, int rows_q, int C,
                             int H, int kvh, int head, int group, int hd,
                             int page, int page_lo, int page_hi, float scale,
                             Epilogue<T> epi) {
  extern __shared__ float smem[];
  constexpr int VN = Vec<T>::N;
  const int R = rows_q * group;
  const int ldk = hd + 1;
  float* qs = smem;             // [R, ldk]
  float* ks = qs + R * ldk;     // [page, ldk]
  float* vs = ks + page * ldk;  // [page, hd]
  float* sc = vs + page * hd;   // [R, page] scores, then probabilities
  float* acc = sc + R * page;   // [R, hd]
  float* m_s = acc + R * hd;    // [R]
  float* l_s = m_s + R;         // [R]
  float* c_s = l_s + R;         // [R]
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int row_vecs = hd / VN;

  // last tile the block's last real row can see
  const int last_row = min(q0 + rows_q, clen);
  int n_pages = 0;
  if (last_row > q0) {
    const int limit = vis.limit(start, last_row, clen);
    if (limit > 0) n_pages = min((limit + page - 1) / page, kv.n_tiles);
  }
  page_hi = min(page_hi, n_pages);

  for (int i = tid; i < R * row_vecs; i += nth) {
    const int r = i / row_vecs, c = (i % row_vecs) * VN;
    const int t = q0 + r / group, g = r % group;
    float tmp[VN];
    if (t < C) {
      load16(q + ((size_t)t * H + head * group + g) * hd + c, tmp);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) tmp[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) qs[r * ldk + c + j] = tmp[j];
  }
  for (int i = tid; i < R * hd; i += nth) acc[i] = 0.f;
  for (int r = tid; r < R; r += nth) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const size_t row_stride = (size_t)kvh * hd;  // between tokens of a page
  const int kquads = page / KQ;
  for (int pi = page_lo; pi < page_hi; ++pi) {
    // stage the tile's K/V rows of this kv head (rows past kend: zeros)
    const size_t pbase = kv.base(pi, page, row_stride) + (size_t)head * hd;
    const int k0 = pi * page;
    for (int i = tid; i < page * row_vecs; i += nth) {
      const int t = i / row_vecs, c = (i % row_vecs) * VN;
      const size_t off = pbase + t * row_stride + c;
      float tk[VN], tv[VN];
      if (k0 + t < kv.kend) {
        load16(k_pool + off, tk);
        load16(v_pool + off, tv);
      } else {
#pragma unroll
        for (int j = 0; j < VN; ++j) tk[j] = tv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        ks[t * ldk + c + j] = tk[j];
        vs[t * hd + c + j] = tv[j];
      }
    }
    __syncthreads();

    // scores: the loop bound is uniform over a warp so every lane reaches
    // the shuffles
    const int work = R * kquads * SPLIT;
    for (int base = 0; base < work; base += nth) {
      const int i = base + tid;
      const int item = i / SPLIT, part = i % SPLIT;
      const int r = item / kquads, kt0 = (item % kquads) * KQ;
      float dot[KQ];
#pragma unroll
      for (int j = 0; j < KQ; ++j) dot[j] = 0.f;
      if (i < work) {
        const float* qr = qs + r * ldk;
        const float* kr = ks + kt0 * ldk;
        for (int d = part; d < hd; d += SPLIT) {
          const float qv = qr[d];
#pragma unroll
          for (int j = 0; j < KQ; ++j) dot[j] = fmaf(qv, kr[j * ldk + d], dot[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < KQ; ++j) {
#pragma unroll
        for (int off = SPLIT / 2; off > 0; off >>= 1)
          dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], off);
      }
      if (i < work && part == 0) {
        const int t = q0 + r / group;
#pragma unroll
        for (int j = 0; j < KQ; ++j) {
          const int kpos = k0 + kt0 + j;
          const bool seen = t < clen && kpos < kv.kend && vis.sees(t, kpos, start);
          sc[r * page + kt0 + j] = seen ? dot[j] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online-softmax row update; a row with no visible key keeps l == 0
    for (int r = tid; r < R; r += nth) {
      float* sr = sc + r * page;
      float mt = -INFINITY;
      for (int kt = 0; kt < page; ++kt) mt = fmaxf(mt, sr[kt]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mt);
      float corr = 1.f, lsum = 0.f;
      if (m_new == -INFINITY) {
        for (int kt = 0; kt < page; ++kt) sr[kt] = 0.f;
      } else {
        corr = expf(m_prev - m_new);
        for (int kt = 0; kt < page; ++kt) {
          const float s = sr[kt];
          const float p = s == -INFINITY ? 0.f : expf(s - m_new);
          sr[kt] = p;
          lsum += p;
        }
      }
      l_s[r] = l_s[r] * corr + lsum;
      m_s[r] = m_new;
      c_s[r] = corr;
    }
    __syncthreads();

    const int rgroups = (R + RQ - 1) / RQ;
    for (int i = tid; i < rgroups * hd; i += nth) {
      const int r0 = (i / hd) * RQ, d = i % hd;
      float a[RQ];
#pragma unroll
      for (int j = 0; j < RQ; ++j)
        a[j] = r0 + j < R ? acc[(r0 + j) * hd + d] * c_s[r0 + j] : 0.f;
      for (int kt = 0; kt < page; ++kt) {
        const float vv = vs[kt * hd + d];
#pragma unroll
        for (int j = 0; j < RQ; ++j)
          if (r0 + j < R) a[j] = fmaf(sc[(r0 + j) * page + kt], vv, a[j]);
      }
#pragma unroll
      for (int j = 0; j < RQ; ++j)
        if (r0 + j < R) acc[(r0 + j) * hd + d] = a[j];
    }
    __syncthreads();
  }

  if (epi.part_acc != nullptr) {
    for (int i = tid; i < R * hd; i += nth) epi.part_acc[i] = acc[i];
    for (int r = tid; r < R; r += nth) {
      epi.part_ml[2 * r] = m_s[r];
      epi.part_ml[2 * r + 1] = l_s[r];
    }
    return;
  }
  for (int i = tid; i < R * hd; i += nth) {
    const int r = i / hd, d = i % hd;
    const int t = q0 + r / group, g = r % group;
    if (t >= C) continue;
    const float l = l_s[r];
    const float o = (t < clen && l > 0.f) ? acc[i] / l : 0.f;
    store1(epi.out + ((size_t)t * H + head * group + g) * hd + d, o);
  }
}

// Launch with the paged kernels' block size (see kern::launch).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, void* stream,
                   Args... args) {
  return kern::launch(kernel, grid, kThreads, smem, stream, args...);
}

// ---------------------------------------------------------------------------
// Split-K over the KV tiles ("flash-decoding"), for decode (C = 1) and
// verify (C = T): a block covers one split of a slot's tiles and writes the
// unnormalised state of its R = C * group rows at rows
// ((b * splits + s) * kvH + head) * R .. + R - 1 of part_acc [.., hd] and
// part_ml [.., 2]; `combine_splits` then merges the splits of each row.
// ---------------------------------------------------------------------------

template <typename T>
__device__ Epilogue<T> split_epilogue(float* part_acc, float* part_ml, int b,
                                      int s, int splits, int kvh, int head,
                                      int rows, int hd) {
  const size_t row0 = (((size_t)b * splits + s) * kvh + head) * rows;
  return Epilogue<T>{nullptr, part_acc + row0 * hd, part_ml + row0 * 2};
}

// out[b, t, h] = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the
// splits that saw a key (l_s > 0); 0 when none did.  Grid (kvH * C * group, B);
// out is [B, C, H, hd].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    combine_splits(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml, T* __restrict__ out,
                   int kvh, int group, int C, int hd, int splits) {
  const int hr = blockIdx.x, b = blockIdx.y;
  const int R = C * group;
  const int head = hr / R, r = hr % R;
  const int t = r / group, g = r % group;
  const size_t stride = (size_t)kvh * R;  // rows between two splits
  const size_t base = (size_t)b * splits * stride + hr;  // row of split 0
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) {
    const float* ml = part_ml + (base + s * stride) * 2;
    if (ml[1] > 0.f) M = fmaxf(M, ml[0]);
  }
  T* o = out + (((size_t)b * C + t) * kvh * group + head * group + g) * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float L = 0.f, O = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t row = base + s * stride;
      const float* ml = part_ml + row * 2;
      if (ml[1] > 0.f) {
        const float w = expf(ml[0] - M);
        L = fmaf(w, ml[1], L);
        O = fmaf(w, part_acc[row * hd + d], O);
      }
    }
    store1(o + d, L > 0.f ? O / L : 0.f);
  }
}

template <typename T>
cudaError_t launch_combine(const void* part_acc, const void* part_ml,
                           void* out, int B, int C, int H, int kvh, int hd,
                           int splits, void* stream) {
  const int group = H / kvh;
  return launch(combine_splits<T>, dim3(kvh * C * group, B), 0, stream,
                static_cast<const float*>(part_acc),
                static_cast<const float*>(part_ml), static_cast<T*>(out), kvh,
                group, C, hd, splits);
}

// ---------------------------------------------------------------------------
// Chunk-verify over paged KV (the body of paged verify and paged tree
// verify): slot b's T chunk rows sit at positions lengths[b] - T + t, with
// their K/V already in the slot's pages.  One block per (kv head, slot,
// split of `pps` pages) holds all T * group rows; TREE swaps the causal
// triangle for the ancestor bitmasks anc [B, T].  `lengths` is not clamped:
// the tile walk stops at the W - 1 real columns, so table reads stay in
// range whatever it holds.
// ---------------------------------------------------------------------------

template <typename T, bool TREE>
__global__ void __launch_bounds__(kThreads)
    verify_partial(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ lengths, const int* __restrict__ anc,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int C, int H, int kvh, int hd, int page, int W, int pps,
                   float scale) {
  const int head = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int splits = gridDim.z, group = H / kvh;
  const int start = lengths[b] - C;
  const PagedKV kv{block_tables + (size_t)b * W, W - 1, (W - 1) * page};
  const Epilogue<T> epi = split_epilogue<T>(part_acc, part_ml, b, s, splits,
                                            kvh, head, C * group, hd);
  const T* qb = q + (size_t)b * C * H * hd;
  if constexpr (TREE) {
    attend_block<T, 8, 1, 1>(qb, k_pool, v_pool, kv,
                             TreeMask{anc + (size_t)b * C, C}, start, C, 0, C,
                             C, H, kvh, head, group, hd, page, s * pps,
                             (s + 1) * pps, scale, epi);
  } else {
    attend_block<T, 8, 1, 1>(qb, k_pool, v_pool, kv, Causal{}, start, C, 0, C,
                             C, H, kvh, head, group, hd, page, s * pps,
                             (s + 1) * pps, scale, epi);
  }
}

template <typename T, bool TREE>
cudaError_t run_verify(const void* q, const void* k_pool, const void* v_pool,
                       const void* block_tables, const void* lengths,
                       const void* anc, void* out, void* part_acc,
                       void* part_ml, int B, int C, int H, int kvh, int hd,
                       int page, int W, int pps, int splits, void* stream) {
  const size_t smem = smem_bytes(C * (H / kvh), hd, page);
  cudaError_t err = launch(
      verify_partial<T, TREE>, dim3(kvh, B, splits), smem, stream,
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<const int*>(anc),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), C, H, kvh,
      hd, page, W, pps, 1.0f / sqrtf((float)hd));
  if (err != cudaSuccess) return err;
  return launch_combine<T>(part_acc, part_ml, out, B, C, H, kvh, hd, splits,
                           stream);
}

}  // namespace paged

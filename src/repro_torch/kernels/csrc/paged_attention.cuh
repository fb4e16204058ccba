// Shared body of the paged decode and paged chunked-prefill attention kernels.
//
// One thread block owns one (slot, kv head, block of chunk rows) and a range
// of the slot's pages.  It reads its own start / chunk length and the slot's
// block-table row, walks its pages up to the last page its rows can see (the
// TPU kernels' kv_map clamp), stages each page's K and V in shared memory as
// fp32, and keeps the online-softmax state (m, l, accumulator) of its rows --
// the GQA group's query heads for every chunk row -- in shared memory.  On
// the TPU that state lived in VMEM scratch carried across the sequential
// page axis of the grid; here the page axis is a loop inside the block (and,
// for decode, split over blocks whose partial states a second kernel
// combines), since blocks run in parallel and in no order.
//
// Row r of a block is chunk row t = q0 + r / group, q head head*group + r % group
// (q head h maps to kv head h / group).  Row t sits at sequence position
// start + t and sees keys kpos <= start + t; rows t >= clen are padding and
// give zeros, as does a row that saw no key (l == 0): never the mean of V.
//
// Decode is the case C = 1, start = length - 1, clen = (length > 0).
//
// Bound: at serving batch sizes both kernels are bound by device-memory
// bytes (each K/V row read once per kv head feeds 2 * group * hd FMAs per
// chunk row).  The design reads each needed page once per block with 16-byte
// vector loads, stops at the last useful page, and spreads the work over
// enough blocks to fill the SMs (decode: pages split over blocks; prefill:
// 8 chunk rows per block).  It does not overlap the next page's loads with
// the current page's math (no cp.async / TMA ring) and uses fp32 FMAs, not
// the tensor cores -- later work.
#pragma once

#include "common.cuh"

namespace paged {

constexpr int kThreads = 128;

using kern::load16;
using kern::store1;
using kern::Vec;

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
template <typename T, int SPLIT, int KQ, int RQ>
__device__ void attend_block(const T* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const int* __restrict__ table, int start,
                             int clen, int q0, int rows_q, int C, int H,
                             int kvh, int head, int group, int hd, int page,
                             int n_cols, int page_lo, int page_hi,
                             float scale, Epilogue<T> epi) {
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

  // last page the block's last real row can see
  const int last_row = min(q0 + rows_q, clen);
  int n_pages = 0;
  if (last_row > q0) {
    const int limit = start + last_row;
    n_pages = min((limit + page - 1) / page, n_cols);
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
    // stage the page's K/V rows of this kv head
    const size_t pbase = (size_t)table[pi] * page * row_stride + (size_t)head * hd;
    for (int i = tid; i < page * row_vecs; i += nth) {
      const int t = i / row_vecs, c = (i % row_vecs) * VN;
      const size_t off = pbase + t * row_stride + c;
      float tk[VN], tv[VN];
      load16(k_pool + off, tk);
      load16(v_pool + off, tv);
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        ks[t * ldk + c + j] = tk[j];
        vs[t * hd + c + j] = tv[j];
      }
    }
    __syncthreads();

    // scores: the loop bound is uniform over a warp so every lane reaches
    // the shuffles
    const int k0 = pi * page;
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
          const bool seen = t < clen && k0 + kt0 + j <= start + t;
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

}  // namespace paged

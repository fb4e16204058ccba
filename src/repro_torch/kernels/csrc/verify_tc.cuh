// Tensor-core paged chunk-verify and tree-verify (bf16, hd 64 or 128) for
// Hopper (sm_90a): prefill_tc.cuh's body, split over the slot's 64-key KV
// tiles, with `paged::combine_splits` merging the splits.
//
// Replaces, with the FMA body of paged_attention.cuh (`paged::verify_partial`)
// that fp32 and other head dims keep, the TPU kernels
// repro/kernels/paged_verify_attention.py `paged_verify_attention` and
// repro/kernels/paged_tree_verify_attention.py `paged_tree_verify_attention`.
// Slot b's C chunk rows sit at positions start + t, start = lengths[b] - C,
// their K/V already in the slot's pages; `lengths` is not clamped, and the
// walk stops at the W - 1 real table columns (kend).
//
// What bounds it on the card: the bytes of the K/V pages the rows see, and
// at serving sizes (a few rows per kv head, up to 8 tiles per slot) the
// latency of one CTA's fetch and its fixed costs.  The design:
//   * one CTA per (q tile of 64 rows, kv head, slot, split of `tps` tiles):
//     at T = 5, group 2 and 32 columns of 16, two tiles a split give
//     8 slots x 8 kv heads x 4 splits = 256 CTAs, one wave at two CTAs an
//     SM, none walking more than two tiles, the second one's fetch under the
//     first one's math (FMA body: 16 splits of 2 pages, no overlap, the
//     rows' softmax one thread per row);
//   * S, the softmax and P V as in the chunked prefill (`wgmma`, registers),
//     under `prefill_tc::CausalVis` or `prefill_tc::TreeVis`: the two differ
//     only in which keys they hide, so a chain's masks give verify's output
//     bit for bit;
//   * a CTA whose tiles lie past its rows' last visible key writes only
//     (m, l) = (-inf, 0) and loads nothing; the others write the real rows'
//     unnormalised fp32 O and (m, l), and stage only their own block-table
//     entries.
#pragma once

#include "prefill_tc.cuh"

namespace verify_tc {

using bf16 = __nv_bfloat16;

// Block-table entries one split of `tps` tiles stages (W - 1 real columns).
inline int table_cols(int tps, int page, int W) {
  return min(W - 1, (tps * prefill_tc::kKeys + page - 1) / page + 1);
}

// Grid (q tiles, kv head, slot * splits + split).  anc: [B, C] (TREE only).
template <int HD, bool TREE>
__global__ void __launch_bounds__(prefill_tc::kThreads)
    paged_verify_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                           const bf16* __restrict__ v_pool,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ lengths, const int* __restrict__ anc,
                           float* __restrict__ part_acc, float* __restrict__ part_ml, int C,
                           int H, int kvh, int page, int W, int tps, int splits,
                           float scale) {
  const int qt = blockIdx.x, head = blockIdx.y;
  const int b = blockIdx.z / splits, s = blockIdx.z % splits;
  const int start = lengths[b] - C;
  // this CTA's rows of the split's [kvH, C * group] partial state
  const size_t row0 = (((size_t)b * splits + s) * kvh + head) * C * (H / kvh);
  const prefill_tc::SplitOut out{part_acc + row0 * HD, part_ml + row0 * 2};
  const paged::PagedKV kv{block_tables + (size_t)b * W, W - 1, (W - 1) * page};
  const bf16* qb = q + (size_t)b * C * H * HD;
  if constexpr (TREE) {
    prefill_tc::attend_tile<HD>(qb, k_pool, v_pool, kv, prefill_tc::TreeVis{anc + (size_t)b * C},
                                page, start, C, C, H, kvh, head, qt, s * tps, (s + 1) * tps,
                                scale, out);
  } else {
    prefill_tc::attend_tile<HD>(qb, k_pool, v_pool, kv, prefill_tc::CausalVis{}, page, start,
                                C, C, H, kvh, head, qt, s * tps, (s + 1) * tps, scale, out);
  }
}

template <int HD, bool TREE>
cudaError_t launch_partial(const void* q, const void* k_pool, const void* v_pool,
                           const void* block_tables, const void* lengths, const void* anc,
                           void* part_acc, void* part_ml, int B, int C, int H, int kvh,
                           int page, int W, int tps, int splits, void* stream) {
  return kern::launch(
      paged_verify_tc_kernel<HD, TREE>,
      dim3(prefill_tc::q_tiles(C, H / kvh), kvh, B * splits), prefill_tc::kThreads,
      prefill_tc::smem_bytes<HD>(table_cols(tps, page, W)), stream,
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<const int*>(anc),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), C, H, kvh, page, W, tps,
      splits, 1.0f / sqrtf((float)HD));
}

// The split pass (`tps` 64-key tiles per split, `splits` of them), then
// `paged::combine_splits`.  part_acc / part_ml: float32 scratch of
// [B, splits, kvH, C * group, hd] and [.., 2].
template <bool TREE>
cudaError_t run(const void* q, const void* k_pool, const void* v_pool,
                const void* block_tables, const void* lengths, const void* anc, void* out,
                void* part_acc, void* part_ml, int B, int C, int H, int kvh, int hd, int page,
                int W, int tps, int splits, void* stream) {
  const cudaError_t err =
      hd == 64 ? launch_partial<64, TREE>(q, k_pool, v_pool, block_tables, lengths, anc,
                                          part_acc, part_ml, B, C, H, kvh, page, W, tps,
                                          splits, stream)
      : hd == 128 ? launch_partial<128, TREE>(q, k_pool, v_pool, block_tables, lengths, anc,
                                              part_acc, part_ml, B, C, H, kvh, page, W, tps,
                                              splits, stream)
                  : cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return paged::launch_combine<bf16>(part_acc, part_ml, out, B, C, H, kvh, hd, splits,
                                     stream);
}

}  // namespace verify_tc

// Paged chunk-verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_verify_attention.py
// `paged_verify_attention` (Pallas body `_verify_kernel` in
// repro/kernels/verify_attention.py): the T = gamma + 1 chunk queries of
// slot b sit at positions lengths[b] - T + t, their K/V already in the
// slot's pages, and query t attends kpos <= lengths[b] - T + t -- the prefix
// plus the chunk's causal triangle.  `lengths` is NOT clamped (suffix
// prefill relies on the causal bound not shifting); the tile walk stops at
// the W - 1 real table columns, so table reads stay in range.  A row whose
// causal window is empty (lengths < T, lengths == 0) gives zeros.  On the
// serving path it is the target's verify pass of a draft-model round.
//
// The chunked-prefill body with start = lengths - T, clen = T (see
// paged_attention.cuh, `paged::verify_partial`): one block per (kv head,
// slot, split of `pps` pages) holds all T * group rows (<= 10 at T = 5,
// group 2) and `paged::combine_splits` merges the splits, as decode does.
// Bound on the card: device-memory bytes, each needed K/V row read once.
#include "paged_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16.  part_acc / part_ml: float32 scratch of
// [B, splits, kvH, T * group, hd] and [.., 2].  Returns a cudaError_t code.
extern "C" int paged_verify_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, void* out, void* part_acc,
    void* part_ml, int B, int T, int H, int kvh, int hd, int page, int W,
    int pps, int splits, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0) return cudaSuccess;
  if (dtype == 0)
    return paged::run_verify<float, false>(
        q, k_pool, v_pool, block_tables, lengths, nullptr, out, part_acc,
        part_ml, B, T, H, kvh, hd, page, W, pps, splits, stream);
  if (dtype == 1)
    return paged::run_verify<__nv_bfloat16, false>(
        q, k_pool, v_pool, block_tables, lengths, nullptr, out, part_acc,
        part_ml, B, T, H, kvh, hd, page, W, pps, splits, stream);
  return cudaErrorInvalidValue;
}

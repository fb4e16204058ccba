// Paged tree-verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_tree_verify_attention.py
// `paged_tree_verify_attention` (Pallas body `_tree_verify_kernel` in
// repro/kernels/tree_verify_attention.py): one query per packed-tree node,
// node j's K/V at position lengths[b] - N + j of the slot's pages.  Node t
// attends the committed prefix kpos < lengths - N plus the tree nodes
// 0 <= j < N whose bit is set in anc[b, t] (N <= 31, int32 bitmasks).
// `lengths` is not clamped, and a row with an empty visibility set gives
// zeros.  On the serving path it is the target's verify pass of an n-gram /
// suffix-proposed tree.
//
// The paged verify kernel with the causal triangle replaced by the ancestor
// masks (`paged::TreeMask`, see paged_attention.cuh): the same template,
// the same split-K over pages and the same accumulation order, so a linear
// chain's masks give the paged verify kernel's output bit for bit.  Bound
// on the card: device-memory bytes, each needed K/V row read once.
#include "paged_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16.  anc: [B, N] int32.  part_acc /
// part_ml: float32 scratch of [B, splits, kvH, N * group, hd] and [.., 2].
// Returns a cudaError_t code.
extern "C" int paged_tree_verify_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, const void* anc, void* out,
    void* part_acc, void* part_ml, int B, int N, int H, int kvh, int hd,
    int page, int W, int pps, int splits, int dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || N == 0) return cudaSuccess;
  if (N > 31) return cudaErrorInvalidValue;
  if (dtype == 0)
    return paged::run_verify<float, true>(
        q, k_pool, v_pool, block_tables, lengths, anc, out, part_acc,
        part_ml, B, N, H, kvh, hd, page, W, pps, splits, stream);
  if (dtype == 1)
    return paged::run_verify<__nv_bfloat16, true>(
        q, k_pool, v_pool, block_tables, lengths, anc, out, part_acc,
        part_ml, B, N, H, kvh, hd, page, W, pps, splits, stream);
  return cudaErrorInvalidValue;
}

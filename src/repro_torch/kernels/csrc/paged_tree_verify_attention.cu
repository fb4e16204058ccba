// Paged tree-verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_tree_verify_attention.py
// `paged_tree_verify_attention` (`pallas_call` at :103; Pallas body
// `_tree_verify_kernel` in repro/kernels/tree_verify_attention.py): one
// query per packed-tree node, node j's K/V at position lengths[b] - N + j of
// the slot's pages.  Node t attends the committed prefix kpos < lengths - N
// plus the tree nodes 0 <= j < N whose bit is set in anc[b, t] (N <= 31,
// int32 bitmasks).  `lengths` is not clamped, and a row with an empty
// visibility set gives zeros.  On the serving path it is the target's
// verify pass of an n-gram / suffix-proposed tree.
//
// The paged verify kernel with the causal triangle replaced by the ancestor
// masks, in the same two bodies chosen the same way (`body`): bf16 at hd 64
// / 128 the tensor-core body (verify_tc.cuh, `prefill_tc::TreeVis`), fp32
// or another head dim the FMA body (`paged::TreeMask`).  Each body runs the
// same split plan, tile order and accumulation order as its verify
// counterpart, so a linear chain's masks give the paged verify kernel's
// output bit for bit.  Bound on the card: the bytes of the K/V pages the
// nodes see -- at serving sizes, the latency and fixed costs of short walks.
#include "verify_tc.cuh"

// dtype: 0 = float32, 1 = bfloat16.  body: 0 = the FMA body (`per` pages per
// split), 1 = the tensor-core body (bfloat16, hd 64 or 128; `per` 64-key
// tiles per split).  anc: [B, N] int32.  part_acc / part_ml: float32 scratch
// of [B, splits, kvH, N * group, hd] and [.., 2].  Returns a cudaError_t code.
extern "C" int paged_tree_verify_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, const void* anc, void* out,
    void* part_acc, void* part_ml, int B, int N, int H, int kvh, int hd,
    int page, int W, int per, int splits, int dtype, int body, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || N == 0) return cudaSuccess;
  if (N > 31) return cudaErrorInvalidValue;
  if (body == 1 && dtype == 1 && (hd == 64 || hd == 128))
    return verify_tc::run<true>(q, k_pool, v_pool, block_tables, lengths, anc,
                                out, part_acc, part_ml, B, N, H, kvh, hd, page,
                                W, per, splits, stream);
  if (body != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return paged::run_verify<float, true, false>(
        q, k_pool, v_pool, block_tables, lengths, anc, out, part_acc,
        part_ml, B, N, H, kvh, hd, page, W, 0, per, splits, stream);
  if (dtype == 1)
    return paged::run_verify<__nv_bfloat16, true, false>(
        q, k_pool, v_pool, block_tables, lengths, anc, out, part_acc,
        part_ml, B, N, H, kvh, hd, page, W, 0, per, splits, stream);
  return cudaErrorInvalidValue;
}

// Paged chunk-verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_verify_attention.py
// `paged_verify_attention` (`pallas_call` at :106; Pallas body
// `_verify_kernel` in repro/kernels/verify_attention.py): the T = gamma + 1
// chunk queries of slot b sit at positions lengths[b] - T + t, their K/V
// already in the slot's pages, and query t attends kpos <= lengths[b] - T + t
// -- the prefix plus the chunk's causal triangle.  `lengths` is NOT clamped
// (suffix prefill relies on the causal bound not shifting); the tile walk
// stops at the W - 1 real table columns, so table reads stay in range.  A
// row whose causal window is empty (lengths < T, lengths == 0) gives zeros.
// On the serving path it is the target's verify pass of a draft-model round
// and, after a radix hit under monolithic prefill, the suffix prefill.
//
// Bound on the card: the bytes of the K/V pages the rows see (each needed
// row read once per kv head) -- at serving sizes, the latency and fixed
// costs of short walks.  Split-K over the slot's KV tiles, then
// `paged::combine_splits`, in two bodies chosen by the caller from dtype
// and head dim (`body`):
//   * bf16 at hd 64 / 128: the tensor-core body (verify_tc.cuh over
//     prefill_tc.cuh) -- one warpgroup per (64 rows, kv head, slot, split of
//     `per` 64-key tiles), `wgmma` products, the softmax in registers, a
//     CTA past its rows' last visible key writing only (m, l);
//   * fp32 or another head dim: the FMA body of paged_attention.cuh
//     (`paged::verify_partial`: one block per (kv head, slot, 32 chunk rows,
//     split of `per` pages), fp32 FMAs on CUDA cores), which the fp32 parity
//     checks hold to 1e-4 and TF32 products would not meet.
#include "verify_tc.cuh"

// dtype: 0 = float32, 1 = bfloat16.  body: 0 = the FMA body (`per` pages per
// split), 1 = the tensor-core body (bfloat16, hd 64 or 128; `per` 64-key
// tiles per split).  part_acc / part_ml: float32 scratch of
// [B, splits, kvH, T * group, hd] and [.., 2].  Returns a cudaError_t code.
extern "C" int paged_verify_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, void* out, void* part_acc,
    void* part_ml, int B, int T, int H, int kvh, int hd, int page, int W,
    int per, int splits, int dtype, int body, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0) return cudaSuccess;
  if (body == 1 && dtype == 1 && (hd == 64 || hd == 128))
    return verify_tc::run<false>(q, k_pool, v_pool, block_tables, lengths,
                                 nullptr, out, part_acc, part_ml, B, T, H, kvh,
                                 hd, page, W, per, splits, stream);
  if (body != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return paged::run_verify<float, false, false>(
        q, k_pool, v_pool, block_tables, lengths, nullptr, out, part_acc,
        part_ml, B, T, H, kvh, hd, page, W, 0, per, splits, stream);
  if (dtype == 1)
    return paged::run_verify<__nv_bfloat16, false, false>(
        q, k_pool, v_pool, block_tables, lengths, nullptr, out, part_acc,
        part_ml, B, T, H, kvh, hd, page, W, 0, per, splits, stream);
  return cudaErrorInvalidValue;
}

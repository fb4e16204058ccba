// Dense chunk-verify and tree-verify attention for Hopper (sm_90a): one
// library, two entry points over one template.
//
// verify_attention_launch replaces the TPU kernel repro/kernels/verify_attention.py
// `verify_attention` (Pallas body `_verify_kernel`): the T = gamma + 1 chunk
// queries of slot b sit at positions lengths[b] - T + t of the slot's rows
// of a dense [B, S, kvH, hd] cache, their K/V already written, and query t
// attends kpos <= lengths[b] - T + t -- the prefix plus the chunk's causal
// triangle.  A row whose causal window is empty (lengths < T, lengths == 0)
// gives zeros.  `lengths` is not clamped to S (the tile walk stops at S).
// On the serving path it is a dense-layout target's verify pass of a
// draft-model round.
//
// The paged verify kernel's body over the dense KV address
// (`paged::DenseKV`: a tile is 16 consecutive cache rows, the last one cut
// at S), with the same split-K over tiles and the same combine as dense
// decode -- see paged_attention.cuh, `paged::verify_partial`.  No identity
// block table is built.  Bound on the card: device-memory bytes, each
// needed K/V row read once.
//
// tree_verify_attention_launch replaces the TPU kernel
// repro/kernels/tree_verify_attention.py `tree_verify_attention` (Pallas
// body `_tree_verify_kernel`): one query per packed-tree node, node j's K/V
// at position lengths[b] - N + j of the slot's rows.  Node t attends the
// committed prefix kpos < lengths - N plus the tree nodes 0 <= j < N whose
// bit is set in anc[b, t] (N <= 31, int32 bitmasks).  A row with an empty
// visibility set gives zeros.  On the serving path it is a dense-layout
// target's verify pass of an n-gram / suffix-proposed tree.  It is the
// verify body with the causal triangle replaced by the ancestor masks
// (`paged::TreeMask`): the same template, the same split-K over tiles and
// the same accumulation order, so a linear chain's masks give the verify
// entry point's output bit for bit.
#include "paged_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16.  part_acc / part_ml: float32 scratch of
// [B, splits, kvH, T * group, hd] and [.., 2].  Returns a cudaError_t code.
extern "C" int verify_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* part_acc,
                                       void* part_ml, int B, int T, int H,
                                       int kvh, int hd, int S, int tile,
                                       int pps, int splits, int dtype,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0) return cudaSuccess;
  if (dtype == 0)
    return paged::run_verify<float, false, true>(
        q, k, v, nullptr, lengths, nullptr, out, part_acc, part_ml, B, T, H,
        kvh, hd, tile, 0, S, pps, splits, stream);
  if (dtype == 1)
    return paged::run_verify<__nv_bfloat16, false, true>(
        q, k, v, nullptr, lengths, nullptr, out, part_acc, part_ml, B, T, H,
        kvh, hd, tile, 0, S, pps, splits, stream);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16.  anc: [B, N] int32.  part_acc /
// part_ml: float32 scratch of [B, splits, kvH, N * group, hd] and [.., 2].
// Returns a cudaError_t code.
extern "C" int tree_verify_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* anc, void* out, void* part_acc, void* part_ml, int B, int N,
    int H, int kvh, int hd, int S, int tile, int pps, int splits, int dtype,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || N == 0) return cudaSuccess;
  if (N > 31) return cudaErrorInvalidValue;
  if (dtype == 0)
    return paged::run_verify<float, true, true>(
        q, k, v, nullptr, lengths, anc, out, part_acc, part_ml, B, N, H, kvh,
        hd, tile, 0, S, pps, splits, stream);
  if (dtype == 1)
    return paged::run_verify<__nv_bfloat16, true, true>(
        q, k, v, nullptr, lengths, anc, out, part_acc, part_ml, B, N, H, kvh,
        hd, tile, 0, S, pps, splits, stream);
  return cudaErrorInvalidValue;
}

// Dense flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// `decode_attention` (`pallas_call` at :146; Pallas body `_decode_kernel`):
// one query token per slot, GQA, over the slot's rows of a dense
// [B, S, kvH, hd] cache, fp32 online softmax, `lengths` clamped to S, zeros
// for lengths <= 0.  On the serving path it is the draft model's proposal
// step and, on the dense target layout, the target's decode step.
//
// One launch per call, in every dtype and head dim the wrapper takes: the
// cluster kernel of decode_cluster.cuh over `paged::DenseKV` -- the slot's
// 64-row tiles split across the CTAs of one thread-block cluster, K / V
// rows copied by `cp.async` into a 2-stage ring, the splits merged in
// distributed shared memory.  Bound on the card: device-memory bytes, each
// needed K/V row read once; at serving sizes the fixed cost of two
// dependent round trips (the length, then K / V) and the launch.
//
// This library instantiates K / V in q's type; decode_attention_fp8.cu the
// same kernels over an 8-bit cache (the kernels: decode_dense.cuh).
//
// Also the partial form (`decode_attention_partial_launch`) for the
// sequence-parallel decode over a model axis: the same cluster kernel over
// one rank's block of the cache, storing each row's unnormalised acc [.., hd]
// and (m, l) in fp32 (decode_cluster.cuh, PARTIAL), and the merge of the
// blocks' partials (`combine_splits_launch`: `paged::combine_splits` at
// C = 1, the blocks as its splits; partials [B, n, H, hd] / [B, n, H, 2]).
#include "decode_dense.cuh"

using dense_decode::by_dtypes;
using dense_decode::run;
using dense_decode::run_partial;

// dtype: q's and out's (0 = float32, 1 = bfloat16); kv_dtype: k's and v's,
// here dtype (decode_attention_fp8.cu takes 2 = float8_e4m3fn and 3 =
// float8_e5m2).  tpc: 64-row tiles per CTA; cluster: CTAs per cluster
// (1..8), from `decode_plan`.  A K / V row, hd values, must fill whole
// 16-byte chunks and be at most 512 bytes.  Returns a cudaError_t code.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int H, int kvh,
                                       int hd, int S, int tpc, int cluster, int dtype,
                                       int kv_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  if (cluster < 1 || cluster > decode::kMaxCluster || tpc < 1) return cudaErrorInvalidValue;
  return by_dtypes<false>(dtype, kv_dtype, hd, [&](auto t, auto tk) {
    using T = typename decltype(t)::type;
    using TK = typename decltype(tk)::type;
    return run<T, TK>(q, k, v, lengths, out, B, H, kvh, hd, S, tpc, cluster, stream);
  });
}

// The partial form over one sequence block: q [B, H, hd], k / v [B, S, kvh,
// hd] (the block's rows), lengths [B] the block's live keys; acc [B, H, hd]
// and ml [B, H, 2] fp32.  Arguments as decode_attention_launch.
extern "C" int decode_attention_partial_launch(const void* q, const void* k, const void* v,
                                               const void* lengths, void* acc, void* ml,
                                               int B, int H, int kvh, int hd, int S, int tpc,
                                               int cluster, int dtype, int kv_dtype,
                                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  if (cluster < 1 || cluster > decode::kMaxCluster || tpc < 1) return cudaErrorInvalidValue;
  return by_dtypes<false>(dtype, kv_dtype, hd, [&](auto t, auto tk) {
    using T = typename decltype(t)::type;
    using TK = typename decltype(tk)::type;
    return run_partial<T, TK>(q, k, v, lengths, acc, ml, B, H, kvh, hd, S, tpc, cluster,
                              stream);
  });
}

// The merge of n blocks' partials: acc [B, n, H, hd], ml [B, n, H, 2] fp32 ->
// out [B, H, hd] in dtype (0 = float32, 1 = bfloat16).
extern "C" int combine_splits_launch(const void* acc, const void* ml, void* out, int B, int H,
                                     int hd, int n, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  if (n < 1) return cudaErrorInvalidValue;
  if (dtype == 0) return paged::launch_combine<float>(acc, ml, out, B, 1, H, H, hd, n, stream);
  if (dtype == 1)
    return paged::launch_combine<__nv_bfloat16>(acc, ml, out, B, 1, H, H, hd, n, stream);
  return cudaErrorInvalidValue;
}

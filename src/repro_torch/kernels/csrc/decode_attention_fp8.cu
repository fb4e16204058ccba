// Dense flash-decode attention #3 and its partial form over an 8-bit K / V
// cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// `decode_attention` (`pallas_call` at :146) where its K / V rows are the
// serve steps' quantized cache (`cache_dtype` float8_e4m3fn / e5m2: a plain
// cast with no scale; the Pallas body widens the rows to fp32 as it reads
// them, `_decode_kernel`).  The kernels are decode_attention.cu's
// (decode_dense.cuh), instantiated here for q in fp32 or bf16 over e4m3 or
// e5m2 rows: a 16-byte chunk holds 16 values, a row is hd bytes (hd a
// multiple of 16, at most 512), and each pair of values widens by
// `cvt.rn.f16x2.e4m3x2` / `.e5m2x2` and then to fp32 (decode_cluster.cuh);
// the scores and the online softmax stay fp32.  Bound on the card: the
// bytes of the K / V rows, half the bf16 cache's, and at serving sizes the
// launch and two dependent round trips, as for the bf16 rows.  A library of
// its own so that its instantiations compile beside decode_attention.cu's.
#include "decode_dense.cuh"

using dense_decode::by_dtypes;
using dense_decode::run;
using dense_decode::run_partial;

// dtype: q's and out's (0 = float32, 1 = bfloat16); kv_dtype: k's and v's
// (2 = float8_e4m3fn, 3 = float8_e5m2).  Otherwise as
// decode_attention.cu's decode_attention_launch.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int H, int kvh,
                                       int hd, int S, int tpc, int cluster, int dtype,
                                       int kv_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  if (cluster < 1 || cluster > decode::kMaxCluster || tpc < 1) return cudaErrorInvalidValue;
  return by_dtypes<true>(dtype, kv_dtype, hd, [&](auto t, auto tk) {
    using T = typename decltype(t)::type;
    using TK = typename decltype(tk)::type;
    return run<T, TK>(q, k, v, lengths, out, B, H, kvh, hd, S, tpc, cluster, stream);
  });
}

// The partial form over one sequence block of an 8-bit cache: acc [B, H, hd]
// and ml [B, H, 2] fp32.  Arguments as decode_attention_launch above.
extern "C" int decode_attention_partial_launch(const void* q, const void* k, const void* v,
                                               const void* lengths, void* acc, void* ml,
                                               int B, int H, int kvh, int hd, int S, int tpc,
                                               int cluster, int dtype, int kv_dtype,
                                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  if (cluster < 1 || cluster > decode::kMaxCluster || tpc < 1) return cudaErrorInvalidValue;
  return by_dtypes<true>(dtype, kv_dtype, hd, [&](auto t, auto tk) {
    using T = typename decltype(t)::type;
    using TK = typename decltype(tk)::type;
    return run_partial<T, TK>(q, k, v, lengths, acc, ml, B, H, kvh, hd, S, tpc, cluster,
                              stream);
  });
}

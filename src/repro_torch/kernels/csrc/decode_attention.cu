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
// Also the partial form (`decode_attention_partial_launch`) for the
// sequence-parallel decode over a model axis: the same cluster kernel over
// one rank's block of the cache, storing each row's unnormalised acc [.., hd]
// and (m, l) in fp32 (decode_cluster.cuh, PARTIAL), and the merge of the
// blocks' partials (`combine_splits_launch`: `paged::combine_splits` at
// C = 1, the blocks as its splits; partials [B, n, H, hd] / [B, n, H, 2]).
#include "decode_cluster.cuh"

namespace {

// Grid (kvh * passes, 1, B * cluster); clusters of (1, 1, cluster).
template <typename T, int G, int LPR>
__global__ void __launch_bounds__(decode::kThreads)
    dense_decode_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const int* __restrict__ lengths,
                                T* __restrict__ out, int H, int kvh, int hd, int S, int tpc,
                                int cluster, float sl2) {
  const int passes = gridDim.x / kvh;
  const int head = blockIdx.x / passes, g0 = (blockIdx.x % passes) * G;
  const int b = blockIdx.z / cluster;
  const paged::DenseKV kv{(size_t)b * S * kvh * hd, 0, S};
  decode::attend<T, G, LPR>(q + (size_t)b * H * hd, k, v, kv, lengths + b,
                            out + (size_t)b * H * hd, H / kvh, kvh, hd, 0, head, g0, tpc,
                            cluster, sl2);
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const void* lengths, void* out,
                int B, int H, int kvh, int hd, int S, int tpc, int cluster, void* stream) {
  return decode::dispatch(H / kvh, hd, (int)sizeof(T), [&](auto g, auto lpr, int passes) {
    constexpr int G = decltype(g)::value, LPR = decltype(lpr)::value;
    return kern::launch_cluster(
        dense_decode_cluster_kernel<T, G, LPR>, dim3(kvh * passes, 1, B * cluster),
        decode::kThreads,
        decode::smem_bytes(G, hd, (int)sizeof(T), 0), cluster, stream,
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const int*>(lengths), static_cast<T*>(out), H, kvh, hd, S, tpc, cluster,
        1.4426950408889634f / sqrtf((float)hd));
  });
}

// The partial form: grid and clusters as above; acc [B, H, hd], ml [B, H, 2].
template <typename T, int G, int LPR>
__global__ void __launch_bounds__(decode::kThreads)
    dense_decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const int* __restrict__ lengths,
                                float* __restrict__ acc, float* __restrict__ ml, int H, int kvh,
                                int hd, int S, int tpc, int cluster, float sl2) {
  const int passes = gridDim.x / kvh;
  const int head = blockIdx.x / passes, g0 = (blockIdx.x % passes) * G;
  const int b = blockIdx.z / cluster;
  const paged::DenseKV kv{(size_t)b * S * kvh * hd, 0, S};
  decode::attend<T, G, LPR, true>(q + (size_t)b * H * hd, k, v, kv, lengths + b, nullptr,
                                  H / kvh, kvh, hd, 0, head, g0, tpc, cluster, sl2,
                                  acc + (size_t)b * H * hd, ml + (size_t)b * H * 2);
}

template <typename T>
cudaError_t run_partial(const void* q, const void* k, const void* v, const void* lengths,
                        void* acc, void* ml, int B, int H, int kvh, int hd, int S, int tpc,
                        int cluster, void* stream) {
  return decode::dispatch(H / kvh, hd, (int)sizeof(T), [&](auto g, auto lpr, int passes) {
    constexpr int G = decltype(g)::value, LPR = decltype(lpr)::value;
    return kern::launch_cluster(
        dense_decode_partial_kernel<T, G, LPR>, dim3(kvh * passes, 1, B * cluster),
        decode::kThreads,
        decode::smem_bytes(G, hd, (int)sizeof(T), 0), cluster, stream,
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const int*>(lengths), static_cast<float*>(acc), static_cast<float*>(ml),
        H, kvh, hd, S, tpc, cluster, 1.4426950408889634f / sqrtf((float)hd));
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  tpc: 64-row tiles per CTA; cluster:
// CTAs per cluster (1..8), from `decode_plan`.  hd * sizeof(dtype) must be
// a multiple of 16 and at most 512.  Returns a cudaError_t code.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int H, int kvh,
                                       int hd, int S, int tpc, int cluster, int dtype,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  if (cluster < 1 || cluster > decode::kMaxCluster || tpc < 1) return cudaErrorInvalidValue;
  if (dtype == 0 && hd % 4 == 0 && hd * 4 <= decode::kMaxRowBytes)
    return run<float>(q, k, v, lengths, out, B, H, kvh, hd, S, tpc, cluster, stream);
  if (dtype == 1 && hd % 8 == 0 && hd * 2 <= decode::kMaxRowBytes)
    return run<__nv_bfloat16>(q, k, v, lengths, out, B, H, kvh, hd, S, tpc, cluster, stream);
  return cudaErrorInvalidValue;
}

// The partial form over one sequence block: q [B, H, hd], k / v [B, S, kvh,
// hd] (the block's rows), lengths [B] the block's live keys; acc [B, H, hd]
// and ml [B, H, 2] fp32.  Arguments as decode_attention_launch.
extern "C" int decode_attention_partial_launch(const void* q, const void* k, const void* v,
                                               const void* lengths, void* acc, void* ml,
                                               int B, int H, int kvh, int hd, int S, int tpc,
                                               int cluster, int dtype, int device,
                                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  if (cluster < 1 || cluster > decode::kMaxCluster || tpc < 1) return cudaErrorInvalidValue;
  if (dtype == 0 && hd % 4 == 0 && hd * 4 <= decode::kMaxRowBytes)
    return run_partial<float>(q, k, v, lengths, acc, ml, B, H, kvh, hd, S, tpc, cluster,
                              stream);
  if (dtype == 1 && hd % 8 == 0 && hd * 2 <= decode::kMaxRowBytes)
    return run_partial<__nv_bfloat16>(q, k, v, lengths, acc, ml, B, H, kvh, hd, S, tpc,
                                      cluster, stream);
  return cudaErrorInvalidValue;
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

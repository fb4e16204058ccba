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

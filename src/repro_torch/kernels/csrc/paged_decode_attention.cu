// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_decode_attention.py
// `paged_decode_attention` (`pallas_call` at :111; Pallas body
// `_decode_kernel` in repro/kernels/decode_attention.py): one query token
// per slot, GQA, over the slot's pages named by its block-table row (the
// last column is the sentinel and is never read), fp32 online softmax,
// zeros for lengths == 0.  On the serving path it is every decode step of
// the paged engine, replayed from a CUDA graph.
//
// One launch per call, in every dtype and head dim the wrapper takes: the
// cluster kernel of decode_cluster.cuh over `paged::PagedKV` -- the slot's
// 64-key tiles split across the CTAs of one thread-block cluster, the
// CTA's block-table entries staged with the length and q, K / V rows
// copied by `cp.async` into a 2-stage ring, the splits merged in
// distributed shared memory.  Bound on the card: device-memory bytes, each
// needed K/V row read once; at serving sizes the fixed cost of two
// dependent round trips and the launch.
#include "decode_cluster.cuh"

namespace {

// Grid (kvh * passes, 1, B * cluster); clusters of (1, 1, cluster).
template <typename T, int G, int LPR>
__global__ void __launch_bounds__(decode::kThreads)
    paged_decode_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                                const T* __restrict__ v_pool,
                                const int* __restrict__ block_tables,
                                const int* __restrict__ lengths, T* __restrict__ out, int H,
                                int kvh, int hd, int page, int W, int tpc, int cluster,
                                float sl2) {
  const int passes = gridDim.x / kvh;
  const int head = blockIdx.x / passes, g0 = (blockIdx.x % passes) * G;
  const int b = blockIdx.z / cluster;
  const paged::PagedKV kv{block_tables + (size_t)b * W, W - 1, (W - 1) * page};
  decode::attend<T, G, LPR>(q + (size_t)b * H * hd, k_pool, v_pool, kv, lengths + b,
                            out + (size_t)b * H * hd, H / kvh, kvh, hd, page, head, g0, tpc,
                            cluster, sl2);
}

template <typename T>
cudaError_t run(const void* q, const void* k_pool, const void* v_pool, const void* block_tables,
                const void* lengths, void* out, int B, int H, int kvh, int hd, int page, int W,
                int tpc, int cluster, void* stream) {
  const int table_ints = decode::table_ints(tpc, page);
  return decode::dispatch(H / kvh, hd, (int)sizeof(T), [&](auto g, auto lpr, int passes) {
    constexpr int G = decltype(g)::value, LPR = decltype(lpr)::value;
    return kern::launch_cluster(
        paged_decode_cluster_kernel<T, G, LPR>, dim3(kvh * passes, 1, B * cluster),
        decode::kThreads,
        decode::smem_bytes(G, hd, (int)sizeof(T), table_ints), cluster, stream,
        static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
        static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
        static_cast<T*>(out), H, kvh, hd, page, W, tpc, cluster,
        1.4426950408889634f / sqrtf((float)hd));
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  tpc: 64-key tiles per CTA; cluster:
// CTAs per cluster (1..8), from `decode_plan`.  hd * sizeof(dtype) must be
// a multiple of 16 and at most 512.  Returns a cudaError_t code.
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const void* block_tables,
                                             const void* lengths, void* out, int B, int H,
                                             int kvh, int hd, int page, int W, int tpc,
                                             int cluster, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  if (cluster < 1 || cluster > decode::kMaxCluster || tpc < 1) return cudaErrorInvalidValue;
  if (dtype == 0 && hd % 4 == 0 && hd * 4 <= decode::kMaxRowBytes)
    return run<float>(q, k_pool, v_pool, block_tables, lengths, out, B, H, kvh, hd, page, W,
                      tpc, cluster, stream);
  if (dtype == 1 && hd % 8 == 0 && hd * 2 <= decode::kMaxRowBytes)
    return run<__nv_bfloat16>(q, k_pool, v_pool, block_tables, lengths, out, B, H, kvh, hd,
                              page, W, tpc, cluster, stream);
  return cudaErrorInvalidValue;
}

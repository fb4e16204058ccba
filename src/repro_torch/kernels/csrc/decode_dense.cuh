// The dense decode kernel #3 and its partial form, templated on q's type T
// and the K / V rows' type TK, over the cluster body of decode_cluster.cuh
// (`paged::DenseKV`), with the launches and the dtype dispatch their C
// entry points share.  Two libraries instantiate them: decode_attention.cu
// (K / V in q's type) and decode_attention_fp8.cu (8-bit K / V: e4m3 or
// e5m2), so the two sets compile in parallel.
#pragma once

#include "decode_cluster.cuh"

namespace dense_decode {

// Grid (kvh * passes, 1, B * cluster); clusters of (1, 1, cluster).
template <typename T, typename TK, int G, int LPR>
__global__ void __launch_bounds__(decode::kThreads)
    dense_decode_cluster_kernel(const T* __restrict__ q, const TK* __restrict__ k,
                                const TK* __restrict__ v, const int* __restrict__ lengths,
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

template <typename T, typename TK>
cudaError_t run(const void* q, const void* k, const void* v, const void* lengths, void* out,
                int B, int H, int kvh, int hd, int S, int tpc, int cluster, void* stream) {
  return decode::dispatch(H / kvh, hd, (int)sizeof(TK), [&](auto g, auto lpr, int passes) {
    constexpr int G = decltype(g)::value, LPR = decltype(lpr)::value;
    return kern::launch_cluster(
        dense_decode_cluster_kernel<T, TK, G, LPR>, dim3(kvh * passes, 1, B * cluster),
        decode::kThreads,
        decode::smem_bytes(G, hd, (int)sizeof(TK), 0), cluster, stream,
        static_cast<const T*>(q), static_cast<const TK*>(k), static_cast<const TK*>(v),
        static_cast<const int*>(lengths), static_cast<T*>(out), H, kvh, hd, S, tpc, cluster,
        1.4426950408889634f / sqrtf((float)hd));
  });
}

// The partial form: grid and clusters as above; acc [B, H, hd], ml [B, H, 2].
template <typename T, typename TK, int G, int LPR>
__global__ void __launch_bounds__(decode::kThreads)
    dense_decode_partial_kernel(const T* __restrict__ q, const TK* __restrict__ k,
                                const TK* __restrict__ v, const int* __restrict__ lengths,
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

template <typename T, typename TK>
cudaError_t run_partial(const void* q, const void* k, const void* v, const void* lengths,
                        void* acc, void* ml, int B, int H, int kvh, int hd, int S, int tpc,
                        int cluster, void* stream) {
  return decode::dispatch(H / kvh, hd, (int)sizeof(TK), [&](auto g, auto lpr, int passes) {
    constexpr int G = decltype(g)::value, LPR = decltype(lpr)::value;
    return kern::launch_cluster(
        dense_decode_partial_kernel<T, TK, G, LPR>, dim3(kvh * passes, 1, B * cluster),
        decode::kThreads,
        decode::smem_bytes(G, hd, (int)sizeof(TK), 0), cluster, stream,
        static_cast<const T*>(q), static_cast<const TK*>(k), static_cast<const TK*>(v),
        static_cast<const int*>(lengths), static_cast<float*>(acc), static_cast<float*>(ml),
        H, kvh, hd, S, tpc, cluster, 1.4426950408889634f / sqrtf((float)hd));
  });
}

template <typename X> struct Type { using type = X; };

// Calls run(Type<T>{}, Type<TK>{}) for the (q, K / V) dtype codes (q: 0 =
// float32, 1 = bfloat16; K / V: q's code, or under FP8 2 = float8_e4m3fn,
// 3 = float8_e5m2: each library instantiates one set) when hd fills whole
// 16-byte chunks of K / V values and a row is at most kMaxRowBytes; else
// cudaErrorInvalidValue.
template <bool FP8, typename Run>
cudaError_t by_dtypes(int dtype, int kv_dtype, int hd, Run&& run) {
  const bool fp8 = kv_dtype == 2 || kv_dtype == 3;
  if (fp8 != FP8 || (!fp8 && kv_dtype != dtype) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int elem = fp8 ? 1 : dtype == 0 ? 4 : 2;
  if (hd % (16 / elem) != 0 || hd * elem > decode::kMaxRowBytes) return cudaErrorInvalidValue;
  if constexpr (FP8) {
    if (dtype == 0)
      return kv_dtype == 2 ? run(Type<float>{}, Type<__nv_fp8_e4m3>{})
                           : run(Type<float>{}, Type<__nv_fp8_e5m2>{});
    return kv_dtype == 2 ? run(Type<__nv_bfloat16>{}, Type<__nv_fp8_e4m3>{})
                         : run(Type<__nv_bfloat16>{}, Type<__nv_fp8_e5m2>{});
  } else {
    if (dtype == 0) return run(Type<float>{}, Type<float>{});
    return run(Type<__nv_bfloat16>{}, Type<__nv_bfloat16>{});
  }
}

}  // namespace dense_decode

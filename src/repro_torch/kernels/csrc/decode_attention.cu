// Dense flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// `decode_attention` (Pallas body `_decode_kernel`): one query token per
// slot, GQA, over the slot's rows of a dense [B, S, kvH, hd] cache, fp32
// online softmax, `lengths` clamped to S, zeros for lengths <= 0.  On the
// serving path it is the draft model's proposal step.
//
// The paged decode kernel's body over another KV address (`paged::DenseKV`:
// a tile is 16 consecutive cache rows, the last one cut at S) -- see
// paged_attention.cuh.  Split-K: `dense_decode_partial` runs one block per
// (kv head, slot, split of `pps` tiles) up to ceil(length / 16) tiles, and
// `paged::combine_splits` merges the splits.  Bound on the card:
// device-memory bytes, each needed K/V row read once.  The draft's batch is
// only B * kvH = 64 (slot, kv head) pairs against 132 SMs; splitting the
// tiles multiplies the blocks by up to 16.
#include "paged_attention.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(paged::kThreads)
    dense_decode_partial(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ lengths,
                         float* __restrict__ part_acc,
                         float* __restrict__ part_ml, int H, int kvh, int hd,
                         int S, int tile, int pps, float scale) {
  const int head = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int splits = gridDim.z, group = H / kvh;
  const int len = min(lengths[b], S);
  const paged::DenseKV kv{(size_t)b * S * kvh * hd, (S + tile - 1) / tile, S};
  const paged::Epilogue<T> epi = paged::split_epilogue<T>(
      part_acc, part_ml, b, s, splits, kvh, head, group, hd);
  paged::attend_block<T, 8, 1, 1>(q + (size_t)b * H * hd, k, v, kv,
                                  paged::Causal{}, len - 1, len > 0 ? 1 : 0, 0,
                                  1, 1, H, kvh, head, group, hd, tile, s * pps,
                                  (s + 1) * pps, scale, epi);
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* lengths, void* out, void* part_acc, void* part_ml,
                int B, int H, int kvh, int hd, int S, int tile, int pps,
                int splits, void* stream) {
  const size_t smem = paged::smem_bytes(H / kvh, hd, tile);
  cudaError_t err = paged::launch(
      dense_decode_partial<T>, dim3(kvh, B, splits), smem, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, kvh, hd,
      S, tile, pps, 1.0f / sqrtf((float)hd));
  if (err != cudaSuccess) return err;
  return paged::launch_combine<T>(part_acc, part_ml, out, B, 1, H, kvh, hd,
                                  splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part_acc / part_ml: float32 scratch of
// [B, splits, kvH, group, hd] and [B, splits, kvH, group, 2].  Returns a
// cudaError_t code.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* part_acc,
                                       void* part_ml, int B, int H, int kvh,
                                       int hd, int S, int tile, int pps,
                                       int splits, int dtype, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  if (dtype == 0)
    return run<float>(q, k, v, lengths, out, part_acc, part_ml, B, H, kvh, hd,
                      S, tile, pps, splits, stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, lengths, out, part_acc, part_ml, B, H,
                              kvh, hd, S, tile, pps, splits, stream);
  return cudaErrorInvalidValue;
}

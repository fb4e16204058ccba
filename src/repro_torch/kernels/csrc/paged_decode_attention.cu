// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_decode_attention.py
// `paged_decode_attention` (Pallas body `_decode_kernel` in
// repro/kernels/decode_attention.py): one query token per slot, GQA, over
// the slot's pages named by its block-table row (the last column is the
// sentinel and is never read), fp32 online softmax, zeros for lengths == 0.
//
// Two kernels (split-K, "flash-decoding"): `paged_decode_partial` runs one
// block per (kv head, slot, split of `pps` pages) over the split's pages up
// to ceil(length / page) -- see paged_attention.cuh -- and writes each row's
// unnormalised accumulator and (m, l); `paged::combine_splits` merges the
// splits of each (slot, q head) with the usual rescaling.  Bound on the card:
// device-memory bytes, each needed K/V row read once.  A decode batch has
// only B * kvH (slot, kv head) pairs, too few blocks to keep 132 SMs busy;
// splitting the pages multiplies the blocks by up to 16.
#include "paged_attention.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(paged::kThreads)
    paged_decode_partial(const T* __restrict__ q, const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ lengths,
                         float* __restrict__ part_acc,
                         float* __restrict__ part_ml, int H, int kvh, int hd,
                         int page, int W, int pps, float scale) {
  const int head = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int splits = gridDim.z, group = H / kvh;
  const int len = lengths[b];
  const paged::PagedKV kv{block_tables + (size_t)b * W, W - 1, (W - 1) * page};
  const paged::Epilogue<T> epi = paged::split_epilogue<T>(
      part_acc, part_ml, b, s, splits, kvh, head, group, hd);
  // the decode query sits at position len - 1 and sees kpos < len
  paged::attend_block<T, 8, 1, 1>(q + (size_t)b * H * hd, k_pool, v_pool, kv,
                                  paged::Causal{}, len - 1, len > 0 ? 1 : 0, 0,
                                  1, 1, H, kvh, head, group, hd, page, s * pps,
                                  (s + 1) * pps, scale, epi);
}

template <typename T>
cudaError_t run(const void* q, const void* k_pool, const void* v_pool,
                const void* block_tables, const void* lengths, void* out,
                void* part_acc, void* part_ml, int B, int H, int kvh, int hd,
                int page, int W, int pps, int splits, void* stream) {
  const size_t smem = paged::smem_bytes(H / kvh, hd, page);
  cudaError_t err = paged::launch(
      paged_decode_partial<T>, dim3(kvh, B, splits), smem, stream,
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), H, kvh, hd, page, W, pps,
      1.0f / sqrtf((float)hd));
  if (err != cudaSuccess) return err;
  return paged::launch_combine<T>(part_acc, part_ml, out, B, 1, H, kvh, hd,
                                  splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part_acc / part_ml: float32 scratch of
// [B, splits, kvH, group, hd] and [B, splits, kvH, group, 2].  Returns a cudaError_t code.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, void* out, void* part_acc,
    void* part_ml, int B, int H, int kvh, int hd, int page, int W, int pps,
    int splits, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  if (dtype == 0)
    return run<float>(q, k_pool, v_pool, block_tables, lengths, out, part_acc,
                      part_ml, B, H, kvh, hd, page, W, pps, splits, stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k_pool, v_pool, block_tables, lengths, out,
                              part_acc, part_ml, B, H, kvh, hd, page, W, pps,
                              splits, stream);
  return cudaErrorInvalidValue;
}

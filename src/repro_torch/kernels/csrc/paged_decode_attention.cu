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
// unnormalised accumulator and (m, l); `combine_splits` merges the splits of
// each (slot, q head) with the usual rescaling.  Bound on the card:
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
  const size_t row0 = ((size_t)b * splits + s) * H + (size_t)head * group;
  paged::Epilogue<T> epi{nullptr, part_acc + row0 * hd, part_ml + row0 * 2};
  // the decode query sits at position len - 1 and sees kpos < len
  paged::attend_block<T, 8, 1, 1>(q + (size_t)b * H * hd, k_pool, v_pool,
                                  block_tables + (size_t)b * W, len - 1,
                                  len > 0 ? 1 : 0, 0, 1, 1, H, kvh, head, group,
                                  hd, page, W - 1, s * pps, (s + 1) * pps,
                                  scale, epi);
}

// out[b, h] = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the splits
// that saw a key (l_s > 0); 0 when none did.
template <typename T>
__global__ void __launch_bounds__(paged::kThreads)
    combine_splits(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml, T* __restrict__ out,
                   int H, int hd, int splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t base = (size_t)b * splits * H + h;  // row of split 0
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) {
    const float* ml = part_ml + (base + (size_t)s * H) * 2;
    if (ml[1] > 0.f) M = fmaxf(M, ml[0]);
  }
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float L = 0.f, O = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t row = base + (size_t)s * H;
      const float* ml = part_ml + row * 2;
      if (ml[1] > 0.f) {
        const float w = expf(ml[0] - M);
        L = fmaf(w, ml[1], L);
        O = fmaf(w, part_acc[row * hd + d], O);
      }
    }
    paged::store1(out + ((size_t)b * H + h) * hd + d, L > 0.f ? O / L : 0.f);
  }
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
  return paged::launch(combine_splits<T>, dim3(H, B), 0, stream,
                       static_cast<const float*>(part_acc),
                       static_cast<const float*>(part_ml),
                       static_cast<T*>(out), H, hd, splits);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part_acc / part_ml: float32 scratch of
// [B, splits, H, hd] and [B, splits, H, 2].  Returns a cudaError_t code.
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

// Paged ragged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_prefill_attention.py
// `paged_prefill_attention` (Pallas body `_prefill_kernel` in
// repro/kernels/prefill_attention.py): chunk query t of slot b attends
// kpos <= starts[b] + t over the slot's pages; rows t >= chunk_lens give
// zeros; chunk_lens is clamped to C; pages past a q block's causal bound
// starts + min((qi + 1) * block_q, chunk_lens) are never read.
//
// Grid (q blocks, kv heads, slots); one block per (slot, kv head, block_q
// chunk rows) holds block_q * group query rows -- see paged_attention.cuh.
// Bound on the card: device-memory bytes at serving chunk sizes (each needed
// K/V row read once).  block_q is small (8, against the TPU's 32) so a
// 32-token chunk wave gives 4x the blocks of one block per chunk; the
// blocks of one slot re-read its pages, mostly from L2.  Each thread scores
// 4 keys per pass and updates 4 rows per V load.  The math is fp32 FMAs on
// CUDA cores; wgmma tiles are later work.
#include "paged_attention.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(paged::kThreads)
    paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ starts,
                         const int* __restrict__ chunk_lens,
                         T* __restrict__ out, int C, int H, int kvh, int hd,
                         int page, int W, int block_q, float scale) {
  const int qi = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int clen = min(max(chunk_lens[b], 0), C);
  const size_t qoff = (size_t)b * C * H * hd;
  paged::Epilogue<T> epi{out + qoff, nullptr, nullptr};
  paged::attend_block<T, 1, 4, 4>(q + qoff, k_pool, v_pool,
                                  block_tables + (size_t)b * W, starts[b], clen,
                                  qi * block_q, block_q, C, H, kvh, head,
                                  H / kvh, hd, page, W - 1, 0, W - 1, scale,
                                  epi);
}

template <typename T>
cudaError_t run(const void* q, const void* k_pool, const void* v_pool,
                const void* block_tables, const void* starts,
                const void* chunk_lens, void* out, int B, int C, int H,
                int kvh, int hd, int page, int W, int block_q, void* stream) {
  const size_t smem = paged::smem_bytes(block_q * (H / kvh), hd, page);
  const int nq = (C + block_q - 1) / block_q;
  return paged::launch(
      paged_prefill_kernel<T>, dim3(nq, kvh, B), smem, stream,
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(starts), static_cast<const int*>(chunk_lens),
      static_cast<T*>(out), C, H, kvh, hd, page, W, block_q,
      1.0f / sqrtf((float)hd));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  page must be a multiple of 4.
// Returns a cudaError_t code.
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* starts, const void* chunk_lens,
    void* out, int B, int C, int H, int kvh, int hd, int page, int W,
    int block_q, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || C == 0) return cudaSuccess;
  if (page % 4 != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return run<float>(q, k_pool, v_pool, block_tables, starts, chunk_lens,
                      out, B, C, H, kvh, hd, page, W, block_q, stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k_pool, v_pool, block_tables, starts,
                              chunk_lens, out, B, C, H, kvh, hd, page, W,
                              block_q, stream);
  return cudaErrorInvalidValue;
}

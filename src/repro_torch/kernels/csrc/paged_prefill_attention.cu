// Paged ragged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_prefill_attention.py
// `paged_prefill_attention` (Pallas body `_prefill_kernel` in
// repro/kernels/prefill_attention.py): chunk query t of slot b attends
// kpos <= starts[b] + t over the slot's pages; rows t >= chunk_lens give
// zeros; chunk_lens is clamped to C; pages past a q tile's causal bound
// starts + min(last row + 1, chunk_lens) are never read.
//
// Bound on the card: device-memory bytes at serving chunk sizes (each
// needed K/V row read once per kv head), and the latency of walking the
// longest slot's pages.  Two bodies, chosen by the caller from dtype and
// head dim (`body`):
//   * bf16 at hd 64 / 128: the tensor-core body of prefill_tc.cuh -- one
//     warpgroup per (64 q rows, kv head, slot), `wgmma` products, the
//     softmax in registers, 64-key tiles (four 16-row pages) gathered
//     by `cp.async` into a 2-stage ring through the slot's block-table row,
//     which the CTA first stages in shared memory;
//   * fp32 or another head dim: the FMA body of paged_attention.cuh
//     (block_q chunk rows per block, fp32 FMAs on CUDA cores), which the
//     fp32 parity checks hold to 1e-4 and TF32 products would not meet.
#include "prefill_tc.cuh"

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
  const paged::PagedKV kv{block_tables + (size_t)b * W, W - 1, (W - 1) * page};
  paged::Epilogue<T> epi{out + qoff, nullptr, nullptr};
  paged::attend_block<T, 1, 4, 4>(q + qoff, k_pool, v_pool, kv,
                                  paged::Causal{}, starts[b], clen,
                                  qi * block_q, block_q, C, H, kvh, head,
                                  H / kvh, hd, page, 0, W - 1, scale, epi);
}

template <int HD>
__global__ void __launch_bounds__(prefill_tc::kThreads)
    paged_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k_pool,
                            const __nv_bfloat16* __restrict__ v_pool,
                            const int* __restrict__ block_tables,
                            const int* __restrict__ starts,
                            const int* __restrict__ chunk_lens,
                            __nv_bfloat16* __restrict__ out, int C, int H,
                            int kvh, int page, int W, float scale) {
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int clen = min(max(chunk_lens[b], 0), C);
  const size_t qoff = (size_t)b * C * H * HD;
  const paged::PagedKV kv{block_tables + (size_t)b * W, W - 1, (W - 1) * page};
  prefill_tc::attend_tile<HD>(
      q + qoff, k_pool, v_pool, kv, prefill_tc::CausalVis{}, page, starts[b], clen, C, H,
      kvh, head, qt, 0, prefill_tc::kAllTiles, scale, prefill_tc::RowsOut{out + qoff});
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

template <int HD>
cudaError_t run_tc(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_tables, const void* starts,
                   const void* chunk_lens, void* out, int B, int C, int H,
                   int kvh, int page, int W, void* stream) {
  using bf16 = __nv_bfloat16;
  return kern::launch(
      paged_prefill_tc_kernel<HD>,
      dim3(prefill_tc::q_tiles(C, H / kvh), kvh, B), prefill_tc::kThreads,
      prefill_tc::smem_bytes<HD>(W - 1), stream, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k_pool), static_cast<const bf16*>(v_pool),
      static_cast<const int*>(block_tables), static_cast<const int*>(starts),
      static_cast<const int*>(chunk_lens), static_cast<bf16*>(out), C, H, kvh,
      page, W, 1.0f / sqrtf((float)HD));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  body: 0 = the FMA body (any dtype;
// page a multiple of 4), 1 = the tensor-core body (bfloat16, hd 64 or 128).
// Returns a cudaError_t code.
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* starts, const void* chunk_lens,
    void* out, int B, int C, int H, int kvh, int hd, int page, int W,
    int block_q, int dtype, int body, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || C == 0) return cudaSuccess;
  if (body == 1 && dtype == 1 && hd == 64)
    return run_tc<64>(q, k_pool, v_pool, block_tables, starts, chunk_lens, out,
                      B, C, H, kvh, page, W, stream);
  if (body == 1 && dtype == 1 && hd == 128)
    return run_tc<128>(q, k_pool, v_pool, block_tables, starts, chunk_lens,
                       out, B, C, H, kvh, page, W, stream);
  if (body != 0 || page % 4 != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return run<float>(q, k_pool, v_pool, block_tables, starts, chunk_lens,
                      out, B, C, H, kvh, hd, page, W, block_q, stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k_pool, v_pool, block_tables, starts,
                              chunk_lens, out, B, C, H, kvh, hd, page, W,
                              block_q, stream);
  return cudaErrorInvalidValue;
}

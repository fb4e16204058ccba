// Dense ragged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/prefill_attention.py
// `prefill_attention` (Pallas body `_prefill_kernel`): chunk query t of slot
// b attends kpos <= starts[b] + t over the slot's rows of a dense
// [B, S, kvH, hd] cache (kpos < S); rows t >= chunk_lens give zeros;
// chunk_lens is clamped to C; tiles past a q block's causal bound
// starts + min((qi + 1) * block_q, chunk_lens) are never read.  On the
// serving path it is the draft model's chunk prefill.
//
// The paged prefill kernel's body over another KV address
// (`paged::DenseKV`: a tile is 16 consecutive cache rows, the last one cut
// at S) -- see paged_attention.cuh.  Grid (q blocks, kv heads, slots); one
// block per (slot, kv head, block_q chunk rows).  Bound on the card:
// device-memory bytes (each needed K/V row read once); the blocks of one
// slot re-read its rows, mostly from L2.  fp32 FMAs on CUDA cores.
#include "paged_attention.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(paged::kThreads)
    dense_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ starts,
                         const int* __restrict__ chunk_lens,
                         T* __restrict__ out, int C, int H, int kvh, int hd,
                         int S, int tile, int block_q, float scale) {
  const int qi = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int clen = min(max(chunk_lens[b], 0), C);
  const size_t qoff = (size_t)b * C * H * hd;
  const paged::DenseKV kv{(size_t)b * S * kvh * hd, (S + tile - 1) / tile, S};
  paged::Epilogue<T> epi{out + qoff, nullptr, nullptr};
  paged::attend_block<T, 1, 4, 4>(q + qoff, k, v, kv, paged::Causal{},
                                  starts[b], clen, qi * block_q, block_q, C, H,
                                  kvh, head, H / kvh, hd, tile, 0, kv.n_tiles,
                                  scale, epi);
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* starts, const void* chunk_lens, void* out, int B,
                int C, int H, int kvh, int hd, int S, int tile, int block_q,
                void* stream) {
  const size_t smem = paged::smem_bytes(block_q * (H / kvh), hd, tile);
  const int nq = (C + block_q - 1) / block_q;
  return paged::launch(
      dense_prefill_kernel<T>, dim3(nq, kvh, B), smem, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(starts),
      static_cast<const int*>(chunk_lens), static_cast<T*>(out), C, H, kvh,
      hd, S, tile, block_q, 1.0f / sqrtf((float)hd));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  tile must be a multiple of 4.
// Returns a cudaError_t code.
extern "C" int prefill_attention_launch(const void* q, const void* k,
                                        const void* v, const void* starts,
                                        const void* chunk_lens, void* out,
                                        int B, int C, int H, int kvh, int hd,
                                        int S, int tile, int block_q,
                                        int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || C == 0) return cudaSuccess;
  if (tile % 4 != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return run<float>(q, k, v, starts, chunk_lens, out, B, C, H, kvh, hd, S,
                      tile, block_q, stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, starts, chunk_lens, out, B, C, H, kvh,
                              hd, S, tile, block_q, stream);
  return cudaErrorInvalidValue;
}

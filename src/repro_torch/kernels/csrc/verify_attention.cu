// Dense chunk-verify and tree-verify attention for Hopper (sm_90a): one
// library, two entry points over one template.
//
// verify_attention_launch replaces the TPU kernel repro/kernels/verify_attention.py
// `verify_attention` (`pallas_call` at :169; Pallas body `_verify_kernel`):
// the T = gamma + 1 chunk queries of slot b sit at positions lengths[b] - T + t
// of the slot's rows of a dense [B, S, kvH, hd] cache, their K/V already
// written, and query t attends kpos <= lengths[b] - T + t -- the prefix plus
// the chunk's causal triangle.  A row whose causal window is empty
// (lengths < T, lengths == 0) gives zeros.  `lengths` is not clamped to S
// (the tile walk stops at S).  On the serving path it is a dense-layout
// target's verify pass of a draft-model round.
//
// tree_verify_attention_launch replaces the TPU kernel
// repro/kernels/tree_verify_attention.py `tree_verify_attention`
// (`pallas_call` at :180; Pallas body `_tree_verify_kernel`): one query per
// packed-tree node, node j's K/V at position lengths[b] - N + j of the
// slot's rows.  Node t attends the committed prefix kpos < lengths - N plus
// the tree nodes 0 <= j < N whose bit is set in anc[b, t] (N <= 31, int32
// bitmasks).  A row with an empty visibility set gives zeros.  On the
// serving path it is a dense-layout target's verify pass of an n-gram /
// suffix-proposed tree.
//
// What bounds both on the card: the bytes of the K/V rows the chunk sees
// (each read once per kv head), and at serving sizes (a few rows per kv
// head, up to 8 64-key tiles per slot) the latency of a short walk and the
// launch's fixed costs.  Two bodies, chosen by the caller from dtype and
// head dim (`body`):
//   * bf16 at hd 64 / 128: the tensor-core body of prefill_tc.cuh
//     (`attend_tile` over `paged::DenseKV`, `CausalVis` or `TreeVis`), split
//     over the slot's 64-key tiles across the CTAs of one thread-block
//     cluster.  Grid (q tiles of 64 rows, kv heads, B * cluster), clusters
//     of (1, 1, cluster): CTA rank r walks tiles r * tpc .. r * tpc + tpc - 1
//     (`tpc` >= 2, so a second tile's fetch runs under the first one's
//     math), then the cluster merges its splits' (m, l, O) through
//     distributed shared memory (`prefill_tc::ClusterOut`) and writes the
//     normalised rows.  One launch: no second kernel to start and no fp32
//     scratch in device memory between two launches, which was half of the
//     paged verify's split-and-combine time.  A CTA whose tiles lie past
//     its rows' last visible key loads nothing and merges (-inf, 0, 0);
//   * fp32 or another head dim: the FMA body of paged_attention.cuh
//     (`paged::verify_partial` over `paged::DenseKV`: 16-row tiles, split
//     over blocks, then `paged::combine_splits`), which the fp32 parity
//     checks hold to 1e-4 and TF32 products would not meet.
// The tree entry point runs the verify one's template with the causal
// triangle swapped for the ancestor masks (`TreeVis`, `paged::TreeMask`):
// the same plan, tile order, merge order and arithmetic, so a linear
// chain's masks give the verify entry point's output bit for bit.
#include "prefill_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Grid (q tiles, kv head, slot * cluster + rank); clusters of (1, 1,
// cluster).  anc: [B, C] (TREE only).
template <int HD, bool TREE>
__global__ void __launch_bounds__(prefill_tc::kThreads)
    dense_verify_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const int* __restrict__ lengths,
                           const int* __restrict__ anc, bf16* __restrict__ out, int C, int H,
                           int kvh, int S, int tpc, int cluster, float scale) {
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z / cluster;
  const int rank = (int)hop::cluster_ctarank();
  const int start = lengths[b] - C;
  const size_t qoff = (size_t)b * C * H * HD;
  const paged::DenseKV kv{(size_t)b * S * kvh * HD, 0, S};
  const prefill_tc::ClusterOut o{out + qoff, rank, cluster};
  if constexpr (TREE) {
    prefill_tc::attend_tile<HD>(q + qoff, k, v, kv, prefill_tc::TreeVis{anc + (size_t)b * C}, 0,
                                start, C, C, H, kvh, head, qt, rank * tpc, (rank + 1) * tpc,
                                scale, o);
  } else {
    prefill_tc::attend_tile<HD>(q + qoff, k, v, kv, prefill_tc::CausalVis{}, 0, start, C, C, H,
                                kvh, head, qt, rank * tpc, (rank + 1) * tpc, scale, o);
  }
}

template <int HD, bool TREE>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* lengths,
                      const void* anc, void* out, int B, int C, int H, int kvh, int S, int tpc,
                      int cluster, void* stream) {
  return kern::launch_cluster(
      dense_verify_tc_kernel<HD, TREE>,
      dim3(prefill_tc::q_tiles(C, H / kvh), kvh, B * cluster), prefill_tc::kThreads,
      prefill_tc::smem_bytes<HD>(0), cluster, stream, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lengths), static_cast<const int*>(anc), static_cast<bf16*>(out),
      C, H, kvh, S, tpc, cluster, 1.0f / sqrtf((float)HD));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  body: 0 = the FMA body (`tile`-row
// tiles, `per` of them per split, `splits` splits, then the combine),
// 1 = the tensor-core body (bfloat16, hd 64 or 128; `per` 64-key tiles per
// CTA, `splits` CTAs per cluster (<= 8); tile, part_acc and part_ml
// unused).  part_acc / part_ml: float32 scratch of [B, splits, kvH,
// T * group, hd] and [.., 2].  Returns a cudaError_t code.
extern "C" int verify_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, void* part_acc,
                                       void* part_ml, int B, int T, int H, int kvh, int hd,
                                       int S, int tile, int per, int splits, int dtype,
                                       int body, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0) return cudaSuccess;
  if (body == 1 && dtype == 1 && splits >= 1 && splits <= prefill_tc::kMaxCluster) {
    if (hd == 64)
      return launch_tc<64, false>(q, k, v, lengths, nullptr, out, B, T, H, kvh, S, per, splits,
                                  stream);
    if (hd == 128)
      return launch_tc<128, false>(q, k, v, lengths, nullptr, out, B, T, H, kvh, S, per,
                                   splits, stream);
  }
  if (body != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return paged::run_verify<float, false, true>(q, k, v, nullptr, lengths, nullptr, out,
                                                 part_acc, part_ml, B, T, H, kvh, hd, tile, 0,
                                                 S, per, splits, stream);
  if (dtype == 1)
    return paged::run_verify<bf16, false, true>(q, k, v, nullptr, lengths, nullptr, out,
                                                part_acc, part_ml, B, T, H, kvh, hd, tile, 0,
                                                S, per, splits, stream);
  return cudaErrorInvalidValue;
}

// The same for the tree: anc [B, N] int32.  Returns a cudaError_t code.
extern "C" int tree_verify_attention_launch(const void* q, const void* k, const void* v,
                                            const void* lengths, const void* anc, void* out,
                                            void* part_acc, void* part_ml, int B, int N,
                                            int H, int kvh, int hd, int S, int tile, int per,
                                            int splits, int dtype, int body, int device,
                                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || N == 0) return cudaSuccess;
  if (N > 31) return cudaErrorInvalidValue;
  if (body == 1 && dtype == 1 && splits >= 1 && splits <= prefill_tc::kMaxCluster) {
    if (hd == 64)
      return launch_tc<64, true>(q, k, v, lengths, anc, out, B, N, H, kvh, S, per, splits,
                                 stream);
    if (hd == 128)
      return launch_tc<128, true>(q, k, v, lengths, anc, out, B, N, H, kvh, S, per, splits,
                                  stream);
  }
  if (body != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return paged::run_verify<float, true, true>(q, k, v, nullptr, lengths, anc, out, part_acc,
                                                part_ml, B, N, H, kvh, hd, tile, 0, S, per,
                                                splits, stream);
  if (dtype == 1)
    return paged::run_verify<bf16, true, true>(q, k, v, nullptr, lengths, anc, out, part_acc,
                                               part_ml, B, N, H, kvh, hd, tile, 0, S, per,
                                               splits, stream);
  return cudaErrorInvalidValue;
}

// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py `flash_attention`
// (Pallas body `_flash_kernel`), which has no backward; the backward here is
// the standard recompute-from-LSE flash backward.
//
// Layout: q [BH, Sq, hd], k/v [BH, Sk, hd] (heads pre-expanded for GQA, as
// repro/kernels/ops.py does before the TPU kernel), row-major, contiguous.
// O = softmax(Q K^T * hd^-0.5, masked) V with the mask of the TPU kernel:
// kpos < Sk, and under `causal` kpos <= qpos (top-left aligned; the caller
// only passes causal with Sq == Sk).  KV tiles strictly above the diagonal
// are never visited.  The forward also writes the row log-sum-exp LSE =
// m + log(l) [BH, Sq] fp32, which the backward reads; a row that sees no
// key gives zeros and LSE = -inf.  The backward is three kernels on the
// stream and no atomics, so its result is deterministic: delta (D =
// rowsum(dO * O), one warp per row), dkdv (one block per kv tile walks the
// q tiles from the diagonal down) and dq (one block per q tile walks the
// kv tiles up to the diagonal).  dq recomputes S and dP, 7 products in all
// against the 5 of a single pass with atomic dQ; the two passes were kept
// for determinism and because they need no fp32 dQ scratch or convert pass.
//
// What bounds it on the card: at the training shape (B = 4, H = 16, S =
// 1024, hd = 128, causal) the work is 17 GFLOP forward and 43 backward
// against 67 and 134 MB of inputs and outputs: operations and bytes bound
// it about equally, so the products must run on the tensor cores and the
// loads must overlap them.  Two sets of kernels, chosen by dtype in the
// entry points:
//
// * bfloat16 (`tc::` below): the tensor cores, in CTAs of three
//   warpgroups.  A producer warpgroup (registers lowered by setmaxnreg) has
//   one thread issue TMA loads through 3-D tensor maps over [BH, S, hd]
//   (the hardware zero-fills past each head's S) into tiles with the
//   128-byte swizzle the wgmma descriptors read, through 2-stage rings with
//   full / empty mbarriers; two consumer warpgroups of 64 rows each run
//   wgmma with fp32 accumulators in registers and never touch global memory
//   except in their epilogue, which stages the result in shared memory and
//   stores 16 bytes per thread.
//   - Forward: persistent CTAs, one per SM, walk the (128 q rows, bh)
//     tiles heaviest first, so a tile's Q and first K / V load while the
//     previous tile finishes.  S = Q K^T is wgmma m64n128k16 from shared
//     memory; the online softmax runs in registers (quad shuffles, exp2
//     with log2(e) folded into the scale, the mask only on diagonal and
//     ragged tiles); O += P V takes P rounded to bf16 in registers as the A
//     operand and V through an MN-major descriptor.
//   - Backward: dkdv gives each consumer warpgroup 64 keys of a 128-key
//     tile and streams 64-row Q / dO tiles (the producer's second warp
//     writes their LSE / D rows): S^T = K Q^T and dP^T = V dO^T come out
//     transposed, so P^T and dS^T, rounded to bf16 once, are the register
//     A operands of dV += P^T dO and dK += dS^T Q.  dq gives each consumer
//     warpgroup 64 rows of a 128-row q tile and streams 64-row K / V tiles:
//     S, dP, then dQ += dS K with dS from registers.
//   hd 80 (zamba2's shared attention) runs in the hd-128 kernels: its tensor
//   maps have an inner dimension of 80 (160-byte rows, 16-byte aligned), so
//   the TMA zero-fills columns 80-127 of every tile; those add 0 to Q K^T and
//   dP and give 0 in O, dQ, dK and dV, whose epilogues store columns < 80
//   alone.  The scale is 80^-0.5, and LSE and D are unchanged.  The padded
//   products cost 128 / 80 = 1.6x the tensor-core work.
//   At the training shape neither pass comes near the 989 TFLOP/s peak: a
//   CTA walks only 1-16 tiles, so its first loads, the diagonal tile's
//   masked half and its epilogue weigh on it, and the first touch of every
//   input comes from device memory.  At S = 4096 the same kernels do
//   markedly more per second (`chip_smoke.py` times both shapes; PERF.md
//   has the numbers).
// * float32: the first version's FMA kernels, kept unchanged (instantiated
//   at hd 64, 80 and 128): each product an fp32 FMA on the CUDA cores from
//   padded fp32 shared tiles.  The fp32
//   parity checks hold them to 1e-4 of the plain version, which TF32 tensor
//   cores (10-bit mantissa) would not meet, so fp32 does not take the
//   tensor-core kernels.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: FMA kernels
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // key rows per tile
constexpr int LDS = BK + 1;    // padded score row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows row0 .. row0 + 63 of a [rows, HD] matrix into a padded fp32 tile
// [64, HD + 1]; rows at or past `nrows` are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int nrows) {
  constexpr int VN = kern::Vec<T>::N, RV = HD / VN, LD = HD + 1;
  for (int i = threadIdx.x; i < 64 * RV; i += kThreads) {
    const int r = i / RV, c = (i % RV) * VN;
    float tmp[VN];
    if (row0 + r < nrows) {
      kern::load16(src + (size_t)(row0 + r) * HD + c, tmp);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) tmp[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) dst[r * LD + c + j] = tmp[j];
  }
}

// Rows row0 .. row0 + 63 of a [rows] fp32 vector; `fill` past `nrows`.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int row0, int nrows, float fill) {
  for (int r = threadIdx.x; r < 64; r += kThreads)
    dst[r] = row0 + r < nrows ? src[row0 + r] : fill;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk,
                                        int causal) {
  return qpos < Sq && kpos < Sk && (!causal || kpos <= qpos);
}

// KV tiles q tile q0 needs: all of them, or (causal) up to its diagonal.
__device__ __forceinline__ int kv_tiles(int q0, int Sk, int causal) {
  const int nk = (Sk + BK - 1) / BK;
  return causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
}

// The 4 x 4 patch (q rows ty + 16 i, key rows tx + 16 j) of A B^T over HD,
// A and B padded fp32 tiles.
template <int HD>
__device__ __forceinline__ void patch_abt(const float* a, const float* b,
                                          int tx, int ty, float (&s)[4][4]) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (HD + 1) + BQ * LDS + 3 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int causal,
                     float scale) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1, CJ = HD / 16;
  float* sQ = smem;           // [BQ, LD]
  float* sK = sQ + BQ * LD;   // [BK, LD]
  float* sV = sK + BK * LD;   // [BK, LD]
  float* sP = sV + BK * LD;   // [BQ, LDS] scores, then probabilities
  float* sM = sP + BQ * LDS;  // [BQ] running max
  float* sL = sM + BQ;        // [BQ] running sum
  float* sC = sL + BQ;        // [BQ] this tile's correction
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const T* kb = k + (size_t)bh * Sk * HD;
  const T* vb = v + (size_t)bh * Sk * HD;

  load_tile<T, HD>(sQ, q + (size_t)bh * Sq * HD, q0, Sq);
  for (int r = tid; r < BQ; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  const int nk = kv_tiles(q0, Sk, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of sK / sV / sP are done
    load_tile<T, HD>(sK, kb, k0, Sk);
    load_tile<T, HD>(sV, vb, k0, Sk);
    __syncthreads();

    float s[4][4];
    patch_abt<HD>(sQ, sK, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        sP[r * LDS + c] =
            visible(q0 + r, k0 + c, Sq, Sk, causal) ? s[i][j] * scale : -INFINITY;
      }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w + 7, lanes 2 columns each
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* pr = sP + r * LDS;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      float mt = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mt);
      float p0 = 0.f, p1 = 0.f, corr = 1.f;
      if (m_new != -INFINITY) {  // a row that saw no key yet stays empty
        p0 = expf(x0 - m_new);
        p1 = expf(x1 - m_new);
        corr = expf(m_prev - m_new);
      }
      float ls = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, off);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        sL[r] = sL[r] * corr + ls;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V  (rows ty + 16 i, columns tx + 16 j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= c;
    }
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = sV[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    if (qpos >= Sq) continue;
    const float l = sL[r];
    const float inv = l == 0.f ? 0.f : 1.f / l;  // no key seen: zeros; NaN stays NaN
    T* orow = out + ((size_t)bh * Sq + qpos) * HD;
#pragma unroll
    for (int j = 0; j < CJ; ++j) kern::store1(orow + tx + 16 * j, acc[i][j] * inv);
    if (tx == 0) lse[(size_t)bh * Sq + qpos] = l == 0.f ? -INFINITY : sM[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// D[row] = sum_c dO[row, c] * O[row, c]; one warp per row.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                           float* __restrict__ delta, int rows) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps only
  const T* o = out + (size_t)row * HD;
  const T* g = dout + (size_t)row * HD;
  float s = 0.f;
  for (int c = lane; c < HD; c += 32) s = fmaf(to_f32(o[c]), to_f32(g[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * ((size_t)(2 * BK + 2 * BQ) * (HD + 1) + 2 * BQ * LDS + 2 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int Sq, int Sk, int causal,
                          float scale) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1, CJ = HD / 16;
  float* sK = smem;             // [BK, LD]
  float* sV = sK + BK * LD;     // [BK, LD]
  float* sQ = sV + BK * LD;     // [BQ, LD]
  float* sG = sQ + BQ * LD;     // [BQ, LD] dO
  float* sP = sG + BQ * LD;     // [BQ, LDS] P
  float* sS = sP + BQ * LDS;    // [BQ, LDS] dS
  float* sLse = sS + BQ * LDS;  // [BQ]
  float* sD = sLse + BQ;        // [BQ]
  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qb = q + (size_t)bh * Sq * HD;
  const T* gb = dout + (size_t)bh * Sq * HD;

  load_tile<T, HD>(sK, k + (size_t)bh * Sk * HD, k0, Sk);
  load_tile<T, HD>(sV, v + (size_t)bh * Sk * HD, k0, Sk);
  // rows ty + 16 i of this kv tile, columns tx + 16 j
  float adk[4][CJ], adv[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int nq = (Sq + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's reads of sQ / sG / sP / sS are done
    load_tile<T, HD>(sQ, qb, q0, Sq);
    load_tile<T, HD>(sG, gb, q0, Sq);
    load_rows(sLse, lse + (size_t)bh * Sq, q0, Sq, 0.f);
    load_rows(sD, delta + (size_t)bh * Sq, q0, Sq, 0.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    patch_abt<HD>(sQ, sK, tx, ty, s);
    patch_abt<HD>(sG, sV, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, Sq, Sk, causal)
                            ? expf(s[i][j] * scale - sLse[r])
                            : 0.f;
        sP[r * LDS + c] = p;
        sS[r * LDS + c] = p * (dp[i][j] - sD[r]);
      }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over this q tile
    for (int qq = 0; qq < BQ; ++qq) {
      float p[4], ds[4], g[CJ], qv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = sP[qq * LDS + ty + 16 * i];
        ds[i] = sS[qq * LDS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        g[j] = sG[qq * LD + tx + 16 * j];
        qv[j] = sQ[qq * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          adv[i][j] = fmaf(p[i], g[j], adv[i][j]);
          adk[i][j] = fmaf(ds[i], qv[j], adk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Sk) continue;
    const size_t off = ((size_t)bh * Sk + kpos) * HD;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      kern::store1(dk + off + tx + 16 * j, adk[i][j] * scale);
      kern::store1(dv + off + tx + 16 * j, adv[i][j]);
    }
  }
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (HD + 1) + BQ * LDS + 2 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Sq, int Sk, int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1, CJ = HD / 16;
  float* sQ = smem;             // [BQ, LD]
  float* sG = sQ + BQ * LD;     // [BQ, LD] dO
  float* sK = sG + BQ * LD;     // [BK, LD]
  float* sV = sK + BK * LD;     // [BK, LD]
  float* sS = sV + BK * LD;     // [BQ, LDS] dS
  float* sLse = sS + BQ * LDS;  // [BQ]
  float* sD = sLse + BQ;        // [BQ]
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* kb = k + (size_t)bh * Sk * HD;
  const T* vb = v + (size_t)bh * Sk * HD;

  load_tile<T, HD>(sQ, q + (size_t)bh * Sq * HD, q0, Sq);
  load_tile<T, HD>(sG, dout + (size_t)bh * Sq * HD, q0, Sq);
  load_rows(sLse, lse + (size_t)bh * Sq, q0, Sq, 0.f);
  load_rows(sD, delta + (size_t)bh * Sq, q0, Sq, 0.f);
  float adq[4][CJ];  // rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) adq[i][j] = 0.f;

  const int nk = kv_tiles(q0, Sk, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of sK / sS are done
    load_tile<T, HD>(sK, kb, k0, Sk);
    load_tile<T, HD>(sV, vb, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    patch_abt<HD>(sQ, sK, tx, ty, s);
    patch_abt<HD>(sG, sV, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, Sq, Sk, causal)
                            ? expf(s[i][j] * scale - sLse[r])
                            : 0.f;
        sS[r * LDS + c] = p * (dp[i][j] - sD[r]);
      }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float ds[4], kv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sS[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = sK[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) adq[i][j] = fmaf(ds[i], kv[j], adq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    T* row = dq + ((size_t)bh * Sq + qpos) * HD;
#pragma unroll
    for (int j = 0; j < CJ; ++j) kern::store1(row + tx + 16 * j, adq[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernels
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// ---- forward: TMA + wgmma, warp-specialised --------------------------------

constexpr int FQ = 128;            // q rows per CTA: two consumer warpgroups of 64
constexpr int FK = 128;            // kv rows per tile
constexpr int kWsThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int kProducerRegs = 40;  // 128 * 40 + 256 * 232 <= 65536
constexpr int kConsumerRegs = 232;

// Shared layout (byte offsets from a 1024-aligned base): Q [FQ, hd], a
// 2-stage ring of K and of V tiles [FK, hd], each tile stored as hd / 64
// halves of [rows, 64] bf16 (128-byte rows, swizzled in 1024-byte atoms, as
// the TMA writes them and the wgmma descriptors read them), the O tile
// [FQ, hd] the epilogue stages (same layout), then the mbarriers: Q full,
// Q empty, K full x2, V full x2, empty x2.  hd = 128 takes 192 KB.
template <int HD>
struct FwdSmem {
  static constexpr int kQBytes = FQ * HD * 2;
  static constexpr int kTileBytes = FK * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + 2 * kTileBytes;
  static constexpr int kO = kV + 2 * kTileBytes;
  static constexpr int kBar = kO + kQBytes;
  static constexpr int kBytes = kBar + 8 * 8 + 1024;  // + alignment slack
};

// The forward's CTAs are persistent: one per SM walks the (q tile, bh)
// tiles, so that a tile's Q and first K / V load while the previous tile
// finishes.  Tiles are numbered heaviest first (the last q tile of every
// bh, then the one before, ...) and dealt out in rounds of gridDim.x, every
// other round in reverse, so that the CTAs' sums of causal work come out
// about even.  Returns the number of this CTA's n-th tile, or -1 past its
// last.
__device__ __forceinline__ int fwd_tile(int n, int tiles) {
  const int g = gridDim.x, b = blockIdx.x;
  const int i = n * g + (n & 1 ? g - 1 - b : b);
  return i < tiles ? i : -1;
}

// An m64nN fp32 accumulator (wgmma layout) rounded to bf16 as the register
// A operand of N / 16 k-steps: the accumulator layout of columns 16 kk ..
// 16 kk + 15 is the register-A layout of k-step kk.
template <int N>
__device__ __forceinline__ void pack_a(const float (&acc)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = hop::pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// d (64 x HD) += a (64 x 16, registers) b (16 x HD, MN-major in shared memory).
template <int HD>
__device__ __forceinline__ void wgmma_rs_hd(float (&d)[HD / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (HD == 128) {
    hop::wgmma_rs_m64n128k16(d, a, desc_b, 1);
  } else {
    hop::wgmma_rs_m64n64k16(d, a, desc_b, 1);
  }
}

// Epilogue of one warpgroup: its 64 x HD accumulator (wgmma layout; the
// thread's first row times ma, its second times mb) goes as bf16 into rows
// row0 .. row0 + 63 of a swizzled shared tile of `rows` rows (the layout
// the TMA wrote), then out with 16-byte stores to rows grow0 .. of dst
// ([nrows, HG]) below nrows: only the HG real columns of a tile padded to
// HD (HG = 80 in HD = 128 tiles).  `bar` names the warpgroup's barrier.
template <int HD, int HG>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], float ma, float mb,
                                           uint8_t* tile, int rows, int row0,
                                           bf16* __restrict__ dst, int grow0, int nrows,
                                           int bar) {
  constexpr int CH = HG / 8;  // 16-byte chunks of a row of dst
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = row0 + 16 * (t / 32) + lane / 4;  // r + 8 has the same swizzle phase
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int byte =
        (i / 8) * rows * 128 + r * 128 + (((i % 8) ^ (r & 7)) << 4) + 4 * (lane % 4);
    *reinterpret_cast<uint32_t*>(tile + byte) =
        hop::pack_bf16(acc[4 * i] * ma, acc[4 * i + 1] * ma);
    *reinterpret_cast<uint32_t*>(tile + byte + 8 * 128) =
        hop::pack_bf16(acc[4 * i + 2] * mb, acc[4 * i + 3] * mb);
  }
  hop::named_sync(bar, 128);
  for (int idx = t; idx < 64 * CH; idx += 128) {
    const int row = row0 + idx / CH, ch = idx % CH, g = grow0 + idx / CH;
    if (g < nrows)
      *reinterpret_cast<uint4*>(dst + (size_t)g * HG + ch * 8) = *reinterpret_cast<const uint4*>(
          tile + (ch / 8) * rows * 128 + row * 128 + (((ch % 8) ^ (row & 7)) << 4));
  }
}

// HD: the tile width (64 or 128); HG: the rows' real width in device memory
// (HD, or 80 in 128-wide tiles: the tensor maps' inner dimension is HG, so
// the TMA zero-fills columns HG .. HD - 1, which add 0 to Q K^T and give 0
// in O, and the epilogue stores columns below HG).  The softmax scale comes
// from HG, the host's.
template <int HD, int HG>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        bf16* __restrict__ out, float* __restrict__ lse, int BH, int Sq,
                        int Sk, int causal, float scale) {
  using L = FwdSmem<HD>;
  constexpr int NH = HD / 64;       // 64-column halves of a row
  constexpr int QHALF = FQ * 128;   // bytes of one half of the Q tile
  constexpr int KHALF = FK * 128;   // bytes of one half of a K / V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hop::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  // mbarriers (+ 8 * stage for the ring): q_full counts the Q bytes, q_empty
  // the 256 consumer threads done with a Q tile (after its last S), k / v
  // the bytes of a ring stage, e the consumer threads done with a stage
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const uint32_t bar_k = q_full + 16, bar_v = q_full + 32, bar_e = q_full + 48;

  const int nq = (Sq + FQ - 1) / FQ, tiles = nq * BH;
  const int nk_all = (Sk + FK - 1) / FK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    hop::mbar_init(q_empty, 256);
    for (int s = 0; s < 2; ++s) {
      hop::mbar_init(bar_k + 8 * s, 1);
      hop::mbar_init(bar_v + 8 * s, 1);
      hop::mbar_init(bar_e + 8 * s, 256);  // every consumer thread releases
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps Q and the ring full, tile after tile ----
    hop::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int j_all = 0;  // kv tiles loaded so far, over all of this CTA's tiles
      for (int n = 0, i; (i = fwd_tile(n, tiles)) >= 0; ++n) {
        const int bh = i % BH, q0 = (nq - 1 - i / BH) * FQ;
        const int nk = causal ? min(nk_all, (q0 + FQ - 1) / FK + 1) : nk_all;
        hop::mbar_wait(q_empty, (n & 1) ^ 1);  // the previous tile's last S is done
        hop::mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          hop::tma_load_3d(sQ + h * QHALF, &tm_q, q_full, 64 * h, q0, bh);
        for (int j = 0; j < nk; ++j, ++j_all) {
          const int s = j_all & 1;
          hop::mbar_wait(bar_e + 8 * s, ((j_all >> 1) & 1) ^ 1);  // round 0 passes at once
          const uint32_t dk = sK + s * L::kTileBytes, dv = sV + s * L::kTileBytes;
          hop::mbar_arrive_expect_tx(bar_k + 8 * s, L::kTileBytes);
#pragma unroll
          for (int h = 0; h < NH; ++h)
            hop::tma_load_3d(dk + h * KHALF, &tm_k, bar_k + 8 * s, 64 * h, j * FK, bh);
          hop::mbar_arrive_expect_tx(bar_v + 8 * s, L::kTileBytes);
#pragma unroll
          for (int h = 0; h < NH; ++h)
            hop::tma_load_3d(dv + h * KHALF, &tm_v, bar_v + 8 * s, 64 * h, j * FK, bh);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows c * 64 .. c * 64 + 63 of each tile ----
  hop::setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1, t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;  // this thread's rows r0, r0 + 8 (of 64)
  const float sl2 = scale * kLog2e;
  int j_all = 0;
  for (int n = 0, i; (i = fwd_tile(n, tiles)) >= 0; ++n) {
    const int bh = i % BH, q0 = (nq - 1 - i / BH) * FQ;
    const int nk = causal ? min(nk_all, (q0 + FQ - 1) / FK + 1) : nk_all;
    const int qa = q0 + 64 * c + r0, qb = qa + 8;
    // wgmma accumulator layout: register 4 i + e holds row r0 + 8 (e / 2),
    // column 8 i + 2 (lane % 4) + e % 2
    float o[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    hop::mbar_wait(q_full, n & 1);
    for (int j = 0; j < nk; ++j, ++j_all) {
      const int s = j_all & 1, k0 = j * FK;
      const uint32_t par = (j_all >> 1) & 1;
      const uint32_t tk = sK + s * L::kTileBytes, tv = sV + s * L::kTileBytes;

      // S = Q K^T (64 x 128 per warpgroup), both operands K-major in shared memory
      float sc[FK / 2];
      hop::mbar_wait(bar_k + 8 * s, par);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t koff = (kk % 4) * 32;  // k16 steps inside a 128-byte row
        const uint64_t da = hop::make_desc(sQ + (kk / 4) * QHALF + c * 64 * 128 + koff, 16, 1024);
        const uint64_t db = hop::make_desc(tk + (kk / 4) * KHALF + koff, 16, 1024);
        hop::wgmma_ss_m64n128k16(sc, da, db, kk > 0);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      if (j == nk - 1) hop::mbar_arrive(q_empty);  // the next tile's Q may load

      // the mask, only where a tile crosses Sk or (causal) this warpgroup's diagonal
      if (k0 + FK > Sk || (causal && k0 + FK - 1 > q0 + 64 * c)) {
#pragma unroll
        for (int x = 0; x < FK / 8; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * x + 2 * (lane % 4) + (e & 1);
            const int qpos = e < 2 ? qa : qb;
            if (kpos >= Sk || (causal && kpos > qpos)) sc[4 * x + e] = -INFINITY;
          }
      }

      // online softmax in registers: a row lives in the 4 threads of a quad
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int x = 0; x < FK / 8; ++x) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * x], sc[4 * x + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * x + 2], sc[4 * x + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // a row that has seen no key keeps m = -inf: subtract 0, not -inf (no NaN)
      const float b0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
      const float b1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
      const float c0 = exp2f(m0 * sl2 - b0), c1 = exp2f(m1 * sl2 - b1);
      m0 = mx0;
      m1 = mx1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int x = 0; x < FK / 8; ++x) {
        sc[4 * x] = exp2f(fmaf(sc[4 * x], sl2, -b0));
        sc[4 * x + 1] = exp2f(fmaf(sc[4 * x + 1], sl2, -b0));
        sc[4 * x + 2] = exp2f(fmaf(sc[4 * x + 2], sl2, -b1));
        sc[4 * x + 3] = exp2f(fmaf(sc[4 * x + 3], sl2, -b1));
        ls0 += sc[4 * x] + sc[4 * x + 1];
        ls1 += sc[4 * x + 2] + sc[4 * x + 3];
      }
      l0 = l0 * c0 + ls0;  // per-thread partial sums; the quad adds them at the end
      l1 = l1 * c1 + ls1;
#pragma unroll
      for (int x = 0; x < HD / 8; ++x) {
        o[4 * x] *= c0;
        o[4 * x + 1] *= c0;
        o[4 * x + 2] *= c1;
        o[4 * x + 3] *= c1;
      }
      uint32_t pa[FK / 16][4];  // P, rounded to bf16, as the A operand
      pack_a<FK>(sc, pa);

      // O += P V: V [keys, hd] is MN-major for this product
      hop::mbar_wait(bar_v + 8 * s, par);
      hop::fence_regs(o);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk)
        wgmma_rs_hd<HD>(o, pa[kk], hop::make_desc(tv + kk * 16 * 128, KHALF, 1024));
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(o);
      hop::mbar_arrive(bar_e + 8 * s);  // this thread is done with stage s
    }

    // ---- epilogue: O / l as bf16 via this warpgroup's rows of the O tile ----
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float i0 = l0 == 0.f ? 0.f : 1.f / l0, i1 = l1 == 0.f ? 0.f : 1.f / l1;
    store_rows<HD, HG>(o, i0, i1, gbase + L::kO, FQ, 64 * c, out + (size_t)bh * Sq * HG,
                   q0 + 64 * c, Sq, 1 + c);
    hop::named_sync(1 + c, 128);  // every row is out before the next tile's O lands
    if (lane % 4 == 0) {
      if (qa < Sq) lse[(size_t)bh * Sq + qa] = l0 == 0.f ? -INFINITY : m0 * scale + logf(l0);
      if (qb < Sq) lse[(size_t)bh * Sq + qb] = l1 == 0.f ? -INFINITY : m1 * scale + logf(l1);
    }
  }
}

// ---- backward: TMA + wgmma, warp-specialised --------------------------------

constexpr int BKN = 128;        // dkdv: key rows per CTA, two consumer warpgroups of 64
constexpr int BQM = 64;         // dkdv: q rows per step
constexpr int DQM = 128;        // dq: q rows per CTA, two consumer warpgroups of 64
constexpr int DKN = 64;         // dq: key rows per step
constexpr int kBwdProducerRegs = 24;   // 128 * 24 + 256 * 240 <= 65536
constexpr int kBwdConsumerRegs = 240;

// LSE in log2 units; +inf for a padding row or one that saw no key, so that
// exp2(s - l2) = 0 there.
__device__ __forceinline__ float lse_log2(float lse, bool valid) {
  return valid && lse != -INFINITY ? lse * kLog2e : INFINITY;
}

// Shared layout of dkdv (byte offsets from a 1024-aligned base): the K and V
// tiles [BKN, hd], a 2-stage ring of Q and of dO tiles [BQM, hd] (all as
// hd / 64 swizzled halves, as in the forward), the ring's LSE (log2 units)
// and D rows [2][BQM] fp32, then the mbarriers: K/V, full x2, empty x2.
template <int HD>
struct DkdvSmem {
  static constexpr int kKVBytes = BKN * HD * 2;
  static constexpr int kStepBytes = BQM * HD * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;
  static constexpr int kG = kQ + 2 * kStepBytes;
  static constexpr int kL = kG + 2 * kStepBytes;
  static constexpr int kD = kL + 2 * BQM * 4;
  static constexpr int kBar = kD + 2 * BQM * 4;
  static constexpr int kBytes = kBar + 5 * 8 + 1024;  // + alignment slack
};

// One CTA per (kv tile of BKN rows, bh): consumer warpgroup c owns keys
// c * 64 .. c * 64 + 63 and walks the q tiles from the diagonal down,
// accumulating dV += P^T dO and dK += dS^T Q in registers.  S^T = K Q^T and
// dP^T = V dO^T are computed transposed (keys as rows), so P^T and dS^T,
// rounded to bf16 once, are the register A operands of the two products.
// HD / HG as the forward's (zero-filled Q / dO / K / V columns give 0 in dK
// and dV, which the epilogue does not store).
template <int HD, int HG>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_g,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int Sq, int Sk, int causal,
                             float scale) {
  using L = DkdvSmem<HD>;
  constexpr int NH = HD / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hop::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sK = base + L::kK, sV = base + L::kV, sQ = base + L::kQ, sG = base + L::kG;
  float* sL = reinterpret_cast<float*>(gbase + L::kL);
  float* sD = reinterpret_cast<float*>(gbase + L::kD);
  // mbarriers (+ 8 * stage): full counts the TMA bytes and the 32 threads
  // that write LSE / D, empty the 256 consumer threads done with a stage
  const uint32_t bar_kv = base + L::kBar, full = bar_kv + 8, empty = bar_kv + 24;

  const int bh = blockIdx.x, k0 = blockIdx.y * BKN;  // kv tile 0 (the heaviest) first
  const int nq = (Sq + BQM - 1) / BQM;
  const int qt0 = causal ? k0 / BQM : 0;
  const int nsteps = max(nq - qt0, 0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(bar_kv, 1);
    for (int s = 0; s < 2; ++s) {
      hop::mbar_init(full + 8 * s, 1 + 32);
      hop::mbar_init(empty + 8 * s, 256);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: thread 0 issues the TMA loads, warp 1 the LSE / D rows ----
    hop::setmaxnreg_dec<kBwdProducerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      hop::mbar_arrive_expect_tx(bar_kv, 2 * L::kKVBytes);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        hop::tma_load_3d(sK + h * BKN * 128, &tm_k, bar_kv, 64 * h, k0, bh);
        hop::tma_load_3d(sV + h * BKN * 128, &tm_v, bar_kv, 64 * h, k0, bh);
      }
      for (int it = 0; it < nsteps; ++it) {
        const int s = it & 1, q0 = (qt0 + it) * BQM;
        hop::mbar_wait(empty + 8 * s, ((it >> 1) & 1) ^ 1);
        hop::mbar_arrive_expect_tx(full + 8 * s, 2 * L::kStepBytes);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          hop::tma_load_3d(sQ + s * L::kStepBytes + h * BQM * 128, &tm_q, full + 8 * s,
                           64 * h, q0, bh);
          hop::tma_load_3d(sG + s * L::kStepBytes + h * BQM * 128, &tm_g, full + 8 * s,
                           64 * h, q0, bh);
        }
      }
    } else if (warp == 1) {
      const float* lb = lse + (size_t)bh * Sq;
      const float* db = delta + (size_t)bh * Sq;
      for (int it = 0; it < nsteps; ++it) {
        const int s = it & 1, q0 = (qt0 + it) * BQM;
        hop::mbar_wait(empty + 8 * s, ((it >> 1) & 1) ^ 1);
        for (int r = lane; r < BQM; r += 32) {
          const int q = q0 + r;
          sL[s * BQM + r] = lse_log2(q < Sq ? lb[q] : 0.f, q < Sq);
          sD[s * BQM + r] = q < Sq ? db[q] : 0.f;
        }
        hop::mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // ---- consumers ----
  hop::setmaxnreg_inc<kBwdConsumerRegs>();
  const int c = wg - 1, t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;  // this thread's key rows r0, r0 + 8 (of 64)
  const int ka = k0 + 64 * c + r0;
  const float sl2 = scale * kLog2e;
  const uint32_t krows = sK + c * 64 * 128, vrows = sV + c * 64 * 128;
  float adk[HD / 2], adv[HD / 2];  // wgmma layout, rows = keys
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) adk[i] = adv[i] = 0.f;

  hop::mbar_wait(bar_kv, 0);
  for (int it = 0; it < nsteps; ++it) {
    const int s = it & 1, q0 = (qt0 + it) * BQM;
    const uint32_t tq = sQ + s * L::kStepBytes, tg = sG + s * L::kStepBytes;
    hop::mbar_wait(full + 8 * s, (it >> 1) & 1);

    // S^T = K Q^T and dP^T = V dO^T (64 keys x BQM queries), K-major operands
    float st[BQM / 2], dpt[BQM / 2];
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t a = (kk / 4) * BKN * 128 + (kk % 4) * 32;
      const uint32_t b = (kk / 4) * BQM * 128 + (kk % 4) * 32;
      hop::wgmma_ss_m64n64k16(st, hop::make_desc(krows + a, 16, 1024),
                              hop::make_desc(tq + b, 16, 1024), kk > 0);
      hop::wgmma_ss_m64n64k16(dpt, hop::make_desc(vrows + a, 16, 1024),
                              hop::make_desc(tg + b, 16, 1024), kk > 0);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(st);
    hop::fence_regs(dpt);

    // P^T = exp(S^T scale - LSE), dS^T = P^T (dP^T - D); the causal mask only
    // where this warpgroup's last key lies past the step's first query
    const bool diag = causal && k0 + 64 * c + 63 > q0;
    const float* l2s = sL + s * BQM;
    const float* dds = sD + s * BQM;
#pragma unroll
    for (int i = 0; i < BQM / 8; ++i)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int qc = 8 * i + 2 * (lane % 4) + e2;
        const float l2 = l2s[qc], dd = dds[qc];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * i + 2 * h + e2;
          float p = exp2f(fmaf(st[e], sl2, -l2));
          if (diag && ka + 8 * h > q0 + qc) p = 0.f;
          st[e] = p;
          dpt[e] = p * (dpt[e] - dd);
        }
      }
    uint32_t pa[BQM / 16][4], da[BQM / 16][4];
    pack_a<BQM>(st, pa);
    pack_a<BQM>(dpt, da);

    // dV += P^T dO and dK += dS^T Q: dO and Q [q, hd] are MN-major B operands
    hop::fence_regs(adv);
    hop::fence_regs(adk);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQM / 16; ++kk) {
      wgmma_rs_hd<HD>(adv, pa[kk], hop::make_desc(tg + kk * 16 * 128, BQM * 128, 1024));
      wgmma_rs_hd<HD>(adk, da[kk], hop::make_desc(tq + kk * 16 * 128, BQM * 128, 1024));
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(adv);
    hop::fence_regs(adk);
    hop::mbar_arrive(empty + 8 * s);
  }

  // each warpgroup's rows of the K and V tiles stage its dK and dV
  const size_t off = (size_t)bh * Sk * HG;
  store_rows<HD, HG>(adk, scale, scale, gbase + L::kK, BKN, 64 * c, dk + off, k0 + 64 * c, Sk,
                     1 + c);
  store_rows<HD, HG>(adv, 1.f, 1.f, gbase + L::kV, BKN, 64 * c, dv + off, k0 + 64 * c, Sk,
                     1 + c);
}

// Shared layout of dq: the Q and dO tiles [DQM, hd], a 2-stage ring of K
// and of V tiles [DKN, hd], then the mbarriers: Q / dO, full x2, empty x2.
template <int HD>
struct DqSmem {
  static constexpr int kQBytes = DQM * HD * 2;
  static constexpr int kStepBytes = DKN * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kG = kQ + kQBytes;
  static constexpr int kK = kG + kQBytes;
  static constexpr int kV = kK + 2 * kStepBytes;
  static constexpr int kBar = kV + 2 * kStepBytes;
  static constexpr int kBytes = kBar + 5 * 8 + 1024;  // + alignment slack
};

// One CTA per (q tile of DQM rows, bh): consumer warpgroup c owns rows c * 64
// .. c * 64 + 63 and walks the kv tiles up to the diagonal, recomputing S =
// Q K^T and dP = dO V^T and accumulating dQ += dS K in registers.  HD / HG
// as the forward's.
template <int HD, int HG>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_g,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dq,
                           int Sq, int Sk, int causal, float scale) {
  using L = DqSmem<HD>;
  constexpr int NH = HD / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hop::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base + L::kQ, sG = base + L::kG, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar, full = bar_q + 8, empty = bar_q + 24;

  const int nqt = (Sq + DQM - 1) / DQM;
  const int bh = blockIdx.x, q0 = (nqt - 1 - (int)blockIdx.y) * DQM;  // heaviest first
  const int nk_all = (Sk + DKN - 1) / DKN;
  const int nk = causal ? min(nk_all, (q0 + DQM - 1) / DKN + 1) : nk_all;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      hop::mbar_init(full + 8 * s, 1);
      hop::mbar_init(empty + 8 * s, 256);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    hop::setmaxnreg_dec<kBwdProducerRegs>();
    if (threadIdx.x == 0) {
      hop::mbar_arrive_expect_tx(bar_q, 2 * L::kQBytes);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        hop::tma_load_3d(sQ + h * DQM * 128, &tm_q, bar_q, 64 * h, q0, bh);
        hop::tma_load_3d(sG + h * DQM * 128, &tm_g, bar_q, 64 * h, q0, bh);
      }
      for (int j = 0; j < nk; ++j) {
        const int s = j & 1;
        hop::mbar_wait(empty + 8 * s, ((j >> 1) & 1) ^ 1);
        hop::mbar_arrive_expect_tx(full + 8 * s, 2 * L::kStepBytes);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          hop::tma_load_3d(sK + s * L::kStepBytes + h * DKN * 128, &tm_k, full + 8 * s,
                           64 * h, j * DKN, bh);
          hop::tma_load_3d(sV + s * L::kStepBytes + h * DKN * 128, &tm_v, full + 8 * s,
                           64 * h, j * DKN, bh);
        }
      }
    }
    return;
  }

  hop::setmaxnreg_inc<kBwdConsumerRegs>();
  const int c = wg - 1, t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;
  const int qa = q0 + 64 * c + r0;  // this thread's rows qa, qa + 8
  const float sl2 = scale * kLog2e;
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = qa + 8 * h;
    l2[h] = lse_log2(q < Sq ? lse[(size_t)bh * Sq + q] : 0.f, q < Sq);
    dd[h] = q < Sq ? delta[(size_t)bh * Sq + q] : 0.f;
  }
  const uint32_t qrows = sQ + c * 64 * 128, grows = sG + c * 64 * 128;
  float adq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) adq[i] = 0.f;

  hop::mbar_wait(bar_q, 0);
  for (int j = 0; j < nk; ++j) {
    const int s = j & 1, k0 = j * DKN;
    const uint32_t tk = sK + s * L::kStepBytes, tv = sV + s * L::kStepBytes;
    hop::mbar_wait(full + 8 * s, (j >> 1) & 1);

    // S = Q K^T and dP = dO V^T (64 rows x DKN keys), K-major operands
    float sc[DKN / 2], dp[DKN / 2];
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t a = (kk / 4) * DQM * 128 + (kk % 4) * 32;
      const uint32_t b = (kk / 4) * DKN * 128 + (kk % 4) * 32;
      hop::wgmma_ss_m64n64k16(sc, hop::make_desc(qrows + a, 16, 1024),
                              hop::make_desc(tk + b, 16, 1024), kk > 0);
      hop::wgmma_ss_m64n64k16(dp, hop::make_desc(grows + a, 16, 1024),
                              hop::make_desc(tv + b, 16, 1024), kk > 0);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    hop::fence_regs(dp);

    // dS = P (dP - D), P = exp(S scale - LSE); keys past Sk are zero rows of
    // K and V, so they add nothing to dQ
    const bool diag = causal && k0 + DKN - 1 > q0 + 64 * c;
#pragma unroll
    for (int i = 0; i < DKN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, kpos = k0 + 8 * i + 2 * (lane % 4) + (e & 1);
        float p = exp2f(fmaf(sc[4 * i + e], sl2, -l2[h]));
        if (diag && kpos > qa + 8 * h) p = 0.f;
        sc[4 * i + e] = p * (dp[4 * i + e] - dd[h]);
      }
    uint32_t da[DKN / 16][4];
    pack_a<DKN>(sc, da);

    // dQ += dS K: K [keys, hd] is an MN-major B operand
    hop::fence_regs(adq);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DKN / 16; ++kk)
      wgmma_rs_hd<HD>(adq, da[kk], hop::make_desc(tk + kk * 16 * 128, DKN * 128, 1024));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(adq);
    hop::mbar_arrive(empty + 8 * s);
  }

  store_rows<HD, HG>(adq, scale, scale, gbase + L::kQ, DQM, 64 * c, dq + (size_t)bh * Sq * HG,
                     q0 + 64 * c, Sq, 1 + c);
}

}  // namespace tc


// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename T, int HD>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* out,
                    void* lse, int BH, int Sq, int Sk, int causal, void* stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  return kern::launch(flash_fwd_kernel<T, HD>, grid, kThreads, fwd_smem<HD>(),
                      stream, static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<T*>(out),
                      static_cast<float*>(lse), Sq, Sk, causal,
                      1.0f / sqrtf((float)HD));
}

template <typename T, int HD>
cudaError_t run_bwd(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int BH, int Sq,
                    int Sk, int causal, void* stream) {
  const float scale = 1.0f / sqrtf((float)HD);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(dout);
  const float* tl = static_cast<const float*>(lse);
  float* td = static_cast<float*>(delta);
  const int rows = BH * Sq, warps = kThreads / 32;
  cudaError_t err = kern::launch(
      flash_bwd_delta_kernel<T, HD>, dim3((rows + warps - 1) / warps),
      kThreads, 0, stream, static_cast<const T*>(out), tg, td, rows);
  if (err != cudaSuccess) return err;
  err = kern::launch(flash_bwd_dkdv_kernel<T, HD>,
                     dim3((Sk + BK - 1) / BK, BH), kThreads, dkdv_smem<HD>(),
                     stream, tq, tk, tv, tg, tl, (const float*)td,
                     static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, causal,
                     scale);
  if (err != cudaSuccess) return err;
  return kern::launch(flash_bwd_dq_kernel<T, HD>,
                      dim3((Sq + BQ - 1) / BQ, BH), kThreads, dq_smem<HD>(),
                      stream, tq, tk, tv, tg, tl, (const float*)td,
                      static_cast<T*>(dq), Sq, Sk, causal, scale);
}

// HD: the kernels' tile width; HG: the rows' width (hd), HD but for hd 80,
// which runs in 128-wide tiles.
template <int HD, int HG = HD>
cudaError_t run_fwd_tc(const void* q, const void* k, const void* v, void* out,
                       void* lse, int BH, int Sq, int Sk, int causal, void* stream) {
  // tensor maps over [BH, S, hd]: encoded per call, since they hold the pointers
  CUtensorMap mq, mk, mv;
  cudaError_t err = hop::make_map_3d(&mq, q, HG, Sq, BH, 64, tc::FQ);
  if (err == cudaSuccess) err = hop::make_map_3d(&mk, k, HG, Sk, BH, 64, tc::FK);
  if (err == cudaSuccess) err = hop::make_map_3d(&mv, v, HG, Sk, BH, 64, tc::FK);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;  // one persistent CTA per SM
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = BH * ((Sq + tc::FQ - 1) / tc::FQ);
  return kern::launch(tc::flash_fwd_tc_kernel<HD, HG>, dim3(std::min(tiles, sms)),
                      tc::kWsThreads, (size_t)tc::FwdSmem<HD>::kBytes, stream, mq, mk, mv,
                      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), BH, Sq,
                      Sk, causal, 1.0f / sqrtf((float)HG));
}

template <int HD, int HG = HD>
cudaError_t run_bwd_tc(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const void* lse,
                       void* delta, void* dq, void* dk, void* dv, int BH, int Sq,
                       int Sk, int causal, void* stream) {
  using bf16 = __nv_bfloat16;
  const float scale = 1.0f / sqrtf((float)HG);
  const float* tl = static_cast<const float*>(lse);
  float* td = static_cast<float*>(delta);
  const int rows = BH * Sq, warps = kThreads / 32;
  cudaError_t err = kern::launch(
      flash_bwd_delta_kernel<bf16, HG>, dim3((rows + warps - 1) / warps), kThreads, 0,
      stream, static_cast<const bf16*>(out), static_cast<const bf16*>(dout), td, rows);
  if (err != cudaSuccess) return err;
  // dkdv streams q / dO tiles of BQM rows past kv tiles of BKN; dq the reverse
  CUtensorMap mq, mk, mv, mg;
  err = hop::make_map_3d(&mq, q, HG, Sq, BH, 64, tc::BQM);
  if (err == cudaSuccess) err = hop::make_map_3d(&mg, dout, HG, Sq, BH, 64, tc::BQM);
  if (err == cudaSuccess) err = hop::make_map_3d(&mk, k, HG, Sk, BH, 64, tc::BKN);
  if (err == cudaSuccess) err = hop::make_map_3d(&mv, v, HG, Sk, BH, 64, tc::BKN);
  if (err != cudaSuccess) return err;
  err = kern::launch(tc::flash_bwd_dkdv_tc_kernel<HD, HG>, dim3(BH, (Sk + tc::BKN - 1) / tc::BKN),
                     tc::kWsThreads, (size_t)tc::DkdvSmem<HD>::kBytes, stream, mq, mk, mv,
                     mg, tl, (const float*)td, static_cast<bf16*>(dk),
                     static_cast<bf16*>(dv), Sq, Sk, causal, scale);
  if (err != cudaSuccess) return err;
  err = hop::make_map_3d(&mq, q, HG, Sq, BH, 64, tc::DQM);
  if (err == cudaSuccess) err = hop::make_map_3d(&mg, dout, HG, Sq, BH, 64, tc::DQM);
  if (err == cudaSuccess) err = hop::make_map_3d(&mk, k, HG, Sk, BH, 64, tc::DKN);
  if (err == cudaSuccess) err = hop::make_map_3d(&mv, v, HG, Sk, BH, 64, tc::DKN);
  if (err != cudaSuccess) return err;
  return kern::launch(tc::flash_bwd_dq_tc_kernel<HD, HG>, dim3(BH, (Sq + tc::DQM - 1) / tc::DQM),
                      tc::kWsThreads, (size_t)tc::DqSmem<HD>::kBytes, stream, mq, mk, mv,
                      mg, tl, (const float*)td, static_cast<bf16*>(dq), Sq, Sk, causal,
                      scale);
}

}  // namespace

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (tensor-core kernels); hd:
// 64, 80 or 128 (bf16 hd 80 in the 128-wide tensor-core tiles, zero-padded
// by the TMA); Sq, Sk >= 1.  Returns a cudaError_t code.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int BH, int Sq, int Sk, int hd,
                                          int causal, int dtype, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (BH == 0) return cudaSuccess;
  if (Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return run_fwd<float, 64>(q, k, v, out, lse, BH, Sq, Sk, causal, stream);
  if (dtype == 0 && hd == 80)
    return run_fwd<float, 80>(q, k, v, out, lse, BH, Sq, Sk, causal, stream);
  if (dtype == 0 && hd == 128)
    return run_fwd<float, 128>(q, k, v, out, lse, BH, Sq, Sk, causal, stream);
  if (dtype == 1 && hd == 64)
    return run_fwd_tc<64>(q, k, v, out, lse, BH, Sq, Sk, causal, stream);
  if (dtype == 1 && hd == 80)
    return run_fwd_tc<128, 80>(q, k, v, out, lse, BH, Sq, Sk, causal, stream);
  if (dtype == 1 && hd == 128)
    return run_fwd_tc<128>(q, k, v, out, lse, BH, Sq, Sk, causal, stream);
  return cudaErrorInvalidValue;
}

// delta: [BH, Sq] fp32 scratch.  Returns a cudaError_t code.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int BH, int Sq, int Sk, int hd, int causal, int dtype,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (BH == 0) return cudaSuccess;
  if (Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return run_bwd<float, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH,
                              Sq, Sk, causal, stream);
  if (dtype == 0 && hd == 80)
    return run_bwd<float, 80>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH,
                              Sq, Sk, causal, stream);
  if (dtype == 0 && hd == 128)
    return run_bwd<float, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH,
                               Sq, Sk, causal, stream);
  if (dtype == 1 && hd == 64)
    return run_bwd_tc<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, Sq,
                          Sk, causal, stream);
  if (dtype == 1 && hd == 80)
    return run_bwd_tc<128, 80>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, Sq,
                               Sk, causal, stream);
  if (dtype == 1 && hd == 128)
    return run_bwd_tc<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, Sq,
                           Sk, causal, stream);
  return cudaErrorInvalidValue;
}

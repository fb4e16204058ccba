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
// are never visited.  All math is fp32; inputs and outputs are T.
//
// Forward: one block per (q tile of BQ rows, bh) walks the KV tiles with
// the online softmax (m, l in shared memory, the output accumulator in
// registers) and writes O and the row log-sum-exp LSE = m + log(l) [BH, Sq]
// fp32.  Backward, three kernels on the stream, no atomics (deterministic):
//   delta  -- D = rowsum(dO * O), one warp per row;
//   dkdv   -- one block per (kv tile, bh) walks the q tiles from the
//             diagonal down, recomputes P = exp(S - LSE), and accumulates
//             dV += P^T dO and dK += dS^T Q in registers, dS = P (dP - D);
//   dq     -- one block per (q tile, bh) walks the kv tiles up to the
//             diagonal and accumulates dQ += dS K in registers.
//
// Bound on the card: at the training shape (S = 1024, hd = 128) the work is
// operations (S^2 hd per head against S hd bytes).  This first version runs
// the products as fp32 FMAs on the CUDA cores from padded shared-memory
// tiles (each thread a 4 x hd/16 or 4 x 4 register patch), with one block
// per SM for want of shared memory; tensor-core tiles (mma.sync / wgmma)
// and a cp.async / TMA ring are later work.
#include "common.cuh"

namespace {

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
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no key seen: zeros
    T* orow = out + ((size_t)bh * Sq + qpos) * HD;
#pragma unroll
    for (int j = 0; j < CJ; ++j) kern::store1(orow + tx + 16 * j, acc[i][j] * inv);
    if (tx == 0) lse[(size_t)bh * Sq + qpos] = l > 0.f ? sM[r] + logf(l) : -INFINITY;
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: 64 or 128; Sq, Sk >= 1.
// Returns a cudaError_t code.
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
  if (dtype == 0 && hd == 128)
    return run_fwd<float, 128>(q, k, v, out, lse, BH, Sq, Sk, causal, stream);
  if (dtype == 1 && hd == 64)
    return run_fwd<__nv_bfloat16, 64>(q, k, v, out, lse, BH, Sq, Sk, causal, stream);
  if (dtype == 1 && hd == 128)
    return run_fwd<__nv_bfloat16, 128>(q, k, v, out, lse, BH, Sq, Sk, causal, stream);
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
  if (dtype == 0 && hd == 128)
    return run_bwd<float, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH,
                               Sq, Sk, causal, stream);
  if (dtype == 1 && hd == 64)
    return run_bwd<__nv_bfloat16, 64>(q, k, v, out, dout, lse, delta, dq, dk,
                                      dv, BH, Sq, Sk, causal, stream);
  if (dtype == 1 && hd == 128)
    return run_bwd<__nv_bfloat16, 128>(q, k, v, out, dout, lse, delta, dq, dk,
                                       dv, BH, Sq, Sk, causal, stream);
  return cudaErrorInvalidValue;
}

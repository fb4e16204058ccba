// The selective scan's backward as first written (one thread per 4 states,
// 4 lanes a row; every exponential taken twice; the gB / gC terms summed
// over a CTA's 32 rows through [16][32][ds] shared-memory buffers; one
// [B, Q, ds] partial per CTA summed by a second kernel), kept beside the
// current kernel in src/repro_torch/kernels/csrc/ssm_scan.cu to be timed
// against it by scripts/torch_scan_breakdown.py --backward.  Same C entry
// point; its partials gBp / gCp are [ceil(di / 32), B, Q, ds]; it reads every
// other one of the forward's 8-step checkpoints hs [B, ceil(Q / 8), di, ds].
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 32;    // d_inner rows a CTA (one step's 128-byte dt / xi row)
constexpr int kLaneCap = 4;  // lanes a row at most; its ds states split over them
constexpr int kTile = 16;    // steps a tile
constexpr int kStages = 4;   // tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int NS>
struct Plan {
  static constexpr int LPR = NS < kLaneCap ? NS : kLaneCap;  // lanes a row
  static constexpr int SPT = NS / LPR;                        // states a lane
  static constexpr int kThreads = kRows * LPR;
  // floats of one ring stage: dt and xi [kTile][kRows], then B and C [kTile][NS]
  static constexpr int kStage = 2 * kTile * kRows + 2 * kTile * NS;
  // the ring, then the y tile [kTile][kRows]
  static constexpr size_t kSmem = sizeof(float) * ((size_t)kStages * kStage + kTile * kRows);
  static_assert(LPR == 1 || kThreads % 32 == 0, "a row's shuffles need whole warps");
  static_assert(kTile % LPR == 0, "whole groups of steps");
};

// N floats from p (N * 4-byte aligned when V == 4) into v.
template <int N, int V>
__device__ __forceinline__ void load_n(const float* p, float* v) {
  if constexpr (V == 4 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// 2^x to the SFU's 2 ulp, results below 2^-126 flushed to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sums v over the LPR lanes of a row, one group of LPR consecutive values
// at a time, in log2(LPR) butterfly levels (LPR - 1 shuffles a group): at
// each level a lane keeps the half of its group's live values that its
// partner sends it the other half of.  Lane l ends with the group's value l
// summed over the lanes, in v[g * LPR].
template <int LPR, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  static_assert(N % LPR == 0, "whole groups");
#pragma unroll
  for (int off = LPR / 2; off > 0; off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int g = 0; g < N; g += LPR)
#pragma unroll
      for (int i = 0; i < off; ++i) {
        const float send = upper ? v[g + i] : v[g + i + off];
        const float keep = upper ? v[g + i + off] : v[g + i];
        v[g + i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
  }
}

// V floats (V == 4: one 16-byte copy; V == 1: one 4-byte copy), zeros when
// !valid (src must still be a valid address).
template <int V>
__device__ __forceinline__ void copy_chunk(float* dst, const float* src, bool valid) {
  if constexpr (V == 4)
    hop::cp_async16(hop::smem_addr(dst), src, valid ? 16 : 0);
  else
    hop::cp_async4(hop::smem_addr(dst), src, valid ? 4 : 0);
}

// SPT floats of a lane's states from v to p (16-byte stores when V == 4).
template <int SPT, int V>
__device__ __forceinline__ void store_n(float* p, const float* v) {
  if constexpr (V == 4 && SPT % 4 == 0) {
#pragma unroll
    for (int j = 0; j < SPT; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < SPT; ++j) p[j] = v[j];
  }
}

// ---------------------------------------------------------------------------
// Backward: the gradients of y and of the final h with respect to xi, dt, B,
// C, A and h0.  Not a port of a TPU kernel: the Pallas scan has no VJP (the
// reference differentiates its XLA chunk), and autograd of the plain scan
// is thousands of launches a layer at Q = 1024.  With g_t = dL/dh_t,
//   g_t = gy_t C_t + a_{t+1} g_{t+1}   (from the final state's gradient),
//   gu_t = sum_n g_t B_t,  gxi_t = gu_t dt_t,
//   gdt_t = gu_t xi_t + sum_n g_t h_{t-1} a_t A,  gA += g_t h_{t-1} a_t dt_t,
//   gB_t = sum_d g_t u_t,  gC_t = sum_d gy_t h_t,  gh0 = a_1 g_1.
// Same grid and lanes as the forward.  The CTA walks the tiles in reverse,
// each tile's inputs (and its gy and entering state from the forward's
// checkpoints) staged by cp.async in a ring issued kBwdStages - 1 tiles
// ahead; it recomputes the tile's 16 states from the checkpoint in
// registers with the forward's own expressions (the same ex2.approx.ftz
// decay, so they are the forward's bit for bit), then steps back through
// them.  gu and the A-term of gdt are summed over a row's lanes by the
// forward's butterfly.  gB and gC sum over d_inner, across CTAs: each CTA
// sums its 32 rows through shared memory and writes a partial [B, Q, ds]
// row (partials [di / 32, B, Q, ds], ~0.27 GB at B = 4, Q = 1024, di 8192),
// and a second kernel sums the partials in a fixed order, as it does gA's
// per-batch-row partials: no atomics, deterministic.  Bound on the card:
// the bytes of xi, dt, gy read and gxi, gdt written (0.67 GB at the
// training shape, ~0.2 ms at 3.35 TB/s) and the Q * di * ds exponentials,
// here taken twice (recompute and the reverse walk).

constexpr int kBwdStages = 3;  // tiles in the backward's ring

template <int NS>
struct BwdPlan {
  // floats of one ring stage: dt, xi, gy [kTile][kRows], B and C [kTile][NS],
  // then the tile's entering state [kRows][NS]
  static constexpr int kStage = 3 * kTile * kRows + 2 * kTile * NS + kRows * NS;
  // one [kTile][kRows][NS] buffer of the gB or gC terms
  static constexpr int kRed = kTile * kRows * NS;
  // the ring, the two term buffers, the gxi and gdt tiles [kTile][kRows]
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kBwdStages * kStage + 2 * kRed + 2 * kTile * kRows);
};

// hs: the forward's checkpoints [B, ceil(Q / kTile), di, NS]; gy [B, Q, di];
// gh [B, di, NS] or null (zero).  Writes gxi, gdt [B, Q, di], gh0 [B, di,
// NS] and the partials gBp, gCp [gridDim.x, B, Q, NS], gAp [B, di, NS].
template <int NS, int V>
__global__ void __launch_bounds__(Plan<NS>::kThreads)
    ssm_scan_bwd_kernel(const float* __restrict__ xi, const float* __restrict__ dt,
                        const float* __restrict__ Bm, const float* __restrict__ Cm,
                        const float* __restrict__ A, const float* __restrict__ hs,
                        const float* __restrict__ gy, const float* __restrict__ gh,
                        float* __restrict__ gxi, float* __restrict__ gdt,
                        float* __restrict__ gBp, float* __restrict__ gCp,
                        float* __restrict__ gAp, float* __restrict__ gh0, int Q, int di) {
  using P = Plan<NS>;
  using BP = BwdPlan<NS>;
  constexpr int LPR = P::LPR, SPT = P::SPT, kThreads = P::kThreads;
  extern __shared__ __align__(16) float bwd_smem[];
  float* s_gb = bwd_smem + kBwdStages * BP::kStage;  // gB terms [kTile][kRows][NS]
  float* s_gc = s_gb + BP::kRed;                     // gC terms
  float* s_ox = s_gc + BP::kRed;                     // the gxi tile [kTile][kRows]
  float* s_od = s_ox + kTile * kRows;                // the gdt tile

  const int tid = threadIdx.x, r = tid / LPR, lane = tid % LPR;
  const int b = blockIdx.y, d0 = blockIdx.x * kRows, nb = gridDim.y;
  const int d = d0 + r;
  const bool live = d < di;
  const size_t seq = (size_t)b * Q;
  const int ntiles = (Q + kTile - 1) / kTile;

  // Tile k's inputs into ring stage `slot`; steps past Q and rows past di
  // arrive as zeros.
  auto load_tile = [&](int k, int slot) {
    float* st = bwd_smem + slot * BP::kStage;
    const int t0 = k * kTile;
    constexpr int RC = kRows / V, NC = NS / V, HC = kRows * NS / V;
#pragma unroll
    for (int n = 0; n < cdiv(kTile * RC, kThreads); ++n) {
      const int i = tid + n * kThreads, t = i / RC, c = (i % RC) * V;
      if (i >= kTile * RC) break;
      const bool ok = t0 + t < Q && d0 + c < di;
      const size_t off = ok ? (seq + t0 + t) * di + d0 + c : 0;
      copy_chunk<V>(st + t * kRows + c, dt + off, ok);
      copy_chunk<V>(st + kTile * kRows + t * kRows + c, xi + off, ok);
      copy_chunk<V>(st + 2 * kTile * kRows + t * kRows + c, gy + off, ok);
    }
#pragma unroll
    for (int n = 0; n < cdiv(kTile * NC, kThreads); ++n) {
      const int i = tid + n * kThreads, t = i / NC, c = (i % NC) * V;
      if (i >= kTile * NC) break;
      const bool ok = t0 + t < Q;
      const size_t off = ok ? (seq + t0 + t) * NS + c : 0;
      copy_chunk<V>(st + 3 * kTile * kRows + t * NS + c, Bm + off, ok);
      copy_chunk<V>(st + 3 * kTile * kRows + kTile * NS + t * NS + c, Cm + off, ok);
    }
#pragma unroll
    for (int n = 0; n < cdiv(HC, kThreads); ++n) {
      const int i = tid + n * kThreads, row = i * V / NS, c = i * V % NS;
      if (i >= HC) break;
      const bool ok = d0 + row < di;
      const size_t off = ok ? ((size_t)(b * cdiv(Q, 8) + 2 * k) * di + d0 + row) * NS + c : 0;
      copy_chunk<V>(st + 3 * kTile * kRows + 2 * kTile * NS + row * NS + c, hs + off, ok);
    }
  };
  // iteration i takes tile ntiles - 1 - i from stage i % kBwdStages
#pragma unroll
  for (int i = 0; i < kBwdStages - 1; ++i) {
    if (i < ntiles) load_tile(ntiles - 1 - i, i);
    hop::cp_async_commit();
  }

  // the lane's gradient of h (from the future), its gA sums, A and A in
  // log2 units, in registers for the whole walk
  float carry[SPT], gA[SPT], An[SPT], a2[SPT];
  const size_t srow = ((size_t)b * di + d) * NS + lane * SPT;
#pragma unroll
  for (int j = 0; j < SPT; ++j) carry[j] = An[j] = gA[j] = 0.f;
  if (live) {
    if (gh != nullptr) load_n<SPT, V>(gh + srow, carry);
    load_n<SPT, V>(A + (size_t)d * NS + lane * SPT, An);
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j) a2[j] = An[j] * kLog2e;

  for (int i = 0; i < ntiles; ++i) {
    const int k = ntiles - 1 - i, t0 = k * kTile;
    if (i + kBwdStages - 1 < ntiles) load_tile(k - (kBwdStages - 1), (i + kBwdStages - 1) % kBwdStages);
    hop::cp_async_commit();
    hop::cp_async_wait<kBwdStages - 1>();  // tile k landed for this thread
    __syncthreads();                       // ... and for every thread
    const float* st = bwd_smem + (i % kBwdStages) * BP::kStage;
    const float* s_dt = st + r;
    const float* s_xi = st + kTile * kRows + r;
    const float* s_gy = st + 2 * kTile * kRows + r;
    const float* s_b = st + 3 * kTile * kRows + lane * SPT;
    const float* s_c = s_b + kTile * NS;
    const float* s_h = st + 3 * kTile * kRows + 2 * kTile * NS + r * NS + lane * SPT;

    // the tile's states, recomputed as the forward computed them:
    // hist[0] entering the tile, hist[t + 1] after step t
    float hist[kTile + 1][SPT];
    load_n<SPT, 4>(s_h, hist[0]);
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float dtv = s_dt[t * kRows];
      const float u = dtv * s_xi[t * kRows];
      float bv[SPT];
      load_n<SPT, 4>(s_b + t * NS, bv);
#pragma unroll
      for (int j = 0; j < SPT; ++j) hist[t + 1][j] = fmaf(ex2(dtv * a2[j]), hist[t][j], u * bv[j]);
    }

    // back through the tile: the lane's parts of each step's gu and of
    // gdt's A-term, and each (step, row, state) term of gB and gC
    float gu_l[kTile], gd_l[kTile];
#pragma unroll
    for (int t = kTile - 1; t >= 0; --t) {
      const float dtv = s_dt[t * kRows], gyv = s_gy[t * kRows];
      const float u = dtv * s_xi[t * kRows];
      float bv[SPT], cv[SPT], tb[SPT], tc[SPT];
      load_n<SPT, 4>(s_b + t * NS, bv);
      load_n<SPT, 4>(s_c + t * NS, cv);
      float gu = 0.f, gd = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float g = fmaf(gyv, cv[j], carry[j]);
        const float a = ex2(dtv * a2[j]);
        const float w = g * hist[t][j] * a;
        gu = fmaf(g, bv[j], gu);
        gd = fmaf(w, An[j], gd);
        gA[j] = fmaf(w, dtv, gA[j]);
        tb[j] = g * u;
        tc[j] = gyv * hist[t + 1][j];
        carry[j] = a * g;
      }
      gu_l[t] = gu;
      gd_l[t] = gd;
      store_n<SPT, 4>(s_gb + (t * kRows + r) * NS + lane * SPT, tb);
      store_n<SPT, 4>(s_gc + (t * kRows + r) * NS + lane * SPT, tc);
    }
    // gu and the A-term summed over the row's lanes (lane l keeps step
    // g * LPR + l of each group g), then gxi and gdt into the tiles
    reduce_scatter<LPR>(gu_l, lane);
    reduce_scatter<LPR>(gd_l, lane);
#pragma unroll
    for (int g = 0; g < kTile / LPR; ++g) {
      const int s = g * LPR + lane;
      const float gu = gu_l[g * LPR];
      s_ox[s * kRows + r] = gu * s_dt[s * kRows];
      s_od[s * kRows + r] = fmaf(gu, s_xi[s * kRows], gd_l[g * LPR]);
    }
    __syncthreads();  // the tiles and term buffers are whole; the stage is free
    constexpr int RC = kRows / V;
#pragma unroll
    for (int n = 0; n < cdiv(kTile * RC, kThreads); ++n) {
      const int i2 = tid + n * kThreads, t = i2 / RC, c = (i2 % RC) * V;
      if (i2 < kTile * RC && t0 + t < Q && d0 + c < di) {
        const size_t o = (seq + t0 + t) * di + d0 + c;
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(gxi + o) = *reinterpret_cast<const float4*>(s_ox + t * kRows + c);
          *reinterpret_cast<float4*>(gdt + o) = *reinterpret_cast<const float4*>(s_od + t * kRows + c);
        } else {
          gxi[o] = s_ox[t * kRows + c];
          gdt[o] = s_od[t * kRows + c];
        }
      }
    }
    // this CTA's rows' part of gB_t and gC_t, summed in row order
#pragma unroll
    for (int n = 0; n < cdiv(kTile * NS, kThreads); ++n) {
      const int i2 = tid + n * kThreads, t = i2 / NS, c = i2 % NS;
      if (i2 < kTile * NS && t0 + t < Q) {
        float sb = 0.f, sc = 0.f;
        for (int rr = 0; rr < kRows; ++rr) {
          sb += s_gb[(t * kRows + rr) * NS + c];
          sc += s_gc[(t * kRows + rr) * NS + c];
        }
        const size_t o = (((size_t)blockIdx.x * nb + b) * Q + t0 + t) * NS + c;
        gBp[o] = sb;
        gCp[o] = sc;
      }
    }
  }
  if (live) {
    store_n<SPT, V>(gh0 + srow, carry);
    store_n<SPT, V>(gAp + srow, gA);
  }
}

// out[i] = sum over p < P of in[p * n + i], p in order (deterministic).
__global__ void sum_partials_kernel(const float* __restrict__ in, float* __restrict__ out,
                                    int P, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += in[p * n + i];
    out[i] = s;
  }
}

cudaError_t sum_partials(const float* in, float* out, int P, long long n, void* stream) {
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + 255) / 256;
  return kern::launch(sum_partials_kernel, dim3((unsigned)(blocks < 4096 ? blocks : 4096)), 256,
                      0, stream, in, out, P, n);
}

template <int NS, int V>
cudaError_t run_bwd(const void* const* p, int B, int Q, int di, void* stream) {
  using P = Plan<NS>;
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  auto w = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  const int nbx = (di + kRows - 1) / kRows;
  cudaError_t err = kern::launch(ssm_scan_bwd_kernel<NS, V>, dim3(nbx, B), P::kThreads,
                                 BwdPlan<NS>::kSmem, stream, f(0), f(1), f(2), f(3), f(4), f(5),
                                 f(6), f(7), w(8), w(9), w(14), w(15), w(16), w(13), Q, di);
  if (err != cudaSuccess) return err;
  const long long nbc = (long long)B * Q * NS;
  err = sum_partials(f(14), w(10), nbx, nbc, stream);  // gB
  if (err != cudaSuccess) return err;
  err = sum_partials(f(15), w(11), nbx, nbc, stream);  // gC
  if (err != cudaSuccess) return err;
  return sum_partials(f(16), w(12), B, (long long)di * NS, stream);  // gA
}

// 16-byte copies when di % 4 == 0 and every non-null pointer is 16-byte aligned.
bool vec_ok(const void* const* p, int n, int di) {
  bool vec = di % 4 == 0;
  for (int i = 0; i < n; ++i) vec = vec && reinterpret_cast<uintptr_t>(p[i]) % 16 == 0;
  return vec;
}

template <int NS>
cudaError_t run_bwd_ns(const void* const* p, int B, int Q, int di, void* stream) {
  return vec_ok(p, 17, di) ? run_bwd<NS, 4>(p, B, Q, di, stream)
                           : run_bwd<NS, 1>(p, B, Q, di, stream);
}

}  // namespace

// The backward of ssm_scan_chunk_launch with checkpoints: from the forward's
// inputs, its checkpoints hs and the gradients gy [B, Q, di] and gh [B, di,
// ds] (null: zero), writes gxi, gdt [B, Q, di], gB, gC [B, Q, ds], gA [di,
// ds] and gh0 [B, di, ds]; gBp, gCp [ceil(di / 32), B, Q, ds] and gAp [B,
// di, ds] are scratch for the partial sums.  Returns a cudaError_t code.
extern "C" int ssm_scan_bwd_launch(const void* xi, const void* dt, const void* Bm,
                                   const void* Cm, const void* A, const void* hs,
                                   const void* gy, const void* gh, void* gxi, void* gdt,
                                   void* gB, void* gC, void* gA, void* gh0, void* gBp,
                                   void* gCp, void* gAp, int B, int Q, int di, int ds,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || di == 0) return cudaSuccess;
  const void* p[17] = {xi, dt, Bm, Cm, A, hs, gy, gh, gxi, gdt, gB, gC, gA, gh0, gBp, gCp, gAp};
  switch (ds) {
    case 4:
      return run_bwd_ns<4>(p, B, Q, di, stream);
    case 8:
      return run_bwd_ns<8>(p, B, Q, di, stream);
    case 16:
      return run_bwd_ns<16>(p, B, Q, di, stream);
    case 32:
      return run_bwd_ns<32>(p, B, Q, di, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Mamba1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py `ssm_scan_chunk`
// (`pallas_call` at :79; Pallas body `_ssm_kernel`): Q serial steps of
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = h_t . C_t
// over xi / dt [B, Q, di], B / C [B, Q, ds], A [di, ds], h0 [B, di, ds],
// all float32, giving y [B, Q, di] and the final h [B, di, ds].  The TPU
// kernel kept the [block_d, ds] state in VMEM for a 64-step chunk; here it
// lives in registers for the whole sequence, so one launch scans any Q >= 0
// (the engine's whole prefill bucket, one launch a layer).
//
// Grid (ceil(di / kRows), B).  A CTA owns kRows d_inner rows of one batch
// row; LPR = min(ds, kLaneCap) neighbouring lanes share a row, each holding
// SPT = ds / LPR of its states (4 lanes of 4 at falcon-mamba's ds = 16).
// What bounds it on the card: device-memory bytes (xi, dt, y [Q, di] and
// both states once, B and C once per batch row) -- 7.9 MB at B = 1, Q = 64,
// di 8192, 2.4 us at 3.35 TB/s; the Q * di * ds exponentials take ~2.2 us
// of the SFU's 16 a clock per SM.  Only one FMA a step, h = decay * h +
// u * B, depends on the previous step, so the design keeps memory and
// everything else off that chain:
//   * the CTA walks Q in tiles of kTile steps.  Each tile's dt / xi
//     [kTile][kRows] slices and its B / C [kTile][ds] rows are copied by
//     `cp.async` (16 bytes when di % 4 == 0 and every pointer is 16-byte
//     aligned, else 4) into a ring of kStages tiles in shared memory, issued
//     kStages - 1 tiles ahead of the scan, so a tile costs no round trip of
//     its own.  Steps past Q arrive as zeros: dt = 0 leaves h exactly as it
//     is;
//   * the tile's steps are unrolled and write nothing to shared memory, so
//     the reads, exp2 (A scaled by log2 e once), u * B and the y products of
//     later steps overlap the one dependent FMA.  Each lane keeps its part of
//     every step's y in registers; after the tile a butterfly over the row's
//     lanes (LPR - 1 shuffles per LPR steps) leaves each lane one step's
//     sum, written to a [kTile][kRows] tile in shared memory and stored in
//     coalesced 128-byte rows;
//   * B / C are read once per CTA (di / kRows times per batch row, from L2).
// The exponential is the SFU's ex2.approx.ftz (2 ulp, what exp2f computes,
// but results below 2^-126 flushed to zero): fp32 stays within 1e-5 of the
// plain version, relative to max |y| and max |h|.  What is left at B = 1
// (scripts/torch_scan_breakdown.py, PERF.md): the empty launch's fixed
// cost, the first tiles' round trip, and the shared-memory reads of B / C
// (every lane reads its states' values every step).
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

// V: floats a copy / store moves (4 when di % 4 == 0 and every pointer is
// 16-byte aligned, else 1).
template <int NS, int V>
__global__ void __launch_bounds__(Plan<NS>::kThreads)
    ssm_scan_kernel(const float* __restrict__ xi, const float* __restrict__ dt,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    const float* __restrict__ A, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ h_out, int Q, int di) {
  using P = Plan<NS>;
  constexpr int LPR = P::LPR, SPT = P::SPT, kThreads = P::kThreads;
  extern __shared__ __align__(16) float scan_smem[];
  float* ys = scan_smem + kStages * P::kStage;  // the y tile

  const int tid = threadIdx.x, r = tid / LPR, lane = tid % LPR;
  const int b = blockIdx.y, d0 = blockIdx.x * kRows;
  const int d = d0 + r;
  const bool live = d < di;
  const size_t seq = (size_t)b * Q;  // the batch row's first step
  const int ntiles = (Q + kTile - 1) / kTile;

  // Tile k's steps t0 .. t0 + kTile - 1 into stage k % kStages; steps past Q
  // and rows past di are zero-filled from the tensor's first address.
  auto load_tile = [&](int k) {
    float* st = scan_smem + (k % kStages) * P::kStage;
    const int t0 = k * kTile;
    constexpr int RC = kRows / V, NC = NS / V;  // copies a step of dt / xi, of B / C
#pragma unroll
    for (int n = 0; n < cdiv(kTile * RC, kThreads); ++n) {
      const int i = tid + n * kThreads, t = i / RC, c = (i % RC) * V;
      if (i >= kTile * RC) break;
      const bool ok = t0 + t < Q && d0 + c < di;
      const size_t off = ok ? (seq + t0 + t) * di + d0 + c : 0;
      copy_chunk<V>(st + t * kRows + c, dt + off, ok);
      copy_chunk<V>(st + kTile * kRows + t * kRows + c, xi + off, ok);
    }
#pragma unroll
    for (int n = 0; n < cdiv(kTile * NC, kThreads); ++n) {
      const int i = tid + n * kThreads, t = i / NC, c = (i % NC) * V;
      if (i >= kTile * NC) break;
      const bool ok = t0 + t < Q;
      const size_t off = ok ? (seq + t0 + t) * NS + c : 0;
      copy_chunk<V>(st + 2 * kTile * kRows + t * NS + c, Bm + off, ok);
      copy_chunk<V>(st + 2 * kTile * kRows + kTile * NS + t * NS + c, Cm + off, ok);
    }
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < ntiles) load_tile(k);
    hop::cp_async_commit();
  }

  // the lane's states and A (in log2 units), in registers for the whole scan
  float h[SPT], a2[SPT];
  const size_t srow = ((size_t)b * di + d) * NS + lane * SPT;
  if (live) {
    load_n<SPT, V>(h0 + srow, h);
    load_n<SPT, V>(A + (size_t)d * NS + lane * SPT, a2);
  } else {
#pragma unroll
    for (int j = 0; j < SPT; ++j) h[j] = a2[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j) a2[j] *= kLog2e;

  for (int k = 0; k < ntiles; ++k) {
    if (k + kStages - 1 < ntiles) load_tile(k + kStages - 1);
    hop::cp_async_commit();
    hop::cp_async_wait<kStages - 1>();  // tile k landed for this thread
    __syncthreads();                    // ... and for every thread
    const float* st = scan_smem + (k % kStages) * P::kStage;
    const float* s_dt = st + r;
    const float* s_xi = st + kTile * kRows + r;
    const float* s_b = st + 2 * kTile * kRows + lane * SPT;
    const float* s_c = s_b + kTile * NS;
    float yv[kTile];  // the lane's part of each step's y
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float dtv = s_dt[t * kRows];
      const float u = dtv * s_xi[t * kRows];
      float bv[SPT], cv[SPT];
      load_n<SPT, 4>(s_b + t * NS, bv);
      load_n<SPT, 4>(s_c + t * NS, cv);
      yv[t] = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        h[j] = fmaf(ex2(dtv * a2[j]), h[j], u * bv[j]);
        yv[t] = fmaf(h[j], cv[j], yv[t]);
      }
    }
    // y summed over the row's lanes; lane l keeps step g * LPR + l of each
    // group g of LPR steps, so every lane stores
    reduce_scatter<LPR>(yv, lane);
#pragma unroll
    for (int g = 0; g < kTile / LPR; ++g) ys[(g * LPR + lane) * kRows + r] = yv[g * LPR];
    __syncthreads();  // the y tile is whole; stage k % kStages is free
    // the y tile's rows below Q, coalesced
    const int t0 = k * kTile;
    constexpr int RC = kRows / V;
#pragma unroll
    for (int n = 0; n < cdiv(kTile * RC, kThreads); ++n) {
      const int i = tid + n * kThreads, t = i / RC, c = (i % RC) * V;
      if (i < kTile * RC && t0 + t < Q && d0 + c < di) {
        float* dst = y + (seq + t0 + t) * di + d0 + c;
        if constexpr (V == 4)
          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(ys + t * kRows + c);
        else
          *dst = ys[t * kRows + c];
      }
    }
  }
  if (live) {
    if constexpr (V == 4 && SPT % 4 == 0) {
#pragma unroll
      for (int j = 0; j < SPT; j += 4)
        *reinterpret_cast<float4*>(h_out + srow + j) = make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < SPT; ++j) h_out[srow + j] = h[j];
    }
  }
}

template <int NS, int V>
cudaError_t run(const void* xi, const void* dt, const void* Bm, const void* Cm, const void* A,
                const void* h0, void* y, void* h_out, int B, int Q, int di, void* stream) {
  using P = Plan<NS>;
  return kern::launch(ssm_scan_kernel<NS, V>, dim3((di + kRows - 1) / kRows, B), P::kThreads,
                      P::kSmem, stream, static_cast<const float*>(xi),
                      static_cast<const float*>(dt), static_cast<const float*>(Bm),
                      static_cast<const float*>(Cm), static_cast<const float*>(A),
                      static_cast<const float*>(h0), static_cast<float*>(y),
                      static_cast<float*>(h_out), Q, di);
}

template <int NS>
cudaError_t run_ns(const void* const* ptrs, int B, int Q, int di, void* stream) {
  bool vec = di % 4 == 0;
  for (int i = 0; i < 8; ++i) vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  auto go = [&](auto fn) {
    return fn(ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5], const_cast<void*>(ptrs[6]),
              const_cast<void*>(ptrs[7]), B, Q, di, stream);
  };
  return vec ? go(run<NS, 4>) : go(run<NS, 1>);
}

}  // namespace

// Any B, Q >= 0 and di; ds (the SSM state width) must be 4, 8, 16 or 32.
// Returns a cudaError_t code.
extern "C" int ssm_scan_chunk_launch(const void* xi, const void* dt, const void* Bm,
                                     const void* Cm, const void* A, const void* h0, void* y,
                                     void* h_out, int B, int Q, int di, int ds, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || di == 0) return cudaSuccess;
  const void* ptrs[8] = {xi, dt, Bm, Cm, A, h0, y, h_out};
  switch (ds) {
    case 4:
      return run_ns<4>(ptrs, B, Q, di, stream);
    case 8:
      return run_ns<8>(ptrs, B, Q, di, stream);
    case 16:
      return run_ns<16>(ptrs, B, Q, di, stream);
    case 32:
      return run_ns<32>(ptrs, B, Q, di, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

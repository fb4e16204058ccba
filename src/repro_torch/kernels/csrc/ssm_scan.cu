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
constexpr int kCkpt = 8;     // steps between the checkpoints the forward keeps for the backward
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

// V: floats a copy / store moves (4 when di % 4 == 0 and every pointer is
// 16-byte aligned, else 1).  CKPT: also write the state entering every
// kCkpt-th step, hs [B, ceil(Q / kCkpt), di, NS] (hs[:, 0] == h0), which the
// backward recomputes each kCkpt steps from; the serving path's launch
// (CKPT false) has no such store.
template <int NS, int V, bool CKPT>
__global__ void __launch_bounds__(Plan<NS>::kThreads)
    ssm_scan_kernel(const float* __restrict__ xi, const float* __restrict__ dt,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    const float* __restrict__ A, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ h_out,
                    float* __restrict__ hs, int Q, int di) {
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
      if constexpr (CKPT) {  // the state entering every kCkpt-th step
        const int q = k * kTile + t;
        if (t % kCkpt == 0 && live && q < Q)
          store_n<SPT, V>(
              hs + ((size_t)(b * cdiv(Q, kCkpt) + q / kCkpt) * di + d) * NS + lane * SPT, h);
      }
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
  if (live) store_n<SPT, V>(h_out + srow, h);
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
// Bound on the card: the bytes of xi, dt, gy read and gxi, gdt written (0.67
// GB at B = 4, Q = 1024, d_inner 8192: ~0.2 ms at 3.35 TB/s).  What costs
// more is issuing ~20 instructions for each (batch, step, row, state), 537 M
// of them at that shape (the exponentials alone take ~0.15 ms of the SFU's
// 16 a clock an SM), so the design keeps that count and the stalls between
// its phases down:
//   * a CTA owns kBwdRows = 32 d_inner rows of one batch row; a lane holds 2
//     states of 2 neighbouring rows (LPR = ds / 2 lanes a row pair: 128
//     threads at ds 16, 3 CTAs and 170 registers a thread an SM), so each
//     step's dt, xi, gy loads serve 4 (row, state) pairs and gB / gC sum over
//     the lane's two rows in registers before any shuffle;
//   * the forward keeps the state entering every kCkpt = 8 steps.  The CTA
//     walks 16-step tiles in reverse, each staged (dt, xi, gy, B, C, its two
//     checkpoints) by cp.async in a ring of kBwdStages tiles, and walks each
//     tile back as two 8-step parts: it recomputes the part's states from its
//     checkpoint with the forward's own expression, fmaf(ex2(dt * A log2 e),
//     h, u * B), so they are the forward's bit for bit, and keeps the 8
//     decays it took there in registers for the walk back: each exponential
//     is taken once;
//   * gu and gdt's A-term sum over a row pair's lanes by a butterfly that
//     leaves each lane one (step, row)'s sums (reduce_scatter_lanes);
//   * gB and gC sum over d_inner with no term buffer.  A lane's 4 terms a
//     step (2 states, gB and gC, each already summed over its 2 rows) sum
//     over the warp's row pairs by shuffles.  The first level, across the
//     warp's halves, needs no select: lanes 16-31 hold their two states in
//     swapped order (read from a pair-swapped copy of B and C in the ring),
//     so every lane adds its partner's second value to its own first; the
//     second level scatters the sums, one a lane.  The CTA's warps then sum
//     in warp order through shared memory, and a thread-block cluster of
//     kCluster CTAs along d_inner sums its CTAs' tile sums in rank order
//     through distributed shared memory every kGroup tiles, each CTA taking
//     1 / kCluster of them: one partial [B, Q, ds] row per cluster (32 at
//     d_inner 8192; the grid is padded to whole clusters with CTAs whose rows
//     all lie past d_inner, which add zeros).  A group's sums are published
//     at its end and read at the end of the next, so no CTA waits on its
//     peers mid-group, and every store to device memory waits until after
//     the cluster barrier's arrive, whose release would wait for it.  A
//     second kernel sums the partials in order, with gA's per-batch-row
//     partials: no atomics, and two launches give bit-equal gradients.
// scripts/torch_scan_breakdown.py --backward times the parts of this.

constexpr int kBwdStages = 3;  // tiles in the backward's ring
constexpr int kBwdRows = 32;   // d_inner rows a backward CTA
constexpr int kBwdTile = 16;   // steps a backward tile (its ring's unit)
constexpr int kParts = kBwdTile / kCkpt;  // parts a tile walks back, one checkpoint each
constexpr int kCluster = 8;    // CTAs along d_inner that sum gB / gC in DSMEM
constexpr int kGroup = 2;      // tiles the cluster sums at each exchange

template <int NS>
struct BwdPlan {
  static constexpr int LPR = NS / 2;  // lanes a row pair, each 2 states of both rows
  static constexpr int RPW = 32 / LPR;  // row pairs a warp
  static constexpr int kThreads = kBwdRows / 2 * LPR;
  static constexpr int kWarps = kThreads / 32;
  // gB / gC: the terms of S steps, N a lane ([state slot][step][gB, gC], each
  // summed over the lane's two rows), sum over the warp's row pairs and
  // leave M sums a lane
  static constexpr int S = RPW / 4 > 1 ? RPW / 4 : 1;
  static constexpr int N = 4 * S;
  static constexpr int M = N / RPW;
  // gu / gd: the 4 values a step (2 rows, gu and gd) of GU steps sum over
  // the row pair's lanes and leave MGU a lane
  static constexpr int GU = LPR / 2 < 1 ? 1 : LPR / 2 > 4 ? 4 : LPR / 2;
  static constexpr int MGU = 4 * GU / LPR;
  // floats of one ring stage: dt, xi, gy [kBwdTile][kBwdRows]; B, C, then B and
  // C with each pair of states swapped, [kBwdTile][NS]; the states entering the
  // tile's parts [kParts][kBwdRows][NS]
  static constexpr int oXi = kBwdTile * kBwdRows, oGy = 2 * oXi, oB = 3 * oXi;
  static constexpr int oC = oB + kBwdTile * NS, oBs = oC + kBwdTile * NS, oCs = oBs + kBwdTile * NS;
  static constexpr int oH = oCs + kBwdTile * NS;
  static constexpr int kStage = oH + kParts * kBwdRows * NS;
  static constexpr int E = 2 * kBwdTile * NS;  // a tile's gB and gC sums
  // the ring, each warp's tile sums [kWarps][E], the CTA's tile sums of
  // three groups of kGroup tiles [3][kGroup][E] (one group summed while the
  // cluster may still read the two before), the gxi and gdt tiles
  // [kBwdTile][kBwdRows]
  static constexpr size_t kSmem = sizeof(float) * ((size_t)kBwdStages * kStage +
                                                   (size_t)kWarps * E + 3 * kGroup * E + 2 * oXi);
  static_assert(LPR <= 16 && 32 % LPR == 0, "a warp holds two or more whole row pairs");
  static_assert(kParts == 2, "two parts a tile");
  static_assert(E % kThreads == 0, "whole tile sums a thread");
  static_assert(E % (4 * kCluster) == 0 && kGroup * E / (4 * kCluster) <= kThreads,
                "a cluster slice of a group, one float4 a thread at most");
  static_assert(N % RPW == 0 && kCkpt % S == 0 && kCkpt % GU == 0 && MGU >= 1 && MGU <= 2,
                "whole groups");
};

// CTAs an SM the backward asks for: 3 on the 16-byte path from ds 8 up (170
// registers a thread, 12 warps at ds 16), else what 255 registers allow.
template <int NS, int V>
struct BwdOccupancy {
  static constexpr int value = (V == 4 && NS >= 8 ? 384 : 256) / BwdPlan<NS>::kThreads;
};

// Sums v over the G lanes lane ^ (m * LO), m < G (powers of two), in
// log2(G) butterfly levels, each halving the values a lane keeps: the lane
// ends with the sums of values p * (N / G) .. p * (N / G) + N / G - 1, p =
// (lane / LO) % G, in v[0 .. N / G - 1].  The order of the sums is fixed.
// One level a call (K: the level's lane distance / LO), so every index is a
// constant and v stays in registers.
template <int LO, int G, int N, int K = G / 2>
__device__ __forceinline__ void reduce_scatter_lanes(float (&v)[N], int lane) {
  static_assert(N % G == 0, "whole values a lane");
  if constexpr (K > 0) {
    constexpr int H = N / G * K;  // values kept after this level
    const bool upper = lane & (K * LO);
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, K * LO);
    }
    reduce_scatter_lanes<LO, G, N, K / 2>(v, lane);
  }
}

// Where entry e of a warp's tile sums ([group of S steps][lane][M], as the
// gB / gC butterfly leaves them) goes in the CTA's [gB, gC][kBwdTile][NS].
template <int NS>
__device__ __forceinline__ int tile_sum_index(int e) {
  using P = BwdPlan<NS>;
  const int gi = e / (32 * P::M), lane = e / P::M % 32, i = e % P::M;
  const int idx = (lane / P::LPR) % (P::RPW / 2) * P::M + i;  // [step][gB, gC] in the group
  const int t = gi * P::S + idx / 2, n = 2 * (lane % P::LPR) + (lane >> 4);
  return (idx % 2) * kBwdTile * NS + t * NS + n;
}

// hs: the forward's checkpoints [B, ceil(Q / kCkpt), di, NS]; gy [B, Q, di];
// gh [B, di, NS] or null (zero).  Grid (B, 1, whole clusters of CTAs along
// d_inner).  Writes gxi, gdt [B, Q, di], gh0 [B, di, NS] and the partials
// gBp, gCp [clusters, B, Q, NS], gAp [B, di, NS].
template <int NS, int V>
__global__ void __launch_bounds__(BwdPlan<NS>::kThreads, BwdOccupancy<NS, V>::value)
    ssm_scan_bwd_kernel(const float* __restrict__ xi, const float* __restrict__ dt,
                        const float* __restrict__ Bm, const float* __restrict__ Cm,
                        const float* __restrict__ A, const float* __restrict__ hs,
                        const float* __restrict__ gy, const float* __restrict__ gh,
                        float* __restrict__ gxi, float* __restrict__ gdt,
                        float* __restrict__ gBp, float* __restrict__ gCp,
                        float* __restrict__ gAp, float* __restrict__ gh0, int Q, int di) {
  using P = BwdPlan<NS>;
  constexpr int LPR = P::LPR, RPW = P::RPW, kThreads = P::kThreads, S = P::S, N = P::N,
                M = P::M, GU = P::GU, MGU = P::MGU, E = P::E;
  extern __shared__ __align__(16) float bwd_smem[];
  float* s_red = bwd_smem + kBwdStages * P::kStage;  // each warp's tile sums [kWarps][E]
  float* s_cta = s_red + P::kWarps * E;              // the CTA's [3][kGroup][E]
  float* s_ox = s_cta + 3 * kGroup * E;              // the gxi tile [kBwdTile][kBwdRows]
  float* s_od = s_ox + kBwdTile * kBwdRows;             // the gdt tile

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int l = lane % LPR, sw = lane >> 4;         // lanes 16-31 hold their states swapped
  const int n0 = 2 * l + sw, n1 = 2 * l + 1 - sw;  // the states of slots 0 and 1
  const int r = 2 * (warp * RPW + lane / LPR);     // the lane's rows r and r + 1
  const int b = blockIdx.x, nb = gridDim.x, cta = blockIdx.z;
  const int d0 = cta * kBwdRows, d = d0 + r;
  const size_t seq = (size_t)b * Q;
  const int ntiles = cdiv(Q, kBwdTile), nck = cdiv(Q, kCkpt);
  const int rank = (int)hop::cluster_ctarank();

  // Part j of tile k holds kCkpt steps from checkpoint kParts * k + j.  The
  // part holding the last step, when Q is not a multiple of kCkpt, holds its
  // steps at its end: position t of the part is step k * kBwdTile + j * kCkpt +
  // t - pad, and the positions before pad are steps of zeros, which leave
  // the part's entering state (its checkpoint) exactly as it is.  So the
  // walk back needs no test: the zero steps add 0 to every sum, even gA's,
  // whose terms there multiply that entering state (zero steps past Q at the
  // end would multiply the last state instead, which a NaN or inf at the
  // last step makes non-finite where the plain gA is finite: 0 * NaN is
  // NaN).  A part past Q has pad >= kCkpt: no position of it is a step.
  auto part_pad = [&](int k, int j) {
    const int n = Q - k * kBwdTile - j * kCkpt;
    return n >= kCkpt ? 0 : kCkpt - n;
  };

  // Tile k's inputs into ring stage `slot`; zero steps and rows past di
  // arrive as zeros.
  auto load_tile = [&](int k, int slot) {
    // the copies' addresses are recomputed at every call rather than hoisted
    // out of the tile loop, where they would hold registers for the whole walk
    int tid = threadIdx.x;
    asm("" : "+r"(tid));
    float* st = bwd_smem + slot * P::kStage;
    const int p0 = part_pad(k, 0), p1 = part_pad(k, 1);
    // the step at tile position `pos`, or -1
    const bool whole = p0 == 0 && p1 == 0;
    auto step_at = [&](int pos) {
      const int j = pos / kCkpt, t = pos % kCkpt, pj = j ? p1 : p0;
      return whole ? k * kBwdTile + pos : t >= pj ? k * kBwdTile + j * kCkpt + t - pj : -1;
    };
    constexpr int RC = kBwdRows / V, NC = NS / V, HC = kBwdRows * NS / V;
#pragma unroll
    for (int n = 0; n < cdiv(kBwdTile * RC, kThreads); ++n) {
      const int i = tid + n * kThreads, t = i / RC, c = (i % RC) * V;
      if (i >= kBwdTile * RC) break;
      const int q = step_at(t);
      const bool ok = q >= 0 && d0 + c < di;
      const size_t off = ok ? (seq + q) * di + d0 + c : 0;
      copy_chunk<V>(st + t * kBwdRows + c, dt + off, ok);
      copy_chunk<V>(st + P::oXi + t * kBwdRows + c, xi + off, ok);
      copy_chunk<V>(st + P::oGy + t * kBwdRows + c, gy + off, ok);
    }
#pragma unroll
    for (int n = 0; n < cdiv(kBwdTile * NC, kThreads); ++n) {
      const int i = tid + n * kThreads, t = i / NC, c = (i % NC) * V;
      if (i >= kBwdTile * NC) break;
      const int q = step_at(t);
      const size_t off = q >= 0 ? (seq + q) * NS + c : 0;
      copy_chunk<V>(st + P::oB + t * NS + c, Bm + off, q >= 0);
      copy_chunk<V>(st + P::oC + t * NS + c, Cm + off, q >= 0);
    }
#pragma unroll
    for (int n = 0; n < cdiv(kBwdTile * NS, kThreads); ++n) {  // the pair-swapped copies
      const int i = tid + n * kThreads, t = i / NS, c = i % NS;
      if (i >= kBwdTile * NS) break;
      const int q = step_at(t);
      const size_t off = q >= 0 ? (seq + q) * NS + c : 0;
      copy_chunk<1>(st + P::oBs + t * NS + (c ^ 1), Bm + off, q >= 0);
      copy_chunk<1>(st + P::oCs + t * NS + (c ^ 1), Cm + off, q >= 0);
    }
#pragma unroll
    for (int n = 0; n < cdiv(kParts * HC, kThreads); ++n) {
      const int i = tid + n * kThreads, j = i / HC, row = i % HC * V / NS, c = i % HC * V % NS;
      if (i >= kParts * HC) break;
      const bool ok = (j ? p1 : p0) < kCkpt && d0 + row < di;
      const size_t off = ok ? ((size_t)(b * nck + kParts * k + j) * di + d0 + row) * NS + c : 0;
      copy_chunk<V>(st + P::oH + (j * kBwdRows + row) * NS + c, hs + off, ok);
    }
  };
  // iteration i takes tile ntiles - 1 - i from stage i % kBwdStages
#pragma unroll
  for (int i = 0; i < kBwdStages - 1; ++i) {
    if (i < ntiles) load_tile(ntiles - 1 - i, i);
    hop::cp_async_commit();
  }

  // This CTA's 1 / kCluster slice of group g's tile sums (CTA buffer g % 3),
  // summed over the cluster's CTAs in rank order through DSMEM, for the
  // cluster's partial rows: returns where the thread's float4 `acc` goes, or
  // null.
  constexpr int kSlice = kGroup * E / (4 * kCluster);  // float4s a CTA sums
  auto cluster_sum = [&](int g, float4& acc) -> float* {
    const int f = 4 * (rank * kSlice + tid), it = g * kGroup + f / E, fe = f % E;
    if (tid < kSlice && it < ntiles) {
      const uint32_t addr = hop::smem_addr(s_cta + (g % 3) * kGroup * E + f);
      float4 v[kCluster];
#pragma unroll
      for (int c = 0; c < kCluster; ++c) v[c] = hop::ld_dsmem_f4(hop::mapa(addr, c));
      acc = v[0];
#pragma unroll
      for (int c = 1; c < kCluster; ++c) {
        acc.x += v[c].x; acc.y += v[c].y; acc.z += v[c].z; acc.w += v[c].w;
      }
      const int k = ntiles - 1 - it, pos = fe / NS % kBwdTile, n = fe % NS;
      const int j = pos / kCkpt, t = pos % kCkpt, pj = part_pad(k, j);
      if (t >= pj)
        return (fe < kBwdTile * NS ? gBp : gCp) +
               (((size_t)(cta / kCluster) * nb + b) * Q + k * kBwdTile + j * kCkpt + t - pj) * NS +
               n;
    }
    return nullptr;
  };

  // the lane's gradient of h (from the future), its gA sums, A and A in log2
  // units, for its two rows and two states, in registers for the whole walk
  float carry[2][2], gA[2][2], An[2][2], a2[2][2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const size_t srow = ((size_t)b * di + d + w) * NS;
    const bool live = d + w < di;
    carry[w][0] = live && gh != nullptr ? gh[srow + n0] : 0.f;
    carry[w][1] = live && gh != nullptr ? gh[srow + n1] : 0.f;
    An[w][0] = live ? A[(size_t)(d + w) * NS + n0] : 0.f;
    An[w][1] = live ? A[(size_t)(d + w) * NS + n1] : 0.f;
    gA[w][0] = gA[w][1] = 0.f;
    a2[w][0] = An[w][0] * kLog2e;
    a2[w][1] = An[w][1] * kLog2e;
  }
  constexpr int kSums = E / kThreads;  // tile sums a thread

  // Iteration i < ntiles walks tile ntiles - 1 - i; the tiles form groups
  // of kGroup, and the cluster sums group g - 1 at the end of group g, the
  // last group in the extra iteration i == ntiles (one call site each, so the
  // lambdas inline and the lane's arrays stay in registers).
  const int ngroups = cdiv(ntiles, kGroup);
  for (int i = 0; i <= ntiles; ++i) {
    const int k = ntiles - 1 - i, p0 = part_pad(k, 0), p1 = part_pad(k, 1);
    const int g = i / kGroup;
    const bool group_end = i == ntiles || i % kGroup == kGroup - 1 || i == ntiles - 1;
    if (i < ntiles) {
      if (i + kBwdStages - 1 < ntiles)
        load_tile(k - (kBwdStages - 1), (i + kBwdStages - 1) % kBwdStages);
      hop::cp_async_commit();
      hop::cp_async_wait<kBwdStages - 1>();  // tile k landed for this thread
      __syncthreads();                       // ... and for every thread
      const float* st = bwd_smem + (i % kBwdStages) * P::kStage;
#pragma unroll 1
      for (int j = kParts - 1; j >= 0; --j) {
        if ((j ? p1 : p0) >= kCkpt) continue;  // a part past Q
        const int pos0 = j * kCkpt;
        const float* s_dt = st + pos0 * kBwdRows + r;  // rows r, r + 1 of each step
        const float* s_xi = s_dt + P::oXi;
        const float* s_gy = s_dt + P::oGy;
        const float* s_b = st + (sw ? P::oBs : P::oB) + pos0 * NS + 2 * l;
        const float* s_c = st + (sw ? P::oCs : P::oC) + pos0 * NS + 2 * l;
        const float* s_h = st + P::oH + (j * kBwdRows + r) * NS;

        // the part's states and decays as the forward computed them:
        // hist[0] entering the part, hist[t + 1] and dec[t] at step t
        float hist[kCkpt + 1][2][2], dec[kCkpt][2][2];
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          hist[0][w][0] = s_h[w * NS + n0];
          hist[0][w][1] = s_h[w * NS + n1];
        }
#pragma unroll
        for (int t = 0; t < kCkpt; ++t) {
          const float2 dt2 = *reinterpret_cast<const float2*>(s_dt + t * kBwdRows);
          const float2 xi2 = *reinterpret_cast<const float2*>(s_xi + t * kBwdRows);
          const float2 bv = *reinterpret_cast<const float2*>(s_b + t * NS);
          const float dtw[2] = {dt2.x, dt2.y}, u[2] = {dt2.x * xi2.x, dt2.y * xi2.y};
          const float bb[2] = {bv.x, bv.y};
#pragma unroll
          for (int w = 0; w < 2; ++w)
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              dec[t][w][s] = ex2(dtw[w] * a2[w][s]);
              hist[t + 1][w][s] = fmaf(dec[t][w][s], hist[t][w][s], u[w] * bb[s]);
            }
        }

        // back through the part
        float gv[4 * GU];  // the lane's parts of gu and gdt's A-term, [step][row][gu, gd]
        float tv[N];       // gB / gC terms over the two rows, [state slot][step][gB, gC]
#pragma unroll
        for (int t = kCkpt - 1; t >= 0; --t) {
          const float2 dt2 = *reinterpret_cast<const float2*>(s_dt + t * kBwdRows);
          const float2 xi2 = *reinterpret_cast<const float2*>(s_xi + t * kBwdRows);
          const float2 gy2 = *reinterpret_cast<const float2*>(s_gy + t * kBwdRows);
          const float2 bv = *reinterpret_cast<const float2*>(s_b + t * NS);
          const float2 cv = *reinterpret_cast<const float2*>(s_c + t * NS);
          const float dtw[2] = {dt2.x, dt2.y}, gyw[2] = {gy2.x, gy2.y};
          const float u[2] = {dt2.x * xi2.x, dt2.y * xi2.y};
          const float bb[2] = {bv.x, bv.y}, cc[2] = {cv.x, cv.y};
          float gw[2][2];
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            float gu = 0.f, gd = 0.f;
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const float gg = fmaf(gyw[w], cc[s], carry[w][s]);
              const float an = dec[t][w][s] * gg;   // a_t g_t: the carry into step t - 1
              const float wv = an * hist[t][w][s];  // g_t a_t h_{t-1}
              gu = fmaf(gg, bb[s], gu);
              gd = fmaf(wv, An[w][s], gd);
              gA[w][s] = fmaf(wv, dtw[w], gA[w][s]);
              carry[w][s] = an;
              gw[w][s] = gg;
            }
            gv[((t % GU) * 2 + w) * 2] = gu;
            gv[((t % GU) * 2 + w) * 2 + 1] = gd;
          }
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            tv[s * (N / 2) + 2 * (t % S)] = fmaf(gw[1][s], u[1], gw[0][s] * u[0]);
            tv[s * (N / 2) + 2 * (t % S) + 1] =
                fmaf(gyw[1], hist[t + 1][1][s], gyw[0] * hist[t + 1][0][s]);
          }
          if (t % GU == 0) {
            // summed over the row pair's lanes: lane l keeps step t + l / 2's
            // gu and A-term of row r + l % 2 (at 16 lanes, lanes 2m and 2m + 1
            // share step t + m / 2's of row r + m % 2)
            reduce_scatter_lanes<1, LPR>(gv, lane);
            float gus = gv[0], gds = gv[MGU - 1];
            int s = l / 2, w = l % 2;
            if constexpr (MGU == 1) {
              const float other = __shfl_xor_sync(0xffffffffu, gv[0], 1);
              gus = l % 2 ? other : gv[0];
              gds = l % 2 ? gv[0] : other;
              s = l / 4;
              w = l / 2 % 2;
            }
            if (MGU == 2 || l % 2 == 0) {
              s_ox[(pos0 + t + s) * kBwdRows + r + w] = gus * s_dt[(t + s) * kBwdRows + w];
              s_od[(pos0 + t + s) * kBwdRows + r + w] =
                  fmaf(gus, s_xi[(t + s) * kBwdRows + w], gds);
            }
          }
          if (t % S == 0) {
            // the group's terms summed over the warp's row pairs: first
            // across the halves (slot 1 of lane ^ 16 holds slot 0's state),
            // then scattered
            float rv[N / 2];
#pragma unroll
            for (int q = 0; q < N / 2; ++q)
              rv[q] = tv[q] + __shfl_xor_sync(0xffffffffu, tv[q + N / 2], 16);
            reduce_scatter_lanes<LPR, RPW / 2>(rv, lane);
#pragma unroll
            for (int q = 0; q < M; ++q)
              s_red[warp * E + ((pos0 + t) / S * 32 + lane) * M + q] = rv[q];
          }
        }
      }
      __syncthreads();  // the gxi / gdt tiles and the warps' sums are whole; the stage is free
    }  // i < ntiles
    // at a group's end, the group before it over the cluster (each CTA
    // published it at its own end of that group); the last group in the
    // extra iteration
    const int gs = i == ntiles ? ngroups - 1 : g - 1;  // the group summed here
    const bool exchange = group_end && gs >= 0;
    float4 part;
    float* part_at = nullptr;
    if (exchange) {
      hop::cluster_wait();
      part_at = cluster_sum(gs, part);
    }
    if (i < ntiles) {
      // this tile's sums over the CTA's warps, in warp order, into the
      // group's buffer, which the peers last read (three groups ago) before
      // they arrived at the barrier this CTA waited on at its last exchange
#pragma unroll
      for (int q = 0; q < kSums; ++q) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < P::kWarps; ++w) sum += s_red[w * E + tid + q * kThreads];
        s_cta[((g % 3) * kGroup + i % kGroup) * E + tile_sum_index<NS>(tid + q * kThreads)] = sum;
      }
      if (group_end) hop::cluster_arrive();
    }
    // stores to device memory after the arrive, whose release would wait for them
    if (part_at != nullptr) *reinterpret_cast<float4*>(part_at) = part;
    if (i == ntiles) break;
    constexpr int RC = kBwdRows / V;
#pragma unroll
    for (int n = 0; n < cdiv(kBwdTile * RC, kThreads); ++n) {
      const int i2 = tid + n * kThreads, pos = i2 / RC, c = (i2 % RC) * V;
      const int j = pos / kCkpt, t = pos % kCkpt, pj = j ? p1 : p0;
      if (i2 < kBwdTile * RC && t >= pj && d0 + c < di) {
        const size_t o = (seq + k * kBwdTile + j * kCkpt + t - pj) * di + d0 + c;
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(gxi + o) =
              *reinterpret_cast<const float4*>(s_ox + pos * kBwdRows + c);
          *reinterpret_cast<float4*>(gdt + o) =
              *reinterpret_cast<const float4*>(s_od + pos * kBwdRows + c);
        } else {
          gxi[o] = s_ox[pos * kBwdRows + c];
          gdt[o] = s_od[pos * kBwdRows + c];
        }
      }
    }
  }
  hop::cluster_arrive();  // no CTA exits while a peer may still read its sums
  hop::cluster_wait();
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (d + w < di) {
      const size_t srow = ((size_t)b * di + d + w) * NS;
      gh0[srow + n0] = carry[w][0];
      gh0[srow + n1] = carry[w][1];
      gAp[srow + n0] = gA[w][0];
      gAp[srow + n1] = gA[w][1];
    }
  }
}

// One launch sums three sets of partials: out[i] = sum over p < parts of
// in[p * n + i], p in order (deterministic).
struct SumJob {
  const float* in;
  float* out;
  int parts;
  long long n;
};

__global__ void sum_partials_kernel(SumJob j0, SumJob j1, SumJob j2) {
  const long long total = j0.n + j1.n + j2.n;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const bool first = i < j0.n, second = !first && i < j0.n + j1.n;
    const float* in = first ? j0.in : second ? j1.in : j2.in;
    float* out = first ? j0.out : second ? j1.out : j2.out;
    const int parts = first ? j0.parts : second ? j1.parts : j2.parts;
    const long long n = first ? j0.n : second ? j1.n : j2.n;
    const long long o = first ? i : second ? i - j0.n : i - j0.n - j1.n;
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += in[p * n + o];
    out[o] = s;
  }
}

template <int NS, int V, bool CKPT>
cudaError_t run(const void* const* p, int B, int Q, int di, void* stream) {
  using P = Plan<NS>;
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  auto w = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  return kern::launch(ssm_scan_kernel<NS, V, CKPT>, dim3((di + kRows - 1) / kRows, B),
                      P::kThreads, P::kSmem, stream, f(0), f(1), f(2), f(3), f(4), f(5), w(6),
                      w(7), w(8), Q, di);
}

template <int NS, int V>
cudaError_t run_bwd(const void* const* p, int B, int Q, int di, void* stream) {
  using P = BwdPlan<NS>;
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  auto w = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  const int ncl = cdiv(cdiv(di, kBwdRows), kCluster);
  cudaError_t err = kern::launch_cluster(
      ssm_scan_bwd_kernel<NS, V>, dim3(B, 1, ncl * kCluster), P::kThreads, P::kSmem, kCluster,
      stream, f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), w(8), w(9), w(14), w(15), w(16),
      w(13), Q, di);
  if (err != cudaSuccess) return err;
  const long long nbc = (long long)B * Q * NS;
  const SumJob jb{f(14), w(10), ncl, nbc}, jc{f(15), w(11), ncl, nbc};
  const SumJob ja{f(16), w(12), B, (long long)di * NS};
  const long long blocks = (2 * nbc + (long long)di * NS + 255) / 256;
  return kern::launch(sum_partials_kernel, dim3((unsigned)(blocks < 4096 ? blocks : 4096)), 256,
                      0, stream, jb, jc, ja);
}

// 16-byte copies when di % 4 == 0 and every non-null pointer is 16-byte aligned.
bool vec_ok(const void* const* p, int n, int di) {
  bool vec = di % 4 == 0;
  for (int i = 0; i < n; ++i) vec = vec && reinterpret_cast<uintptr_t>(p[i]) % 16 == 0;
  return vec;
}

template <int NS>
cudaError_t run_ns(const void* const* p, bool ckpt, int B, int Q, int di, void* stream) {
  if (vec_ok(p, 9, di))
    return ckpt ? run<NS, 4, true>(p, B, Q, di, stream) : run<NS, 4, false>(p, B, Q, di, stream);
  return ckpt ? run<NS, 1, true>(p, B, Q, di, stream) : run<NS, 1, false>(p, B, Q, di, stream);
}

template <int NS>
cudaError_t run_bwd_ns(const void* const* p, int B, int Q, int di, void* stream) {
  return vec_ok(p, 17, di) ? run_bwd<NS, 4>(p, B, Q, di, stream)
                           : run_bwd<NS, 1>(p, B, Q, di, stream);
}

}  // namespace

// Any B, Q >= 0 and di; ds (the SSM state width) must be 4, 8, 16 or 32.
// hs: null, or [B, ceil(Q / 8), di, ds] for the state entering every 8th
// step (the backward's checkpoints).  Returns a cudaError_t code.
extern "C" int ssm_scan_chunk_launch(const void* xi, const void* dt, const void* Bm,
                                     const void* Cm, const void* A, const void* h0, void* y,
                                     void* h_out, void* hs, int B, int Q, int di, int ds,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || di == 0) return cudaSuccess;
  const void* p[9] = {xi, dt, Bm, Cm, A, h0, y, h_out, hs};
  const bool ckpt = hs != nullptr;
  switch (ds) {
    case 4:
      return run_ns<4>(p, ckpt, B, Q, di, stream);
    case 8:
      return run_ns<8>(p, ckpt, B, Q, di, stream);
    case 16:
      return run_ns<16>(p, ckpt, B, Q, di, stream);
    case 32:
      return run_ns<32>(p, ckpt, B, Q, di, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward of ssm_scan_chunk_launch with checkpoints: from the forward's
// inputs, its checkpoints hs and the gradients gy [B, Q, di] and gh [B, di,
// ds] (null: zero), writes gxi, gdt [B, Q, di], gB, gC [B, Q, ds], gA [di,
// ds] and gh0 [B, di, ds]; gBp, gCp [ceil(di / 256), B, Q, ds] (one row per
// cluster of 8 CTAs of 32 rows) and gAp [B, di, ds] are scratch for the
// partial sums.  Returns a cudaError_t code.
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

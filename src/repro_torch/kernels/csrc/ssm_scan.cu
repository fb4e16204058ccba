// Mamba1 selective-scan chunk for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py `ssm_scan_chunk`
// (Pallas body `_ssm_kernel`): one chunk of Q steps of
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = h_t . C_t
// over xi / dt [B, Q, di], B / C [B, Q, ds], A [di, ds], h0 [B, di, ds],
// all float32, giving y [B, Q, di] and the final h [B, di, ds].
//
// On the TPU the [block_d, ds] state lived in VMEM scratch for the chunk.
// Here it lives in registers: one thread per (d, n) pair, ds lanes per
// d_inner row (16 at falcon-mamba's ds = 16, 8 rows per 128-thread block),
// dt_t and x_t shared by the row's lanes (one broadcast load) and y_t an
// ds-lane shuffle sum.  The loop over the Q steps is serial, as the
// recurrence is; the grid covers (d_inner / rows per block, B).  Bound on
// the card: device-memory bytes (xi, dt, y and both states once, B and C
// once per row block from L2) -- at the engine's shape one launch moves
// ~7.9 MB, ~2.3 us at 3.35 TB/s, so launch latency and the serial step
// chain dominate.  expf, not a fast-math exponential, keeps fp32 within
// 1e-5 of the plain version.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <int NS>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ xi, const float* __restrict__ dt,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    const float* __restrict__ A, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ h_out, int Q,
                    int di) {
  constexpr int kRows = kThreads / NS;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % NS;
  const int d = blockIdx.x * kRows + threadIdx.x / NS;
  const bool live = d < di;
  const int dd = live ? d : di - 1;  // dead rows still join the shuffles
  const float a = __ldg(A + (size_t)dd * NS + lane);
  const size_t hrow = ((size_t)b * di + dd) * NS + lane;
  float h = __ldg(h0 + hrow);
  const size_t seq = (size_t)b * Q;
  for (int t = 0; t < Q; ++t) {
    const size_t xt = (seq + t) * di + dd;
    const float dtv = __ldg(dt + xt);
    const float u = dtv * __ldg(xi + xt);
    const size_t nt = (seq + t) * NS + lane;
    h = expf(dtv * a) * h + u * __ldg(Bm + nt);
    float part = h * __ldg(Cm + nt);
#pragma unroll
    for (int off = NS / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off, NS);
    if (live && lane == 0) y[xt] = part;
  }
  if (live) h_out[hrow] = h;
}

template <int NS>
cudaError_t run(const void* xi, const void* dt, const void* Bm,
                const void* Cm, const void* A, const void* h0, void* y,
                void* h_out, int B, int Q, int di, void* stream) {
  constexpr int kRows = kThreads / NS;
  return kern::launch(ssm_scan_kernel<NS>, dim3((di + kRows - 1) / kRows, B),
                      kThreads, 0, stream, static_cast<const float*>(xi),
                      static_cast<const float*>(dt),
                      static_cast<const float*>(Bm),
                      static_cast<const float*>(Cm),
                      static_cast<const float*>(A),
                      static_cast<const float*>(h0), static_cast<float*>(y),
                      static_cast<float*>(h_out), Q, di);
}

}  // namespace

// ds (the SSM state width) must be 4, 8, 16 or 32.  Returns a cudaError_t
// code.
extern "C" int ssm_scan_chunk_launch(const void* xi, const void* dt,
                                     const void* Bm, const void* Cm,
                                     const void* A, const void* h0, void* y,
                                     void* h_out, int B, int Q, int di, int ds,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || di == 0) return cudaSuccess;
  switch (ds) {
    case 4:
      return run<4>(xi, dt, Bm, Cm, A, h0, y, h_out, B, Q, di, stream);
    case 8:
      return run<8>(xi, dt, Bm, Cm, A, h0, y, h_out, B, Q, di, stream);
    case 16:
      return run<16>(xi, dt, Bm, Cm, A, h0, y, h_out, B, Q, di, stream);
    case 32:
      return run<32>(xi, dt, Bm, Cm, A, h0, y, h_out, B, Q, di, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

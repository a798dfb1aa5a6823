// RG-LRU linear recurrence for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` behind `rglru_scan` in
// src/repro/kernels/rglru_scan.py. Same function: h_t = exp(a_log_t) h_{t-1}
// + b_t over the sequence axis from a zero state, for a_log, b (B,S,W) f32;
// h (B,S,W) and h_last (B,W) in f32.
//
// What bounds it on this card: every element is read twice and written
// once and costs a handful of operations, so the bound is bytes (at
// recurrentgemma-9b's prefill, B=4, S=2048, W=4096: ~403 MB, ~0.12 ms at
// 3.35 TB/s).
//
// Design. The TPU kernel runs a Hillis-Steele doubling scan over (256, 512)
// tiles, because a step-by-step loop does not suit its vector unit, and
// carries the state across time blocks in VMEM. On Hopper the channels are
// independent and plentiful (B*W = 16384 at the prefill shape), so each
// thread owns one channel and walks the sequence in order: one FMA and one
// exp a step, no scan overhead, exactly the recurrence's own work.
// Neighbouring threads own neighbouring channels, so every load and store
// of a warp is one contiguous 128-byte line. The loop is latency-bound
// unless many loads are in flight: each thread loads the next U = 16 steps
// of a_log and b into registers (streaming, evict-first) before it computes
// the current 16, so 32 loads per thread stay in flight behind the
// dependent FMA chain. Splitting the sequence across blocks (a chunked
// scan with a carry pass) would add parallelism at smaller B*W; it is left
// to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // channels per block
constexpr int U = 16;    // steps loaded ahead

__global__ void __launch_bounds__(NT)
rglru_kernel(const float* __restrict__ a_log, const float* __restrict__ bx,
             float* __restrict__ h_out, float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const size_t base = size_t(b) * S * W + w;
  const float* ap = a_log + base;
  const float* bp = bx + base;
  float* hp = h_out + base;

  float h = 0.f;
  const int full = S / U * U;   // steps in whole groups of U
  float an[U], bn[U];
  if (full > 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      an[u] = __ldcs(ap + size_t(u) * W);
      bn[u] = __ldcs(bp + size_t(u) * W);
    }
  }
  for (int t0 = 0; t0 < full; t0 += U) {
    float ac[U], bc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ac[u] = an[u];
      bc[u] = bn[u];
    }
    if (t0 + U < full) {   // the next group's loads go out before this group's FMAs
#pragma unroll
      for (int u = 0; u < U; ++u) {
        an[u] = __ldcs(ap + size_t(t0 + U + u) * W);
        bn[u] = __ldcs(bp + size_t(t0 + U + u) * W);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = fmaf(expf(ac[u]), h, bc[u]);
      __stcs(hp + size_t(t0 + u) * W, h);
    }
  }
  for (int t = full; t < S; ++t) {
    h = fmaf(expf(__ldcs(ap + size_t(t) * W)), h, __ldcs(bp + size_t(t) * W));
    __stcs(hp + size_t(t) * W, h);
  }
  h_last[size_t(b) * W + w] = h;
}

}  // namespace

extern "C" {

// a_log, b, h (B,S,W) and h_last (B,W), float32, contiguous. Returns a
// cudaError_t.
int rglru_scan_fwd(const void* a_log, const void* b, void* h, void* h_last, int B, int S,
                   int W, void* stream) {
  if (B <= 0 || W <= 0) return int(cudaSuccess);
  if (S <= 0) return int(cudaErrorInvalidValue);
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a_log), static_cast<const float*>(b), static_cast<float*>(h),
      static_cast<float*>(h_last), S, W);
  return int(cudaGetLastError());
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

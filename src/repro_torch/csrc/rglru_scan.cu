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
//
// The backward (`rglru_scan_bwd`) has no Pallas kernel: the JAX package
// differentiates its associative-scan oracle (src/repro/models/rglru.py,
// `_rglru_scan`). With a_t = exp(a_log_t), h_{-1} = 0 and the cotangents dh
// (B,S,W) and dh_last (B,W), either of which may be absent (zero):
//   g_{S-1} = dh_{S-1} + dh_last,  g_t = dh_t + a_{t+1} g_{t+1},
//   db_t = g_t,  da_log_t = g_t a_t h_{t-1}.
// It is the forward's loop run backwards: each thread owns one channel and
// walks t from S-1 down to 0, loading the next U steps of a_log, h (one step
// behind) and dh before it computes the current U. Reads a_log, h, dh and
// writes da_log, db: 20 bytes an element, bound by bytes (at
// recurrentgemma-9b's training shape, B=2, S=4096, W=4096: ~671 MB, ~0.20 ms
// at 3.35 TB/s). The grid is the forward's, (W/128, B): 64 blocks at B = 2
// for 132 SMs; splitting the sequence would fill the card and is left to a
// later change, as for the forward.

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

// the steps [t0, t0 + U) of one channel, loaded into registers: a_log_t, dh_t
// (0 without dh) and h_{t-1} (0 at t = 0)
struct BwdGroup {
  float a[U], d[U], hp[U];
};

__device__ __forceinline__ void bwd_load(BwdGroup& g, const float* ap, const float* hp,
                                         const float* dp, int t0, int W) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    g.a[u] = __ldcs(ap + size_t(t) * W);
    g.d[u] = dp != nullptr ? __ldcs(dp + size_t(t) * W) : 0.f;
    g.hp[u] = t > 0 ? __ldcs(hp + size_t(t - 1) * W) : 0.f;
  }
}

__global__ void __launch_bounds__(NT)
rglru_bwd_kernel(const float* __restrict__ a_log, const float* __restrict__ h,
                 const float* __restrict__ dh, const float* __restrict__ dh_last,
                 float* __restrict__ da_log, float* __restrict__ db, int S, int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const size_t base = size_t(b) * S * W + w;
  const float* ap = a_log + base;
  const float* hp = h + base;
  const float* dp = dh != nullptr ? dh + base : nullptr;
  float* dap = da_log + base;
  float* dbp = db + base;

  float g = dh_last != nullptr ? dh_last[size_t(b) * W + w] : 0.f;   // g_S, with a_S = 1
  float an = 1.f;                                                      // a_{t+1}
  const int rem = S % U;   // steps [0, rem) after the whole groups [rem, S), top down
  BwdGroup nx;
  if (S >= U) bwd_load(nx, ap, hp, dp, S - U, W);
  for (int t0 = S - U; t0 >= rem; t0 -= U) {
    BwdGroup cur = nx;
    if (t0 - U >= rem) bwd_load(nx, ap, hp, dp, t0 - U, W);   // the next group's loads first
#pragma unroll
    for (int u = U - 1; u >= 0; --u) {
      g = fmaf(an, g, cur.d[u]);
      const float a = expf(cur.a[u]);
      __stcs(dbp + size_t(t0 + u) * W, g);
      __stcs(dap + size_t(t0 + u) * W, g * a * cur.hp[u]);
      an = a;
    }
  }
  for (int t = rem - 1; t >= 0; --t) {
    g = fmaf(an, g, dp != nullptr ? __ldcs(dp + size_t(t) * W) : 0.f);
    const float a = expf(__ldcs(ap + size_t(t) * W));
    const float hprev = t > 0 ? __ldcs(hp + size_t(t - 1) * W) : 0.f;
    __stcs(dbp + size_t(t) * W, g);
    __stcs(dap + size_t(t) * W, g * a * hprev);
    an = a;
  }
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

// a_log, h, dh, da_log, db (B,S,W) and dh_last (B,W), float32, contiguous;
// dh and dh_last may be null (a zero cotangent). Returns a cudaError_t.
int rglru_scan_bwd(const void* a_log, const void* h, const void* dh, const void* dh_last,
                   void* da_log, void* db, int B, int S, int W, void* stream) {
  if (B <= 0 || W <= 0) return int(cudaSuccess);
  if (S <= 0) return int(cudaErrorInvalidValue);
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_bwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a_log), static_cast<const float*>(h),
      static_cast<const float*>(dh), static_cast<const float*>(dh_last),
      static_cast<float*>(da_log), static_cast<float*>(db), S, W);
  return int(cudaGetLastError());
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// RG-LRU linear recurrence for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` behind `rglru_scan` in
// src/repro/kernels/rglru_scan.py. Same function: h_t = exp(a_log_t) h_{t-1}
// + b_t over the sequence axis from a zero state, for a_log, b (B,S,W) f32;
// h (B,S,W) and h_last (B,W) in f32.
//
// What bounds it on this card: bytes. Each element reads a_log and b once
// and writes h once, 12 bytes, for one exp and two FMAs. At recurrentgemma-9b's
// training shape (B=2, S=4096, W=4096) and at its prefill shape (B=4,
// S=2048, W=4096) that is 403 MB either way: 0.1202 ms at 3.35 TB/s. The
// operations would take a tenth of that at the f32 rate.
//
// Why one thread a channel missed the bound. The first version gave each
// thread one channel and walked all S steps in order on a grid of (W/128,
// B) blocks of 4 warps. At B = 2 that is 64 blocks on 132 SMs: half the SMs
// idle, the others holding 4 of their 64 warps, and a chain of dependent
// FMAs over 4096 steps behind loads that 4 warps can keep in flight. By
// Little's law the card needs about 3.35 TB/s x ~1 us = ~3.4 MB in flight;
// 64 SMs x 128 threads x 32 loads of 4 bytes is ~1 MB, and less while a
// thread computes. It read 0.2582 ms at B = 2 (47% of the bound) and 0.1710
// ms at B = 4 (70%) on an H100 at 700 W.
//
// Design: the sequence is split inside the block. A block owns TW = 32
// consecutive channels (one warp's width, so every load and store of a warp
// is one 128-byte line) of one batch row and takes the sequence in rounds of
// NW x L = 8 x 16 = 128 steps; warp k holds steps [k L, (k+1) L) of the
// round. A round:
//   1. each thread scans its L steps from zero in registers: the local
//      h_loc_t and the running decay A_t = prod_{s<=t} a_s of its piece;
//   2. it writes the piece's aggregate (A_L, h_loc_L) to shared memory; one
//      __syncthreads;
//   3. every thread folds the round's NW aggregates onto the incoming carry
//      with (A1, h1) o (A2, h2) = (A1 A2, A2 h1 + h2), in piece order: its own
//      carry-in is the fold before its piece, the next round's carry the
//      fold of all NW;
//   4. it writes h_t = fma(A_t, carry_in, h_loc_t) with streaming stores.
// The next round's L steps of a_log and b are loaded into registers before
// the current round is computed, as the first version did with its 16-step
// groups, so 2 L = 32 loads a thread stay in flight behind the scan and the
// barrier. Steps past S read a_log = 0, b = 0, the operator's identity, so a
// ragged last round needs no other case, and the last carry is h_{S-1}.
//
// The numbers. The training shape is B x W / TW = 256 blocks of 256 threads
// (~2 a SM, ~16 resident warps a SM instead of ~2); the prefill's 512 blocks
// fill the card twice. Each block keeps 256 threads x 32 loads x 4 B = 32 KB
// in flight, ~64 KB a SM, ~8 MB over the card: above the ~3.4 MB that the
// memory rate wants. One round moves 256 x 16 x 12 B = 48 KB a block for a
// few hundred cycles of scan, fold and barrier. A longer piece (L = 32)
// doubles the registers for no more bytes in flight than a second resident
// block gives; more warps a block (NW = 16) lengthen the fold and the
// barrier; tools/rglru_variants.py times both against this choice (each
// within 5% of it at B = 2 on an H100, where this design reads ~0.15 ms at
// both shapes, ~80% of the bound).
//
// Why the fold runs in a fixed order. The operator is associative but not
// commutative, and in floating point not even associative: every thread
// folds the same aggregates in the same piece order with the same FMAs, so
// all warps agree bit for bit on each carry, the last piece's end written to
// h equals the carry the next round starts from, and two launches on the
// same inputs give the same bits. No atomics and no cross-block flags: a
// decoupled look-back would stop at a point that depends on timing, and its
// sums would not be reproducible.
//
// The backward (`rglru_scan_bwd`) has no Pallas kernel: the JAX package
// differentiates its associative-scan oracle (src/repro/models/rglru.py,
// `_rglru_scan`). With a_t = exp(a_log_t), h_{-1} = 0 and the cotangents dh
// (B,S,W) and dh_last (B,W), either of which may be absent (zero):
//   g_{S-1} = dh_{S-1} + dh_last,  g_t = dh_t + a_{t+1} g_{t+1},
//   db_t = g_t,  da_log_t = g_t a_t h_{t-1}.
// It is the first forward's loop run backwards: each thread owns one channel
// and walks t from S-1 down to 0, loading the next U steps of a_log, h (one
// step behind) and dh before it computes the current U. Reads a_log, h, dh
// and writes da_log, db: 20 bytes an element, bound by bytes (at
// recurrentgemma-9b's training shape, B=2, S=4096, W=4096: ~671 MB, ~0.20 ms
// at 3.35 TB/s). Its grid is (W/128, B): 64 blocks at B = 2 for 132 SMs;
// splitting the sequence as the forward does would fill the card and is
// left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // the backward's channels per block
constexpr int U = 16;    // the backward's steps loaded ahead

// the forward's tile: TW channels, NW warps, L steps a piece, NW L a round
constexpr int TW = 32;
constexpr int NW = 8;
constexpr int L = 16;

// one piece's L steps of a_log and b from step t0 (0 past S or W: the identity)
__device__ __forceinline__ void fwd_load(float (&a)[L], float (&b)[L], const float* ap,
                                         const float* bp, int t0, int S, int W, bool live) {
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const int t = t0 + u;
    const bool ok = live && t < S;
    a[u] = ok ? __ldcs(ap + size_t(t) * W) : 0.f;
    b[u] = ok ? __ldcs(bp + size_t(t) * W) : 0.f;
  }
}

__global__ void __launch_bounds__(NW * 32, 2)
rglru_kernel(const float* __restrict__ a_log, const float* __restrict__ bx,
             float* __restrict__ h_out, float* __restrict__ h_last, int S, int W) {
  __shared__ float2 agg[2][NW][TW];   // (A_L, h_loc_L) of each piece, by round parity
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * TW + lane;
  const int b = blockIdx.y;
  const bool live = w < W;            // lanes past W run the rounds on zeros
  const size_t base = size_t(b) * S * W + (live ? w : 0);
  const float* ap = a_log + base;
  const float* bp = bx + base;
  float* hp = h_out + base;

  constexpr int R = NW * L;
  const int rounds = (S + R - 1) / R;
  float an[L], bn[L];
  fwd_load(an, bn, ap, bp, warp * L, S, W, live);
  float carry = 0.f;                  // h before the round's first step
  for (int r = 0; r < rounds; ++r) {
    const int t0 = r * R + warp * L;
    float A[L], H[L];
#pragma unroll
    for (int u = 0; u < L; ++u) {
      A[u] = an[u];
      H[u] = bn[u];
    }
    if (r + 1 < rounds) fwd_load(an, bn, ap, bp, t0 + R, S, W, live);   // next round's loads first

    float acc_a = 1.f, acc_h = 0.f;   // the piece's scan from zero
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const float a = expf(A[u]);
      acc_a *= a;
      acc_h = fmaf(a, acc_h, H[u]);
      A[u] = acc_a;
      H[u] = acc_h;
    }
    float2 (*slot)[TW] = agg[r & 1];
    slot[warp][lane] = make_float2(acc_a, acc_h);
    __syncthreads();   // the other parity's slots were last read before this barrier

    float in = carry;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const float2 g = slot[k][lane];
      if (k == warp) in = carry;
      carry = fmaf(g.x, carry, g.y);
    }
#pragma unroll
    for (int u = 0; u < L; ++u) {
      if (live && t0 + u < S) __stcs(hp + size_t(t0 + u) * W, fmaf(A[u], in, H[u]));
    }
  }
  if (live && warp == 0) h_last[size_t(b) * W + w] = carry;
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
  const dim3 grid((W + TW - 1) / TW, B);
  rglru_kernel<<<grid, NW * 32, 0, static_cast<cudaStream_t>(stream)>>>(
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

// Mamba-2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` behind `ssd_scan` in
// src/repro/kernels/ssd_scan.py. Same function: for each (b, h) and each
// chunk of L steps, in order, with a_cum the chunk's cumulative log-decay,
//   y      = (tril(exp(a_cum_i - a_cum_j)) o C B^T) X + exp(a_cum) C state^T
//   state' = exp(a_cum[L-1]) state + (X * exp(a_cum[L-1] - a_cum))^T B
// from a zero state; x (B,S,H,P), a_log (B,S,H) f32, b/c (B,S,G,N) with
// group h / (H/G); y in x's type, the final state (B,H,P,N) in f32.
//
// bfloat16 (the serving path): a chunk-parallel SSD on the tensor cores.
// The TPU kernel walks the chunks of one (b, h) in order with the (P, N)
// state in VMEM; on Hopper that order leaves most SMs idle. The SSD paper's
// decomposition (arXiv:2405.21060, sections 6-7) splits the scan into four
// launches on the caller's stream, three of them products over independent
// (b, chunk, ...) tiles and one a short elementwise recurrence:
//
// 1. ssd_cb_kernel, a block per (lower 64x64 tile, chunk, group, b):
//    cb = C_c B_c^T over N, once per group (not per head), f32, into
//    (B, nc, G, LP, LP) scratch, LP = L rounded up to 64 (rows and keys
//    past L read as zeros). Tiles above the diagonal are neither computed
//    nor read. 128 threads, 4 warps of 16 rows x 64 keys; C and B tiles
//    (64 x N bf16) by cp.async into 34816 B of shared memory.
// 2. ssd_chunk_state_kernel, a block per (h, chunk, b), h fastest so the
//    heads of a group meet the same B rows in L2: a_cum by a warp scan
//    (written to (B, H, nc, L) scratch for the later stages) and
//    states[c] = (X * w)^T B, w = exp(a_cum[L-1] - a_cum), a (P, N) f32
//    tile into (B, nc, H, P, N) scratch. 256 threads, 8 warps of 16 p-rows
//    x 64 n-columns; slabs of 64 rows of x and B stream through a 2-stage
//    cp.async ring; 54272 B of shared memory, 3 blocks an SM.
// 3. ssd_state_passing_kernel, a block per (1024 elements of P*N, h, b):
//    prev[c] = run; run = exp(a_cum_c[L-1]) run + states[c], in f32, over
//    the chunks in order; prev goes out in bf16 (B, nc, H, P, N), the last
//    run as the final state in f32. A thread carries a float4.
// 4. ssd_chunk_scan_kernel, a block per (h, 64-row query tile, chunk, b),
//    longest tiles first, h fastest: y = exp(a_cum_i) C prev^T (skipped in
//    chunk 0) + the sum over the key tiles at or left of the diagonal of
//    (cb o tril(exp(a_cum_i - a_cum_j))) X; on the diagonal tile a warp
//    stops at its own last row. 128 threads, 4 warps of 16 rows x P; the C
//    rows and prev in one cp.async group, the x rows of the key tiles
//    through a 2-stage ring; 54272 B of shared memory, 4 blocks an SM. cb
//    comes from L2 straight into the registers that build the scores' A
//    fragments (keys permuted inside each k-step so a thread's four keys
//    are one float4); the decay is 2^x on the MUFU with a_cum pre-scaled
//    by log2(e); y leaves through shared memory in 16-byte row chunks.
//
// What bounds it on this card: at mamba2-780m's prefill (B=4, S=4096, H=48,
// P=64, G=1, N=128, L=256) the function reads x, a_log, B, C and writes y
// and the final state once: 219 MB, 0.065 ms at 3.35 TB/s. Its least work
// (C B^T once per group and the scores' X product over the causal pairs
// only, C prev^T and X^T B) is ~39 GFLOP, 0.040 ms at 989 TFLOP/s; so the
// function is bound by bytes. (The TPU kernel's count, ~103 GFLOP, redoes
// C B^T for every head over full L x L tiles.) This design does ~52 GFLOP
// (the state product split in two, whole 64x64 diagonal tiles) and moves
// more than the function must: x is read twice (100.7 MB each), the f32
// chunk states (100.7 MB) are written once and read once, prev (50.3 MB)
// written and read, y (100.7 MB) written, plus cb, a_cum, B and C: ~0.66
// GB, ~0.20 ms at 3.35 TB/s. Inside the SMs the heads re-read cb (f32), B,
// C and x from L2, ~1.6 GB in all, and mma.sync reaches about half the
// card's bf16 peak.
//
// float32 keeps the first design below, on the CUDA cores (the tensor cores
// would round to TF32): one block of 256 threads per (b, h) loops over the
// chunks with the (P, N) state in shared memory (n-major, 32 KB), 64-row
// query tiles meeting only the 64-key tiles at or left of the diagonal,
// the state update accumulated in registers by the tile that holds the
// chunk's last row. Its grid is B*H blocks of ~131 KB shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LMAX = 256;  // longest chunk
constexpr int PMAX = 64;   // largest head dim P
constexpr int NMAX = 128;  // largest state size N

// ---------------------------------------------------------------------------
// float32: one block per (b, h) over the chunks, on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int NT = 256;    // threads per block
constexpr int TQ = 64;     // query rows per tile
constexpr int TK = 64;     // key rows per tile

// shared memory, in floats
constexpr int SM_ACUM = 0;                    // [LMAX] a_cum
constexpr int SM_EAC = SM_ACUM + LMAX;        // [LMAX] exp(a_cum)
constexpr int SM_WDEC = SM_EAC + LMAX;        // [LMAX] exp(a_cum[L-1] - a_cum)
constexpr int SM_ST = SM_WDEC + LMAX;         // [NMAX][PMAX] state, n-major
constexpr int SM_CT = SM_ST + NMAX * PMAX;    // [NMAX][TQ] C tile, n-major
constexpr int SM_BT = SM_CT + NMAX * TQ;      // [NMAX][TK] B tile, n-major
constexpr int SM_XT = SM_BT + NMAX * TK;      // [TK][PMAX] X tile
constexpr int SM_SC = SM_XT + TK * PMAX;      // [TK][TQ] masked, decayed scores
constexpr int SM_FLOATS = SM_SC + TK * TQ;
constexpr size_t SMEM_BYTES = sizeof(float) * SM_FLOATS;
static_assert(TQ == TK, "load_bc_tile stages C and B tiles alike");

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// rows [row0, row0 + TQ) of a (B,S,G,N) operand, transposed into dst[n][row]
// (zeros past the chunk's end); 8 elements a thread per step, rows fastest
template <typename T>
__device__ __forceinline__ void load_bc_tile(const T* src, float* dst, int rows, int N,
                                             size_t row_stride) {
  for (int i = threadIdx.x; i < TQ * (N / 8); i += NT) {
    const int r = i % TQ, n8 = (i / TQ) * 8;
    float v[8];
    if (r < rows) {
      load8(src + size_t(r) * row_stride + n8, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(n8 + e) * TQ + r] = v[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ a_log, const T* __restrict__ bm,
           const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ state_out, int S,
           int H, int P, int G, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  float* acum = smem + SM_ACUM;
  float* eac = smem + SM_EAC;
  float* wdec = smem + SM_WDEC;
  float* st = smem + SM_ST;
  float* ct = smem + SM_CT;
  float* bt = smem + SM_BT;
  float* xt = smem + SM_XT;
  float* sc = smem + SM_SC;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int r = tid / 16, q = tid % 16;   // 4 rows (or N/16 states) x P/16 cols each
  const int PT = P / 16, NTn = N / 16;
  const size_t x_row = size_t(H) * P, bc_row = size_t(G) * N;

  for (int i = tid; i < NMAX * PMAX; i += NT) st[i] = 0.f;

  float sacc[8][4];   // this thread's slice of the chunk's state update
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) sacc[nn][pp] = 0.f;

  for (int s0 = 0; s0 < S; s0 += L) {
    __syncthreads();   // the previous chunk's state is written
    // a_cum by a warp scan: each lane sums 8 consecutive steps
    if (tid < 32) {
      float v[8], run = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int t = tid * 8 + e;
        run += t < L ? a_log[(size_t(b) * S + s0 + t) * H + h] : 0.f;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acum[tid * 8 + e] = v[e] + excl;
    }
    __syncthreads();
    const float a_last = acum[L - 1];
    for (int t = tid; t < LMAX; t += NT) {
      eac[t] = t < L ? expf(acum[t]) : 0.f;
      wdec[t] = t < L ? expf(a_last - acum[t]) : 0.f;
    }

    for (int q0 = 0; q0 < L; q0 += TQ) {
      const int nq = min(TQ, L - q0);
      const bool last_tile = q0 + TQ >= L;
      __syncthreads();   // ct, bt, xt, sc free; eac / wdec written
      load_bc_tile(cm + (size_t(b) * S + s0 + q0) * bc_row + size_t(g) * N, ct, nq, N, bc_row);
      __syncthreads();

      // inter-chunk part: exp(a_cum_i) * C_i . state_p
      float acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) acc[ii][pp] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 c4 = *reinterpret_cast<const float4*>(&ct[n * TQ + r * 4]);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (pp < PT) {
            const float s = st[n * PMAX + q * PT + pp];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) acc[ii][pp] = fmaf(cv[ii], s, acc[ii][pp]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float e = eac[q0 + r * 4 + ii];   // 0 past the chunk's end
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) acc[ii][pp] *= e;
      }

      // intra-chunk part over the key tiles at or left of the diagonal
      for (int k0 = 0; k0 <= q0; k0 += TK) {
        const int nk = min(TK, L - k0);
        __syncthreads();   // bt, xt, sc free
        load_bc_tile(bm + (size_t(b) * S + s0 + k0) * bc_row + size_t(g) * N, bt, nk, N,
                     bc_row);
        for (int i = tid; i < TK * (P / 8); i += NT) {
          const int j = i / (P / 8), p8 = (i % (P / 8)) * 8;
          float v[8];
          if (j < nk) {
            load8(x + (size_t(b) * S + s0 + k0 + j) * x_row + size_t(h) * P + p8, v);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = 0.f;
          }
          *reinterpret_cast<float4*>(&xt[j * PMAX + p8]) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(&xt[j * PMAX + p8 + 4]) =
              make_float4(v[4], v[5], v[6], v[7]);
        }
        __syncthreads();

        // scores C_i . B_j for rows r*4.., keys q*4..
        float s[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 c4 = *reinterpret_cast<const float4*>(&ct[n * TQ + r * 4]);
          const float4 b4 = *reinterpret_cast<const float4*>(&bt[n * TK + q * 4]);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) s[ii][jj] = fmaf(cv[ii], bv[jj], s[ii][jj]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int jl = q * 4 + jj, j = k0 + jl;
          float out[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int i = q0 + r * 4 + ii;
            out[ii] = (j <= i && i < L) ? s[ii][jj] * expf(acum[i] - acum[j]) : 0.f;
          }
          *reinterpret_cast<float4*>(&sc[jl * TQ + r * 4]) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
        __syncthreads();

        // Y += S X over this key tile
#pragma unroll 8
        for (int j = 0; j < TK; ++j) {
          const float4 s4 = *reinterpret_cast<const float4*>(&sc[j * TQ + r * 4]);
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            if (pp < PT) {
              const float xv = xt[j * PMAX + q * PT + pp];
#pragma unroll
              for (int ii = 0; ii < 4; ++ii) acc[ii][pp] = fmaf(sv[ii], xv, acc[ii][pp]);
            }
          }
        }

        // the last query tile meets every key tile: accumulate the state update
        if (last_tile) {
#pragma unroll 4
          for (int j = 0; j < nk; ++j) {
            const float w = wdec[k0 + j];
            float xv[4];
#pragma unroll
            for (int pp = 0; pp < 4; ++pp) xv[pp] = pp < PT ? xt[j * PMAX + q * PT + pp] * w : 0.f;
#pragma unroll
            for (int nn = 0; nn < 8; ++nn) {
              if (nn < NTn) {
                const float bv = bt[(r * NTn + nn) * TK + j];
#pragma unroll
                for (int pp = 0; pp < 4; ++pp) sacc[nn][pp] = fmaf(xv[pp], bv, sacc[nn][pp]);
              }
            }
          }
        }
      }

#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = r * 4 + ii;
        if (i < nq) {
          T* yr = y + (size_t(b) * S + s0 + q0 + i) * x_row + size_t(h) * P + q * PT;
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
            if (pp < PT) yr[pp] = from_f32<T>(acc[ii][pp]);
        }
      }
    }

    // every row of the chunk has read the old state: rewrite it
    __syncthreads();
    const float chunk_decay = expf(a_last);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      if (nn < NTn) {
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (pp < PT) {
            float* sp = &st[(r * NTn + nn) * PMAX + q * PT + pp];
            *sp = chunk_decay * *sp + sacc[nn][pp];
          }
          sacc[nn][pp] = 0.f;
        }
      }
    }
  }

  __syncthreads();
  float* so = state_out + (size_t(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += NT) {
    const int p = i / N, n = i % N;
    so[i] = st[n * PMAX + p];
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the chunk-parallel stages on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;          // rows of a cb / chunk_scan tile, rows of a load group
constexpr int RS_N = NMAX + 8;    // padded bf16 row of an (.., N) tile
constexpr int RS_P = PMAX + 8;    // padded bf16 row of an (.., P) tile

constexpr int CB_THREADS = 128;
constexpr size_t CB_SMEM = size_t(2) * TILE * RS_N * 2;                 // C tile, B tile

constexpr int CS_THREADS = 256;
constexpr int CS_BLOCKS = 3;                                            // blocks an SM
constexpr size_t CS_SLAB = size_t(TILE) * (RS_P + RS_N) * 2;            // 64 rows of x, of B
constexpr size_t CS_W = 2 * CS_SLAB;                                    // after a 2-slab ring
constexpr size_t CS_SMEM = CS_W + size_t(LMAX) * 4;                     // [LMAX] f32 w

constexpr int SP_THREADS = 256;
constexpr int SP_SLICE = SP_THREADS * 4;                                // a float4 a thread

constexpr int SC_THREADS = 128;
constexpr int SC_BLOCKS = 4;                                            // blocks an SM
constexpr size_t SC_C = 0;                                              // [TILE][RS_N] C rows
constexpr size_t SC_PV = SC_C + size_t(TILE) * RS_N * 2;                // [PMAX][RS_N] prev
constexpr size_t SC_X = SC_PV + size_t(PMAX) * RS_N * 2;                // [2][TILE][RS_P] x ring
constexpr size_t SC_A = SC_X + size_t(2) * TILE * RS_P * 2;             // [LMAX] f32 a_cum
constexpr size_t SC_SMEM = SC_A + size_t(LMAX) * 4;

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the MUFU (ex2.approx, ~2^-22 relative): the scores it feeds are
// rounded to bf16 (2^-9) before their product
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the first in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) * (w0, w1) = hi + lo, each bf16x2, to ~2^-17 of the product
__device__ __forceinline__ void split_scaled(uint32_t xv, float2 w, uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
  const float p0 = f.x * w.x, p1 = f.y * w.y;
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - hf.x, p1 - hf.y);
}

// ldmatrix row addresses (lane -> row, column offset) for the fragments of
// m16n8k16: "qa" gives matrices (rows 0-7, +0), (rows 8-15, +0), (rows 0-7,
// +8), (rows 8-15, +8): an A operand stored row-major, or, with .trans, a
// B operand stored k-major as two n-tiles. "kb" gives (rows 0-7, +0),
// (rows 0-7, +8), (rows 8-15, +0), (rows 8-15, +8): a B operand stored
// n-major as two n-tiles, or, with .trans, an A operand stored k-major.
struct Lanes {
  int qa_row, qa_col, kb_row, kb_col, g4, t2;
  __device__ explicit Lanes(int lane)
      : qa_row((lane & 7) + ((lane >> 3) & 1) * 8), qa_col((lane >> 4) * 8),
        kb_row((lane & 7) + (lane >> 4) * 8), kb_col(((lane >> 3) & 1) * 8),
        g4(lane >> 2), t2((lane & 3) * 2) {}
};

// Stage 1. cb[b, c, g, i, j] = sum_n C[i, n] B[j, n] for the 64x64 tiles
// (qt, kt), kt <= qt, of each chunk; grid (ntri * nc * G, B).
__global__ void __launch_bounds__(CB_THREADS)
ssd_cb_kernel(const bf16* __restrict__ bm, const bf16* __restrict__ cm, float* __restrict__ cb,
              int S, int G, int N, int L, int LP, int nc) {
  extern __shared__ __align__(128) unsigned char smem_cb[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_cb);
  bf16* Bs = Cs + TILE * RS_N;
  const int ntri = (LP / TILE) * (LP / TILE + 1) / 2;
  const int tri = blockIdx.x % ntri, cg = blockIdx.x / ntri;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= tri) ++qt;
  const int kt = tri - qt * (qt + 1) / 2;
  const int c = cg / G, g = cg % G, b = blockIdx.y;
  const int i0 = qt * TILE, j0 = kt * TILE;
  const size_t row = size_t(G) * N;
  const size_t s0 = size_t(b) * S + size_t(c) * L;
  const bf16* cbase = cm + s0 * row + size_t(g) * N;
  const bf16* bbase = bm + s0 * row + size_t(g) * N;
  const int n8 = N / 8;
  for (int i = threadIdx.x; i < TILE * n8; i += CB_THREADS) {
    const int r = i / n8, col = (i % n8) * 8;
    const bool qin = i0 + r < L, kin = j0 + r < L;
    cp_async16(smem_u32(Cs + r * RS_N + col), cbase + size_t(qin ? i0 + r : 0) * row + col, qin);
    cp_async16(smem_u32(Bs + r * RS_N + col), bbase + size_t(kin ? j0 + r : 0) * row + col, kin);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const Lanes ln(threadIdx.x & 31);
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(smem_u32(Cs + (warp * 16 + ln.qa_row) * RS_N + kk * 16 + ln.qa_col), a[0], a[1],
            a[2], a[3]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(smem_u32(Bs + (np * 16 + ln.kb_row) * RS_N + kk * 16 + ln.kb_col), b0, b1, b2, b3);
      mma16816(acc[2 * np], a, b0, b1);
      mma16816(acc[2 * np + 1], a, b2, b3);
    }
  }
  float* out = cb + ((size_t(b) * nc + c) * G + g) * size_t(LP) * LP;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = i0 + warp * 16 + ln.g4 + 8 * hh, col = j0 + n * 8 + ln.t2;
      *reinterpret_cast<float2*>(out + size_t(r) * LP + col) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
}

// Stage 2. a_cum[b, h, c, :] and states[b, c, h] = (X * w)^T B; grid (H * nc, B).
__global__ void __launch_bounds__(CS_THREADS, CS_BLOCKS)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ a_log,
                       const bf16* __restrict__ bm, float* __restrict__ states,
                       float* __restrict__ a_cum, int S, int H, int P, int G, int N, int L,
                       int nc) {
  extern __shared__ __align__(128) unsigned char smem_cs[];
  float* ws = reinterpret_cast<float*>(smem_cs + CS_W);
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t s0 = size_t(b) * S + size_t(c) * L;
  const int nq = (L + TILE - 1) / TILE;

  // slab q (rows 64q.. of x and B) into ring stage q % 2, one commit group each
  auto issue = [&](int q) {
    if (q < nq) {
      const size_t x_row = size_t(H) * P, bc_row = size_t(G) * N;
      const bf16* xb = x + s0 * x_row + size_t(h) * P;
      const bf16* bb = bm + s0 * bc_row + size_t(g) * N;
      const int Lr = (L + 15) / 16 * 16;    // rows the products read; zeros past L
      bf16* Xs = reinterpret_cast<bf16*>(smem_cs + (q & 1) * CS_SLAB);
      bf16* Bs = Xs + TILE * RS_P;
      // a row is 8 chunks of 16 bytes of x (P <= 64), then 16 of B (N <= 128)
      for (int i = tid; i < TILE * 24; i += CS_THREADS) {
        const int r = i / 24, k = i % 24, l = q * TILE + r;
        const bool is_x = k < 8;
        const int col = (is_x ? k : k - 8) * 8;
        if (l < Lr && col < (is_x ? P : N)) {
          const bool in = l < L;
          const size_t lr = in ? l : 0;
          if (is_x)
            cp_async16(smem_u32(Xs + r * RS_P + col), xb + lr * x_row + col, in);
          else
            cp_async16(smem_u32(Bs + r * RS_N + col), bb + lr * bc_row + col, in);
        }
      }
    }
    cp_commit();
  };
  issue(0);
  issue(1);

  // a_cum by a warp scan (each lane sums 8 consecutive steps), then w
  if (warp == 0) {
    float v[8], run = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int t = lane * 8 + e;
      run += t < L ? a_log[(s0 + t) * H + h] : 0.f;
      v[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    float* ac = a_cum + ((size_t(b) * H + h) * nc + c) * L;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int t = lane * 8 + e;
      v[e] += excl;
      ws[t] = v[e];
      if (t < L) ac[t] = v[e];
    }
    __syncwarp();
    const float a_last = ws[L - 1];
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int t = lane * 8 + e;
      ws[t] = t < L ? expf(a_last - v[e]) : 0.f;
    }
  }

  const int wp = warp & 3, wn = warp >> 2;     // 16 p-rows, 64 n-columns
  const bool active = wp * 16 < P && wn * 64 < N;
  const Lanes ln(lane);
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int q = 0; q < nq; ++q) {
    cp_wait<1>();
    __syncthreads();               // slab q has landed for every thread; ws is written
    if (active) {
      const bf16* Xs = reinterpret_cast<const bf16*>(smem_cs + (q & 1) * CS_SLAB);
      const bf16* Bs = Xs + TILE * RS_P;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k0 = kk * 16;
        if (q * TILE + k0 < L) {
          uint32_t xv[4], hi[4], lo[4];
          ldsm_x4_t(smem_u32(Xs + (k0 + ln.kb_row) * RS_P + wp * 16 + ln.kb_col), xv[0], xv[1],
                    xv[2], xv[3]);
          const float* w = ws + q * TILE + k0 + ln.t2;
          const float2 w01 = *reinterpret_cast<const float2*>(w);
          const float2 w89 = *reinterpret_cast<const float2*>(w + 8);
          split_scaled(xv[0], w01, hi[0], lo[0]);
          split_scaled(xv[1], w01, hi[1], lo[1]);
          split_scaled(xv[2], w89, hi[2], lo[2]);
          split_scaled(xv[3], w89, hi[3], lo[3]);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (wn * 64 + np * 16 < N) {
              uint32_t b0, b1, b2, b3;
              ldsm_x4_t(smem_u32(Bs + (k0 + ln.qa_row) * RS_N + wn * 64 + np * 16 + ln.qa_col),
                        b0, b1, b2, b3);
              mma16816(acc[2 * np], hi, b0, b1);
              mma16816(acc[2 * np], lo, b0, b1);
              mma16816(acc[2 * np + 1], hi, b2, b3);
              mma16816(acc[2 * np + 1], lo, b2, b3);
            }
          }
        }
      }
    }
    __syncthreads();               // every warp is done with ring stage q % 2
    issue(q + 2);
  }
  cp_wait<0>();
  if (!active) return;
  float* out = states + ((size_t(b) * nc + c) * H + h) * size_t(P) * N;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = wn * 64 + n * 8 + ln.t2;
    if (col < N) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = wp * 16 + ln.g4 + 8 * hh;
        *reinterpret_cast<float2*>(out + size_t(p) * N + col) =
            make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
      }
    }
  }
}

// Stage 3. prev[b, c, h] = the state entering chunk c (bf16), final = the
// state after the last chunk (f32); grid (ceil(P*N / 1024), H, B).
__global__ void __launch_bounds__(SP_THREADS)
ssd_state_passing_kernel(const float* __restrict__ states, const float* __restrict__ a_cum,
                         bf16* __restrict__ prev, float* __restrict__ final_state, int H, int PN,
                         int nc, int L) {
  const int i = blockIdx.x * SP_SLICE + threadIdx.x * 4;
  const int h = blockIdx.y, b = blockIdx.z;
  if (i >= PN) return;
  const float* ac = a_cum + (size_t(b) * H + h) * nc * size_t(L) + (L - 1);
  const size_t stride = size_t(H) * PN;                     // one chunk
  const size_t base = (size_t(b) * nc * H + h) * PN + i;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 cur = *reinterpret_cast<const float4*>(states + base);
  for (int c = 0; c < nc; ++c) {
    const size_t at = base + size_t(c) * stride;
    const float4 nxt = c + 1 < nc ? *reinterpret_cast<const float4*>(states + at + stride)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    const float d = expf(ac[size_t(c) * L]);
    *reinterpret_cast<uint2*>(prev + at) = make_uint2(pack_bf16(run.x, run.y),
                                                      pack_bf16(run.z, run.w));
    run.x = d * run.x + cur.x;
    run.y = d * run.y + cur.y;
    run.z = d * run.z + cur.z;
    run.w = d * run.w + cur.w;
    cur = nxt;
  }
  *reinterpret_cast<float4*>(final_state + (size_t(b) * H + h) * PN + i) = run;
}

// Stage 4. y for one 64-row query tile of one (b, chunk, h); grid (H * nt * nc, B).
__global__ void __launch_bounds__(SC_THREADS, SC_BLOCKS)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ a_cum,
                      const bf16* __restrict__ cm, const float* __restrict__ cb,
                      const bf16* __restrict__ prev, bf16* __restrict__ y, int S, int H, int P,
                      int G, int N, int L, int LP, int nc) {
  extern __shared__ __align__(128) unsigned char smem_sc[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_sc + SC_C);
  bf16* Ps = reinterpret_cast<bf16*>(smem_sc + SC_PV);
  float* As = reinterpret_cast<float*>(smem_sc + SC_A);
  const int nt = LP / TILE;
  const int h = blockIdx.x % H, rest = blockIdx.x / H;
  const int qt = nt - 1 - rest % nt, c = rest / nt, b = blockIdx.y;
  const int g = h / (H / G);
  const int i0 = qt * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t x_row = size_t(H) * P, bc_row = size_t(G) * N;
  const size_t s0 = size_t(b) * S + size_t(c) * L;
  const bf16* cbase = cm + s0 * bc_row + size_t(g) * N;
  const bf16* xbase = x + s0 * x_row + size_t(h) * P;
  const bf16* pbase = prev + ((size_t(b) * nc + c) * H + h) * size_t(P) * N;
  const float* cbm = cb + ((size_t(b) * nc + c) * G + g) * size_t(LP) * LP;
  const bool inter = c > 0;     // the state entering chunk 0 is zero

  // group 0: the tile's C rows and prev; then the x rows of key tile kt, one
  // group each, into ring stage kt % 2
  for (int i = tid; i < TILE * 16; i += SC_THREADS) {      // 16 chunks of 16 bytes a row
    const int r = i >> 4, col = (i & 15) * 8;
    const bool in = i0 + r < L;
    if (col < N)
      cp_async16(smem_u32(Cs + r * RS_N + col), cbase + size_t(in ? i0 + r : 0) * bc_row + col,
                 in);
    if (inter && r < P && col < N)
      cp_async16(smem_u32(Ps + r * RS_N + col), pbase + size_t(r) * N + col, true);
  }
  cp_commit();
  auto issue_x = [&](int kt) {
    if (kt <= qt) {
      bf16* Xs = reinterpret_cast<bf16*>(smem_sc + SC_X) + (kt & 1) * TILE * RS_P;
      for (int i = tid; i < TILE * 8; i += SC_THREADS) {     // 8 chunks of 16 bytes a row
        const int r = i >> 3, col = (i & 7) * 8, l = kt * TILE + r;
        const bool in = l < L;
        if (col < P)
          cp_async16(smem_u32(Xs + r * RS_P + col), xbase + size_t(in ? l : 0) * x_row + col,
                     in);
      }
    }
    cp_commit();
  };
  issue_x(0);
  issue_x(1);
  const float* ac = a_cum + ((size_t(b) * H + h) * nc + c) * L;
  for (int t = tid; t < LMAX; t += SC_THREADS) As[t] = t < L ? ac[t] * LOG2E : 0.f;

  const Lanes ln(lane);
  const int r0 = i0 + warp * 16 + ln.g4, r1 = r0 + 8;      // this thread's rows
  const int np_n = P / 16;

  // Inside each 16-key k-step the keys are permuted so that this thread's
  // A-fragment slots (2t, 2t+1, 2t+8, 2t+9) hold keys 4t..4t+3: its cb and
  // a_cum entries are one float4 each, and the x rows go to ldmatrix in the
  // same order (a product sums over k in any order).
  const int t4 = 2 * ln.t2;
  const int x_row_perm = 4 * ((lane & 7) >> 1) + (lane & 1) + 2 * ((lane >> 3) & 1);
  float4 cbv[4][2];     // key tile kt: rows r0, r1; keys 64 kt + 16 kk + 4t + {0..3}
  auto load_cb = [&](int kt) {
    const int kk_end = kt == qt ? warp + 1 : 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        cbv[kk][hh] = kk < kk_end ? __ldg(reinterpret_cast<const float4*>(
                                        cbm + size_t(hh ? r1 : r0) * LP + kt * TILE + kk * 16 + t4))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  cp_wait<2>();
  __syncthreads();                 // C, prev and As are in shared memory
  if (inter) {
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(smem_u32(Cs + (warp * 16 + ln.qa_row) * RS_N + kk * 16 + ln.qa_col), a[0], a[1],
              a[2], a[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np < np_n) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_u32(Ps + (np * 16 + ln.kb_row) * RS_N + kk * 16 + ln.kb_col), b0, b1, b2,
                  b3);
          mma16816(acc[2 * np], a, b0, b1);
          mma16816(acc[2 * np + 1], a, b2, b3);
        }
      }
    }
    const float e0 = fast_exp2(As[r0]), e1 = fast_exp2(As[r1]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= e0;
      acc[n][1] *= e0;
      acc[n][2] *= e1;
      acc[n][3] *= e1;
    }
  }

  const float ar[2] = {As[r0], As[r1]};
  const bool rv[2] = {r0 < L, r1 < L};
  for (int kt = 0; kt <= qt; ++kt) {
    load_cb(kt);
    cp_wait<1>();
    __syncthreads();               // the x rows of key tile kt have landed
    const bf16* Xs = reinterpret_cast<const bf16*>(smem_sc + SC_X) + (kt & 1) * TILE * RS_P;
    const int kk_end = kt == qt ? warp + 1 : 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < kk_end) {
        const int j = kt * TILE + kk * 16 + t4;            // keys j..j+3
        const float4 aj = *reinterpret_cast<const float4*>(As + j);
        const float ak[4] = {aj.x, aj.y, aj.z, aj.w};
        float s[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = hh ? r1 : r0;
          const float v[4] = {cbv[kk][hh].x, cbv[kk][hh].y, cbv[kk][hh].z, cbv[kk][hh].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)   // below the diagonal tile every key is <= r
            s[hh][e] = ((kt < qt || j + e <= r) && rv[hh])
                           ? v[e] * fast_exp2(ar[hh] - ak[e]) : 0.f;
        }
        const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[1][0], s[1][1]),
                               pack_bf16(s[0][2], s[0][3]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np < np_n) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(smem_u32(Xs + (kk * 16 + x_row_perm) * RS_P + np * 16 + ln.qa_col), b0, b1,
                      b2, b3);
            mma16816(acc[2 * np], a, b0, b1);
            mma16816(acc[2 * np + 1], a, b2, b3);
          }
        }
      }
    }
    __syncthreads();               // every warp is done with ring stage kt % 2
    issue_x(kt + 2);
  }
  cp_wait<0>();

  // y through shared memory (the C rows' space, free since the last barrier)
  // so that each row leaves as whole 16-byte chunks; a warp stages its own rows
  bf16* Ys = Cs + warp * 16 * RS_P;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (n < 2 * np_n)
        *reinterpret_cast<uint32_t*>(Ys + (ln.g4 + 8 * hh) * RS_P + n * 8 + ln.t2) =
            pack_bf16(acc[n][2 * hh], acc[n][2 * hh + 1]);
  __syncwarp();
  bf16* yb = y + (s0 + i0 + warp * 16) * x_row + size_t(h) * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = lane + 32 * i, rr = q >> 3, col = (q & 7) * 8;
    if (col < P && i0 + warp * 16 + rr < L)
      *reinterpret_cast<uint4*>(yb + size_t(rr) * x_row + col) =
          *reinterpret_cast<const uint4*>(Ys + rr * RS_P + col);
  }
}

bool bad_shape(int B, int S, int H, int P, int G, int N, int L) {
  return B <= 0 || H <= 0 || P % 16 || P <= 0 || P > PMAX || N % 16 || N <= 0 || N > NMAX ||
         G <= 0 || H % G || L <= 0 || L > LMAX || S <= 0 || S % L;
}

int round_up_tile(int L) { return (L + TILE - 1) / TILE * TILE; }

}  // namespace

extern "C" {

// float32 (the first design): x/y (B,S,H,P), a_log (B,S,H), b/c (B,S,G,N), state
// (B,H,P,N), all float32, contiguous and 16-byte aligned. P and N multiples of
// 16 up to 64 and 128, H % G == 0, 1 <= chunk <= 256 dividing S. Every entry
// point returns a cudaError_t.
int ssd_scan_f32_fwd(const void* x, const void* a_log, const void* b, const void* c, void* y,
                     void* state, int B, int S, int H, int P, int G, int N, int chunk,
                     void* stream) {
  if (bad_shape(B, S, H, P, G, N, chunk)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  ssd_kernel<float><<<dim3(H, B), NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a_log),
      static_cast<const float*>(b), static_cast<const float*>(c), static_cast<float*>(y),
      static_cast<float*>(state), S, H, P, G, N, chunk);
  return int(cudaGetLastError());
}

// bfloat16 stage 1: b, c (B,S,G,N) bf16 -> cb (B, S/L, G, LP, LP) f32, LP = L
// rounded up to 64; only the 64x64 tiles at or below the diagonal are written.
int ssd_cb_fwd(const void* b, const void* c, void* cb, int B, int S, int G, int N, int L,
               void* stream) {
  if (bad_shape(B, S, G, 16, G, N, L)) return int(cudaErrorInvalidValue);
  const int LP = round_up_tile(L), nt = LP / TILE, nc = S / L;
  const dim3 grid(unsigned(nt * (nt + 1) / 2) * nc * G, B);
  ssd_cb_kernel<<<grid, CB_THREADS, CB_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(b), static_cast<const bf16*>(c), static_cast<float*>(cb), S, G,
      N, L, LP, nc);
  return int(cudaGetLastError());
}

// bfloat16 stage 2: x (B,S,H,P) bf16, a_log (B,S,H) f32, b (B,S,G,N) bf16 ->
// states (B, S/L, H, P, N) f32 and a_cum (B, H, S/L, L) f32.
int ssd_chunk_state_fwd(const void* x, const void* a_log, const void* b, void* states,
                        void* a_cum, int B, int S, int H, int P, int G, int N, int L,
                        void* stream) {
  if (bad_shape(B, S, H, P, G, N, L)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(CS_SMEM));
  if (err != cudaSuccess) return int(err);
  const int nc = S / L;
  ssd_chunk_state_kernel<<<dim3(unsigned(H) * nc, B), CS_THREADS, CS_SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a_log),
      static_cast<const bf16*>(b), static_cast<float*>(states), static_cast<float*>(a_cum), S,
      H, P, G, N, L, nc);
  return int(cudaGetLastError());
}

// bfloat16 stage 3: states (B,nc,H,P,N) f32, a_cum (B,H,nc,L) f32 -> prev
// (B,nc,H,P,N) bf16 (the state entering each chunk) and the final state
// (B,H,P,N) f32.
int ssd_state_passing_fwd(const void* states, const void* a_cum, void* prev, void* final_state,
                          int B, int nc, int H, int P, int N, int L, void* stream) {
  if (bad_shape(B, nc * L, H, P, 1, N, L)) return int(cudaErrorInvalidValue);
  const int PN = P * N;
  const dim3 grid((PN + SP_SLICE - 1) / SP_SLICE, H, B);
  ssd_state_passing_kernel<<<grid, SP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(states), static_cast<const float*>(a_cum),
      static_cast<bf16*>(prev), static_cast<float*>(final_state), H, PN, nc, L);
  return int(cudaGetLastError());
}

// bfloat16 stage 4: x (B,S,H,P) bf16, a_cum (B,H,nc,L) f32, c (B,S,G,N) bf16,
// cb (B,nc,G,LP,LP) f32, prev (B,nc,H,P,N) bf16 -> y (B,S,H,P) bf16.
int ssd_chunk_scan_fwd(const void* x, const void* a_cum, const void* c, const void* cb,
                       const void* prev, void* y, int B, int S, int H, int P, int G, int N,
                       int L, void* stream) {
  if (bad_shape(B, S, H, P, G, N, L)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SC_SMEM));
  if (err != cudaSuccess) return int(err);
  const int LP = round_up_tile(L), nc = S / L;
  const dim3 grid(unsigned(H) * (LP / TILE) * nc, B);
  ssd_chunk_scan_kernel<<<grid, SC_THREADS, SC_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a_cum),
      static_cast<const bf16*>(c), static_cast<const float*>(cb),
      static_cast<const bf16*>(prev), static_cast<bf16*>(y), S, H, P, G, N, L, LP, nc);
  return int(cudaGetLastError());
}

// dynamic shared memory a block asks for: 0 the float32 kernel, 1 cb,
// 2 chunk_state, 3 state_passing, 4 chunk_scan
int ssd_scan_smem_bytes(int stage) {
  const size_t bytes[5] = {SMEM_BYTES, CB_SMEM, CS_SMEM, 0, SC_SMEM};
  return stage >= 0 && stage < 5 ? int(bytes[stage]) : -1;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

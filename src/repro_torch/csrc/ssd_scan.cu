// Mamba-2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` behind `ssd_scan` in
// src/repro/kernels/ssd_scan.py. Same function: for each (b, h) and each
// chunk of L steps, in order, with a_cum the chunk's cumulative log-decay,
//   y      = (tril(exp(a_cum_i - a_cum_j)) o C B^T) X + exp(a_cum) C state^T
//   state' = exp(a_cum[L-1]) state + (X * exp(a_cum[L-1] - a_cum))^T B
// from a zero state; x (B,S,H,P), a_log (B,S,H) f32, b/c (B,S,G,N) with
// group h / (H/G); y in x's type, the final state (B,H,P,N) in f32. All
// products and sums are f32, whatever the input type.
//
// What bounds it on this card: at mamba2-780m's prefill (B=4, S=4096, H=48,
// P=64, N=128, L=256) the TPU kernel's work is ~103 GFLOP against ~219 MB of
// input and output, so the bound is operations (~0.10 ms at the bf16 tensor
// core rate). This first version runs the products on the CUDA cores in f32
// and sits far above that bound (PERF.md has its time).
//
// Design. The TPU kernel carries the (P,N) f32 state in VMEM along a
// sequential chunk grid axis and builds the whole (L,L) decay matrix per
// chunk (256 KB in f32, more than a block's shared memory). Here one block
// of 256 threads owns one (b, h) and loops over the chunks itself, keeping
// the state in shared memory (n-major, 32 KB). Each chunk is cut into
// 64-row query tiles; each query tile meets only the 64-key tiles at or
// left of the diagonal (the others are fully masked and skipped), as in
// flash attention: S = C_q B_k^T (64x64 over N), masked and decayed in
// registers, staged in shared memory, then Y += S X_k. The query tile that
// holds the chunk's last row meets every key tile, so the state update
// (X * decay)^T B is accumulated in registers alongside it and the state is
// rewritten once per chunk, after every row has read the old one. Each
// thread owns a 4x4 score tile, a 4 x P/16 output tile and an N/16 x P/16
// slice of the state update; the operand tiles sit in shared memory laid
// out so the score and output products read float4s.
//
// With G = 1 the C B^T product is the same for all heads of a (b, chunk);
// like the TPU kernel, this version recomputes it per head. Sharing it
// across heads (one block computes it for several heads, or a
// chunk-state / state-passing split as in arXiv:2405.21060), and moving the
// bf16 products onto the tensor cores, are the first design changes for a
// later version. The grid is B*H blocks (192 at the prefill shape, on 132
// SMs, one block of ~131 KB shared memory per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;    // threads per block
constexpr int TQ = 64;     // query rows per tile
constexpr int TK = 64;     // key rows per tile
constexpr int LMAX = 256;  // longest chunk
constexpr int PMAX = 64;   // largest head dim P
constexpr int NMAX = 128;  // largest state size N

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
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b, const void* c, void* y,
                   void* state, int B, int S, int H, int P, int G, int N, int L,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<dim3(H, B), NT, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), static_cast<float*>(state), S, H, P, G,
      N, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of x, b, c and y: 0 = float32, 1 = bfloat16; a_log and the state are
// float32. x/y (B,S,H,P), a_log (B,S,H), b/c (B,S,G,N), state (B,H,P,N), all
// contiguous and 16-byte aligned. P and N multiples of 16 up to 64 and 128,
// H % G == 0, 1 <= chunk <= 256 dividing S. Returns a cudaError_t.
int ssd_scan_fwd(const void* x, const void* a_log, const void* b, const void* c, void* y,
                 void* state, int B, int S, int H, int P, int G, int N, int chunk, int dtype,
                 void* stream) {
  if (B <= 0 || H <= 0) return int(cudaSuccess);
  if (P % 16 || P <= 0 || P > PMAX || N % 16 || N <= 0 || N > NMAX || G <= 0 || H % G ||
      chunk <= 0 || chunk > LMAX || S <= 0 || S % chunk)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, a_log, b, c, y, state, B, S, H, P, G, N, chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a_log, b, c, y, state, B, S, H, P, G, N, chunk, st);
  return int(cudaErrorInvalidValue);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

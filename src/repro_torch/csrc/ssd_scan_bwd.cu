// The gradient of the Mamba-2 SSD chunked scan for Hopper, sm_90a.
//
// Has no Pallas kernel to replace: the JAX package differentiates
// `ssd_chunked` (src/repro/models/ssm.py:28) through XLA, and the forward's
// TPU kernel `_ssd_kernel` (src/repro/kernels/ssd_scan.py:34) has no
// backward. Same function as kernels/ssd_scan.py `ssd_scan_bwd_ref`: from
// zero state, with the cotangents dy of y (B,S,H,P) and dstate of the
// final state (B,H,P,N) f32 (or none), it returns dx (B,S,H,P) in x's type,
// da_log (B,S,H) f32, and db, dc (B,S,G,N) in b's type, summed over the
// H/G heads of each group. For a chunk of L steps with a_cum its
// cumulative log-decay, lmat_ij = exp(a_cum_i - a_cum_j) for j <= i, prev
// the state entering the chunk and dst the cotangent of the state leaving
// it:
//   dS = dy X^T (o lmat),   dx = (lmat o C B^T)^T dy + w o (B dst^T),
//   dC = dS B + exp(a_cum) o (dy prev),   dB = dS^T C + w o (X dst),
// with w_j = exp(a_cum[L-1] - a_cum_j), and d a_cum from the same terms,
// summed back to da_log by a reverse cumulative sum in the chunk.
//
// Four launches on the caller's stream, in float32 arithmetic on the CUDA
// cores for both input types (bf16 values are widened as they are loaded):
//
// 1. ssd_bwd_state_kernel, a block per (h, chunk, b): a_cum of the chunk,
//    its own state X^T (w o B) and dy's share of the cotangent of prev,
//    (exp(a_cum) o dy)^T C, both (P, N) f32; and, in the first head of each
//    group, the chunk's rows of the f32 db / dc accumulators set to 0.
// 2. ssd_bwd_passing_kernel, a block per (h, b), over the chunks: prev by
//    the forward recurrence, then the reverse one, dst_c = g; g = d_prev_c +
//    exp(a_cum_c[L-1]) g from g = dstate; d(chunk decay) reduced over P*N.
// 3. ssd_bwd_chunk_kernel, a block per (h, chunk, b): the 64-row tiles of
//    the chunk, each key tile J against the query tiles I >= J, C B^T and
//    dy X^T recomputed in registers, masked by lmat through shared memory;
//    dx and dB's share of the tile pair accumulate in registers over I, dC's
//    goes to the f32 accumulator by atomics (as do db's, across heads);
//    d a_cum in shared memory, then da_log.
// 4. ssd_bwd_convert_kernel (bf16 only): db and dc from f32 to bf16.
//
// Every product is a 64-row register tile of 4 x (up to 8) outputs a
// thread, 16 x 16 threads, with rows of shared memory padded by one float
// so that neither operand's reads conflict. ptxas -v (nvcc 12.8, sm_90a):
// the chunk kernel 184 registers and 167680 B of shared memory (one block
// an SM), the state kernel 124 / 126 (f32 / bf16) and 100352 B, the
// passing kernel 48; no spills.
//
// What bounds it on this card: at mamba2-780m's training shape (B=4,
// S=4096, H=48, P=64, G=1, N=128, L=256) in bf16 the function reads x, dy,
// a_log, b and c and writes dx, da_log, db and dc once: 326 MB, 0.097 ms at
// 3.35 TB/s; its least work (C B^T once per group over the causal pairs;
// per head dy X^T, the dx, dC and dB products over the same pairs, and the
// five L x P x N state products) is ~143 GFLOP, 0.144 ms at 989 TFLOP/s:
// bound by operations. This first design is simple and right, not fast: it
// recomputes C B^T for every head, runs every product on the CUDA cores
// (67 TFLOP/s f32 peak), keeps three (P, N) f32 scratch tensors a chunk in
// device memory, and adds dB and dC with atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int LMAX = 256;  // longest chunk
constexpr int PMAX = 64;   // largest head dim P
constexpr int NMAX = 128;  // largest state size N
constexpr int TILE = 64;   // rows of a tile
constexpr int NT = 256;    // threads of a block: 16 x 16
constexpr int EPT = PMAX * NMAX / NT;   // (P, N) elements a thread of the passing kernel

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16(v); }

// TILE rows of D values, row r at src + r * stride, into dst with rows of
// D + 1 floats; rows at or past `valid` are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, size_t stride, int valid,
                                          int D) {
  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r < valid ? ld(src + size_t(r) * stride + d) : 0.f;
  }
}

// acc[r][c] += sum_k a(row, k) b(k, col) for the thread's rows ty + 16 r and
// columns tx + 16 c < ncols
template <int NC, class FA, class FB>
__device__ __forceinline__ void mm(float (&acc)[4][NC], int K, int ncols, FA a, FB b) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < K; ++k) {
    float av[4], bv[NC];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a(ty + 16 * r, k);
#pragma unroll
    for (int c = 0; c < NC; ++c) bv[c] = 16 * c < ncols ? b(k, tx + 16 * c) : 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[4][NC]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
}

// the sum over the 16 threads of a row (tx, within one half warp)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// 1. a_cum, the chunk's own state and dy's share of d prev
// ---------------------------------------------------------------------------
constexpr size_t ST_SMEM =
    sizeof(float) * (LMAX + 2 * size_t(TILE) * (PMAX + 1) + 2 * size_t(TILE) * (NMAX + 1));

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_state_kernel(const T* __restrict__ x, const float* __restrict__ a_log,
                     const T* __restrict__ b, const T* __restrict__ c, const T* __restrict__ dy,
                     float* __restrict__ a_cum, float* __restrict__ states,
                     float* __restrict__ d_prev, float* __restrict__ db32,
                     float* __restrict__ dc32, int S, int H, int P, int G, int N, int L, int nc) {
  extern __shared__ __align__(16) float smem_st[];
  float* acum = smem_st;                       // [LMAX]
  float* xs = acum + LMAX;                     // [TILE][P + 1], x * w
  float* dys = xs + TILE * (PMAX + 1);         // [TILE][P + 1], dy * exp(a_cum)
  float* bs = dys + TILE * (PMAX + 1);         // [TILE][N + 1]
  float* cs = bs + TILE * (NMAX + 1);          // [TILE][N + 1]
  const int h = blockIdx.x, ch = blockIdx.y, bb = blockIdx.z;
  const int g = h / (H / G), t0 = ch * L;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < L; ++i) {
      run += a_log[(size_t(bb) * S + t0 + i) * H + h];
      acum[i] = run;
    }
  }
  if (h % (H / G) == 0) {                      // this group's f32 accumulators, zeroed
    for (int i = tid; i < L * N; i += NT) {
      const size_t o = ((size_t(bb) * S + t0 + i / N) * G + g) * N + i % N;
      db32[o] = 0.f;
      dc32[o] = 0.f;
    }
  }
  __syncthreads();
  float* acum_out = a_cum + ((size_t(bb) * H + h) * nc + ch) * L;
  for (int i = tid; i < L; i += NT) acum_out[i] = acum[i];
  const float last = acum[L - 1];

  float sacc[4][8], dacc[4][8];
  zero(sacc);
  zero(dacc);
  for (int r0 = 0; r0 < L; r0 += TILE) {
    const int valid = min(TILE, L - r0);
    __syncthreads();
    for (int i = tid; i < TILE * P; i += NT) {
      const int r = i / P, p = i % P;
      float xv = 0.f, dv = 0.f;
      if (r < valid) {
        const size_t o = ((size_t(bb) * S + t0 + r0 + r) * H + h) * P + p;
        xv = ld(x + o) * __expf(last - acum[r0 + r]);
        dv = ld(dy + o) * __expf(acum[r0 + r]);
      }
      xs[r * (P + 1) + p] = xv;
      dys[r * (P + 1) + p] = dv;
    }
    const size_t bc0 = ((size_t(bb) * S + t0 + r0) * G + g) * N;
    load_rows(bs, b + bc0, size_t(G) * N, valid, N);
    load_rows(cs, c + bc0, size_t(G) * N, valid, N);
    __syncthreads();
    // states(p, n) += sum_r xs(r, p) bs(r, n); d_prev(p, n) += sum_r dys(r, p) cs(r, n)
    mm(sacc, TILE, N, [&](int p, int r) { return p < P ? xs[r * (P + 1) + p] : 0.f; },
       [&](int r, int n) { return bs[r * (N + 1) + n]; });
    mm(dacc, TILE, N, [&](int p, int r) { return p < P ? dys[r * (P + 1) + p] : 0.f; },
       [&](int r, int n) { return cs[r * (N + 1) + n]; });
  }
  const size_t o = ((size_t(bb) * nc + ch) * H + h) * size_t(P) * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = ty + 16 * r;
    if (p >= P) continue;
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int n = tx + 16 * cc;
      if (n < N) {
        states[o + size_t(p) * N + n] = sacc[r][cc];
        d_prev[o + size_t(p) * N + n] = dacc[r][cc];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the state recurrence forward (prev) and in reverse (d states)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
ssd_bwd_passing_kernel(float* __restrict__ states, const float* __restrict__ a_cum,
                       const float* __restrict__ d_prev, const float* __restrict__ dstate,
                       float* __restrict__ prev, float* __restrict__ d_decay, int H, int PN,
                       int nc, int L) {
  __shared__ float red[NT / 32];
  const int h = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* acum = a_cum + (size_t(bb) * H + h) * nc * L;
  float v[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) v[k] = 0.f;
  for (int ch = 0; ch < nc; ++ch) {            // prev_c = run; run = decay_c run + states_c
    const float decay = __expf(acum[size_t(ch) * L + L - 1]);
    const size_t o = ((size_t(bb) * nc + ch) * H + h) * size_t(PN);
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int e = tid + NT * k;
      if (e < PN) {
        prev[o + e] = v[k];
        v[k] = decay * v[k] + states[o + e];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int e = tid + NT * k;
    v[k] = dstate != nullptr && e < PN ? dstate[(size_t(bb) * H + h) * PN + e] : 0.f;
  }
  for (int ch = nc - 1; ch >= 0; --ch) {       // dst_c = g; g = d_prev_c + decay_c g
    const float decay = __expf(acum[size_t(ch) * L + L - 1]);
    const size_t o = ((size_t(bb) * nc + ch) * H + h) * size_t(PN);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int e = tid + NT * k;
      if (e < PN) {
        s = fmaf(v[k], prev[o + e], s);
        states[o + e] = v[k];
        v[k] = fmaf(decay, v[k], d_prev[o + e]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < NT / 32; ++w) t += red[w];
      d_decay[(size_t(bb) * H + h) * nc + ch] = decay * t;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 3. the chunk's tiles: dx, da_log, and the heads' shares of db and dc
// ---------------------------------------------------------------------------
constexpr int MS = TILE + 1;                   // row of a masked 64 x 64 tile
constexpr size_t CH_SMEM =
    sizeof(float) * (2 * LMAX + size_t(PMAX) * (NMAX + 1) + 2 * size_t(TILE) * (PMAX + 1) +
                     2 * size_t(TILE) * (NMAX + 1) + 2 * size_t(TILE) * MS);

template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ c,
                     const T* __restrict__ dy, const float* __restrict__ a_cum,
                     const float* __restrict__ prev, const float* __restrict__ dst,
                     const float* __restrict__ d_decay, T* __restrict__ dx,
                     float* __restrict__ da, float* __restrict__ db32, float* __restrict__ dc32,
                     int S, int H, int P, int G, int N, int L, int nc) {
  extern __shared__ __align__(16) float smem_ch[];
  float* acum = smem_ch;                       // [LMAX]
  float* dac = acum + LMAX;                    // [LMAX] d a_cum
  float* sts = dac + LMAX;                     // [P][N + 1]: prev, then dst
  float* xs = sts + PMAX * (NMAX + 1);         // [TILE][P + 1] x, key tile J
  float* dys = xs + TILE * (PMAX + 1);         // [TILE][P + 1] dy, query tile I
  float* bs = dys + TILE * (PMAX + 1);         // [TILE][N + 1] B, key tile J
  float* cs = bs + TILE * (NMAX + 1);          // [TILE][N + 1] C, query tile I
  float* cbm = cs + TILE * (NMAX + 1);         // [TILE][MS] lmat o C B^T (i, j)
  float* dsm = cbm + TILE * MS;                // [TILE][MS] lmat o dy X^T (i, j)
  const int h = blockIdx.x, ch = blockIdx.y, bb = blockIdx.z;
  const int g = h / (H / G), t0 = ch * L;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t pn0 = ((size_t(bb) * nc + ch) * H + h) * size_t(P) * N;
  const size_t xrow = size_t(H) * P, brow = size_t(G) * N;
  const T* xc = x + (size_t(bb) * S + t0) * xrow + size_t(h) * P;
  const T* dyc = dy + (size_t(bb) * S + t0) * xrow + size_t(h) * P;
  const T* bc = b + (size_t(bb) * S + t0) * brow + size_t(g) * N;
  const T* ccp = c + (size_t(bb) * S + t0) * brow + size_t(g) * N;
  float* db_c = db32 + (size_t(bb) * S + t0) * brow + size_t(g) * N;
  float* dc_c = dc32 + (size_t(bb) * S + t0) * brow + size_t(g) * N;

  for (int i = tid; i < L; i += NT) {
    acum[i] = a_cum[((size_t(bb) * H + h) * nc + ch) * L + i];
    dac[i] = 0.f;
  }
  for (int i = tid; i < P * N; i += NT) sts[(i / N) * (N + 1) + i % N] = prev[pn0 + i];
  __syncthreads();
  if (tid == 0) dac[L - 1] = d_decay[(size_t(bb) * H + h) * nc + ch];
  const float last = acum[L - 1];

  // dC += exp(a_cum_i) (dy prev)(i, n); d a_cum_i += its dot with C_i
  for (int i0 = 0; i0 < L; i0 += TILE) {
    const int valid = min(TILE, L - i0);
    __syncthreads();
    load_rows(dys, dyc + size_t(i0) * xrow, xrow, valid, P);
    load_rows(cs, ccp + size_t(i0) * brow, brow, valid, N);
    __syncthreads();
    float acc[4][8];
    zero(acc);
    mm(acc, P, N, [&](int i, int p) { return dys[i * (P + 1) + p]; },
       [&](int p, int n) { return sts[p * (N + 1) + n]; });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      const float e = i < valid ? __expf(acum[i0 + i]) : 0.f;
      float part = 0.f;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int n = tx + 16 * cc;
        if (n < N && i < valid) {
          const float v = e * acc[r][cc];
          atomicAdd(dc_c + size_t(i0 + i) * brow + n, v);
          part = fmaf(v, cs[i * (N + 1) + n], part);
        }
      }
      part = row_sum(part);
      if (tx == 0 && i < valid) atomicAdd(&dac[i0 + i], part);
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += NT) sts[(i / N) * (N + 1) + i % N] = dst[pn0 + i];

  for (int j0 = 0; j0 < L; j0 += TILE) {
    const int jvalid = min(TILE, L - j0);
    __syncthreads();
    load_rows(xs, xc + size_t(j0) * xrow, xrow, jvalid, P);
    load_rows(bs, bc + size_t(j0) * brow, brow, jvalid, N);
    __syncthreads();
    // the chunk state's terms: z = B dst^T, dx = w z, dB = w (X dst), d a_cum by w x . z
    float dxa[4][4], dba[4][8];
    zero(dxa);
    zero(dba);
    mm(dxa, N, P, [&](int j, int n) { return bs[j * (N + 1) + n]; },
       [&](int n, int p) { return sts[p * (N + 1) + n]; });
    mm(dba, P, N, [&](int j, int p) { return xs[j * (P + 1) + p]; },
       [&](int p, int n) { return sts[p * (N + 1) + n]; });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      const float w = j < jvalid ? __expf(last - acum[j0 + j]) : 0.f;
      float part = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tx + 16 * cc;
        if (p < P) part = fmaf(xs[j * (P + 1) + p], dxa[r][cc], part);
        dxa[r][cc] *= w;
      }
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) dba[r][cc] *= w;
      part = row_sum(part) * w;
      if (tx == 0 && j < jvalid) {
        atomicAdd(&dac[L - 1], part);
        atomicAdd(&dac[j0 + j], -part);
      }
    }
    for (int i0 = j0; i0 < L; i0 += TILE) {
      const int ivalid = min(TILE, L - i0);
      __syncthreads();
      load_rows(dys, dyc + size_t(i0) * xrow, xrow, ivalid, P);
      load_rows(cs, ccp + size_t(i0) * brow, brow, ivalid, N);
      __syncthreads();
      float cb[4][4], ds[4][4];
      zero(cb);
      zero(ds);
      mm(cb, N, TILE, [&](int i, int n) { return cs[i * (N + 1) + n]; },
         [&](int n, int j) { return bs[j * (N + 1) + n]; });
      mm(ds, P, TILE, [&](int i, int p) { return dys[i * (P + 1) + p]; },
         [&](int p, int j) { return xs[j * (P + 1) + p]; });
      float colp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        float rowp = 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int j = tx + 16 * cc;
          const bool live = i < ivalid && j < jvalid && i0 + i >= j0 + j;
          const float lm = live ? __expf(acum[i0 + i] - acum[j0 + j]) : 0.f;
          const float m = lm * ds[r][cc];
          const float t = m * cb[r][cc];
          cbm[i * MS + j] = lm * cb[r][cc];
          dsm[i * MS + j] = m;
          rowp += t;
          colp[cc] += t;
        }
        rowp = row_sum(rowp);
        if (tx == 0 && i < ivalid) atomicAdd(&dac[i0 + i], rowp);
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = tx + 16 * cc;
        if (j < jvalid) atomicAdd(&dac[j0 + j], -colp[cc]);
      }
      __syncthreads();
      // dx(j, p) += sum_i cbm(i, j) dy(i, p); dB(j, n) += sum_i dsm(i, j) C(i, n)
      mm(dxa, TILE, P, [&](int j, int i) { return cbm[i * MS + j]; },
         [&](int i, int p) { return dys[i * (P + 1) + p]; });
      mm(dba, TILE, N, [&](int j, int i) { return dsm[i * MS + j]; },
         [&](int i, int n) { return cs[i * (N + 1) + n]; });
      // dC(i, n) += sum_j dsm(i, j) B(j, n), added across key tiles and heads
      float dca[4][8];
      zero(dca);
      mm(dca, TILE, N, [&](int i, int j) { return dsm[i * MS + j]; },
         [&](int j, int n) { return bs[j * (N + 1) + n]; });
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= ivalid) continue;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const int n = tx + 16 * cc;
          if (n < N) atomicAdd(dc_c + size_t(i0 + i) * brow + n, dca[r][cc]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      if (j >= jvalid) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tx + 16 * cc;
        if (p < P) st(dx + (size_t(bb) * S + t0 + j0 + j) * xrow + size_t(h) * P + p, dxa[r][cc]);
      }
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int n = tx + 16 * cc;
        if (n < N) atomicAdd(db_c + size_t(j0 + j) * brow + n, dba[r][cc]);
      }
    }
  }
  __syncthreads();
  // da_log: the reverse cumulative sum of d a_cum over the chunk
  for (int i = tid; i < L; i += NT) {
    float s = 0.f;
    for (int k = L - 1; k >= i; --k) s += dac[k];
    da[(size_t(bb) * S + t0 + i) * H + h] = s;
  }
}

// ---------------------------------------------------------------------------
// 4. db, dc to bf16
// ---------------------------------------------------------------------------
__global__ void ssd_bwd_convert_kernel(const float* __restrict__ db32,
                                       const float* __restrict__ dc32, bf16* __restrict__ db,
                                       bf16* __restrict__ dc, size_t n) {
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x) {
    db[i] = __float2bfloat16(db32[i]);
    dc[i] = __float2bfloat16(dc32[i]);
  }
}

bool bad_shape(int B, int S, int H, int P, int G, int N, int L) {
  return B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P % 16 || P > PMAX ||
         N <= 0 || N % 16 || N > NMAX || L <= 0 || L > LMAX || S % L;
}

template <typename T>
cudaError_t launch(const void* x, const void* a_log, const void* b, const void* c,
                   const void* dy, const void* dstate, float* a_cum, float* states, float* prev,
                   float* d_prev, float* d_decay, void* dx, float* da, float* db32, float* dc32,
                   void* db, void* dc, int B, int S, int H, int P, int G, int N, int L,
                   cudaStream_t stream) {
  const int nc = S / L;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(ST_SMEM));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(CH_SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, nc, B);
  ssd_bwd_state_kernel<T><<<grid, NT, ST_SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(dy), a_cum, states, d_prev, db32, dc32,
      S, H, P, G, N, L, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_passing_kernel<<<dim3(H, B), NT, 0, stream>>>(
      states, a_cum, d_prev, static_cast<const float*>(dstate), prev, d_decay, H, P * N, nc, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T><<<grid, NT, CH_SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(dy), a_cum, prev, states, d_decay, static_cast<T*>(dx), da, db32,
      dc32, S, H, P, G, N, L, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (sizeof(T) == 2) {
    const size_t n = size_t(B) * S * G * N;
    const unsigned blocks = unsigned(n / 256 < 4096 ? n / 256 + 1 : 4096);
    ssd_bwd_convert_kernel<<<blocks, 256, 0, stream>>>(db32, dc32, static_cast<bf16*>(db),
                                                        static_cast<bf16*>(dc), n);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, b, c, dy, dx, db, dc). x/dy/dx
// (B,S,H,P), a_log/da (B,S,H) f32, b/c/db/dc (B,S,G,N), dstate (B,H,P,N) f32
// or null for zero; all contiguous. f32 scratch: a_cum (B,H,S/L,L), states,
// prev and d_prev (B,S/L,H,P,N), d_decay (B,H,S/L), db32 and dc32
// (B,S,G,N), which in float32 may be db and dc themselves. P and N multiples
// of 16 up to 64 and 128, H % G == 0, 1 <= chunk <= 256 dividing S. Launches
// the kernels on `stream`; returns a cudaError_t.
int ssd_scan_bwd(const void* x, const void* a_log, const void* b, const void* c, const void* dy,
                 const void* dstate, void* a_cum, void* states, void* prev, void* d_prev,
                 void* d_decay, void* dx, void* da, void* db32, void* dc32, void* db, void* dc,
                 int B, int S, int H, int P, int G, int N, int chunk, int dtype, void* stream) {
  if (bad_shape(B, S, H, P, G, N, chunk) || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st_ = static_cast<cudaStream_t>(stream);
#define BWD_ARGS x, a_log, b, c, dy, dstate, static_cast<float*>(a_cum), \
    static_cast<float*>(states), static_cast<float*>(prev), static_cast<float*>(d_prev), \
    static_cast<float*>(d_decay), dx, static_cast<float*>(da), static_cast<float*>(db32), \
    static_cast<float*>(dc32), db, dc, B, S, H, P, G, N, chunk, st_
  const cudaError_t err = dtype == 0 ? launch<float>(BWD_ARGS) : launch<bf16>(BWD_ARGS);
#undef BWD_ARGS
  return int(err);
}

// dynamic shared memory a block asks for: 0 the state kernel, 1 the chunk kernel
int ssd_scan_bwd_smem_bytes(int kernel) {
  return kernel == 0 ? int(ST_SMEM) : kernel == 1 ? int(CH_SMEM) : -1;
}

const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

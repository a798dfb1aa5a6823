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
//   dcb = sum over the group's heads of (dy X^T) o lmat,
//   dx = (lmat o C B^T)^T dy + w o (B dst^T),
//   dC = dcb B + sum_h exp(a_cum) o (dy prev),   dB = dcb^T C + sum_h w o (X dst),
// with w_j = exp(a_cum[L-1] - a_cum_j), and d a_cum from the same terms,
// summed back to da_log by a reverse cumulative sum in the chunk.
//
// bfloat16: the SSD paper's chunk-parallel decomposition (arXiv:2405.21060,
// sections 6-7) on the tensor cores (mma.sync m16n8k16 bf16 -> f32,
// ldmatrix, cp.async rings, as csrc/ssd_scan.cu's forward), in six launches
// on the caller's stream; every sum in a fixed order (no atomics), so every
// output is bit-reproducible:
//
// 1. ssd_bwd_chunk_state_kernel, a block per (h, chunk, b), h fastest: a_cum
//    by a warp scan, the chunk's state (X * w)^T B and dy's share of d prev,
//    (dy * exp(a_cum))^T C, both (P, N) f32; 8 warps of 16 p-rows x 64
//    n-columns over 64-row slabs of x, dy, B and C in a 2-stage ring.
// 2. ssd_bwd_state_passing_kernel, a block per (1024 elements of P*N, h, b):
//    prev forward from zero, then in reverse dst_c = g, g = d_prev_c +
//    exp(a_cum_c[L-1]) g from dstate, a float4 a thread; prev and dst go out
//    as three bf16 planes each (hi, mid, lo), and the slice's share of
//    <dst_c, prev_{c+1}>, the state's whole share of d a_cum_c[L-1] (the
//    chunk-state terms sum to <dst_c, states_c>).
// 3. ssd_bwd_dcb_kernel, a block per (lower 64x64 tile pair, chunk, group,
//    b), key-major (rows j, columns i): cbT = B_J C_I^T once per group, then
//    over the group's heads (x and dy rows in a 2-stage ring) dcbT += (X_J
//    dy_I^T) o lmat^T in registers, and each head's t = that o cbT summed
//    over rows and columns into its in-chunk share of d a_cum (one slot per
//    other tile, so each value has one writer); cbT out in f32, dcbT in bf16.
// 4. ssd_bwd_dx_kernel, a block per (h, 64-row key tile, chunk, b), longest
//    first: the forward's chunk_scan transposed, dx_J = w o (B_J dst^T) + the
//    sum over the query tiles I >= J of (cbT o lmat^T) dy_I, cbT from L2 into
//    the A fragments, dy rows through a 2-stage ring; dst's hi plane.
// 5. ssd_bwd_dbdc_kernel, a block per (dC or dB, 128-row block, chunk,
//    group, b): the dcb products once per group, then over the group's heads
//    the state term with prev (dC) or dst (dB) in its three planes, and each
//    head's state share of d a_cum (exp(a_cum) (dy prev) . C, - w (X dst) .
//    B). Splitting by output halves the prev / dst planes a block loads.
// 6. ssd_bwd_da_kernel, a block per (h, chunk, b): d a_cum from the slots,
//    da_log by a reverse scan over the chunk.
//
// Precision: da_log is held to the float32 tolerance. Its near-cancelling
// entries need O(1) terms (<dst, prev>, exp(a_cum) (dy prev) . C) to ~1e-6
// relative, which a bf16 hi + lo split (2^-18 of each operand) does not
// give; so the f32 operands of the state products are split in three bf16
// parts (hi + mid + lo, ~2^-26): X * w and dy * exp(a_cum) in stage 1, prev
// and dst in stage 2's planes.
// dy X^T and C B^T are products of bf16 inputs summed in f32; dcb is rounded
// to bf16 only for dC and dB, which are bf16 outputs.
//
// ptxas -v (nvcc 12.8, sm_90a), registers / dynamic shared memory / blocks
// an SM, no spills: chunk_state 120 / 108544 / 2, state_passing 32 / 0,
// dcb 166 / 73984 / 3, dx 125 / 54272 / 4, dbdc 192 / 177152 / 1, da 32 /
// 0; the float32 kernels below 124 / 100352, 48 / 0 and 184 / 167680 / 1.
//
// What bounds it on this card: at mamba2-780m's training shape (B=4,
// S=4096, H=48, P=64, G=1, N=128, L=256) the function reads x, dy, a_log, b
// and c and writes dx, da_log, db and dc once: 325 MB, 0.097 ms at 3.35
// TB/s; its least work (per group three L x L x N products over the causal
// pairs, per head two L x L x P and five L x P x N) is ~92 GFLOP, 0.093 ms
// at 989 TFLOP/s: bound by bytes. This design does ~200 GFLOP of mma (the
// three-part state products are 155 of them) and moves ~1.5 GB through
// device memory (the f32 chunk states and d prev, 0.2 GB written and read,
// the six bf16 planes, 0.3 GB written and read, prev re-read in stage 2),
// ~0.45 ms at 3.35 TB/s; inside the SMs the heads re-read B, C, x and dy
// from L2. Stages 1 and 5 are bound by their loads more than by their
// products: stage 1 without its mma keeps ~55% of its time, stage 5 with a
// third of its state products ~90% (tools/ssd_bwd_variants.py).
//
// float32 keeps the first design (the tensor cores would round to TF32):
// three kernels on the CUDA cores, ssd_bwd_state_kernel and
// ssd_bwd_chunk_kernel a block per (h, chunk, b), ssd_bwd_passing_kernel a
// block per (h, b), db and dc added over a group's heads with f32 atomics
// (not bit-reproducible).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int LMAX = 256;  // longest chunk
constexpr int PMAX = 64;   // largest head dim P
constexpr int NMAX = 128;  // largest state size N
constexpr int TILE = 64;   // rows of a tile

// ===========================================================================
// float32: the first design, on the CUDA cores
// ===========================================================================
constexpr int NT = 256;    // threads of a block: 16 x 16
constexpr int EPT = PMAX * NMAX / NT;   // (P, N) elements a thread of the passing kernel

// TILE rows of D values, row r at src + r * stride, into dst with rows of
// D + 1 floats; rows at or past `valid` are zero
__device__ __forceinline__ void load_rows(float* dst, const float* src, size_t stride,
                                          int valid, int D) {
  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r < valid ? src[size_t(r) * stride + d] : 0.f;
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

// 1. a_cum, the chunk's own state and dy's share of d prev
constexpr size_t ST_SMEM =
    sizeof(float) * (LMAX + 2 * size_t(TILE) * (PMAX + 1) + 2 * size_t(TILE) * (NMAX + 1));

__global__ void __launch_bounds__(NT)
ssd_bwd_state_kernel(const float* __restrict__ x, const float* __restrict__ a_log,
                     const float* __restrict__ b, const float* __restrict__ c,
                     const float* __restrict__ dy, float* __restrict__ a_cum,
                     float* __restrict__ states, float* __restrict__ d_prev,
                     float* __restrict__ db, float* __restrict__ dc, int S, int H, int P, int G,
                     int N, int L, int nc) {
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
  if (h % (H / G) == 0) {                      // this group's rows of db and dc, zeroed
    for (int i = tid; i < L * N; i += NT) {
      const size_t o = ((size_t(bb) * S + t0 + i / N) * G + g) * N + i % N;
      db[o] = 0.f;
      dc[o] = 0.f;
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
        xv = x[o] * __expf(last - acum[r0 + r]);
        dv = dy[o] * __expf(acum[r0 + r]);
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

// 2. the state recurrence forward (prev) and in reverse (d states)
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

// 3. the chunk's tiles: dx, da_log, and the heads' shares of db and dc
constexpr int MS = TILE + 1;                   // row of a masked 64 x 64 tile
constexpr size_t CH_SMEM =
    sizeof(float) * (2 * LMAX + size_t(PMAX) * (NMAX + 1) + 2 * size_t(TILE) * (PMAX + 1) +
                     2 * size_t(TILE) * (NMAX + 1) + 2 * size_t(TILE) * MS);

__global__ void __launch_bounds__(NT, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ b,
                     const float* __restrict__ c, const float* __restrict__ dy,
                     const float* __restrict__ a_cum, const float* __restrict__ prev,
                     const float* __restrict__ dst, const float* __restrict__ d_decay,
                     float* __restrict__ dx, float* __restrict__ da, float* __restrict__ db,
                     float* __restrict__ dc, int S, int H, int P, int G, int N, int L, int nc) {
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
  const float* xc = x + (size_t(bb) * S + t0) * xrow + size_t(h) * P;
  const float* dyc = dy + (size_t(bb) * S + t0) * xrow + size_t(h) * P;
  const float* bc = b + (size_t(bb) * S + t0) * brow + size_t(g) * N;
  const float* ccp = c + (size_t(bb) * S + t0) * brow + size_t(g) * N;
  float* db_c = db + (size_t(bb) * S + t0) * brow + size_t(g) * N;
  float* dc_c = dc + (size_t(bb) * S + t0) * brow + size_t(g) * N;

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
        if (p < P) dx[(size_t(bb) * S + t0 + j0 + j) * xrow + size_t(h) * P + p] = dxa[r][cc];
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

// ===========================================================================
// bfloat16: the chunk-parallel stages on the tensor cores
// ===========================================================================
constexpr int RS_N = NMAX + 8;    // padded bf16 row of an (.., N) tile
constexpr int RS_P = PMAX + 8;    // padded bf16 row of an (.., P) tile
constexpr int RS_T = TILE + 8;    // padded bf16 row of a 64 x 64 tile
constexpr float LOG2E = 1.4426950408889634f;

// 1. chunk_state: a block per (head, chunk, b)
constexpr int K1_THREADS = 256;
constexpr size_t K1_SLAB = size_t(TILE) * (2 * RS_P + 2 * RS_N) * 2;   // 64 rows of x, dy, B, C
constexpr size_t K1_W = 2 * K1_SLAB;                                   // after a 2-slab ring
constexpr size_t K1_SMEM = K1_W + size_t(2) * LMAX * 4;                // [LMAX] w, [LMAX] e

// 2. state_passing
constexpr int K2_THREADS = 256;
constexpr int K2_SLICE = K2_THREADS * 4;                               // a float4 a thread

// 3. dcb: a block per lower tile pair of a chunk and group
constexpr int K3_THREADS = 128;
constexpr size_t K3_C = 0;                                             // [TILE][RS_N] C, tile I
constexpr size_t K3_B = K3_C + size_t(TILE) * RS_N * 2;                // [TILE][RS_N] B, tile J
constexpr size_t K3_RING = K3_B + size_t(TILE) * RS_N * 2;             // [2] head stages
constexpr size_t K3_STAGE = size_t(2) * TILE * RS_P * 2 + size_t(2) * TILE * 4;  // x, dy, a_cum
constexpr size_t K3_RED = K3_RING + 2 * K3_STAGE;                      // [4][TILE] + [TILE] f32
constexpr size_t K3_SMEM = K3_RED + size_t(5) * TILE * 4;

// 4. dx: a block per (head, key tile, chunk, b)
constexpr int K4_THREADS = 128;
constexpr size_t K4_B = 0;                                             // [TILE][RS_N] B, tile J
constexpr size_t K4_D = K4_B + size_t(TILE) * RS_N * 2;                // [PMAX][RS_N] dst (hi)
constexpr size_t K4_Y = K4_D + size_t(PMAX) * RS_N * 2;                // [2][TILE][RS_P] dy ring
constexpr size_t K4_A = K4_Y + size_t(2) * TILE * RS_P * 2;            // [LMAX] f32 a_cum log2(e)
constexpr size_t K4_SMEM = K4_A + size_t(LMAX) * 4;

// 5. dbdc: a block per (dC or dB, 128-row block, chunk, group, b), over the group's heads
constexpr int K5_THREADS = 256;
constexpr int K5_ROWS = 2 * TILE;                                      // rows of a block
constexpr size_t K5_R = 0;                                             // [K5_ROWS][RS_N] C or B
constexpr size_t K5_RING = K5_R + size_t(K5_ROWS) * RS_N * 2;          // [2] units
constexpr size_t K5_UNIT = size_t(K5_ROWS) * RS_P * 2 + size_t(3) * PMAX * RS_N * 2;
constexpr size_t K5_RED = K5_RING + 2 * K5_UNIT;                       // [2][K5_ROWS] f32
constexpr size_t K5_SMEM = K5_RED + size_t(2) * K5_ROWS * 4;
static_assert(size_t(TILE) * RS_N * 2 + size_t(2) * TILE * RS_T * 2 <= K5_UNIT,
              "a dcb unit fits a ring stage");

// 6. da: a block per (h, chunk, b)
constexpr int K6_THREADS = LMAX;

// 2^x on the MUFU (ex2.approx, ~2^-22 relative)
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

// (x0, x1) * (w0, w1) = hi + mid + lo, each bf16x2, to ~2^-26 of the product
__device__ __forceinline__ void split3_scaled(uint32_t xv, float2 w, uint32_t (&out)[3]) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
  float r0 = f.x * w.x, r1 = f.y * w.y;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(r0, r1);
    const float2 hf = __bfloat1622float2(h);
    out[k] = *reinterpret_cast<const uint32_t*>(&h);
    r0 -= hf.x;
    r1 -= hf.y;
  }
}

// four floats as bf16 hi, mid, lo (8 bytes each)
__device__ __forceinline__ void split4(float4 v, uint2 (&out)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    out[k] = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                        *reinterpret_cast<const uint32_t*>(&b));
    v = make_float4(v.x - fa.x, v.y - fa.y, v.z - fb.x, v.w - fb.y);
  }
}

// the sum of three planes of four bf16 (the float4 split4 took apart)
__device__ __forceinline__ float4 join4(const bf16* p, size_t plane) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    const uint2 u = *reinterpret_cast<const uint2*>(p + k * plane);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v = make_float4(v.x + a.x, v.y + a.y, v.z + b.x, v.w + b.y);
  }
  return v;
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

template <int NT8>
__device__ __forceinline__ void zero_acc(float (&acc)[NT8][4]) {
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// the (lower 64x64 tile) pair (qt, kt), kt <= qt, of triangle index `tri`
__device__ __forceinline__ void tile_pair(int tri, int& qt, int& kt) {
  qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= tri) ++qt;
  kt = tri - qt * (qt + 1) / 2;
}

// Stage 1. a_cum[b, h, c, :], states[b, c, h] = (X * w)^T B and d_prev[b, c,
// h] = (dy * exp(a_cum))^T C, (P, N) f32 each; grid (H * nc, B), h fastest
// so the heads of a group meet the same B and C rows in L2.
__global__ void __launch_bounds__(K1_THREADS, 2)
ssd_bwd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ a_log,
                           const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                           const bf16* __restrict__ dy, float* __restrict__ states,
                           float* __restrict__ d_prev, float* __restrict__ a_cum, int S, int H,
                           int P, int G, int N, int L, int nc) {
  extern __shared__ __align__(128) unsigned char smem_k1[];
  float* ws = reinterpret_cast<float*>(smem_k1 + K1_W);
  float* es = ws + LMAX;
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t s0 = size_t(b) * S + size_t(c) * L;
  const int nq = (L + TILE - 1) / TILE;

  // slab q (rows 64q.. of x, dy, B and C) into ring stage q % 2, one commit group each
  auto issue = [&](int q) {
    if (q < nq) {
      const size_t x_row = size_t(H) * P, bc_row = size_t(G) * N;
      const size_t xo = s0 * x_row + size_t(h) * P, bo = s0 * bc_row + size_t(g) * N;
      const int Lr = (L + 15) / 16 * 16;    // rows the products read; zeros past L
      bf16* Xs = reinterpret_cast<bf16*>(smem_k1 + (q & 1) * K1_SLAB);
      bf16* Ds = Xs + TILE * RS_P;
      bf16* Bs = Ds + TILE * RS_P;
      bf16* Cs = Bs + TILE * RS_N;
      // a row is 8 chunks of 16 bytes of x, 8 of dy (P <= 64), then 16 of B, 16 of C
      for (int i = tid; i < TILE * 48; i += K1_THREADS) {
        const int r = i / 48, k = i % 48, l = q * TILE + r;
        const int which = k < 16 ? k >> 3 : 2 + ((k - 16) >> 4);
        const int col = (k < 16 ? k & 7 : (k - 16) & 15) * 8;
        if (l < Lr && col < (which < 2 ? P : N)) {
          const bool in = l < L;
          const size_t lr = in ? l : 0;
          if (which == 0)
            cp_async16(smem_u32(Xs + r * RS_P + col), x + xo + lr * x_row + col, in);
          else if (which == 1)
            cp_async16(smem_u32(Ds + r * RS_P + col), dy + xo + lr * x_row + col, in);
          else if (which == 2)
            cp_async16(smem_u32(Bs + r * RS_N + col), bm + bo + lr * bc_row + col, in);
          else
            cp_async16(smem_u32(Cs + r * RS_N + col), cm + bo + lr * bc_row + col, in);
        }
      }
    }
    cp_commit();
  };
  issue(0);
  issue(1);

  // a_cum by a warp scan (each lane sums 8 consecutive steps), then w and e
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
      es[t] = t < L ? expf(v[e]) : 0.f;
    }
  }

  const int wp = warp & 3, wn = warp >> 2;     // 16 p-rows, 64 n-columns
  const bool active = wp * 16 < P && wn * 64 < N;
  const Lanes ln(lane);
  float sacc[8][4], dacc[8][4];
  zero_acc(sacc);
  zero_acc(dacc);
  for (int q = 0; q < nq; ++q) {
    cp_wait<1>();
    __syncthreads();               // slab q has landed for every thread; ws, es are written
    if (active) {
      const bf16* Xs = reinterpret_cast<const bf16*>(smem_k1 + (q & 1) * K1_SLAB);
      const bf16* Ds = Xs + TILE * RS_P;
      const bf16* Bs = Ds + TILE * RS_P;
      const bf16* Cs = Bs + TILE * RS_N;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k0 = kk * 16;
        if (q * TILE + k0 < L) {
          // the two products share their shape: A = (X * w)^T or (dy * e)^T, split
          // into bf16 hi + mid + lo; B = the B or C rows
          auto product = [&](const bf16* As, const bf16* Bsrc, const float* sc,
                             float(&acc)[8][4]) {
            uint32_t xv[4], a[3][4];
            ldsm_x4_t(smem_u32(As + (k0 + ln.kb_row) * RS_P + wp * 16 + ln.kb_col), xv[0],
                      xv[1], xv[2], xv[3]);
            const float2 w01 = *reinterpret_cast<const float2*>(sc);
            const float2 w89 = *reinterpret_cast<const float2*>(sc + 8);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              uint32_t parts[3];
              split3_scaled(xv[r], r < 2 ? w01 : w89, parts);
              a[0][r] = parts[0];
              a[1][r] = parts[1];
              a[2][r] = parts[2];
            }
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              if (wn * 64 + np * 16 < N) {
                uint32_t b0, b1, b2, b3;
                ldsm_x4_t(smem_u32(Bsrc + (k0 + ln.qa_row) * RS_N + wn * 64 + np * 16 +
                                   ln.qa_col), b0, b1, b2, b3);
#pragma unroll
                for (int part = 0; part < 3; ++part) {
                  mma16816(acc[2 * np], a[part], b0, b1);
                  mma16816(acc[2 * np + 1], a[part], b2, b3);
                }
              }
            }
          };
          product(Xs, Bs, ws + q * TILE + k0 + ln.t2, sacc);
          product(Ds, Cs, es + q * TILE + k0 + ln.t2, dacc);
        }
      }
    }
    __syncthreads();               // every warp is done with ring stage q % 2
    issue(q + 2);
  }
  cp_wait<0>();
  if (!active) return;
  const size_t o = ((size_t(b) * nc + c) * H + h) * size_t(P) * N;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = wn * 64 + n * 8 + ln.t2;
    if (col < N) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const size_t at = o + size_t(wp * 16 + ln.g4 + 8 * hh) * N + col;
        *reinterpret_cast<float2*>(states + at) = make_float2(sacc[n][2 * hh], sacc[n][2 * hh + 1]);
        *reinterpret_cast<float2*>(d_prev + at) = make_float2(dacc[n][2 * hh], dacc[n][2 * hh + 1]);
      }
    }
  }
}

// Stage 2. prev (the state entering each chunk) forward from zero, then in
// reverse dst_c = g, g = d_prev_c + exp(a_cum_c[L-1]) g from dstate; prev and
// dst out as bf16 hi, mid, lo planes, (B, nc, H, 3, P, N); d_last[b, h, c,
// slice] this slice's share of <dst_c, prev_{c+1}>. grid (ceil(P*N / 1024), H, B).
__global__ void __launch_bounds__(K2_THREADS)
ssd_bwd_state_passing_kernel(const float* __restrict__ states, const float* __restrict__ d_prev,
                             const float* __restrict__ a_cum, const float* __restrict__ dstate,
                             bf16* __restrict__ prev3, bf16* __restrict__ dst3,
                             float* __restrict__ d_last, int H, int PN, int nc, int L) {
  __shared__ float red[K2_THREADS / 32];
  const int i = blockIdx.x * K2_SLICE + threadIdx.x * 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool on = i < PN;
  const float* ac = a_cum + (size_t(b) * H + h) * nc * size_t(L) + (L - 1);
  const size_t stride = size_t(H) * PN;                     // one chunk of states / d_prev
  const size_t base = (size_t(b) * nc * H + h) * PN + i;
  const size_t base3 = (size_t(b) * nc * H + h) * 3 * PN + i;
  auto store3 = [&](bf16* dst, float4 v) {
    uint2 part[3];
    split4(v, part);
#pragma unroll
    for (int k = 0; k < 3; ++k) *reinterpret_cast<uint2*>(dst + k * PN) = part[k];
  };
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc && on; ++c) {
    store3(prev3 + base3 + 3 * c * stride, run);
    const float4 cur = *reinterpret_cast<const float4*>(states + base + c * stride);
    const float d = expf(ac[size_t(c) * L]);
    run = make_float4(d * run.x + cur.x, d * run.y + cur.y, d * run.z + cur.z, d * run.w + cur.w);
  }
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (dstate != nullptr && on)
    g = *reinterpret_cast<const float4*>(dstate + (size_t(b) * H + h) * PN + i);
  float4 nxt = run;                                          // prev_{c+1}: the final state first
  for (int c = nc - 1; c >= 0; --c) {
    float s = 0.f;
    if (on) {
      const size_t at3 = base3 + 3 * c * stride;
      store3(dst3 + at3, g);
      s = g.x * nxt.x + g.y * nxt.y + g.z * nxt.z + g.w * nxt.w;
      nxt = join4(prev3 + at3, PN);
      const float4 dp = *reinterpret_cast<const float4*>(d_prev + base + c * stride);
      const float d = expf(ac[size_t(c) * L]);
      g = make_float4(dp.x + d * g.x, dp.y + d * g.y, dp.z + d * g.z, dp.w + d * g.w);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < K2_THREADS / 32; ++w) t += red[w];
      d_last[((size_t(b) * H + h) * nc + c) * gridDim.x + blockIdx.x] = t;
    }
    __syncthreads();
  }
}

// Stage 3. For the tile pair (qt, kt), kt <= qt, of a chunk and group, in the
// key-major orientation (rows j of tile kt, columns i of tile qt): cbT = B_J
// C_I^T (f32), then over the group's heads dcbT += (X_J dy_I^T) o lmat^T
// (bf16 out), and each head's t = (X_J dy_I^T) o lmat^T o cbT summed over
// its columns (into d_intra of rows j, negated) and over its rows (d_intra
// of rows i); d_intra (B, H, nc, nt, LP) holds one slot per other tile, so
// each (slot, row) has one writer. grid (ntri * nc * G, B).
__global__ void __launch_bounds__(K3_THREADS, 3)
ssd_bwd_dcb_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                   const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                   const float* __restrict__ a_cum, float* __restrict__ cbT,
                   bf16* __restrict__ dcbT, float* __restrict__ d_intra, int S, int H, int P,
                   int G, int N, int L, int LP, int nc) {
  extern __shared__ __align__(128) unsigned char smem_k3[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_k3 + K3_C);
  bf16* Bs = reinterpret_cast<bf16*>(smem_k3 + K3_B);
  float* red = reinterpret_cast<float*>(smem_k3 + K3_RED);    // [4][TILE] column sums
  float* rsm = red + 4 * TILE;                                 // [TILE] row sums
  const int nt = LP / TILE, ntri = nt * (nt + 1) / 2;
  const int tri = blockIdx.x % ntri, cg = blockIdx.x / ntri;
  int qt, kt;
  tile_pair(tri, qt, kt);
  const int c = cg / G, g = cg % G, b = blockIdx.y;
  const int i0 = qt * TILE, j0 = kt * TILE, rep = H / G;
  const int tid = threadIdx.x, warp = tid >> 5;
  const Lanes ln(tid & 31);
  const size_t bc_row = size_t(G) * N, x_row = size_t(H) * P;
  const size_t s0 = size_t(b) * S + size_t(c) * L;

  // group 0: the C rows of tile I, the B rows of tile J
  {
    const bf16* cbase = cm + s0 * bc_row + size_t(g) * N;
    const bf16* bbase = bm + s0 * bc_row + size_t(g) * N;
    const int n8 = N / 8;
    for (int i = tid; i < TILE * n8; i += K3_THREADS) {
      const int r = i / n8, col = (i % n8) * 8;
      const bool qin = i0 + r < L, kin = j0 + r < L;
      cp_async16(smem_u32(Cs + r * RS_N + col), cbase + size_t(qin ? i0 + r : 0) * bc_row + col,
                 qin);
      cp_async16(smem_u32(Bs + r * RS_N + col), bbase + size_t(kin ? j0 + r : 0) * bc_row + col,
                 kin);
    }
    cp_commit();
  }
  // head k of the group into ring stage k % 2: x rows of J, dy rows of I (one
  // group), a_cum of rows I and J scaled by log2(e) (plain stores, seen after
  // the barrier that opens the head)
  auto issue = [&](int k) {
    if (k < rep) {
      const int h = g * rep + k;
      unsigned char* st = smem_k3 + K3_RING + (k & 1) * K3_STAGE;
      bf16* Xs = reinterpret_cast<bf16*>(st);
      bf16* Ys = Xs + TILE * RS_P;
      float* As = reinterpret_cast<float*>(Ys + TILE * RS_P);
      for (int i = tid; i < TILE * 16; i += K3_THREADS) {
        const int r = i >> 4, is_x = (i & 15) < 8, col = (i & 7) * 8;
        if (col < P) {
          const int l = (is_x ? j0 : i0) + r;
          const bool in = l < L;
          const bf16* src = (is_x ? x : dy) + (s0 + (in ? l : 0)) * x_row + size_t(h) * P + col;
          cp_async16(smem_u32((is_x ? Xs : Ys) + r * RS_P + col), src, in);
        }
      }
      const int l = (tid < TILE ? i0 : j0) + (tid & (TILE - 1));
      As[tid] = l < L ? a_cum[((size_t(b) * H + h) * nc + c) * L + l] * LOG2E : 0.f;
    }
    cp_commit();
  };
  issue(0);
  issue(1);

  cp_wait<2>();
  __syncthreads();                 // C, B rows in shared memory
  // cbT(j, i) = B_j . C_i: the warp's 16 rows j x 64 columns i
  float cbt[8][4];
  zero_acc(cbt);
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(smem_u32(Bs + (warp * 16 + ln.qa_row) * RS_N + kk * 16 + ln.qa_col), a[0], a[1],
            a[2], a[3]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(smem_u32(Cs + (np * 16 + ln.kb_row) * RS_N + kk * 16 + ln.kb_col), b0, b1, b2, b3);
      mma16816(cbt[2 * np], a, b0, b1);
      mma16816(cbt[2 * np + 1], a, b2, b3);
    }
  }
  const size_t tile0 = ((size_t(b) * nc + c) * G + g) * size_t(LP) * LP;
  const int jr = warp * 16 + ln.g4;              // this thread's rows jr, jr + 8 of tile J
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(cbT + tile0 + size_t(j0 + jr + 8 * hh) * LP + i0 + n * 8 +
                                 ln.t2) = make_float2(cbt[n][2 * hh], cbt[n][2 * hh + 1]);

  float dcb[8][4];
  zero_acc(dcb);
  for (int k = 0; k < rep; ++k) {
    cp_wait<1>();
    __syncthreads();               // head k has landed
    const unsigned char* st = smem_k3 + K3_RING + (k & 1) * K3_STAGE;
    const bf16* Xs = reinterpret_cast<const bf16*>(st);
    const bf16* Ys = Xs + TILE * RS_P;
    const float* As = reinterpret_cast<const float*>(Ys + TILE * RS_P);
    float d[8][4];
    zero_acc(d);
    for (int kk = 0; kk < P / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(smem_u32(Xs + (warp * 16 + ln.qa_row) * RS_P + kk * 16 + ln.qa_col), a[0], a[1],
              a[2], a[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(Ys + (np * 16 + ln.kb_row) * RS_P + kk * 16 + ln.kb_col), b0, b1, b2,
                b3);
        mma16816(d[2 * np], a, b0, b1);
        mma16816(d[2 * np + 1], a, b2, b3);
      }
    }
    const float aj[2] = {As[TILE + jr], As[TILE + jr + 8]};
    float rs[2] = {0.f, 0.f}, cs[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + ln.t2 + e, ig = i0 + col;
        const float ai = As[col];
        cs[n][e] = 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int jg = j0 + jr + 8 * hh;
          const float m = (ig >= jg && ig < L) ? d[n][2 * hh + e] * fast_exp2(ai - aj[hh]) : 0.f;
          dcb[n][2 * hh + e] += m;
          const float t = m * cbt[n][2 * hh + e];
          rs[hh] += t;
          cs[n][e] += t;
        }
      }
    }
    // row sums over the quad (t2), column sums over the warp's rows (g4)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          cs[n][e] += __shfl_xor_sync(0xffffffffu, cs[n][e], off);
    if (ln.t2 == 0) {
      rsm[jr] = rs[0];
      rsm[jr + 8] = rs[1];
    }
    if (ln.g4 == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        red[warp * TILE + n * 8 + ln.t2] = cs[n][0];
        red[warp * TILE + n * 8 + ln.t2 + 1] = cs[n][1];
      }
    }
    __syncthreads();               // every warp is done with ring stage k % 2; sums staged
    if (tid < TILE) {
      const float col = red[tid] + red[TILE + tid] + red[2 * TILE + tid] + red[3 * TILE + tid];
      float* di = d_intra + ((size_t(b) * H + g * rep + k) * nc + c) * size_t(nt) * LP;
      if (qt == kt) {
        di[size_t(kt) * LP + j0 + tid] = col - rsm[tid];
      } else {
        di[size_t(qt) * LP + j0 + tid] = -rsm[tid];     // rows j, the slot of tile I
        di[size_t(kt) * LP + i0 + tid] = col;           // rows i, the slot of tile J
      }
    }
    issue(k + 2);
  }
  cp_wait<0>();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(dcbT + tile0 + size_t(j0 + jr + 8 * hh) * LP + i0 + n * 8 +
                                   ln.t2) = pack_bf16(dcb[n][2 * hh], dcb[n][2 * hh + 1]);
}

// Stage 4. dx for one 64-row key tile of one (b, chunk, h): w o (B_J dst^T)
// + the sum over the query tiles I >= J of (cbT o lmat^T) dy_I; grid (H * nt
// * nc, B), longest first.
__global__ void __launch_bounds__(K4_THREADS, 4)
ssd_bwd_dx_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ bm,
                  const float* __restrict__ a_cum, const float* __restrict__ cbT,
                  const bf16* __restrict__ dst3, bf16* __restrict__ dx, int S, int H, int P,
                  int G, int N, int L, int LP, int nc) {
  extern __shared__ __align__(128) unsigned char smem_k4[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_k4 + K4_B);
  bf16* Ds = reinterpret_cast<bf16*>(smem_k4 + K4_D);
  float* As = reinterpret_cast<float*>(smem_k4 + K4_A);
  const int nt = LP / TILE;
  const int h = blockIdx.x % H, rest = blockIdx.x / H;
  const int jt = rest % nt, c = rest / nt, b = blockIdx.y;
  const int g = h / (H / G);
  const int j0 = jt * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t x_row = size_t(H) * P, bc_row = size_t(G) * N;
  const size_t s0 = size_t(b) * S + size_t(c) * L;
  const bf16* bbase = bm + s0 * bc_row + size_t(g) * N;
  const bf16* ybase = dy + s0 * x_row + size_t(h) * P;
  const bf16* dbase = dst3 + ((size_t(b) * nc + c) * H + h) * 3 * size_t(P) * N;   // hi
  const float* cbm = cbT + ((size_t(b) * nc + c) * G + g) * size_t(LP) * LP;

  // group 0: the tile's B rows and dst (hi); then the dy rows of query tile
  // it, one group each, into ring stage (it - jt) % 2
  for (int i = tid; i < TILE * 16; i += K4_THREADS) {      // 16 chunks of 16 bytes a row
    const int r = i >> 4, col = (i & 15) * 8;
    const bool in = j0 + r < L;
    if (col < N) {
      cp_async16(smem_u32(Bs + r * RS_N + col), bbase + size_t(in ? j0 + r : 0) * bc_row + col,
                 in);
      if (r < P) cp_async16(smem_u32(Ds + r * RS_N + col), dbase + size_t(r) * N + col, true);
    }
  }
  cp_commit();
  auto issue_y = [&](int it) {
    if (it < nt) {
      bf16* Ys = reinterpret_cast<bf16*>(smem_k4 + K4_Y) + ((it - jt) & 1) * TILE * RS_P;
      for (int i = tid; i < TILE * 8; i += K4_THREADS) {     // 8 chunks of 16 bytes a row
        const int r = i >> 3, col = (i & 7) * 8, l = it * TILE + r;
        const bool in = l < L;
        if (col < P)
          cp_async16(smem_u32(Ys + r * RS_P + col), ybase + size_t(in ? l : 0) * x_row + col,
                     in);
      }
    }
    cp_commit();
  };
  issue_y(jt);
  issue_y(jt + 1);
  const float* ac = a_cum + ((size_t(b) * H + h) * nc + c) * L;
  for (int t = tid; t < LMAX; t += K4_THREADS) As[t] = t < L ? ac[t] * LOG2E : 0.f;

  const Lanes ln(lane);
  const int r0 = j0 + warp * 16 + ln.g4, r1 = r0 + 8;      // this thread's rows j
  const int np_n = P / 16;

  // Inside each 16-key k-step the query rows i are permuted so that this
  // thread's A-fragment slots (2t, 2t+1, 2t+8, 2t+9) hold i = 4t..4t+3: its
  // cbT and a_cum entries are one float4 each, and the dy rows go to
  // ldmatrix in the same order (a product sums over k in any order).
  const int t4 = 2 * ln.t2;
  const int y_row_perm = 4 * ((lane & 7) >> 1) + (lane & 1) + 2 * ((lane >> 3) & 1);
  float4 cbv[4][2];     // query tile it: rows r0, r1; i = 64 it + 16 kk + 4t + {0..3}
  auto load_cb = [&](int it) {
    const int kk_begin = it == jt ? warp : 0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        cbv[kk][hh] = kk >= kk_begin
                          ? __ldg(reinterpret_cast<const float4*>(
                                cbm + size_t(hh ? r1 : r0) * LP + it * TILE + kk * 16 + t4))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  float acc[8][4];
  zero_acc(acc);
  cp_wait<2>();
  __syncthreads();                 // B, dst and As are in shared memory
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(smem_u32(Bs + (warp * 16 + ln.qa_row) * RS_N + kk * 16 + ln.qa_col), a[0], a[1],
            a[2], a[3]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np < np_n) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(Ds + (np * 16 + ln.kb_row) * RS_N + kk * 16 + ln.kb_col), b0, b1, b2,
                b3);
        mma16816(acc[2 * np], a, b0, b1);
        mma16816(acc[2 * np + 1], a, b2, b3);
      }
    }
  }
  const bool rv[2] = {r0 < L, r1 < L};
  const float ar[2] = {As[r0], As[r1]};
  {
    const float a_last = As[L - 1];
    const float w0 = rv[0] ? fast_exp2(a_last - ar[0]) : 0.f;
    const float w1 = rv[1] ? fast_exp2(a_last - ar[1]) : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= w0;
      acc[n][1] *= w0;
      acc[n][2] *= w1;
      acc[n][3] *= w1;
    }
  }

  for (int it = jt; it < nt; ++it) {
    load_cb(it);
    cp_wait<1>();
    __syncthreads();               // the dy rows of query tile it have landed
    const bf16* Ys = reinterpret_cast<const bf16*>(smem_k4 + K4_Y) + ((it - jt) & 1) * TILE * RS_P;
    const int kk_begin = it == jt ? warp : 0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= kk_begin) {
        const int i = it * TILE + kk * 16 + t4;            // queries i..i+3
        const float4 ai = *reinterpret_cast<const float4*>(As + i);
        const float ak[4] = {ai.x, ai.y, ai.z, ai.w};
        float s[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = hh ? r1 : r0;
          const float v[4] = {cbv[kk][hh].x, cbv[kk][hh].y, cbv[kk][hh].z, cbv[kk][hh].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)   // right of the diagonal tile every query is >= r
            s[hh][e] = ((it > jt || i + e >= r) && i + e < L && rv[hh])
                           ? v[e] * fast_exp2(ak[e] - ar[hh]) : 0.f;
        }
        const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[1][0], s[1][1]),
                               pack_bf16(s[0][2], s[0][3]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np < np_n) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(smem_u32(Ys + (kk * 16 + y_row_perm) * RS_P + np * 16 + ln.qa_col), b0, b1,
                      b2, b3);
            mma16816(acc[2 * np], a, b0, b1);
            mma16816(acc[2 * np + 1], a, b2, b3);
          }
        }
      }
    }
    __syncthreads();               // every warp is done with ring stage (it - jt) % 2
    issue_y(it + 2);
  }
  cp_wait<0>();

  // dx through shared memory (the B rows' space, free since the first product)
  // so that each row leaves as whole 16-byte chunks; a warp stages its own rows
  bf16* Xo = Bs + warp * 16 * RS_P;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (n < 2 * np_n)
        *reinterpret_cast<uint32_t*>(Xo + (ln.g4 + 8 * hh) * RS_P + n * 8 + ln.t2) =
            pack_bf16(acc[n][2 * hh], acc[n][2 * hh + 1]);
  __syncwarp();
  bf16* xb = dx + (s0 + j0 + warp * 16) * x_row + size_t(h) * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = lane + 32 * i, rr = q >> 3, col = (q & 7) * 8;
    if (col < P && j0 + warp * 16 + rr < L)
      *reinterpret_cast<uint4*>(xb + size_t(rr) * x_row + col) =
          *reinterpret_cast<const uint4*>(Xo + rr * RS_P + col);
  }
}

// Stage 5. dC (which = 0) or dB (which = 1) of one 128-row block (the 64-row
// tiles T0, T0 + 1) of one (b, chunk, group). First the group's dcb
// products over the tiles U (dC_T += dcb_TU B_U for U <= T, dB_T += dcbT_TU
// C_U for U >= T), then over the group's heads in order the state term, dC
// += exp(a_cum) o (dy prev) or dB += w o (X dst), with prev or dst as bf16
// hi, mid and lo planes, and each head's share of d_state, exp(a_cum) (dy
// prev) . C or - w (X dst) . B of the block's rows, into its slot `which`.
// Units of work stream through a 2-stage ring: the dcb units, then one a
// head. A warp holds 32 rows x 64 columns; over the heads it keeps the dy
// (or X) fragments of its rows and walks its columns 16 at a time through
// the three planes. grid (2 * nrb * nc * G, B), nrb = ceil(LP / 128).
__global__ void __launch_bounds__(K5_THREADS, 1)
ssd_bwd_dbdc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                    const float* __restrict__ a_cum, const bf16* __restrict__ dcbT,
                    const bf16* __restrict__ prev3, const bf16* __restrict__ dst3,
                    bf16* __restrict__ db, bf16* __restrict__ dc, float* __restrict__ d_state,
                    int S, int H, int P, int G, int N, int L, int LP, int nc) {
  extern __shared__ __align__(128) unsigned char smem_k5[];
  bf16* Rs = reinterpret_cast<bf16*>(smem_k5 + K5_R);
  float* red = reinterpret_cast<float*>(smem_k5 + K5_RED);    // [2][K5_ROWS] row partials
  const int nt = LP / TILE, nrb = (LP + K5_ROWS - 1) / K5_ROWS;
  const int which = blockIdx.x & 1, rb = (blockIdx.x >> 1) % nrb, cg = (blockIdx.x >> 1) / nrb;
  const int c = cg / G, g = cg % G, b = blockIdx.y;
  const int T0 = 2 * rb, r0 = T0 * TILE, rep = H / G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wn = warp >> 2;                     // 32 rows, 64 n-columns
  const int Tw = T0 + (wr >> 1);                               // the tile of the warp's rows
  const bool active = wn * 64 < N && Tw < nt;
  const Lanes ln(lane);
  const size_t bc_row = size_t(G) * N, x_row = size_t(H) * P, PN = size_t(P) * N;
  const size_t s0 = size_t(b) * S + size_t(c) * L;
  const bf16* cbase = cm + s0 * bc_row + size_t(g) * N;
  const bf16* bbase = bm + s0 * bc_row + size_t(g) * N;
  const bf16* dtile = dcbT + ((size_t(b) * nc + c) * G + g) * size_t(LP) * LP;
  const int u0 = which ? T0 : 0;                               // the dcb units' first tile
  const int n_dcb = which ? nt - T0 : min(T0 + 1, nt - 1) + 1;
  const int n_units = n_dcb + rep;

  // n rows of a (.., N) operand from row l0 into dst, zeros past L
  auto rows_n = [&](bf16* dst, const bf16* base, int l0, int n) {
    for (int i = tid; i < n * 16; i += K5_THREADS) {
      const int r = i >> 4, col = (i & 15) * 8;
      const bool in = l0 + r < L;
      if (col < N)
        cp_async16(smem_u32(dst + r * RS_N + col), base + size_t(in ? l0 + r : 0) * bc_row + col,
                   in);
    }
  };
  // group 0: the block's C rows (dC) or B rows (dB), for the d_state dot
  rows_n(Rs, which ? bbase : cbase, r0, K5_ROWS);
  cp_commit();
  auto issue = [&](int u) {
    if (u < n_units) {
      unsigned char* st = smem_k5 + K5_RING + (u & 1) * K5_UNIT;
      if (u < n_dcb) {             // B_U (dC) or C_U (dB), then dcbT (U, T) or (T, U), T = T0, T0 + 1
        const int U = u0 + u;
        bf16* Us = reinterpret_cast<bf16*>(st);
        rows_n(Us, which ? cbase : bbase, U * TILE, TILE);
        bf16* Ts = Us + TILE * RS_N;
        for (int i = tid; i < 2 * TILE * 8; i += K5_THREADS) {
          const int t = i >> 9, r = (i >> 3) & (TILE - 1), col = (i & 7) * 8, T = T0 + t;
          if (T < nt && (which ? U >= T : U <= T)) {
            const int rr = which ? T * TILE + r : U * TILE + r, cc = which ? U * TILE : T * TILE;
            cp_async16(smem_u32(Ts + (t * TILE + r) * RS_T + col), dtile + size_t(rr) * LP + cc +
                       col, true);
          }
        }
      } else {                     // head k: the rows of dy (dC) or X (dB), prev or dst planes
        const int h = g * rep + (u - n_dcb);
        bf16* Ys = reinterpret_cast<bf16*>(st);
        bf16* Ps = Ys + K5_ROWS * RS_P;
        const bf16* src = (which ? x : dy) + s0 * x_row + size_t(h) * P;
        for (int i = tid; i < K5_ROWS * 8; i += K5_THREADS) {
          const int r = i >> 3, col = (i & 7) * 8, l = r0 + r;
          const bool in = l < L;
          if (col < P)
            cp_async16(smem_u32(Ys + r * RS_P + col), src + size_t(in ? l : 0) * x_row + col, in);
        }
        const bf16* st3 = (which ? dst3 : prev3) + ((size_t(b) * nc + c) * H + h) * 3 * PN;
        for (int i = tid; i < 3 * PMAX * 16; i += K5_THREADS) {   // hi, mid, lo rows
          const int r = i >> 4, col = (i & 15) * 8, plane = r / PMAX, p = r % PMAX;
          if (p < P && col < N)
            cp_async16(smem_u32(Ps + r * RS_N + col), st3 + plane * PN + size_t(p) * N + col,
                       true);
        }
      }
    }
    cp_commit();
  };
  issue(0);
  issue(1);

  const int rw = wr * 32;                          // the warp's first row in the block
  float acc[2][8][4];
#pragma unroll
  for (int rf = 0; rf < 2; ++rf) zero_acc(acc[rf]);
  for (int u = 0; u < n_units; ++u) {
    cp_wait<1>();
    __syncthreads();               // unit u (and the block's rows) has landed
    const unsigned char* st = smem_k5 + K5_RING + (u & 1) * K5_UNIT;
    if (u < n_dcb) {
      const int U = u0 + u;
      if (active && (which ? U >= Tw : U <= Tw)) {
        const bf16* Us = reinterpret_cast<const bf16*>(st);
        const bf16* Ts = Us + TILE * RS_N + (wr >> 1) * TILE * RS_T;   // the warp's tile
        const int tr = (wr & 1) * 32;                                  // its rows in the tile
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int rf = 0; rf < 2; ++rf) {
            if (which)             // dB_T += dcbT_TU C_U: rows j of T, k = i of U
              ldsm_x4(smem_u32(Ts + (tr + rf * 16 + ln.qa_row) * RS_T + kk * 16 + ln.qa_col),
                      a[rf][0], a[rf][1], a[rf][2], a[rf][3]);
            else                   // dC_T += dcb_TU B_U: dcbT (U, T) read transposed
              ldsm_x4_t(smem_u32(Ts + (kk * 16 + ln.kb_row) * RS_T + tr + rf * 16 + ln.kb_col),
                        a[rf][0], a[rf][1], a[rf][2], a[rf][3]);
          }
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (wn * 64 + np * 16 < N) {
              uint32_t b0, b1, b2, b3;
              ldsm_x4_t(smem_u32(Us + (kk * 16 + ln.qa_row) * RS_N + wn * 64 + np * 16 +
                                 ln.qa_col), b0, b1, b2, b3);
#pragma unroll
              for (int rf = 0; rf < 2; ++rf) {
                mma16816(acc[rf][2 * np], a[rf], b0, b1);
                mma16816(acc[rf][2 * np + 1], a[rf], b2, b3);
              }
            }
          }
        }
      }
    } else {
      const int h = g * rep + (u - n_dcb);
      const float* ac = a_cum + ((size_t(b) * H + h) * nc + c) * L;
      const float al = ac[L - 1];
      // e = exp(a_cum) for dy prev, w = exp(a_cum[L-1] - a_cum) for X dst; 0 past L
      float sc[2][2], part[2][2];
#pragma unroll
      for (int rf = 0; rf < 2; ++rf)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int l = r0 + rw + rf * 16 + ln.g4 + 8 * hh;
          const float a = l < L ? ac[l] : 0.f;
          sc[rf][hh] = l < L ? fast_exp2((which ? al - a : a) * LOG2E) : 0.f;
          part[rf][hh] = 0.f;
        }
      if (active) {
        const bf16* Ys = reinterpret_cast<const bf16*>(st);
        const bf16* Ps = Ys + K5_ROWS * RS_P;
        uint32_t af[2][4][4];      // the rows' dy (or X) fragments, k-steps of P
#pragma unroll
        for (int rf = 0; rf < 2; ++rf)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk * 16 < P)
              ldsm_x4(smem_u32(Ys + (rw + rf * 16 + ln.qa_row) * RS_P + kk * 16 + ln.qa_col),
                      af[rf][kk][0], af[rf][kk][1], af[rf][kk][2], af[rf][kk][3]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (wn * 64 + np * 16 < N) {
            float q[2][2][4];
#pragma unroll
            for (int rf = 0; rf < 2; ++rf) {
              zero_acc(q[rf]);
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              if (kk * 16 < P) {
#pragma unroll
                for (int plane = 0; plane < 3; ++plane) {
                  uint32_t b0, b1, b2, b3;
                  ldsm_x4_t(smem_u32(Ps + (plane * PMAX + kk * 16 + ln.qa_row) * RS_N + wn * 64 +
                                     np * 16 + ln.qa_col), b0, b1, b2, b3);
#pragma unroll
                  for (int rf = 0; rf < 2; ++rf) {
                    mma16816(q[rf][0], af[rf][kk], b0, b1);
                    mma16816(q[rf][1], af[rf][kk], b2, b3);
                  }
                }
              }
            }
            // scale, add to dC or dB, dot with the block's C or B rows
#pragma unroll
            for (int rf = 0; rf < 2; ++rf)
#pragma unroll
              for (int n8 = 0; n8 < 2; ++n8) {
                const int col = wn * 64 + np * 16 + n8 * 8 + ln.t2;
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                  const float2 rv2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                      Rs + (rw + rf * 16 + ln.g4 + 8 * hh) * RS_N + col));
                  const float v0 = sc[rf][hh] * q[rf][n8][2 * hh];
                  const float v1 = sc[rf][hh] * q[rf][n8][2 * hh + 1];
                  acc[rf][2 * np + n8][2 * hh] += v0;
                  acc[rf][2 * np + n8][2 * hh + 1] += v1;
                  part[rf][hh] = fmaf(v0, rv2.x, fmaf(v1, rv2.y, part[rf][hh]));
                }
              }
          }
        }
      }
#pragma unroll
      for (int rf = 0; rf < 2; ++rf)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          part[rf][hh] += __shfl_xor_sync(0xffffffffu, part[rf][hh], 1);
          part[rf][hh] += __shfl_xor_sync(0xffffffffu, part[rf][hh], 2);
          if (ln.t2 == 0) red[wn * K5_ROWS + rw + rf * 16 + ln.g4 + 8 * hh] = part[rf][hh];
        }
    }
    __syncthreads();               // every warp is done with ring stage u % 2
    if (u >= n_dcb && tid < K5_ROWS && r0 + tid < LP) {   // idle warps wrote zeros
      const int h = g * rep + (u - n_dcb);
      const float v = red[tid] + red[K5_ROWS + tid];
      d_state[(((size_t(b) * H + h) * nc + c) * 2 + which) * LP + r0 + tid] = which ? -v : v;
    }
    issue(u + 2);
  }
  cp_wait<0>();
  if (!active) return;
  bf16* out = which ? db : dc;
#pragma unroll
  for (int rf = 0; rf < 2; ++rf)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = wn * 64 + n * 8 + ln.t2;
      if (col < N) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int l = r0 + rw + rf * 16 + ln.g4 + 8 * hh;
          if (l < L)
            *reinterpret_cast<uint32_t*>(out + (s0 + l) * bc_row + size_t(g) * N + col) =
                pack_bf16(acc[rf][n][2 * hh], acc[rf][n][2 * hh + 1]);
        }
      }
    }
}

// Stage 6. d a_cum = the d_intra slots + the d_state slots (+ d_last on the chunk's
// last step), then da_log by a reverse cumulative sum over the chunk; grid
// (H, nc, B), a thread a step.
__global__ void __launch_bounds__(K6_THREADS)
ssd_bwd_da_kernel(const float* __restrict__ d_intra, const float* __restrict__ d_state,
                  const float* __restrict__ d_last, float* __restrict__ da, int S, int H, int L,
                  int LP, int nc, int n_slices) {
  __shared__ float tot[K6_THREADS / 32];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x, lane = r & 31, warp = r >> 5;
  const int nt = LP / TILE;
  const size_t hc = (size_t(b) * H + h) * nc + c;
  float d = 0.f;
  if (r < L) {
    for (int s = 0; s < nt; ++s) d += d_intra[(hc * nt + s) * LP + r];
    d += d_state[hc * 2 * LP + r] + d_state[hc * 2 * LP + LP + r];
    if (r == L - 1)
      for (int s = 0; s < n_slices; ++s) d += d_last[hc * n_slices + s];
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {     // suffix sums inside the warp
    const float v = __shfl_down_sync(0xffffffffu, d, off);
    if (lane + off < 32) d += v;
  }
  if (lane == 0) tot[warp] = d;
  __syncthreads();
  for (int w = warp + 1; w < K6_THREADS / 32; ++w) d += tot[w];
  if (r < L) da[(size_t(b) * S + size_t(c) * L + r) * H + h] = d;
}

bool bad_shape(int B, int S, int H, int P, int G, int N, int L) {
  return B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P % 16 || P > PMAX ||
         N <= 0 || N % 16 || N > NMAX || L <= 0 || L > LMAX || S % L;
}

int round_up_tile(int L) { return (L + TILE - 1) / TILE * TILE; }

}  // namespace

extern "C" {

// float32 (the first design): x/dy/dx (B,S,H,P), a_log/da (B,S,H), b/c/db/dc
// (B,S,G,N), dstate (B,H,P,N) or null for zero; all float32 and contiguous.
// Scratch: a_cum (B,H,S/L,L), states, prev and d_prev (B,S/L,H,P,N), d_decay
// (B,H,S/L). P and N multiples of 16 up to 64 and 128, H % G == 0, 1 <=
// chunk <= 256 dividing S. Every entry point launches on `stream` and
// returns a cudaError_t.
int ssd_scan_bwd_f32(const void* x, const void* a_log, const void* b, const void* c,
                     const void* dy, const void* dstate, void* a_cum, void* states, void* prev,
                     void* d_prev, void* d_decay, void* dx, void* da, void* db, void* dc, int B,
                     int S, int H, int P, int G, int N, int chunk, void* stream) {
  if (bad_shape(B, S, H, P, G, N, chunk)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = chunk, nc = S / L;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_state_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(ST_SMEM));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(CH_SMEM));
  if (err != cudaSuccess) return int(err);
  const float *xf = static_cast<const float*>(x), *bf = static_cast<const float*>(b),
              *cf = static_cast<const float*>(c), *dyf = static_cast<const float*>(dy);
  float *acum = static_cast<float*>(a_cum), *sts = static_cast<float*>(states),
        *dpv = static_cast<float*>(d_prev), *dbf = static_cast<float*>(db),
        *dcf = static_cast<float*>(dc);
  const dim3 grid(H, nc, B);
  ssd_bwd_state_kernel<<<grid, NT, ST_SMEM, st>>>(xf, static_cast<const float*>(a_log), bf, cf,
                                                  dyf, acum, sts, dpv, dbf, dcf, S, H, P, G, N,
                                                  L, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_bwd_passing_kernel<<<dim3(H, B), NT, 0, st>>>(sts, acum, dpv,
                                                    static_cast<const float*>(dstate),
                                                    static_cast<float*>(prev),
                                                    static_cast<float*>(d_decay), H, P * N, nc, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_bwd_chunk_kernel<<<grid, NT, CH_SMEM, st>>>(
      xf, bf, cf, dyf, acum, static_cast<const float*>(prev), sts,
      static_cast<const float*>(d_decay), static_cast<float*>(dx), static_cast<float*>(da), dbf,
      dcf, S, H, P, G, N, L, nc);
  return int(cudaGetLastError());
}

// bfloat16 stage 1: x, dy (B,S,H,P) bf16, a_log (B,S,H) f32, b, c (B,S,G,N)
// bf16 -> states, d_prev (B,S/L,H,P,N) f32 and a_cum (B,H,S/L,L) f32.
int ssd_bwd_chunk_state(const void* x, const void* a_log, const void* b, const void* c,
                        const void* dy, void* states, void* d_prev, void* a_cum, int B, int S,
                        int H, int P, int G, int N, int L, void* stream) {
  if (bad_shape(B, S, H, P, G, N, L)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_chunk_state_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(K1_SMEM));
  if (err != cudaSuccess) return int(err);
  const int nc = S / L;
  ssd_bwd_chunk_state_kernel<<<dim3(unsigned(H) * nc, B), K1_THREADS, K1_SMEM,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a_log),
      static_cast<const bf16*>(b), static_cast<const bf16*>(c), static_cast<const bf16*>(dy),
      static_cast<float*>(states), static_cast<float*>(d_prev), static_cast<float*>(a_cum), S,
      H, P, G, N, L, nc);
  return int(cudaGetLastError());
}

// bfloat16 stage 2: states, d_prev (B,nc,H,P,N) f32, a_cum (B,H,nc,L) f32,
// dstate (B,H,P,N) f32 or null -> prev3, dst3 (B,nc,H,3,P,N) bf16 (hi, mid,
// lo) and d_last (B,H,nc,ceil(P*N/1024)) f32.
int ssd_bwd_state_passing(const void* states, const void* d_prev, const void* a_cum,
                          const void* dstate, void* prev3, void* dst3, void* d_last, int B,
                          int nc, int H, int P, int N, int L, void* stream) {
  if (bad_shape(B, nc * L, H, P, 1, N, L)) return int(cudaErrorInvalidValue);
  const int PN = P * N;
  const dim3 grid((PN + K2_SLICE - 1) / K2_SLICE, H, B);
  ssd_bwd_state_passing_kernel<<<grid, K2_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(states), static_cast<const float*>(d_prev),
      static_cast<const float*>(a_cum), static_cast<const float*>(dstate),
      static_cast<bf16*>(prev3), static_cast<bf16*>(dst3), static_cast<float*>(d_last), H, PN,
      nc, L);
  return int(cudaGetLastError());
}

// bfloat16 stage 3: x, dy (B,S,H,P) bf16, b, c (B,S,G,N) bf16, a_cum f32 ->
// cbT (B,S/L,G,LP,LP) f32 and dcbT (same) bf16, LP = L rounded up to 64,
// only the 64x64 tiles at or above the diagonal written (key-major: cbT[j][i]
// = C_i . B_j); d_intra (B,H,S/L,LP/64,LP) f32.
int ssd_bwd_dcb(const void* x, const void* dy, const void* b, const void* c, const void* a_cum,
                void* cbT, void* dcbT, void* d_intra, int B, int S, int H, int P, int G, int N,
                int L, void* stream) {
  if (bad_shape(B, S, H, P, G, N, L)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_dcb_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(K3_SMEM));
  if (err != cudaSuccess) return int(err);
  const int LP = round_up_tile(L), nt = LP / TILE, nc = S / L;
  const dim3 grid(unsigned(nt * (nt + 1) / 2) * nc * G, B);
  ssd_bwd_dcb_kernel<<<grid, K3_THREADS, K3_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<const float*>(a_cum), static_cast<float*>(cbT),
      static_cast<bf16*>(dcbT), static_cast<float*>(d_intra), S, H, P, G, N, L, LP, nc);
  return int(cudaGetLastError());
}

// bfloat16 stage 4: dy (B,S,H,P) bf16, b (B,S,G,N) bf16, a_cum f32, cbT
// (stage 3's), dst3 (stage 2's; its hi plane) -> dx (B,S,H,P) bf16.
int ssd_bwd_dx(const void* dy, const void* b, const void* a_cum, const void* cbT,
               const void* dst3, void* dx, int B, int S, int H, int P, int G, int N, int L,
               void* stream) {
  if (bad_shape(B, S, H, P, G, N, L)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_dx_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(K4_SMEM));
  if (err != cudaSuccess) return int(err);
  const int LP = round_up_tile(L), nc = S / L;
  const dim3 grid(unsigned(H) * (LP / TILE) * nc, B);
  ssd_bwd_dx_kernel<<<grid, K4_THREADS, K4_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(b), static_cast<const float*>(a_cum),
      static_cast<const float*>(cbT), static_cast<const bf16*>(dst3), static_cast<bf16*>(dx), S,
      H, P, G, N, L, LP, nc);
  return int(cudaGetLastError());
}

// bfloat16 stage 5: x, dy (B,S,H,P) bf16, b, c (B,S,G,N) bf16, a_cum f32,
// dcbT (stage 3's), prev3, dst3 (stage 2's) -> db, dc (B,S,G,N) bf16 and
// d_state (B,H,S/L,2,LP) f32.
int ssd_bwd_dbdc(const void* x, const void* dy, const void* b, const void* c, const void* a_cum,
                 const void* dcbT, const void* prev3, const void* dst3, void* db, void* dc,
                 void* d_state, int B, int S, int H, int P, int G, int N, int L, void* stream) {
  if (bad_shape(B, S, H, P, G, N, L)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_dbdc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(K5_SMEM));
  if (err != cudaSuccess) return int(err);
  const int LP = round_up_tile(L), nc = S / L;
  const dim3 grid(2 * unsigned((LP + 2 * TILE - 1) / (2 * TILE)) * nc * G, B);
  ssd_bwd_dbdc_kernel<<<grid, K5_THREADS, K5_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<const float*>(a_cum),
      static_cast<const bf16*>(dcbT), static_cast<const bf16*>(prev3),
      static_cast<const bf16*>(dst3), static_cast<bf16*>(db), static_cast<bf16*>(dc),
      static_cast<float*>(d_state), S, H, P, G, N, L, LP, nc);
  return int(cudaGetLastError());
}

// bfloat16 stage 6: d_intra (stage 3's), d_state (stage 5's), d_last (stage
// 2's) -> da (B,S,H) f32.
int ssd_bwd_da(const void* d_intra, const void* d_state, const void* d_last, void* da, int B,
               int S, int H, int P, int N, int L, void* stream) {
  if (bad_shape(B, S, H, P, 1, N, L)) return int(cudaErrorInvalidValue);
  const int nc = S / L, n_slices = (P * N + K2_SLICE - 1) / K2_SLICE;
  ssd_bwd_da_kernel<<<dim3(H, nc, B), K6_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d_intra), static_cast<const float*>(d_state),
      static_cast<const float*>(d_last), static_cast<float*>(da), S, H, L, round_up_tile(L), nc,
      n_slices);
  return int(cudaGetLastError());
}

// dynamic shared memory a block asks for: 0 the f32 state kernel, 1 the f32
// chunk kernel, 2 chunk_state, 3 dcb, 4 dx, 5 dbdc (bf16)
int ssd_scan_bwd_smem_bytes(int kernel) {
  const size_t bytes[6] = {ST_SMEM, CH_SMEM, K1_SMEM, K3_SMEM, K4_SMEM, K5_SMEM};
  return kernel >= 0 && kernel < 6 ? int(bytes[kernel]) : -1;
}

const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

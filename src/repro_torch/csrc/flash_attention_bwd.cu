// Flash attention backward (causal / sliding-window / GQA self-attention)
// for Hopper, sm_90a.
//
// The gradient of `flash_attention` (csrc/flash_attention.cu). The JAX
// package has no Pallas backward: above `attn_chunk` it differentiates its
// query-chunked, rematerialised attention (src/repro/models/attention.py,
// `gqa_attention_chunked`, jax.remat per query chunk), whose forward the
// port sends to the flash kernel; this is the port's counterpart of that
// gradient. q, o, dO, dq (B,S,H,D); k, v, dk, dv (B,S,KV,D), S == T,
// causal, optional window (key k is live for query s when k <= s and
// k > s - window); lse (B,H,S) f32 is the forward's natural-log
// log-sum-exp of each row's scaled scores (+inf for a row with no live
// key, which then gets zero gradient).
//
// FlashAttention-2's decomposition, deterministic and without atomics:
//   1. dsum  D = rowsum(dO o O) in f32, (B,H,S): one warp a row.
//   2. dk/dv one block per (64-key tile, KV head, b). It loops over the G
//      query heads of the group and over the query tiles that can see the
//      key tile (the forward's causal and window skips), recomputes
//      P = exp(S scale - lse) and accumulates dV += P^T dO and
//      dK += (P o (dP - D))^T Q scale in f32 registers. Summing the group
//      inside the block is what makes atomics unneeded for GQA.
//   3. dq    one block per (64-query tile, head, b); it loops over the
//      live key tiles and accumulates dQ += dS K scale.
// Key tiles (dk/dv) and query tiles (dq) run longest first under the
// causal mask so the diagonal leaves no tail.
//
// What bounds it: at qwen3-32b's training shape (B=2, S=4096, H=64, KV=8,
// D=128) the least work is 10 D operations per live (query, key) pair (the
// S recompute, dP, dV, dK, dQ: 2 D each), 1.375 TFLOP against ~0.61 GB in
// and out, so it is bound by arithmetic (1.39 ms at 989 TFLOP/s bf16).
// This first version runs every product on mma.sync m16n8k16 (bf16 in,
// f32 accumulate); wgmma with TMA-fed tiles, as the forward has, is the
// next step once its time is measured.
//
// bfloat16: 128 threads, four warps of 16 rows (keys in dk/dv, queries in
// dq). Operands go to shared memory by cp.async (rows padded by 16 bytes
// so ldmatrix rows fall on distinct banks), Q/dO (dk/dv) or K/V (dq) in a
// 2-stage ring. S^T and dP^T (dk/dv) or S and dP (dq) stay in registers;
// P and dS are rounded to bf16 in registers (as the forward rounds P) and
// reused as the A operand of the next product by the accumulator-to-A
// fragment identity of m16n8k16, so no P or dS passes through shared
// memory. dk/dv keeps a 16 x D f32 dK and dV a warp (D registers a thread
// for the two) and takes its 32-query stage 16 queries at a time; dq keeps
// a 16 x D dQ and takes its 64-key stage 32 keys at a time: so the scores
// and their gradients take 16 registers each and nothing spills at D = 128
// (255 registers and ~80 bytes of spills with the whole stage at once).
//
// head_dim 80 (h2o-danube-1.8b) is five k-steps of 16 and ten n8 tiles
// of the same m16n8k16 products, so every kernel takes it as it is: rows
// padded to 88 elements (176 bytes, still conflict-free for ldmatrix), dK
// and dV 80 registers a thread. Nothing is padded to 128. ptxas -v (nvcc
// 12.8, sm_90a) at D = 80: dk/dv 163 registers, dq 146, no spills.
//
// float32: the CUDA cores, so that f32 keeps f32 products (the tensor
// cores would round to TF32). 256 threads; the tiles sit in shared memory
// with odd row strides, each thread scores 8 (key, query) pairs and then
// owns one row's D/4 columns of the accumulators.
//
// Rows past S are zero-filled on load and never written. NEG_INF stays
// finite in the forward; here every dead pair is a select to exactly 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int DSUM_ROWS = 8;      // rows per dsum block: one warp each
constexpr int KB = 64;            // keys per dk/dv block (4 warps x 16)
constexpr int QB = 32;            // queries per step of the dk/dv loop
constexpr int QD = 64;            // queries per dq block (4 warps x 16)
constexpr int KD = 64;            // keys per step of the dq loop
constexpr int THREADS = 128;
constexpr int F_THREADS = 256;    // float32 kernels
constexpr int F_KB = 64, F_QB = 32;   // f32 dk/dv: keys per block, queries per step
constexpr int F_QD = 64, F_KD = 32;   // f32 dq: queries per block, keys per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool live(int qpos, int kpos, int S, int window) {
  return qpos < S && kpos <= qpos && (window < 0 || kpos > qpos - window);
}

// query rows [lo, hi) that see some key of [k0, k0 + n) (causal, window)
__device__ __forceinline__ int2 query_span(int k0, int n, int S, int window) {
  const int hi = window >= 0 ? min(S, k0 + n - 1 + window) : S;
  return make_int2(k0, hi);
}
// key rows [lo, hi) that some query of [q0, q0 + n) sees
__device__ __forceinline__ int2 key_span(int q0, int n, int S, int window) {
  const int lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  return make_int2(lo, min(S, q0 + n));
}

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
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// The accumulators of two neighbouring m16n8 tiles (n-tiles 2j, 2j + 1) as
// the A fragment of one m16k16 step: the m16n8k16 identity that lets a
// product's result feed the next product from registers.
__device__ __forceinline__ void to_a(const float* c0, const float* c1, uint32_t* a) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ldmatrix row addresses (lane -> row, column offset) for the fragments of
// m16n8k16: "qa" gives matrices (rows 0-7, +0), (rows 8-15, +0), (rows 0-7,
// +8), (rows 8-15, +8): an A operand stored row-major, or, with .trans, a
// B operand stored k-major as two n-tiles. "kb" gives (rows 0-7, +0),
// (rows 0-7, +8), (rows 8-15, +0), (rows 8-15, +8): a B operand stored
// n-major as two n-tiles. g4 / t2: the accumulator's row and column pair.
struct Lanes {
  int qa_row, qa_col, kb_row, kb_col, g4, t2;
  __device__ explicit Lanes(int lane)
      : qa_row((lane & 7) + ((lane >> 3) & 1) * 8), qa_col((lane >> 4) * 8),
        kb_row((lane & 7) + (lane >> 4) * 8), kb_col(((lane >> 3) & 1) * 8),
        g4(lane >> 2), t2((lane & 3) * 2) {}
};

// ---------------------------------------------------------------------------
// 1. dsum = rowsum(dO o O), (B,H,S) f32
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(32 * DSUM_ROWS)
flash_bwd_dsum_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
                      int S, int H, int D, long long rows) {
  const long long row = (long long)blockIdx.x * DSUM_ROWS + (threadIdx.x >> 5);   // (b, s, h)
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* op = o + row * D;
  const T* dp = dout + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f32(op[c]), to_f32(dp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = int(row % H);
    const long long bs = row / H;
    dsum[(bs / S * H + h) * S + bs % S] = acc;
  }
}

// ---------------------------------------------------------------------------
// 2. bfloat16 dk/dv
// ---------------------------------------------------------------------------
template <int D>
struct DkvSmem {                 // byte offsets
  static constexpr int RS = D + 8;                                    // padded row (elements)
  static constexpr size_t k = 0;                                      // [KB][RS] bf16
  static constexpr size_t v = k + size_t(KB) * RS * 2;                // [KB][RS]
  static constexpr size_t q = v + size_t(KB) * RS * 2;                // [2][QB][RS]
  static constexpr size_t dout = q + size_t(2) * QB * RS * 2;         // [2][QB][RS]
  static constexpr size_t lse = dout + size_t(2) * QB * RS * 2;       // [2][QB] f32, log2 units
  static constexpr size_t dsum = lse + size_t(2) * QB * 4;            // [2][QB] f32
  static constexpr size_t bytes = dsum + size_t(2) * QB * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int KV,
                      int window, float scale, float scale2, int B) {
  using L = DkvSmem<D>;
  constexpr int RS = L::RS, C8 = D / 8, NT = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Os = reinterpret_cast<bf16*>(smem + L::dout);
  float* Ls = reinterpret_cast<float*>(smem + L::lse);
  float* Ds = reinterpret_cast<float*>(smem + L::dsum);

  int x = blockIdx.x;
  const int kvh = x % KV;
  x /= KV;
  const int b = x % B;
  const int k0 = (x / B) * KB;          // key tile 0 sees the most queries: it runs first
  const int G = H / KV;
  const int2 qs = query_span(k0, KB, S, window);
  const int qt0 = qs.x / QB, n_qt = (qs.y + QB - 1) / QB - qt0;
  const int n_it = G * n_qt;            // (query head, query tile) steps

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const size_t krow = size_t(KV) * D, qrow = size_t(H) * D;
  const bf16* kb = k + (size_t(b) * S * KV + kvh) * D;
  const bf16* vb = v + (size_t(b) * S * KV + kvh) * D;
  for (int i = tid; i < KB * C8; i += THREADS) {
    const int r = i / C8, c = (i % C8) * 8, t = k0 + r;
    const bool in = t < S;
    const size_t off = size_t(in ? t : 0) * krow + c;
    cp_async16(smem_u32(Ks + r * RS + c), kb + off, in);
    cp_async16(smem_u32(Vs + r * RS + c), vb + off, in);
  }
  auto load_q = [&](int it, int buf) {
    const int h = kvh * G + it / n_qt, q0 = (qt0 + it % n_qt) * QB;
    const bf16* qb = q + (size_t(b) * S * H + h) * D;
    const bf16* ob = dout + (size_t(b) * S * H + h) * D;
    for (int i = tid; i < QB * C8; i += THREADS) {
      const int r = i / C8, c = (i % C8) * 8, s = q0 + r;
      const bool in = s < S;
      const size_t off = size_t(in ? s : 0) * qrow + c;
      cp_async16(smem_u32(Qs + (buf * QB + r) * RS + c), qb + off, in);
      cp_async16(smem_u32(Os + (buf * QB + r) * RS + c), ob + off, in);
    }
    if (tid < QB) {
      const int s = q0 + tid;
      const size_t li = (size_t(b) * H + h) * S + s;
      Ls[buf * QB + tid] = s < S ? lse[li] * LOG2E : 0.f;
      Ds[buf * QB + tid] = s < S ? dsum[li] : 0.f;
    }
  };
  cp_commit();
  if (n_it > 0) load_q(0, 0);
  cp_commit();

  const Lanes ln(lane);
  const int kw = 16 * w;                // this warp's 16 keys within the tile
  // ldmatrix addresses: this lane's row and column within a 16 x 16 block, in bytes
  const uint32_t qa_off = (ln.qa_row * RS + ln.qa_col) * 2, kb_off = (ln.kb_row * RS + ln.kb_col) * 2;
  const uint32_t k_a = smem_u32(Ks + kw * RS) + qa_off, v_a = smem_u32(Vs + kw * RS) + qa_off;
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) load_q(it + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int q0 = (qt0 + it % n_qt) * QB;
    const bf16* Qb = Qs + buf * QB * RS;
    const bf16* Ob = Os + buf * QB * RS;

    // 16 queries at a time (so S^T and dP^T take 16 registers, not 32):
    // S^T = K Q^T and dP^T = V dO^T, 16 keys x 16 queries a warp
#pragma unroll 1
    for (int hq = 0; hq < QB / 16; ++hq) {
      const uint32_t qb_addr = smem_u32(Qb + (hq * 16) * RS);
      const uint32_t ob_addr = smem_u32(Ob + (hq * 16) * RS);
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4], bq[4], bo[4];
        ldsm_x4(k_a + kk * 32, ak);
        ldsm_x4(v_a + kk * 32, av);
        ldsm_x4(qb_addr + kb_off + kk * 32, bq);
        ldsm_x4(ob_addr + kb_off + kk * 32, bo);
        mma16816(st[0], ak, bq[0], bq[1]);
        mma16816(st[1], ak, bq[2], bq[3]);
        mma16816(dpt[0], av, bo[0], bo[1]);
        mma16816(dpt[1], av, bo[2], bo[3]);
      }

      // P^T = exp2(S^T scale2 - lse2), dS^T = P^T o (dP^T - D); dead pairs exactly 0
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kw + ln.g4 + 8 * (e >> 1);
          const int ql = hq * 16 + n * 8 + ln.t2 + (e & 1);
          const bool ok = live(q0 + ql, key, S, window);
          const float p = ok ? fast_exp2(st[n][e] * scale2 - Ls[buf * QB + ql]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = ok ? p * (dpt[n][e] - Ds[buf * QB + ql]) : 0.f;
        }

      // dV += P^T dO, dK += dS^T Q (dO and Q as k-major B operands)
      uint32_t pa[4], da[4];
      to_a(st[0], st[1], pa);
      to_a(dpt[0], dpt[1], da);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(ob_addr + qa_off + nd * 32, bo);
        ldsm_x4_t(qb_addr + qa_off + nd * 32, bq);
        mma16816(dva[2 * nd], pa, bo[0], bo[1]);
        mma16816(dva[2 * nd + 1], pa, bo[2], bo[3]);
        mma16816(dka[2 * nd], da, bq[0], bq[1]);
        mma16816(dka[2 * nd + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();                    // this stage is read out before it is refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kw + ln.g4 + 8 * r;
    if (key >= S) continue;
    const size_t off = ((size_t(b) * S + key) * KV + kvh) * D + ln.t2;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
          __floats2bfloat162_rn(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. bfloat16 dq
// ---------------------------------------------------------------------------
template <int D>
struct DqSmem {                  // byte offsets
  static constexpr int RS = D + 8;
  static constexpr size_t q = 0;                                      // [QD][RS] bf16
  static constexpr size_t dout = q + size_t(QD) * RS * 2;             // [QD][RS]
  static constexpr size_t k = dout + size_t(QD) * RS * 2;             // [2][KD][RS]
  static constexpr size_t v = k + size_t(2) * KD * RS * 2;            // [2][KD][RS]
  static constexpr size_t bytes = v + size_t(2) * KD * RS * 2;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    bf16* __restrict__ dq, int S, int H, int KV, int window, float scale,
                    float scale2, int n_qt, int B) {
  using L = DqSmem<D>;
  constexpr int RS = L::RS, C8 = D / 8, NT = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Os = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);

  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int b = x % B;
  const int q0 = (n_qt - 1 - x / B) * QD;   // the last query tiles see the most keys: first
  const int kvh = h / (H / KV);
  const int2 ks = key_span(q0, QD, S, window);
  const int kt0 = ks.x / KD, n_kt = (ks.y + KD - 1) / KD - kt0;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const size_t krow = size_t(KV) * D, qrow = size_t(H) * D;
  const bf16* qb = q + (size_t(b) * S * H + h) * D;
  const bf16* ob = dout + (size_t(b) * S * H + h) * D;
  for (int i = tid; i < QD * C8; i += THREADS) {
    const int r = i / C8, c = (i % C8) * 8, s = q0 + r;
    const bool in = s < S;
    const size_t off = size_t(in ? s : 0) * qrow + c;
    cp_async16(smem_u32(Qs + r * RS + c), qb + off, in);
    cp_async16(smem_u32(Os + r * RS + c), ob + off, in);
  }
  const bf16* kb = k + (size_t(b) * S * KV + kvh) * D;
  const bf16* vb = v + (size_t(b) * S * KV + kvh) * D;
  auto load_kv = [&](int kt, int buf) {
    const int t0 = kt * KD;
    for (int i = tid; i < KD * C8; i += THREADS) {
      const int r = i / C8, c = (i % C8) * 8, t = t0 + r;
      const bool in = t < S;
      const size_t off = size_t(in ? t : 0) * krow + c;
      cp_async16(smem_u32(Ks + (buf * KD + r) * RS + c), kb + off, in);
      cp_async16(smem_u32(Vs + (buf * KD + r) * RS + c), vb + off, in);
    }
  };
  cp_commit();
  if (n_kt > 0) load_kv(kt0, 0);
  cp_commit();

  const Lanes ln(lane);
  const int qw = 16 * w;                // this warp's 16 queries within the tile
  const uint32_t qa_off = (ln.qa_row * RS + ln.qa_col) * 2, kb_off = (ln.kb_row * RS + ln.kb_col) * 2;
  const uint32_t q_a = smem_u32(Qs + qw * RS) + qa_off, o_a = smem_u32(Os + qw * RS) + qa_off;
  int rows[2];
  float lse2[2], dsr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = q0 + qw + ln.g4 + 8 * r;
    const size_t li = (size_t(b) * H + h) * S + rows[r];
    lse2[r] = rows[r] < S ? lse[li] * LOG2E : 0.f;
    dsr[r] = rows[r] < S ? dsum[li] : 0.f;
  }
  float dqa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int i = 0; i < n_kt; ++i) {
    const int buf = i & 1, t0 = (kt0 + i) * KD;
    if (i + 1 < n_kt) load_kv(kt0 + i + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* Kb = Ks + buf * KD * RS;
    const bf16* Vb = Vs + buf * KD * RS;

    // 32 keys at a time (so S and dP take 16 registers each):
    // S = Q K^T and dP = dO V^T, 16 queries x 32 keys a warp
#pragma unroll 1
    for (int kc = 0; kc < KD / 32; ++kc) {
      const uint32_t kb_addr = smem_u32(Kb + (kc * 32) * RS);
      const uint32_t vb_addr = smem_u32(Vb + (kc * 32) * RS);
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // by two, or whole where the step count is odd (D = 80): by two with a
      // remainder step, ptxas held dq<80> to 128 registers and spilled 4 bytes
#pragma unroll(D / 16 % 2 ? D / 16 : 2)
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t aq[4], ao[4];
        ldsm_x4(q_a + kk * 32, aq);
        ldsm_x4(o_a + kk * 32, ao);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bk[4], bv[4];
          ldsm_x4(kb_addr + np * 16 * RS * 2 + kb_off + kk * 32, bk);
          ldsm_x4(vb_addr + np * 16 * RS * 2 + kb_off + kk * 32, bv);
          mma16816(s[2 * np], aq, bk[0], bk[1]);
          mma16816(s[2 * np + 1], aq, bk[2], bk[3]);
          mma16816(dp[2 * np], ao, bv[0], bv[1]);
          mma16816(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
      }

      // dS = P o (dP - D), P = exp2(S scale2 - lse2); dead pairs exactly 0
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, key = t0 + kc * 32 + n * 8 + ln.t2 + (e & 1);
          const bool ok = live(rows[r], key, S, window);
          const float p = ok ? fast_exp2(s[n][e] * scale2 - lse2[r]) : 0.f;
          s[n][e] = ok ? p * (dp[n][e] - dsr[r]) : 0.f;
        }

      // dQ += dS K (K as the k-major B operand)
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
        uint32_t da[4];
        to_a(s[2 * kq], s[2 * kq + 1], da);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t bk[4];
          ldsm_x4_t(kb_addr + kq * 16 * RS * 2 + qa_off + nd * 32, bk);
          mma16816(dqa[2 * nd], da, bk[0], bk[1]);
          mma16816(dqa[2 * nd + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    bf16* out = dq + ((size_t(b) * S + rows[r]) * H + h) * D + ln.t2;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
          __floats2bfloat162_rn(dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
template <int D>
struct FDkvSmem {                // float offsets
  static constexpr int DP = D + 1;                  // odd row stride: no bank conflicts
  static constexpr int PS = F_QB + 1;
  static constexpr size_t k = 0, v = k + size_t(F_KB) * DP, q = v + size_t(F_KB) * DP;
  static constexpr size_t dout = q + size_t(F_QB) * DP, p = dout + size_t(F_QB) * DP;
  static constexpr size_t ds = p + size_t(F_KB) * PS, lse = ds + size_t(F_KB) * PS;
  static constexpr size_t dsum = lse + F_QB;
  static constexpr size_t bytes = (dsum + F_QB) * 4;
};

template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KV,
                          int window, float scale, float scale2, int B) {
  using L = FDkvSmem<D>;
  constexpr int DP = L::DP, PS = L::PS, DJ = D / 4;
  extern __shared__ __align__(16) float fsm[];
  float *Ks = fsm + L::k, *Vs = fsm + L::v, *Qs = fsm + L::q, *Os = fsm + L::dout;
  float *Ps = fsm + L::p, *DSs = fsm + L::ds, *Ls = fsm + L::lse, *Ds = fsm + L::dsum;

  int x = blockIdx.x;
  const int kvh = x % KV;
  x /= KV;
  const int b = x % B;
  const int k0 = (x / B) * F_KB;
  const int G = H / KV;
  const int2 qs = query_span(k0, F_KB, S, window);
  const int tid = threadIdx.x;
  const size_t krow = size_t(KV) * D, qrow = size_t(H) * D;
  const float* kb = k + (size_t(b) * S * KV + kvh) * D;
  const float* vb = v + (size_t(b) * S * KV + kvh) * D;
  for (int i = tid; i < F_KB * D; i += F_THREADS) {
    const int r = i / D, c = i % D, t = k0 + r;
    Ks[r * DP + c] = t < S ? kb[size_t(t) * krow + c] : 0.f;
    Vs[r * DP + c] = t < S ? vb[size_t(t) * krow + c] : 0.f;
  }
  const int sk = tid & 63, sq = tid >> 6;       // scoring: key sk, queries sq + 4 i
  const int ak = tid >> 2, ad = tid & 3;        // accumulating: key ak, columns ad + 4 j
  float dka[DJ], dva[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dka[j] = dva[j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qb = q + (size_t(b) * S * H + h) * D;
    const float* ob = dout + (size_t(b) * S * H + h) * D;
    for (int q0 = qs.x / F_QB * F_QB; q0 < qs.y; q0 += F_QB) {
      __syncthreads();                          // the previous step is read out
      for (int i = tid; i < F_QB * D; i += F_THREADS) {
        const int r = i / D, c = i % D, s = q0 + r;
        Qs[r * DP + c] = s < S ? qb[size_t(s) * qrow + c] : 0.f;
        Os[r * DP + c] = s < S ? ob[size_t(s) * qrow + c] : 0.f;
      }
      if (tid < F_QB) {
        const int s = q0 + tid;
        const size_t li = (size_t(b) * H + h) * S + s;
        Ls[tid] = s < S ? lse[li] * LOG2E : 0.f;
        Ds[tid] = s < S ? dsum[li] : 0.f;
      }
      __syncthreads();
      float sa[F_QB / 4], pa[F_QB / 4];
#pragma unroll
      for (int i = 0; i < F_QB / 4; ++i) sa[i] = pa[i] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float kv = Ks[sk * DP + c], vv = Vs[sk * DP + c];
#pragma unroll
        for (int i = 0; i < F_QB / 4; ++i) {
          sa[i] = fmaf(Qs[(sq + 4 * i) * DP + c], kv, sa[i]);
          pa[i] = fmaf(Os[(sq + 4 * i) * DP + c], vv, pa[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < F_QB / 4; ++i) {
        const int ql = sq + 4 * i;
        const bool ok = live(q0 + ql, k0 + sk, S, window);
        const float p = ok ? exp2f(sa[i] * scale2 - Ls[ql]) : 0.f;
        Ps[sk * PS + ql] = p;
        DSs[sk * PS + ql] = ok ? p * (pa[i] - Ds[ql]) : 0.f;
      }
      __syncthreads();
      // each step's sum apart, then added to the running one: a key sums over
      // up to G S queries, and one running f32 sum would round at every term
      float sv[DJ], sk[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) sv[j] = sk[j] = 0.f;
#pragma unroll 4
      for (int ql = 0; ql < F_QB; ++ql) {
        const float p = Ps[ak * PS + ql], ds = DSs[ak * PS + ql];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          sv[j] = fmaf(p, Os[ql * DP + ad + 4 * j], sv[j]);
          sk[j] = fmaf(ds, Qs[ql * DP + ad + 4 * j], sk[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dva[j] += sv[j];
        dka[j] += sk[j];
      }
    }
  }
  const int key = k0 + ak;
  if (key < S) {
    const size_t off = ((size_t(b) * S + key) * KV + kvh) * D + ad;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + 4 * j] = dka[j] * scale;
      dv[off + 4 * j] = dva[j];
    }
  }
}

template <int D>
struct FDqSmem {                 // float offsets
  static constexpr int DP = D + 1;
  static constexpr int PS = F_KD + 1;
  static constexpr size_t q = 0, dout = q + size_t(F_QD) * DP, k = dout + size_t(F_QD) * DP;
  static constexpr size_t v = k + size_t(F_KD) * DP, ds = v + size_t(F_KD) * DP;
  static constexpr size_t lse = ds + size_t(F_QD) * PS, dsum = lse + F_QD;
  static constexpr size_t bytes = (dsum + F_QD) * 4;
};

template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        float* __restrict__ dq, int S, int H, int KV, int window, float scale,
                        float scale2, int n_qt, int B) {
  using L = FDqSmem<D>;
  constexpr int DP = L::DP, PS = L::PS, DJ = D / 4;
  extern __shared__ __align__(16) float fsm[];
  float *Qs = fsm + L::q, *Os = fsm + L::dout, *Ks = fsm + L::k, *Vs = fsm + L::v;
  float *DSs = fsm + L::ds, *Ls = fsm + L::lse, *Ds = fsm + L::dsum;

  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int b = x % B;
  const int q0 = (n_qt - 1 - x / B) * F_QD;
  const int kvh = h / (H / KV);
  const int2 ks = key_span(q0, F_QD, S, window);
  const int tid = threadIdx.x;
  const size_t krow = size_t(KV) * D, qrow = size_t(H) * D;
  const float* qb = q + (size_t(b) * S * H + h) * D;
  const float* ob = dout + (size_t(b) * S * H + h) * D;
  for (int i = tid; i < F_QD * D; i += F_THREADS) {
    const int r = i / D, c = i % D, s = q0 + r;
    Qs[r * DP + c] = s < S ? qb[size_t(s) * qrow + c] : 0.f;
    Os[r * DP + c] = s < S ? ob[size_t(s) * qrow + c] : 0.f;
  }
  if (tid < F_QD) {
    const int s = q0 + tid;
    const size_t li = (size_t(b) * H + h) * S + s;
    Ls[tid] = s < S ? lse[li] * LOG2E : 0.f;
    Ds[tid] = s < S ? dsum[li] : 0.f;
  }
  const float* kb = k + (size_t(b) * S * KV + kvh) * D;
  const float* vb = v + (size_t(b) * S * KV + kvh) * D;
  const int sq = tid & 63, sk = tid >> 6;       // scoring: query sq, keys sk + 4 i
  const int aq = tid >> 2, ad = tid & 3;        // accumulating: query aq, columns ad + 4 j
  float dqa[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dqa[j] = 0.f;

  for (int t0 = ks.x / F_KD * F_KD; t0 < ks.y; t0 += F_KD) {
    __syncthreads();
    for (int i = tid; i < F_KD * D; i += F_THREADS) {
      const int r = i / D, c = i % D, t = t0 + r;
      Ks[r * DP + c] = t < S ? kb[size_t(t) * krow + c] : 0.f;
      Vs[r * DP + c] = t < S ? vb[size_t(t) * krow + c] : 0.f;
    }
    __syncthreads();
    float sa[F_KD / 4], pa[F_KD / 4];
#pragma unroll
    for (int i = 0; i < F_KD / 4; ++i) sa[i] = pa[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float qv = Qs[sq * DP + c], ov = Os[sq * DP + c];
#pragma unroll
      for (int i = 0; i < F_KD / 4; ++i) {
        sa[i] = fmaf(qv, Ks[(sk + 4 * i) * DP + c], sa[i]);
        pa[i] = fmaf(ov, Vs[(sk + 4 * i) * DP + c], pa[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < F_KD / 4; ++i) {
      const int kl = sk + 4 * i;
      const bool ok = live(q0 + sq, t0 + kl, S, window);
      const float p = ok ? exp2f(sa[i] * scale2 - Ls[sq]) : 0.f;
      DSs[sq * PS + kl] = ok ? p * (pa[i] - Ds[sq]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kl = 0; kl < F_KD; ++kl) {
      const float ds = DSs[aq * PS + kl];
#pragma unroll
      for (int j = 0; j < DJ; ++j) dqa[j] = fmaf(ds, Ks[kl * DP + ad + 4 * j], dqa[j]);
    }
  }
  const int s = q0 + aq;
  if (s < S) {
    float* out = dq + ((size_t(b) * S + s) * H + h) * D + ad;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[4 * j] = dqa[j] * scale;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T>
cudaError_t launch_dsum(const void* o, const void* dout, float* dsum, int B, int S, int H, int D,
                        cudaStream_t st) {
  const long long rows = (long long)B * S * H;
  const long long blocks = (rows + DSUM_ROWS - 1) / DSUM_ROWS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dsum_kernel<T><<<unsigned(blocks), 32 * DSUM_ROWS, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dsum, S, H, D, rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* dsum, void* dq, void* dk, void* dv, int B,
                        int S, int H, int KV, int window, float scale, cudaStream_t st) {
  const float scale2 = scale * LOG2E;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* op = static_cast<const bf16*>(dout);
  const long long kv_blocks = (long long)((S + KB - 1) / KB) * KV * B;
  const int n_qt = (S + QD - 1) / QD;
  const long long q_blocks = (long long)n_qt * H * B;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(flash_bwd_dkdv_kernel<D>, DkvSmem<D>::bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D><<<unsigned(kv_blocks), THREADS, DkvSmem<D>::bytes, st>>>(
      qp, kp, vp, op, lse, dsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, KV,
      window, scale, scale2, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(flash_bwd_dq_kernel<D>, DqSmem<D>::bytes)) != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<unsigned(q_blocks), THREADS, DqSmem<D>::bytes, st>>>(
      qp, kp, vp, op, lse, dsum, static_cast<bf16*>(dq), S, H, KV, window, scale, scale2, n_qt,
      B);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* dsum, void* dq, void* dk, void* dv, int B,
                       int S, int H, int KV, int window, float scale, cudaStream_t st) {
  const float scale2 = scale * LOG2E;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* op = static_cast<const float*>(dout);
  const long long kv_blocks = (long long)((S + F_KB - 1) / F_KB) * KV * B;
  const int n_qt = (S + F_QD - 1) / F_QD;
  const long long q_blocks = (long long)n_qt * H * B;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(flash_bwd_dkdv_f32_kernel<D>, FDkvSmem<D>::bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_f32_kernel<D><<<unsigned(kv_blocks), F_THREADS, FDkvSmem<D>::bytes, st>>>(
      qp, kp, vp, op, lse, dsum, static_cast<float*>(dk), static_cast<float*>(dv), S, H, KV,
      window, scale, scale2, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(flash_bwd_dq_f32_kernel<D>, FDqSmem<D>::bytes)) != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<D><<<unsigned(q_blocks), F_THREADS, FDqSmem<D>::bytes, st>>>(
      qp, kp, vp, op, lse, dsum, static_cast<float*>(dq), S, H, KV, window, scale, scale2, n_qt,
      B);
  return cudaGetLastError();
}

// dynamic shared memory of one block: kernel 0 = dk/dv, 1 = dq
template <int D>
int bwd_smem(int dtype, int kernel) {
  if (dtype == 1) return int(kernel == 0 ? DkvSmem<D>::bytes : DqSmem<D>::bytes);
  return int(kernel == 0 ? FDkvSmem<D>::bytes : FDqSmem<D>::bytes);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D = 64, 80 or 128. Causal self-attention:
// q, o, dout, dq (B,S,H,D); k, v, dk, dv (B,S,KV,D); lse and the scratch
// dsum (B,H,S) float32. window < 0 means no window. All tensors contiguous
// and 16-byte aligned. Runs three kernels on `stream`; returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* dsum, void* dq, void* dk,
                        void* dv, int B, int S, int H, int KV, int D, int dtype, int window,
                        float scale, void* stream) {
  if (S <= 0 || B <= 0) return int(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || (D != 64 && D != 80 && D != 128) || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  cudaError_t err = dtype == 1 ? launch_dsum<bf16>(o, dout, ds, B, S, H, D, st)
                               : launch_dsum<float>(o, dout, ds, B, S, H, D, st);
  if (err != cudaSuccess) return int(err);
#define BWD_ARGS q, k, v, dout, lp, ds, dq, dk, dv, B, S, H, KV, window, scale, st
  if (dtype == 1 && D == 64) return int(launch_bf16<64>(BWD_ARGS));
  if (dtype == 1 && D == 80) return int(launch_bf16<80>(BWD_ARGS));
  if (dtype == 1) return int(launch_bf16<128>(BWD_ARGS));
  if (D == 64) return int(launch_f32<64>(BWD_ARGS));
  if (D == 80) return int(launch_f32<80>(BWD_ARGS));
  return int(launch_f32<128>(BWD_ARGS));
#undef BWD_ARGS
}

// Dynamic shared memory of one block, in bytes: kernel 0 = dk/dv, 1 = dq.
int flash_attention_bwd_smem_bytes(int dtype, int D, int kernel) {
  if (D == 64) return bwd_smem<64>(dtype, kernel);
  if (D == 80) return bwd_smem<80>(dtype, kernel);
  if (D == 128) return bwd_smem<128>(dtype, kernel);
  return -1;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Flash attention forward (causal / sliding-window / GQA) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_flash_kernel` behind `flash_attention`
// in src/repro/kernels/flash_attention.py. Same function: q (B,S,H,D),
// k/v (B,T,KV,D) -> o (B,S,H,D) in q's type, KV head h / (H/KV), scale
// applied to the scores, an online softmax with a running max, a running
// sum and an f32 accumulator, rows with no live key written as 0, and KV
// tiles wholly above the causal diagonal or left of the window skipped.
//
// What bounds it on this card: at prefill shapes (S = T = 4096, D = 128)
// attention does ~4*S*T*D/2 operations per head against 2*(S+T)*D bytes,
// far above the H100's ~295 operations per byte, so it is bound by
// arithmetic, and the arithmetic has to run on the tensor cores. In both
// paths below a block owns one (b, h, 64-row query tile) and walks its
// reachable 64-key tiles in a loop (the TPU's sequential KV grid axis),
// with K and V tiles in shared memory.
//
// bfloat16 (the serving path): tensor cores through WMMA (mma.sync,
// 16x16x16, f32 accumulate). Each of 4 warps owns 16 query rows and keeps
// its Q fragments in registers; S = Q K^T goes through shared memory to
// the online softmax (two lanes per row), P is rounded to bf16 (as the
// JAX reference rounds its weights) for P V, and each lane keeps half of
// its row's output in f32 registers, rescaled per tile. Moving the
// products onto wgmma with TMA-fed, double-buffered tiles is left to a
// later change.
//
// float32: the CUDA cores, so that f32 keeps f32 products (tensor cores
// would round to TF32). Q and K tiles sit transposed in shared memory so
// each of 128 threads reads its 4 query rows and 8 keys as float4s, P is
// staged transposed for the PV product, and each thread keeps a 4x8 score
// tile and a 4x(D/8) output tile in registers.
//
// Scores are kept in base-2 units (scale * log2 e) so the exponentials
// are exp2f.
//
// NEG_INF is finite (-2e38), as in the TPU kernel: a fully masked tile seen
// before the first live one contributes exp2(0) = 1 per key to the running
// sum, and the first live tile's rescale exp2(NEG_INF - m) = 0 wipes it.
// With -inf that would be NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NT = 128;      // threads: 16 row groups x 8 key groups
constexpr int RM = 4;        // query rows per thread
constexpr int CN = 8;        // keys per thread in the score tile
constexpr int QP = BQ + 4;   // padded row length of the transposed Q and P tiles
constexpr int KP = BK + 4;   // padded row length of the transposed K tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(D) * QP + size_t(D) * KP + size_t(BK) * D + size_t(BK) * QP);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int Tk, int H, int KV, int causal, int window,
                 float scale2) {
  constexpr int DV = D / 32;   // float4 output chunks per thread (dims tx*4 + 32*j)
  extern __shared__ __align__(16) float smem[];
  float* QsT = smem;             // [D][QP]  Q tile transposed, pre-scaled
  float* KsT = QsT + D * QP;     // [D][KP]  K tile transposed
  float* Vs = KsT + D * KP;      // [BK][D]
  float* PsT = Vs + BK * D;      // [BK][QP] probabilities transposed

  const int tid = threadIdx.x;
  const int ty = tid >> 3;       // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 7;        // key group: keys tx*8 .. tx*8+7; dims tx*4 + 32*j
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const size_t q_row = size_t(H) * D;
  const size_t k_row = size_t(KV) * D;
  const T* qb = q + (size_t(b) * S * H + h) * D;
  const T* kb = k + (size_t(b) * Tk * KV + kvh) * D;
  const T* vb = v + (size_t(b) * Tk * KV + kvh) * D;
  T* ob = o + (size_t(b) * S * H + h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, s = q0 + r;
    QsT[c * QP + r] = s < S ? to_f32(qb[size_t(s) * q_row + c]) * scale2 : 0.f;
  }

  float m[RM], l[RM], acc[RM][DV][4];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;
  }

  // KV tiles reachable from this query tile (the TPU kernel's skip rule)
  int kb_end = (Tk + BK - 1) / BK;
  if (causal) kb_end = min(kb_end, (q0 + BQ - 1) / BK + 1);
  int kb_begin = 0;
  if (window >= 0) {
    const int lo = q0 - window - BK + 2;     // a live tile has k_start >= lo
    if (lo > 0) kb_begin = (lo + BK - 1) / BK;
  }

  for (int kbi = kb_begin; kbi < kb_end; ++kbi) {
    const int k0 = kbi * BK;
    __syncthreads();                         // previous tile consumed; Q stored
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, t = k0 + r;
      const bool in = t < Tk;
      KsT[c * KP + r] = in ? to_f32(kb[size_t(t) * k_row + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[size_t(t) * k_row + c]) : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(&QsT[c * QP + ty * RM]);
      const float4 ka = *reinterpret_cast<const float4*>(&KsT[c * KP + tx * CN]);
      const float4 kc = *reinterpret_cast<const float4*>(&KsT[c * KP + tx * CN + 4]);
      const float qr[RM] = {qv.x, qv.y, qv.z, qv.w};
      const float kr[CN] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[r][j] = fmaf(qr[r], kr[j], s[r][j]);
    }

    float p_out[CN][RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int qpos = q0 + ty * RM + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx * CN + j;
        bool ok = kpos < Tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window >= 0) ok = ok && kpos > qpos - window;
        s[r][j] = ok ? s[r][j] : NEG_INF;
        mx = fmaxf(mx, s[r][j]);
      }
      // the 8 threads of a row group are 8 consecutive lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = exp2f(s[r][j] - m_new);
        p_out[j][r] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][j][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < CN; ++j)
      *reinterpret_cast<float4*>(&PsT[(tx * CN + j) * QP + ty * RM]) =
          make_float4(p_out[j][0], p_out[j][1], p_out[j][2], p_out[j][3]);
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      const float4 pv = *reinterpret_cast<const float4*>(&PsT[t * QP + ty * RM]);
      const float pr[RM] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < DV; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[t * D + tx * 4 + 32 * j]);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          acc[r][j][0] = fmaf(pr[r], vv.x, acc[r][j][0]);
          acc[r][j][1] = fmaf(pr[r], vv.y, acc[r][j][1]);
          acc[r][j][2] = fmaf(pr[r], vv.z, acc[r][j][2]);
          acc[r][j][3] = fmaf(pr[r], vv.w, acc[r][j][3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int s = q0 + ty * RM + r;
    if (s >= S) continue;
    const float denom = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int j = 0; j < DV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[size_t(s) * q_row + tx * 4 + 32 * j + e] = from_f32<T>(acc[r][j][e] / denom);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through WMMA
// ---------------------------------------------------------------------------
namespace wmma = nvcuda::wmma;
constexpr int TC_NT = 128;   // 4 warps x 16 query rows = BQ

template <int D>
struct TcSmem {              // byte offsets; every fragment pointer is 32-byte aligned
  static constexpr int QL = D + 8;   // bf16 row stride of the Q, K and V tiles
  static constexpr int SL = BK + 4;  // f32 row stride of the score tile
  static constexpr int PL = BK + 8;  // bf16 row stride of the probability tile
  static constexpr int OL = D + 4;   // f32 row stride of the P V tile
  static constexpr size_t q = 0;
  static constexpr size_t k = q + size_t(BQ) * QL * 2;
  static constexpr size_t v = k + size_t(BK) * QL * 2;
  static constexpr size_t s = v + size_t(BK) * QL * 2;
  static constexpr size_t p = s + size_t(BQ) * SL * 4;
  static constexpr size_t o = p + size_t(BQ) * PL * 2;
  static constexpr size_t bytes = o + size_t(BQ) * OL * 4;
};

template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                    int Tk, int H, int KV, int causal, int window, float scale2) {
  using L = TcSmem<D>;
  constexpr int QL = L::QL, SL = L::SL, PL = L::PL, OL = L::OL;
  constexpr int CH = D / 8;          // 16-byte chunks of a row
  constexpr int OH = D / 2;          // output columns per lane: 2*i + side
  extern __shared__ __align__(128) unsigned char smem_tc[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::v);
  float* Sf = reinterpret_cast<float*>(smem_tc + L::s);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::p);
  float* Of = reinterpret_cast<float*>(smem_tc + L::o);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_row = size_t(H) * D;
  const size_t k_row = size_t(KV) * D;
  const __nv_bfloat16* qb = q + (size_t(b) * S * H + h) * D;
  const __nv_bfloat16* kb = k + (size_t(b) * Tk * KV + kvh) * D;
  const __nv_bfloat16* vb = v + (size_t(b) * Tk * KV + kvh) * D;
  __nv_bfloat16* ob = o + (size_t(b) * S * H + h) * D;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BQ * CH; i += TC_NT) {
    const int r = i / CH, c = (i % CH) * 8, s = q0 + r;
    *reinterpret_cast<uint4*>(&Qs[r * QL + c]) =
        s < S ? *reinterpret_cast<const uint4*>(qb + size_t(s) * q_row + c) : zero4;
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * QL + kk * 16, QL);

  // softmax and output ownership: lane -> row r of this warp and one half (side) of its
  // keys and output columns
  const int r = lane >> 1, side = lane & 1;
  const int qpos = q0 + warp * 16 + r;
  float m = NEG_INF, l = 0.f, acc[OH];
#pragma unroll
  for (int i = 0; i < OH; ++i) acc[i] = 0.f;

  int kb_end = (Tk + BK - 1) / BK;
  if (causal) kb_end = min(kb_end, (q0 + BQ - 1) / BK + 1);
  int kb_begin = 0;
  if (window >= 0) {
    const int lo = q0 - window - BK + 2;     // a live tile has k_start >= lo
    if (lo > 0) kb_begin = (lo + BK - 1) / BK;
  }

  for (int kbi = kb_begin; kbi < kb_end; ++kbi) {
    const int k0 = kbi * BK;
    __syncthreads();                         // previous tile's K, V consumed
    for (int i = tid; i < BK * CH; i += TC_NT) {
      const int rr = i / CH, c = (i % CH) * 8, t = k0 + rr;
      const bool in = t < Tk;
      *reinterpret_cast<uint4*>(&Ks[rr * QL + c]) =
          in ? *reinterpret_cast<const uint4*>(kb + size_t(t) * k_row + c) : zero4;
      *reinterpret_cast<uint4*>(&Vs[rr * QL + c]) =
          in ? *reinterpret_cast<const uint4*>(vb + size_t(t) * k_row + c) : zero4;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows, into shared memory
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * QL + kk * 16, QL);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(Sf + warp * 16 * SL + n * 16, sf, SL, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the lane's 32 keys; the row's two lanes are neighbours
    const float* srow = Sf + (warp * 16 + r) * SL + side * 32;
    float sv[32];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kpos = k0 + side * 32 + j;
      bool ok = kpos < Tk;
      if (causal) ok = ok && kpos <= qpos;
      if (window >= 0) ok = ok && kpos > qpos - window;
      sv[j] = ok ? srow[j] * scale2 : NEG_INF;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    float sum = 0.f;
    __nv_bfloat16* prow = Ps + (warp * 16 + r) * PL + side * 32;
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const float p0 = exp2f(sv[j] - m_new), p1 = exp2f(sv[j + 1] - m_new);
      sum += p0 + p1;
      *reinterpret_cast<__nv_bfloat162*>(prow + j) = __floats2bfloat162_rn(p0, p1);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < OH; ++i) acc[i] *= alpha;
    __syncwarp();

    // P V for this warp's rows, into shared memory, then into the lane's registers
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + warp * 16 * PL + kk * 16, PL);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * QL + n * 16, QL);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(Of + warp * 16 * OL + n * 16, of, OL, wmma::mem_row_major);
    }
    __syncwarp();
    const float* orow = Of + (warp * 16 + r) * OL;
#pragma unroll
    for (int i = 0; i < OH; ++i) acc[i] += orow[2 * i + side];
  }

  if (qpos < S) {
    const float denom = l > 0.f ? l : 1.f;
#pragma unroll
    for (int i = 0; i < OH; ++i)
      ob[size_t(qpos) * q_row + 2 * i + side] = __float2bfloat16(acc[i] / denom);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int Tk, int H, int KV, int causal, int window, float scale,
                      cudaStream_t stream) {
  const size_t smem = TcSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_tc_kernel<D><<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, Tk, H, KV,
      causal, window, scale * LOG2E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
                   int H, int KV, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Tk, H, KV, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window < 0 means no window. All tensors
// contiguous and 16-byte aligned: q/o (B,S,H,D), k/v (B,T,KV,D). Returns a
// cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int Tk, int H, int KV, int D, int dtype, int causal, int window,
                        float scale, void* stream) {
  if (S <= 0 || B <= 0) return int(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 1 && D == 64)
    return launch_tc<64>(q, k, v, o, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 1 && D == 128)
    return launch_tc<128>(q, k, v, o, B, S, Tk, H, KV, causal, window, scale, st);
  return int(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

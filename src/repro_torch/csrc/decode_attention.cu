// Decode attention (one new token against a KV cache) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_decode_kernel` behind `decode_attention`
// in src/repro/kernels/decode_attention.py. Same function: q (B,1,H,D)
// against a (B,T,KV,D) cache, keys kpos < cache_len[b] live, and with a
// window only kpos > cache_len[b] - 1 - window; an online softmax in f32;
// KV tiles at or past the valid length skipped; a row with no live key
// written as 0.
//
// What bounds it on this card: each cache row is read once and used for
// only G = H/KV heads, ~4*G operations per 4 bytes of K and V, so decode is
// bound by memory bytes. The design answer is to read each K/V row once for
// the whole GQA group: one block per (b, KV head, group of up to 8 query
// heads) stages tiles of BK keys of K and V in shared memory (BK = 128 for
// D = 64 and 128; BK = 64 for D = 256, where 128 f32 keys of K and V would
// need ~279 KB, more than a block may have), NT/BK threads share a key
// (their parts add by shuffles) and score it for all the group's heads, one
// warp per head runs the online softmax on the tile, and each thread
// accumulates a float4 slice of the output for all heads over a strided
// subset of the tile's keys; the subsets are summed through shared memory
// at the end. `cache_len` is read inside the block.
// This version has B*KV*ceil(G/8) blocks (32 at qwen3-32b, batch 4; 8 at
// recurrentgemma-9b's MQA, batch 4), fewer than the card's 132 SMs:
// splitting the keys across blocks and merging the partial softmaxes is
// left to a later change.
//
// NEG_INF is finite (-2e38), as in the TPU kernel, so that a fully masked
// tile never produces NaN (see flash_attention.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 256;   // threads per block
constexpr int GC = 8;     // query heads per block (one warp each in the softmax)

// keys per tile: 128 (two threads a key in the score step), 64 at D = 256
template <int D> constexpr int key_tile() { return D == 256 ? 64 : 128; }

// 8 consecutive elements to f32; the pointer is 16-byte aligned
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D, int BK>
constexpr size_t smem_bytes() {
  // Q, K (rows padded by 8), V, P, and the running max / sum / rescale
  return sizeof(float) *
         (size_t(GC) * D + size_t(BK) * (D + 8) + size_t(BK) * D + size_t(GC) * BK + 3 * GC);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int32_t* __restrict__ cache_len, T* __restrict__ o, int Tk, int H, int KV,
              int window, float scale2) {
  constexpr int KS = D + 8;          // padded K row: conflict-free float4 reads
  constexpr int NCH = D / 4;         // float4 chunks of an output row
  constexpr int NKS = NT / NCH;      // key subsets in the PV step
  constexpr int TPK = NT / BK;       // threads sharing a key in the score step
  static_assert(NKS * GC * D <= BK * KS, "reduction buffer must fit in the K tile");
  static_assert(BK % 32 == 0 && D % (4 * TPK) == 0, "tile shapes");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [GC][D] pre-scaled
  float* Ks = Qs + GC * D;           // [BK][KS]
  float* Vs = Ks + BK * KS;          // [BK][D]
  float* Ps = Vs + BK * D;           // [GC][BK]
  float* mrow = Ps + GC * BK;        // [GC] running max (base-2 units)
  float* lrow = mrow + GC;           // [GC] running sum
  float* arow = lrow + GC;           // [GC] this tile's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g0 = blockIdx.x * GC;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int gc = min(GC, G - g0);
  const int h0 = kvh * G + g0;       // first query head of this block

  int valid = cache_len[b];
  valid = valid < Tk ? valid : Tk;
  const size_t k_row = size_t(KV) * D;
  const T* kb = kc + (size_t(b) * Tk * KV + kvh) * D;
  const T* vb = vc + (size_t(b) * Tk * KV + kvh) * D;

  for (int i = tid; i < GC * D; i += NT) {
    const int g = i / D, c = i % D;
    Qs[i] = g < gc ? to_f32(q[(size_t(b) * H + h0 + g) * D + c]) * scale2 : 0.f;
  }
  if (tid < GC) {
    mrow[tid] = NEG_INF;
    lrow[tid] = 0.f;
  }

  const int key = tid / TPK, part_id = tid % TPK;   // score step
  const int chunk = tid % NCH, ks = tid / NCH;   // PV step
  float acc[GC][4];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;

  int lo = 0;
  if (window >= 0) lo = max(valid - window, 0);   // first live key
  for (int t0 = (lo / BK) * BK; t0 < valid; t0 += BK) {
    __syncthreads();                              // previous tile consumed
    for (int i = tid; i < BK * (D / 8); i += NT) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8, t = t0 + r;
      float kk[8], vv[8];
      if (t < valid) {
        load8(kb + size_t(t) * k_row + c, kk);
        load8(vb + size_t(t) * k_row + c, vv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kk[e] = vv[e] = 0.f;
      }
      *reinterpret_cast<float4*>(&Ks[r * KS + c]) = make_float4(kk[0], kk[1], kk[2], kk[3]);
      *reinterpret_cast<float4*>(&Ks[r * KS + c + 4]) = make_float4(kk[4], kk[5], kk[6], kk[7]);
      *reinterpret_cast<float4*>(&Vs[r * D + c]) = make_float4(vv[0], vv[1], vv[2], vv[3]);
      *reinterpret_cast<float4*>(&Vs[r * D + c + 4]) = make_float4(vv[4], vv[5], vv[6], vv[7]);
    }
    __syncthreads();

    // scores: this thread's key against every head, over its share of the dims
    float part[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) part[g] = 0.f;
#pragma unroll 4
    for (int i = 0; i < D / (4 * TPK); ++i) {
      const int c = (TPK * i + part_id) * 4;
      const float4 k4 = *reinterpret_cast<const float4*>(&Ks[key * KS + c]);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float4 q4 = *reinterpret_cast<const float4*>(&Qs[g * D + c]);
        part[g] = fmaf(q4.x, k4.x, fmaf(q4.y, k4.y, fmaf(q4.z, k4.z, fmaf(q4.w, k4.w, part[g]))));
      }
    }
    const int kpos = t0 + key;
    bool ok = kpos < valid;
    if (window >= 0) ok = ok && kpos > valid - 1 - window;
#pragma unroll
    for (int g = 0; g < GC; ++g) {
#pragma unroll
      for (int off = 1; off < TPK; off <<= 1)
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (part_id == 0) Ps[g * BK + key] = ok ? part[g] : NEG_INF;
    }
    __syncthreads();

    // online softmax: warp w owns head w
    if (warp < gc) {
      float s[BK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        s[e] = Ps[warp * BK + lane + 32 * e];
        mx = fmaxf(mx, s[e]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = mrow[warp];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const float p = exp2f(s[e] - m_new);
        Ps[warp * BK + lane + 32 * e] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        arow[warp] = alpha;
        lrow[warp] = lrow[warp] * alpha + sum;
        mrow[warp] = m_new;
      }
    }
    __syncthreads();

    // PV: this thread's float4 slice of every head's output, keys ks, ks+NKS, ...
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < gc) {
        const float a = arow[g];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] *= a;
      }
    }
    for (int t = ks; t < BK; t += NKS) {
      const float4 v4 = *reinterpret_cast<const float4*>(&Vs[t * D + chunk * 4]);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g < gc) {
          const float p = Ps[g * BK + t];
          acc[g][0] = fmaf(p, v4.x, acc[g][0]);
          acc[g][1] = fmaf(p, v4.y, acc[g][1]);
          acc[g][2] = fmaf(p, v4.z, acc[g][2]);
          acc[g][3] = fmaf(p, v4.w, acc[g][3]);
        }
      }
    }
  }

  // sum the key subsets through shared memory (reusing the K tile)
  __syncthreads();
  float* red = Ks;   // [NKS][GC][D]
#pragma unroll
  for (int g = 0; g < GC; ++g)
    *reinterpret_cast<float4*>(&red[(ks * GC + g) * D + chunk * 4]) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();
  for (int i = tid; i < gc * D; i += NT) {
    const int g = i / D, d = i % D;
    float sum = 0.f;
    for (int j = 0; j < NKS; ++j) sum += red[(j * GC + g) * D + d];
    const float l = lrow[g];
    o[(size_t(b) * H + h0 + g) * D + d] = from_f32<T>(sum / (l > 0.f ? l : 1.f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lens, void* o,
                   int B, int Tk, int H, int KV, int window, float scale, cudaStream_t stream) {
  constexpr int BK = key_tile<D>();
  constexpr size_t smem = smem_bytes<D, BK>();
  static_assert(smem <= 232448, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, D, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  const dim3 grid((G + GC - 1) / GC, KV, B);
  decode_kernel<T, D, BK><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(lens), static_cast<T*>(o), Tk, H, KV, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window < 0 means no window. q/o
// (B,1,H,D), k/v (B,T,KV,D) contiguous and 16-byte aligned; cache_len (B,)
// int32 on the device. Returns a cudaError_t.
int decode_attention_fwd(const void* q, const void* k, const void* v, const void* cache_len,
                         void* o, int B, int Tk, int H, int KV, int D, int dtype, int window,
                         float scale, void* stream) {
  if (B <= 0) return int(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, cache_len, o, B, Tk, H, KV, window, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, cache_len, o, B, Tk, H, KV, window, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, cache_len, o, B, Tk, H, KV, window, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, cache_len, o, B, Tk, H, KV, window, scale, st);
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, cache_len, o, B, Tk, H, KV, window, scale, st);
  if (dtype == 1 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, cache_len, o, B, Tk, H, KV, window, scale, st);
  return int(cudaErrorInvalidValue);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

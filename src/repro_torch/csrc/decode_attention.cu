// Decode attention (one new token against a KV cache) for Hopper, sm_90a:
// split-KV flash-decoding.
//
// Replaces the Pallas TPU kernel `_decode_kernel` behind `decode_attention`
// in src/repro/kernels/decode_attention.py. Same function: q (B,1,H,D)
// against a (B,T,KV,D) cache, keys kpos < cache_len[b] live, and with a
// window only kpos > cache_len[b] - 1 - window; an online softmax in f32;
// a row with no live key written as 0.
//
// What bounds it on this card: each cache row is used by only G = H/KV
// query heads, 4*G operations per 4 bytes of K and V (qwen3-32b: G = 8;
// recurrentgemma-9b: G = 16), so decode is bound by memory bytes, and the
// cache has to stream through every SM at once. A batch of 4 has only
// B*KV*ceil(G/16) (b, KV head, head group) pairs: 32 at qwen3-32b, 4 at
// recurrentgemma-9b, against 132 SMs. So the keys are split:
//
// 1. The partial kernel runs on a grid (split, KV head x head group, b).
//    The wrapper picks the split length from T, B, KV and G alone
//    (kernels/decode_attention.py `split_plan`: about four blocks per SM, a
//    split a whole number of 32-key tiles), never from cache_len, so it
//    never reads the device. Each block reads cache_len[b] itself, computes
//    the live range in global key positions ([cache_len - window,
//    cache_len), or [0, cache_len) without a window), clips it to the keys
//    this call holds, [kv_offset, kv_offset + Tk), and to its split, and if
//    nothing is left writes m = NEG_INF, l = 0 and exits. Otherwise it
//    scores its keys for all heads of its group (each K/V row read once per
//    group) and writes the partial (m, l, acc[D]) in f32 to scratch the
//    wrapper allocated.
// 2. The combine kernel, one block per (b, h, 128 columns), merges the splits by
//    log-sum-exp, weight 0 for an empty split (whose acc, never written,
//    is discarded), and writes the output in q's type; 0 where no split
//    has a live key. Its loads do not wait on each other: the splits'
//    maxima are reduced across the block first, then groups of threads sum
//    float4 columns over interleaved splits, and the groups add up.
//    Both kernels are launched from one C call on the caller's stream.
//
// Sharded keys (`decode_attention_partial_fwd`): a rank that holds keys
// [kv_offset, kv_offset + Tk) of a cache sharded over its sequence runs the
// same two kernels on its shard; the combine kernel then writes the output
// in float32, normalised over this shard's live keys, and beside it
// lse[b, h], the natural log of the shard's softmax denominator
// (NEG_INF, with an output of 0, where the shard holds no live key), so the
// ranks' partials merge by log-sum-exp without a second rounding
// (kernels/ops.py). `decode_attention_fwd` is this with kv_offset 0, the
// output in q's type and no lse.
//
// bfloat16 (the serving path) runs on the tensor cores with mma.sync
// m16n8k16: the group's query heads are the 16 rows (G = 8 leaves half of
// them zero), so at recurrentgemma's G = 16 the 16 operations per byte do
// not land on the CUDA cores, whose 67 TFLOP/s f32 peak would be within
// 1.25x of the ~54 TFLOP/s that streaming the cache at 3.35 TB/s needs.
// Each block has 2 warps; each warp streams its own 16-key chunks (the
// block's chunks alternate between the warps) through a 3-stage cp.async
// ring of bf16 K and V rows padded by 16 bytes (conflict-free ldmatrix),
// scores them against Q (ldmatrix from shared memory), runs the online
// softmax on the accumulator fragments, and feeds P (rounded to bf16, as
// the JAX reference rounds its weights) straight from registers into the
// P V mma, reading V with ldmatrix.trans. No S or P passes through
// shared memory; the two warps merge their (m, l, acc) there once, at the
// end. head_dim 80 (h2o-danube-1.8b) is five k-steps of 16 and ten n8
// tiles of the same products, with rows padded to 88 elements (176 bytes,
// conflict-free for ldmatrix). head_dim 16 (the reduced dense configs that
// calibration times) is one k-step of Q K^T and two n8 tiles of P V; head_dim
// 32 (the reduced recurrentgemma and paligemma) two k-steps and four n8 tiles,
// rows padded to 40 elements (80 bytes, conflict-free). head_dim 24 (the
// reduced whisper) is not a whole k-step: it runs the D = 32 instance, whose
// loads zero-fill columns 24-31 of Q, K and V in shared memory (cp.async of
// source size 0; nothing is padded in device memory), so Q K^T takes two
// k-steps whose last half adds zeros, and P V writes three of its four n8
// tiles. ptxas -v (nvcc 12.8, sm_90a), D = 64 / 80 /
// 128 / 256: 80 / 128 / 124 / 180 registers (with the sharded-keys offset), 0 bytes of spills, 29952 /
// 36608 / 56576 / 109824 bytes of dynamic shared memory, so up to four
// blocks fit on an SM at D <= 128 and two at D = 256; D = 32 (head_dim 24
// and 32): 64 registers, 0 spills, 16640 bytes.
//
// float32 keeps f32 arithmetic on the CUDA cores (tensor cores would round
// to TF32): one block per (split, KV head, group of 8 heads), K and V tiles
// widened to f32 in shared memory, over the block's key range, writing the
// same partials. At D = 80 the P V step's 20 float4 columns leave 16 of
// its 256 threads without a key subset (12 subsets of 20 threads); those
// threads idle there, and the combine kernel's 20 columns leave 16 threads
// idle the same way. At D = 16 the P V step takes 16 key subsets of 4
// threads (64 of 256 busy), so that its reduction buffer fits in the K tile;
// at D = 24 and 32, 16 subsets of 6 and 8 (96 and 128 busy), the same way.
//
// NEG_INF is finite (-2e38), as in the TPU kernel, and masked keys get a
// weight of exactly 0, so no row ever produces NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bfloat16: mma.sync partial kernel
// ---------------------------------------------------------------------------
constexpr int MW = 2;       // warps per block
constexpr int MR = 16;      // query heads per block: the mma's 16 rows
constexpr int CK = 16;      // keys per warp chunk: one mma k-step of P V
constexpr int NSTAGE = 3;   // cp.async ring depth per warp

template <int D>
struct MmaSmem {            // byte offsets
  static constexpr int RS = D + 8;                              // padded bf16 row
  static constexpr size_t stage = size_t(2) * CK * RS * 2;      // K chunk, then V chunk
  static constexpr size_t q = 0;                                // [MR][RS]
  static constexpr size_t ring = size_t(MR) * RS * 2;           // [MW][NSTAGE] stages
  static constexpr size_t bytes = ring + size_t(MW) * NSTAGE * stage;
  // the merge buffer reuses the ring: (MW - 1) warps x 32 lanes x (D/2 + 4) floats
  static_assert(size_t(MW - 1) * 32 * (D / 2 + 4) * 4 <= size_t(MW) * NSTAGE * stage,
                "merge buffer fits in the ring");
};

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
__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the first in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Partials: ml[(b*H + h) * n_splits + split] = (m, l), m in base-2 units;
// acc[((b*H + h) * n_splits + split) * DO + c], unnormalised.
// D: the row width in shared memory and in the products (whole k-steps of
// 16); DO <= D: the head_dim, the columns that hold data. The loads
// zero-fill columns DO..D-1 of Q, K and V in shared memory (a cp.async of
// source size 0), so those columns add nothing to Q K^T, and the P V
// columns past DO are computed and not written.
template <int D, int DO = D>
__global__ void __launch_bounds__(MW * 32)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                  const __nv_bfloat16* __restrict__ vc, const int32_t* __restrict__ cache_len,
                  float* __restrict__ part_ml, float* __restrict__ part_acc, int Tk, int H,
                  int KV, int window, int kv_offset, int split_len, int n_splits, float scale2) {
  using L = MmaSmem<D>;
  constexpr int RS = L::RS;
  constexpr int NT = D / 8;          // n-tiles of the output
  extern __shared__ __align__(128) unsigned char smem_dec[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_dec + L::q);

  const int split = blockIdx.x;
  const int G = H / KV;
  const int n_grp = (G + MR - 1) / MR;
  const int kvh = blockIdx.y / n_grp, g0 = (blockIdx.y % n_grp) * MR;
  const int b = blockIdx.z;
  const int gc = min(MR, G - g0);
  const int h0 = kvh * G + g0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const size_t row0 = size_t(b) * H + h0;
  // Q's rows (zeros past the group) go in flight before cache_len is read
  for (int i = tid; i < MR * (D / 8); i += MW * 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool in = r < gc && c < DO;
    cp_async16(smem_u32(Qs + r * RS + c), q + (row0 + (in ? r : 0)) * DO + (in ? c : 0), in);
  }
  cp_commit();
  const int len = cache_len[b] - kv_offset;   // the live range's end, in this call's keys
  const int lo = window >= 0 ? max(len - window, 0) : 0;
  const int s0 = split * split_len;
  const int kb = max(s0, lo), ke = min(min(s0 + split_len, len), Tk);   // live keys [kb, ke)
  if (kb >= ke) {
    for (int g = tid; g < gc; g += MW * 32) {
      float* ml = part_ml + ((row0 + g) * n_splits + split) * 2;
      ml[0] = NEG_INF;
      ml[1] = 0.f;
    }
    cp_wait<0>();
    return;
  }

  const size_t k_row = size_t(KV) * DO;
  const __nv_bfloat16* kbase = kc + (size_t(b) * Tk * KV + kvh) * DO;
  const __nv_bfloat16* vbase = vc + (size_t(b) * Tk * KV + kvh) * DO;
  const int n_chunks = (ke - kb + CK - 1) / CK;
  const int mine = n_chunks > warp ? (n_chunks - warp + MW - 1) / MW : 0;
  unsigned char* wring = smem_dec + L::ring + size_t(warp) * NSTAGE * L::stage;

  // this warp's j-th chunk (keys kb + (warp + j*MW)*CK ...) into stage j % NSTAGE;
  // keys at or past ke (and columns past DO) are zero-filled, so masked keys
  // never carry NaN into P V
  auto issue = [&](int j) {
    if (j < mine) {
      const int t0 = kb + (warp + j * MW) * CK;
      __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(wring + (j % NSTAGE) * L::stage);
      __nv_bfloat16* vs = ks + CK * RS;
      for (int i = lane; i < CK * (D / 8); i += 32) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8, t = t0 + r;
        const bool in = t < ke && c < DO;
        const size_t off = size_t(in ? t : kb) * k_row + (in ? c : 0);
        cp_async16(smem_u32(ks + r * RS + c), kbase + off, in);
        cp_async16(smem_u32(vs + r * RS + c), vbase + off, in);
      }
    }
    cp_commit();
  };

  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};   // rows lane/4 and lane/4 + 8
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int c2 = (lane & 3) * 2;
  // ldmatrix row addresses: Q and V (matrices ordered rows 0-7 / 8-15, then +8 columns),
  // K (rows 0-7 at +0 / +8 columns, then rows 8-15)
  const int qa_row = (lane & 7) + ((lane >> 3) & 1) * 8, qa_col = (lane >> 4) * 8;
  const int kb_row = (lane & 7) + (lane >> 4) * 8, kb_col = ((lane >> 3) & 1) * 8;

#pragma unroll
  for (int j = 0; j < NSTAGE - 1; ++j) issue(j);
  cp_wait<NSTAGE - 1>();                // Q's group (the oldest) has landed
  __syncthreads();
  for (int j = 0; j < mine; ++j) {
    cp_wait<NSTAGE - 2>();
    __syncwarp();
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(wring + (j % NSTAGE) * L::stage);
    const __nv_bfloat16* vs = ks + CK * RS;

    // S = Q K^T: 16 heads x 16 keys, as two 8-key n-tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0, a1, a2, a3, b0, b1, b2, b3;
      ldsm_x4(smem_u32(Qs + qa_row * RS + kk * 16 + qa_col), a0, a1, a2, a3);
      ldsm_x4(smem_u32(ks + kb_row * RS + kk * 16 + kb_col), b0, b1, b2, b3);
      mma16816(s[0], a0, a1, a2, a3, b0, b1);
      mma16816(s[1], a0, a1, a2, a3, b2, b3);
    }

    // online softmax on the fragments: s[n][e] is row lane/4 + 8*(e>>1), key 8n + c2 + (e&1)
    const int t0 = kb + (warp + j * MW) * CK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = t0 + 8 * n + c2 + (e & 1) < ke;
        s[n][e] = ok ? s[n][e] * scale2 : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] == NEG_INF ? 0.f : exp2f(s[n][e] - m_r[e >> 1]);
        s[n][e] = p;
        l_r[e >> 1] += p;                  // this lane's share; the quad adds up at the end
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // P V: P's accumulator fragments are the A fragment of the 16-key k-step
    const uint32_t p0 = pack_bf16(s[0][0], s[0][1]), p1 = pack_bf16(s[0][2], s[0][3]);
    const uint32_t p2 = pack_bf16(s[1][0], s[1][1]), p3 = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(smem_u32(vs + qa_row * RS + np * 16 + qa_col), b0, b1, b2, b3);
      mma16816(acc[2 * np], p0, p1, p2, p3, b0, b1);
      mma16816(acc[2 * np + 1], p0, p1, p2, p3, b2, b3);
    }
    __syncwarp();                          // the stage is read; refill it
    issue(j + NSTAGE - 1);
  }
  cp_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }

  // merge the warps' partials (same fragment layout) through the idle ring
  __syncthreads();
  float* xch = reinterpret_cast<float*>(smem_dec + L::ring);
  constexpr int XS = D / 2 + 4;
  if (warp > 0) {
    float* x = xch + ((warp - 1) * 32 + lane) * XS;
    x[0] = m_r[0];
    x[1] = m_r[1];
    x[2] = l_r[0];
    x[3] = l_r[1];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[4 + 4 * n + e] = acc[n][e];
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int w = 1; w < MW; ++w) {
    const float* x = xch + ((w - 1) * 32 + lane) * XS;
    float a[2], aw[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_r[r], x[r]);
      a[r] = exp2f(m_r[r] - m_new);
      aw[r] = exp2f(x[r] - m_new);
      l_r[r] = a[r] * l_r[r] + aw[r] * x[2 + r];
      m_r[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = a[e >> 1] * acc[n][e] + aw[e >> 1] * x[4 + 4 * n + e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = (lane >> 2) + 8 * r;
    if (g >= gc) continue;
    const size_t i = (row0 + g) * n_splits + split;
    if ((lane & 3) == 0) {
      part_ml[2 * i] = m_r[r];
      part_ml[2 * i + 1] = l_r[r];
    }
    float* out = part_acc + i * DO + c2;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core partial kernel
// ---------------------------------------------------------------------------
constexpr int NT32 = 256;   // threads per block
constexpr int GC = 8;       // query heads per block (one warp each in the softmax)

// keys per tile: 128 (two threads a key in the score step), 64 at D = 256
template <int D> constexpr int key_tile() { return D == 256 ? 64 : 128; }

template <int D, int BK>
constexpr size_t smem_bytes() {
  // Q, K (rows padded by 8), V, P, and the running max / sum / rescale
  return sizeof(float) *
         (size_t(GC) * D + size_t(BK) * (D + 8) + size_t(BK) * D + size_t(GC) * BK + 3 * GC);
}

template <int D, int BK>
__global__ void __launch_bounds__(NT32, 1)
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                  const float* __restrict__ vc, const int32_t* __restrict__ cache_len,
                  float* __restrict__ part_ml, float* __restrict__ part_acc, int Tk, int H,
                  int KV, int window, int kv_offset, int split_len, int n_splits, float scale2) {
  constexpr int KS = D + 8;          // padded K row: conflict-free float4 reads
  constexpr int NCH = D / 4;         // float4 chunks of an output row
  // key subsets in the PV step (threads past NKS * NCH idle); at most 16, so
  // that the reduction buffer fits in the K tile at D = 16
  constexpr int NKS = NT32 / NCH < 16 ? NT32 / NCH : 16;
  constexpr int TPK = NT32 / BK;     // threads sharing a key in the score step
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
  const int split = blockIdx.x;
  const int G = H / KV;
  const int n_grp = (G + GC - 1) / GC;
  const int kvh = blockIdx.y / n_grp, g0 = (blockIdx.y % n_grp) * GC;
  const int b = blockIdx.z;
  const int gc = min(GC, G - g0);
  const int h0 = kvh * G + g0;       // first query head of this block

  const int len = cache_len[b] - kv_offset;   // the live range's end, in this call's keys
  const int lo = window >= 0 ? max(len - window, 0) : 0;
  const int s0 = split * split_len;
  const int kb = max(s0, lo), ke = min(min(s0 + split_len, len), Tk);   // live keys [kb, ke)
  const size_t row0 = size_t(b) * H + h0;
  if (kb >= ke) {
    if (tid < gc) {
      float* ml = part_ml + ((row0 + tid) * n_splits + split) * 2;
      ml[0] = NEG_INF;
      ml[1] = 0.f;
    }
    return;
  }

  const size_t k_row = size_t(KV) * D;
  const float* kbp = kc + (size_t(b) * Tk * KV + kvh) * D;
  const float* vbp = vc + (size_t(b) * Tk * KV + kvh) * D;

  for (int i = tid; i < GC * D; i += NT32) {
    const int g = i / D, c = i % D;
    Qs[i] = g < gc ? q[(row0 + g) * D + c] * scale2 : 0.f;
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

  // the first tile starts at a live key, so every running max is finite after it
  for (int t0 = kb; t0 < ke; t0 += BK) {
    __syncthreads();                              // previous tile consumed
    for (int i = tid; i < BK * (D / 4); i += NT32) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4, t = t0 + r;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (t < ke) {
        kk = *reinterpret_cast<const float4*>(kbp + size_t(t) * k_row + c);
        vv = *reinterpret_cast<const float4*>(vbp + size_t(t) * k_row + c);
      }
      *reinterpret_cast<float4*>(&Ks[r * KS + c]) = kk;
      *reinterpret_cast<float4*>(&Vs[r * D + c]) = vv;
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
    const bool ok = t0 + key < ke;
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
      float sv[BK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        sv[e] = Ps[warp * BK + lane + 32 * e];
        mx = fmaxf(mx, sv[e]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = mrow[warp];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const float p = sv[e] == NEG_INF ? 0.f : exp2f(sv[e] - m_new);
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
    for (int t = ks; t < BK && ks < NKS; t += NKS) {
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

  // sum the key subsets through shared memory (reusing the K tile), write the partials
  __syncthreads();
  float* red = Ks;   // [NKS][GC][D]
  if (ks < NKS) {
#pragma unroll
    for (int g = 0; g < GC; ++g)
      *reinterpret_cast<float4*>(&red[(ks * GC + g) * D + chunk * 4]) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
  for (int i = tid; i < gc * D; i += NT32) {
    const int g = i / D, d = i % D;
    float sum = 0.f;
    for (int j = 0; j < NKS; ++j) sum += red[(j * GC + g) * D + d];
    part_acc[((row0 + g) * n_splits + split) * D + d] = sum;
  }
  if (tid < gc) {
    float* ml = part_ml + ((row0 + tid) * n_splits + split) * 2;
    ml[0] = mrow[tid];
    ml[1] = lrow[tid];
  }
}

// ---------------------------------------------------------------------------
// combine: one block per (b, h, 32 float4 columns)
// ---------------------------------------------------------------------------
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int NTC = 256;    // combine threads: CB float4 columns x NTC/CB split groups
                            // (threads past that idle: 16 at D = 80, where CB = 20)
template <int D> __host__ __device__ constexpr int comb_cols() { return D / 4 < 32 ? D / 4 : 32; }

template <typename T, int D>
__global__ void __launch_bounds__(NTC)
decode_combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                      T* __restrict__ o, float* __restrict__ lse, int n_splits) {
  constexpr int CB = comb_cols<D>(), NG = NTC / CB, NC = D / 4;
  __shared__ float red_m[NTC / 32];
  __shared__ float red_l[NG];
  __shared__ float4 red[NG][CB];
  const size_t bh = blockIdx.x / (NC / CB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / CB, c = (blockIdx.x % (NC / CB)) * CB + tid % CB;   // float4 column
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + bh * n_splits;
  // the largest running max of a split with a live key, over the block
  float m = NEG_INF;
  for (int s = tid; s < n_splits; s += NTC)
    if (ml[s].y > 0.f) m = fmaxf(m, ml[s].x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red_m[warp] = m;
  __syncthreads();
  m = red_m[0];
#pragma unroll
  for (int w = 1; w < NTC / 32; ++w) m = fmaxf(m, red_m[w]);
  // group g sums splits g, g + NG, ...: weight exp2(m_s - m), 0 for an empty
  // split, whose acc (never written) is read and discarded by a select, so
  // the loads do not wait on each other
  const float4* acc = reinterpret_cast<const float4*>(part_acc) + bh * n_splits * NC + c;
  float l = 0.f;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g < NG) {
#pragma unroll 4
    for (int s = g; s < n_splits; s += NG) {
      const float2 ms = ml[s];
      const float4 a = acc[size_t(s) * NC];
      const bool live = ms.y > 0.f;
      const float w = live ? exp2f(ms.x - m) : 0.f;
      l += w * ms.y;
      sum.x += live ? w * a.x : 0.f;
      sum.y += live ? w * a.y : 0.f;
      sum.z += live ? w * a.z : 0.f;
      sum.w += live ? w * a.w : 0.f;
    }
    red[g][tid % CB] = sum;
    if (tid % CB == 0) red_l[g] = l;
  }
  __syncthreads();
  if (g > 0) return;
  for (int i = 1; i < NG; ++i) {
    const float4 r = red[i][tid];
    sum.x += r.x;
    sum.y += r.y;
    sum.z += r.z;
    sum.w += r.w;
    l += red_l[i];
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  // m is in base-2 units: ln(sum_s 2^(m_s) l_s) = (m + log2 l) ln 2
  if (lse != nullptr && tid == 0 && blockIdx.x % (NC / CB) == 0)
    lse[bh] = l > 0.f ? (m + log2f(l)) * LN2 : NEG_INF;
  T* out = o + bh * D + 4 * c;
  out[0] = from_f32<T>(sum.x * inv);
  out[1] = from_f32<T>(sum.y * inv);
  out[2] = from_f32<T>(sum.z * inv);
  out[3] = from_f32<T>(sum.w * inv);
}

// With `lse` (the sharded-keys mode) the output is float32 and lse is written.
// head_dim DO in rows of D columns (D = DO, or 32 for DO = 24)
template <int D, int DO = D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* lens,
                        float* ml, float* acc, void* o, float* lse, int B, int Tk, int H, int KV,
                        int window, int kv_offset, int split_len, int n_splits, float scale,
                        cudaStream_t stream) {
  constexpr size_t smem = MmaSmem<D>::bytes;
  static_assert(smem <= 232448, "shared memory of one block");
  static_assert(D % 16 == 0 && DO <= D && DO % 8 == 0, "whole k-steps; whole n8 tiles written");
  cudaError_t err = cudaFuncSetAttribute(decode_mma_kernel<D, DO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  const dim3 grid(n_splits, KV * ((G + MR - 1) / MR), B);
  decode_mma_kernel<D, DO><<<grid, MW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(lens), ml, acc, Tk, H,
      KV, window, kv_offset, split_len, n_splits, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int comb_blocks = B * H * (DO / 4 / comb_cols<DO>());
  if (lse != nullptr)
    decode_combine_kernel<float, DO><<<comb_blocks, NTC, 0, stream>>>(
        ml, acc, static_cast<float*>(o), lse, n_splits);
  else
    decode_combine_kernel<__nv_bfloat16, DO><<<comb_blocks, NTC, 0, stream>>>(
        ml, acc, static_cast<__nv_bfloat16*>(o), nullptr, n_splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* lens, float* ml,
                       float* acc, void* o, float* lse, int B, int Tk, int H, int KV, int window,
                       int kv_offset, int split_len, int n_splits, float scale,
                       cudaStream_t stream) {
  constexpr int BK = key_tile<D>();
  constexpr size_t smem = smem_bytes<D, BK>();
  static_assert(smem <= 232448, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(decode_f32_kernel<D, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  const dim3 grid(n_splits, KV * ((G + GC - 1) / GC), B);
  decode_f32_kernel<D, BK><<<grid, NT32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(lens), ml, acc, Tk, H, KV, window, kv_offset, split_len,
      n_splits, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int comb_blocks = B * H * (D / 4 / comb_cols<D>());
  decode_combine_kernel<float, D><<<comb_blocks, NTC, 0, stream>>>(ml, acc, static_cast<float*>(o),
                                                           lse, n_splits);
  return cudaGetLastError();
}

int decode_run(const void* q, const void* k, const void* v, const void* cache_len,
               void* part_ml, void* part_acc, void* o, float* lse, int B, int Tk, int H, int KV,
               int D, int dtype, int window, int kv_offset, int split_len, int n_splits,
               float scale, void* stream) {
  if (B <= 0 || H <= 0) return int(cudaSuccess);
  if (split_len <= 0 || n_splits <= 0 || split_len % 32) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
#define DECODE_ARGS q, k, v, cache_len, ml, acc, o, lse, B, Tk, H, KV, window, kv_offset, \
    split_len, n_splits, scale, st
  if (dtype == 1 && D == 16) return launch_bf16<16>(DECODE_ARGS);
  if (dtype == 1 && D == 24) return launch_bf16<32, 24>(DECODE_ARGS);
  if (dtype == 1 && D == 32) return launch_bf16<32>(DECODE_ARGS);
  if (dtype == 1 && D == 64) return launch_bf16<64>(DECODE_ARGS);
  if (dtype == 1 && D == 80) return launch_bf16<80>(DECODE_ARGS);
  if (dtype == 1 && D == 128) return launch_bf16<128>(DECODE_ARGS);
  if (dtype == 1 && D == 256) return launch_bf16<256>(DECODE_ARGS);
  if (dtype == 0 && D == 16) return launch_f32<16>(DECODE_ARGS);
  if (dtype == 0 && D == 24) return launch_f32<24>(DECODE_ARGS);
  if (dtype == 0 && D == 32) return launch_f32<32>(DECODE_ARGS);
  if (dtype == 0 && D == 64) return launch_f32<64>(DECODE_ARGS);
  if (dtype == 0 && D == 80) return launch_f32<80>(DECODE_ARGS);
  if (dtype == 0 && D == 128) return launch_f32<128>(DECODE_ARGS);
  if (dtype == 0 && D == 256) return launch_f32<256>(DECODE_ARGS);
#undef DECODE_ARGS
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window < 0 means no window. q/o
// (B,1,H,D), k/v (B,T,KV,D) contiguous and 16-byte aligned; cache_len (B,)
// int32 on the device; part_ml (B,H,n_splits,2) and part_acc
// (B,H,n_splits,D) float32 scratch; split s covers keys
// [s*split_len, (s+1)*split_len). Launches the partial kernel, then the
// combine kernel, on `stream`. Returns a cudaError_t.
int decode_attention_fwd(const void* q, const void* k, const void* v, const void* cache_len,
                         void* part_ml, void* part_acc, void* o, int B, int Tk, int H, int KV,
                         int D, int dtype, int window, int split_len, int n_splits, float scale,
                         void* stream) {
  return decode_run(q, k, v, cache_len, part_ml, part_acc, o, nullptr, B, Tk, H, KV, D, dtype,
                    window, 0, split_len, n_splits, scale, stream);
}

// The sharded-keys mode: k/v (B,Tk,KV,D) hold the cache's keys [kv_offset,
// kv_offset + Tk); cache_len and window are in global key positions. o
// (B,1,H,D) is float32 whatever q's type, normalised over the live keys of
// this shard (0 where there are none); lse (B,H) float32 gets the natural
// log of the shard's softmax denominator (NEG_INF where there are none).
int decode_attention_partial_fwd(const void* q, const void* k, const void* v,
                                 const void* cache_len, void* part_ml, void* part_acc, void* o,
                                 void* lse, int B, int Tk, int H, int KV, int D, int dtype,
                                 int window, int kv_offset, int split_len, int n_splits,
                                 float scale, void* stream) {
  if (lse == nullptr) return int(cudaErrorInvalidValue);
  return decode_run(q, k, v, cache_len, part_ml, part_acc, o, static_cast<float*>(lse), B, Tk,
                    H, KV, D, dtype, window, kv_offset, split_len, n_splits, scale, stream);
}

// Dynamic shared memory of one block of the partial kernel for (dtype, D), in bytes.
int decode_attention_smem_bytes(int dtype, int D) {
  if (dtype == 1 && D == 16) return int(MmaSmem<16>::bytes);
  if (dtype == 1 && (D == 24 || D == 32)) return int(MmaSmem<32>::bytes);
  if (dtype == 1 && D == 64) return int(MmaSmem<64>::bytes);
  if (dtype == 1 && D == 80) return int(MmaSmem<80>::bytes);
  if (dtype == 1 && D == 128) return int(MmaSmem<128>::bytes);
  if (dtype == 1 && D == 256) return int(MmaSmem<256>::bytes);
  if (dtype == 0 && D == 16) return int(smem_bytes<16, key_tile<16>()>());
  if (dtype == 0 && D == 24) return int(smem_bytes<24, key_tile<24>()>());
  if (dtype == 0 && D == 32) return int(smem_bytes<32, key_tile<32>()>());
  if (dtype == 0 && D == 64) return int(smem_bytes<64, key_tile<64>()>());
  if (dtype == 0 && D == 80) return int(smem_bytes<80, key_tile<80>()>());
  if (dtype == 0 && D == 128) return int(smem_bytes<128, key_tile<128>()>());
  if (dtype == 0 && D == 256) return int(smem_bytes<256, key_tile<256>()>());
  return -1;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

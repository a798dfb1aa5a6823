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
// arithmetic, and the arithmetic has to run on the tensor cores at the
// rate only `wgmma` reaches.
//
// bfloat16 (the serving path), `flash_wgmma_kernel`, D = 64, 80, 128, 256:
// * One block per (128-row query tile, b, h), h fastest so the G query
//   heads sharing a KV head run together and find its tiles in L2, query
//   tiles longest first (reversed) so the causal diagonal leaves no tail.
// * 384 threads. Warpgroup 0 is the producer: `setmaxnreg` drops it to 40
//   registers and one thread issues TMA loads, Q once and then K and V
//   tiles of BK keys into a 2-stage ring, each stage with its own K-full,
//   V-full and empty `mbarrier`. Warpgroups 1 and 2 are consumers (232
//   registers), each owning 64 query rows.
// * TMA maps are 4-D (d, heads, seq, batch) with a box of (64, 1, rows,
//   1) and the 128-byte swizzle, built on the host per call through
//   `cudaGetDriverEntryPoint` (no -lcuda). A bf16 row of D > 64 is wider
//   than the swizzle span, so every tile is stored as D/64 column slabs
//   of 64 elements, and rows past S or T are zero-filled by the TMA.
// * S = Q K^T is `wgmma` m64nBKk16 with both operands in shared memory
//   (K-major descriptors, 1024-byte stride between 8-row groups, 32 bytes
//   a k-step within a slab); S stays in registers, where the online
//   softmax runs on the accumulator fragment in base 2 (masking only
//   tiles that cross the diagonal, the window edge or T).
// * P is rounded to bf16 in registers (as the JAX reference rounds its
//   weights) and is the register A operand of the P V `wgmma`; V is read
//   from shared memory as the transposed (MN-major) B operand: 1024 bytes
//   between 8-key groups, one slab (BK * 128 bytes) between 64-column
//   groups. O stays in f32 registers, rescaled per tile, and is written
//   once at the end: no S, P or O passes through shared memory.
// * BK = 128 at D = 64 and 128 (S: 64 registers; O: 32 / 64); BK = 64 at
//   D = 256, where O is 128 registers a thread. Shared memory: Q 16 / 32 /
//   64 KB plus 2 stages of K and V, 80 / 160 / 192 KB a block.
// * ptxas -v (nvcc 12.8, sm_90a), <D, BK, DO>: <64,128,64>,
//   <128,128,128>, <128,128,80> and <256,64,256> each 168 registers at
//   entry (the consumers run at 232 after setmaxnreg), 0 bytes of spills,
//   83000 / 164920 / 164920 / 197688 bytes of dynamic shared memory;
//   <64,128,16>, <64,128,24> and <64,128,32> as <64,128,64>. The f32
//   kernel at D = 256: 229 registers, 0 spills.
//   chip_smoke.py prints and records them. The
//   mbarrier wait spins on try_wait alone: a clock64 / __trap timeout in
//   that loop made ptxas hold every warpgroup to 168 registers and spill
//   (412 bytes at D = 128, 644 at D = 256).
// * head_dim 80 (h2o-danube-1.8b) is not a whole number of 64-column
//   slabs. It runs the D = 128 instance padded inside the kernel, and
//   nothing is padded in device memory: the TMA maps' d-extent is 80, so
//   the TMA zero-fills columns 80-127 of every Q, K and V tile in shared
//   memory (the transaction count is the whole box either way). Q K^T
//   issues only the 5 k-steps of 16 that hold real columns, so scores cost
//   exactly d = 80; P V runs at n = 128, its columns 80-127 are zeros and
//   are not written. Executed work is 1.3x the function's (P V 1.6x), for
//   no new instance of the wgmma code: the alternative, a 32-byte swizzle
//   with five 16-column slabs, needs new descriptors and an n = 80 P V.
// * head_dim 16, 24 and 32 (the reduced configs) run the D = 64 instance the
//   same way (`flash_wgmma_kernel<64, 128, DO>`): TMA maps of d-extent DO
//   (a bf16 row of 32, 48 or 64 bytes, within the TMA's 16-byte stride rule)
//   zero-fill the rest of the one 64-column slab; Q K^T issues the k-steps
//   that hold real columns (1, 2 and 2: at 24 the second covers columns
//   16-31, half of them zeros); P V runs at n = 64 and DO columns are
//   written. Executed work is 2.5x, 2.0x and 1.5x the function's at 16, 24
//   and 32 (P V 4x, 2.7x, 2x), for no new wgmma code.
// Left for later: ping-pong scheduling between the two consumer
// warpgroups, overlapping the softmax with the next tile's Q K^T, fp8.
//
// float32: the CUDA cores, so that f32 keeps f32 products (tensor cores
// would round to TF32), D = 16, 24, 32, 64, 80, 128 and 256. A block owns one (b, h, 64-row
// query tile) and walks its reachable 64-key tiles in a loop (the TPU's
// sequential KV grid axis). Q and K tiles sit transposed in shared memory
// so each of 128 threads reads its 4 query rows and 8 keys as float4s, P
// is staged transposed for the PV product, and each thread keeps a 4x8
// score tile and a 4x(D/8) output tile in registers (at D = 80, whose
// rows are not a whole number of 32-column passes, the last pass is taken
// by half of the key groups; at D = 16 and 24, one pass narrower than 32
// columns, by the first 4 and 6 key groups). At D = 256 the tiles take
// 222,208 of the 232,448 bytes of shared memory a block may have, so one
// block (4 warps) runs on an SM, and each thread holds 128 f32 output
// registers.
//
// Scores are kept in base-2 units (scale * log2 e) so the exponentials
// are exp2. When the caller asks for it (training), each row's natural-log
// log-sum-exp, m ln 2 + ln l, is written to a (B,H,S) f32 array for the
// backward (csrc/flash_attention_bwd.cu); serving passes null and writes
// nothing more.
//
// NEG_INF is finite (-2e38), as in the TPU kernel. The f32 path lets a
// fully masked tile seen before the first live one add exp2(0) = 1 per key
// to the running sum; the first live tile's rescale exp2(NEG_INF - m) = 0
// wipes it (with -inf that would be NaN). The bf16 path gives masked keys
// a weight of exactly 0, so a row with no live key ends with l = 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// a row's natural-log log-sum-exp from its running max m (base-2 units of the
// scaled scores) and sum l; +inf for a row with no live key (its backward
// weights exp(s - lse) are then 0)
__device__ __forceinline__ float row_lse(float m, float l) {
  return m > 0.5f * NEG_INF && l > 0.f ? m * 0.6931471805599453f + logf(l)
                                       : __int_as_float(0x7f800000);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(D) * QP + size_t(D) * KP + size_t(BK) * D + size_t(BK) * QP);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int Tk, int H, int KV,
                 int causal, int window, float scale2) {
  constexpr int DV = (D + 31) / 32;   // float4 output chunks per thread (dims tx*4 + 32*j)
  extern __shared__ __align__(16) float smem[];
  float* QsT = smem;             // [D][QP]  Q tile transposed, pre-scaled
  float* KsT = QsT + D * QP;     // [D][KP]  K tile transposed
  float* Vs = KsT + D * KP;      // [BK][D]
  float* PsT = Vs + BK * D;      // [BK][QP] probabilities transposed

  const int tid = threadIdx.x;
  const int ty = tid >> 3;       // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 7;        // key group: keys tx*8 .. tx*8+7; dims tx*4 + 32*j
  // the last chunk (dims 32 j + tx*4) exists for tx*4 < D - 32 j only: tx < 4 at D = 80
  // and 16, tx < 6 at D = 24
  auto has = [&](int j) { return D % 32 == 0 || tx * 4 + 32 * j < D; };
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
        if (!has(j)) continue;
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
    if (lse != nullptr && tx == 0) lse[(size_t(b) * H + h) * S + s] = row_lse(m[r], l[r]);
    const float denom = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int j = 0; j < DV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (has(j)) ob[size_t(s) * q_row + tx * 4 + 32 * j + e] = from_f32<T>(acc[r][j][e] / denom);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma with TMA-fed tiles
// ---------------------------------------------------------------------------
constexpr int WG_BQ = 128;     // query rows per block: two consumer warpgroups of 64
constexpr int STAGES = 2;      // K/V ring depth
constexpr int WG_THREADS = 384;

template <int D, int BK>
struct WgSmem {                // byte offsets from a 1024-aligned base
  static constexpr int NSLAB = D / 64;                                 // 64-column slabs
  static constexpr size_t tile = size_t(NSLAB) * BK * 128;             // one K or V tile
  static constexpr size_t q = 0;                                       // [NSLAB][WG_BQ][64]
  static constexpr size_t k = q + size_t(NSLAB) * WG_BQ * 128;         // [STAGES] tiles
  static constexpr size_t v = k + STAGES * tile;
  static constexpr size_t bar = v + STAGES * tile;                     // mbarriers
  static constexpr size_t bytes = bar + 8 * (3 * STAGES + 1) + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one TMA box of a 4-D map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFFu) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of accumulator registers across a wait
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (m64n64 f32) {+}= A (64x16 bf16, shared, K-major) * B (64x16 bf16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n128 f32) {+}= A (64x16 bf16, shared, K-major) * B (128x16 bf16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n64 f32) {+}= A (64x16 bf16, registers) * B (16x64 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (m64n128 f32) {+}= A (64x16 bf16, registers) * B (16x128 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (m64n256 f32) {+}= A (64x16 bf16, registers) * B (16x256 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
  else wgmma_rs_n256(d, a, db, 1);
}

// D: the tile width in shared memory (whole 64-column slabs); DO <= D: the
// head_dim, the columns that hold data (the TMA zero-fills the rest)
template <int D, int BK, int DO>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int S, int Tk, int H, int KV, int causal, int window,
                   float scale2, int n_qt, int B) {
  using L = WgSmem<D, BK>;
  constexpr int NSLAB = L::NSLAB;
  constexpr uint32_t TILE_BYTES = BK * D * 2;
  extern __shared__ unsigned char smem_wg[];
  const uint32_t base = (smem_u32(smem_wg) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::q, sK = base + L::k, sV = base + L::v, sBar = base + L::bar;
  // mbarriers: K full [STAGES], V full [STAGES], empty [STAGES], Q full
  auto full_k = [&](int s) { return sBar + 8u * s; };
  auto full_v = [&](int s) { return sBar + 8u * (STAGES + s); };
  auto empty = [&](int s) { return sBar + 8u * (2 * STAGES + s); };
  const uint32_t q_full = sBar + 8u * (3 * STAGES);

  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int b = x % B;
  const int q0 = (n_qt - 1 - x / B) * WG_BQ;      // longest query tiles first
  const int kvh = h / (H / KV);

  // this block's KV tiles [jb, je) (the TPU kernel's skip rule at BQ = 128)
  int je = (Tk + BK - 1) / BK;
  if (causal) je = min(je, (min(q0 + WG_BQ, S) - 1) / BK + 1);
  const int jb = window >= 0 ? max(0, q0 - window + 1) / BK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 8);                      // lane 0 of each consumer warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role is warp-uniform by construction (a shuffle from lane 0), so ptxas
  // gives each branch the register budget of its setmaxnreg
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      mbar_expect_tx(q_full, WG_BQ * D * 2);
      for (int sl = 0; sl < NSLAB; ++sl)
        tma_load4(sQ + sl * WG_BQ * 128, &tm_q, q_full, sl * 64, h, q0, b);
      for (int j = jb; j < je; ++j) {
        const int i = j - jb, s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full_k(s), TILE_BYTES);
        for (int sl = 0; sl < NSLAB; ++sl)
          tma_load4(sK + s * L::tile + sl * BK * 128, &tm_k, full_k(s), sl * 64, kvh, j * BK, b);
        mbar_expect_tx(full_v(s), TILE_BYTES);
        for (int sl = 0; sl < NSLAB; ++sl)
          tma_load4(sV + s * L::tile + sl * BK * 128, &tm_v, full_v(s), sl * 64, kvh, j * BK, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int q0w = q0 + 64 * cw;
  const int lane = tid & 31, wl = (tid >> 5) & 3;
  const int row0 = q0w + 16 * wl + (lane >> 2);    // this thread's rows: row0, row0 + 8
  const int c2 = (lane & 3) * 2;
  // tiles holding a live key for some row of this warpgroup
  int jew = je, jbw = jb;
  if (causal) jew = min(jew, (q0w + 63) / BK + 1);
  if (window >= 0) jbw = max(jbw, max(0, q0w - window + 1) / BK);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const uint32_t sQw = sQ + cw * 64 * 128;

  mbar_wait(q_full, 0);
  for (int j = jb; j < je; ++j) {
    const int i = j - jb, st = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const uint32_t sKs = sK + st * L::tile, sVs = sV + st * L::tile;
    mbar_wait(full_k(st), ph);
    if (j >= jbw && j < jew) {
      // S = Q K^T (64 x BK), f32 in registers
      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < NSLAB; ++sl)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (sl * 64 + kk * 16 < DO)      // k-steps past the head_dim hold only zeros
            wgmma_ss<BK>(s, gmma_desc(sQw + sl * WG_BQ * 128 + kk * 32, 16, 1024),
                         gmma_desc(sKs + sl * BK * 128 + kk * 32, 16, 1024), sl | kk);
      wgmma_commit();
      wgmma_wait0();
      reg_fence<BK / 2>(s);

      // online softmax on the fragment: s[i] is row row0 + 8*((i>>1)&1),
      // key k0 + 8*(i>>2) + c2 + (i&1)
      const int k0 = j * BK;
      const bool full = k0 + BK <= Tk && (!causal || k0 + BK - 1 <= q0w) &&
                        (window < 0 || k0 > q0w + 63 - window);
      float mx[2] = {NEG_INF, NEG_INF};
      if (full) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          s[e] *= scale2;
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int row = row0 + 8 * ((e >> 1) & 1);
          const int key = k0 + 8 * (e >> 2) + c2 + (e & 1);
          bool ok = key < Tk;
          if (causal) ok = ok && key <= row;
          if (window >= 0) ok = ok && key > row - window;
          s[e] = ok ? s[e] * scale2 : NEG_INF;
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        alpha[r] = fast_exp2(m_r[r] - m_new);
        m_r[r] = m_new;
        l_r[r] *= alpha[r];
      }
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int r = (e >> 1) & 1;
        const float p = s[e] == NEG_INF ? 0.f : fast_exp2(s[e] - m_r[r]);
        s[e] = p;
        l_r[r] += p;                       // this lane's share; the quad adds up at the end
      }
      uint32_t pa[BK / 16][4];             // P as the A fragment of each 16-key k-step
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];

      // O += P V, V read as the MN-major B operand
      mbar_wait(full_v(st), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk], gmma_desc(sVs + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
      reg_fence<D / 2>(acc);
    } else {
      mbar_wait(full_v(st), ph);           // every load is waited for before the block ends
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    if (lse != nullptr && (lane & 3) == 0) lse[(size_t(b) * H + h) * S + row] = row_lse(m_r[r], l_r[r]);
    const float inv = l_r[r] > 0.f ? 1.f / l_r[r] : 0.f;
    __nv_bfloat16* orow = o + ((size_t(b) * S + row) * H + h) * DO + c2;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
  }
}

// cuTensorMapEncodeTiled from the driver, fetched through the runtime
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (d, heads, rows, batch) bf16 tensor, contiguous; box (64, 1, box_rows, 1), 128-byte swizzle;
// a box's columns past d (d = 80) and rows past `rows` are zero-filled
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int d, int heads, int rows,
              int batch, int box_rows) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads), cuuint64_t(rows), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(d) * 2, cuuint64_t(heads) * d * 2,
                                 cuuint64_t(rows) * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// head_dim DO in tiles of D columns (D = DO; 128 for DO = 80; 64 for DO = 16, 24, 32)
template <int D, int DO = D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                         int Tk, int H, int KV, int causal, int window, float scale,
                         cudaStream_t stream) {
  constexpr int BK = D == 256 ? 64 : 128;
  constexpr size_t smem = WgSmem<D, BK>::bytes;
  static_assert(smem <= 232448, "shared memory of one block");
  static_assert(DO <= D && DO % 8 == 0, "whole n8 tiles written; rows of 16-byte multiples");
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, DO, H, S, B, WG_BQ) || !make_map(enc, &tk, k, DO, KV, Tk, B, BK) ||
      !make_map(enc, &tv, v, DO, KV, Tk, B, BK))
    return cudaErrorInvalidValue;
  const int n_qt = (S + WG_BQ - 1) / WG_BQ;
  const long long blocks = (long long)H * n_qt * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<D, BK, DO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  flash_wgmma_kernel<D, BK, DO><<<unsigned(blocks), WG_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, Tk, H, KV, causal, window, scale * LOG2E,
      n_qt, B);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int Tk,
                   int H, int KV, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, Tk, H, KV, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D = 16, 24, 32, 64, 80, 128 or 256 in both.
// window < 0 means no window. All tensors contiguous and 16-byte aligned:
// q/o (B,S,H,D), k/v (B,T,KV,D). lse, if not null, receives each row's
// natural-log log-sum-exp of its scaled scores, (B,H,S) float32 (+inf for
// a row with no live key); the backward reads it. Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse_out,
                        int B, int S, int Tk, int H, int KV, int D, int dtype, int causal,
                        int window, float scale, void* stream) {
  if (S <= 0 || B <= 0) return int(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (dtype == 0 && D == 16)
    return launch<float, 16>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 0 && D == 24)
    return launch<float, 24>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 0 && D == 32)
    return launch<float, 32>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 0 && D == 80)
    return launch<float, 80>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 1 && D == 16)
    return launch_wgmma<64, 16>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 1 && D == 24)
    return launch_wgmma<64, 24>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 1 && D == 32)
    return launch_wgmma<64, 32>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 1 && D == 64)
    return launch_wgmma<64>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 1 && D == 80)
    return launch_wgmma<128, 80>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  if (dtype == 1 && D == 256)
    return launch_wgmma<256>(q, k, v, o, lse, B, S, Tk, H, KV, causal, window, scale, st);
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block of the kernel for (dtype, D), in bytes.
int flash_attention_smem_bytes(int dtype, int D) {
  if (dtype == 1 && (D == 16 || D == 24 || D == 32 || D == 64)) return int(WgSmem<64, 128>::bytes);
  if (dtype == 1 && (D == 80 || D == 128)) return int(WgSmem<128, 128>::bytes);
  if (dtype == 1 && D == 256) return int(WgSmem<256, 64>::bytes);
  if (dtype == 0 && D == 16) return int(smem_bytes<16>());
  if (dtype == 0 && D == 24) return int(smem_bytes<24>());
  if (dtype == 0 && D == 32) return int(smem_bytes<32>());
  if (dtype == 0 && D == 64) return int(smem_bytes<64>());
  if (dtype == 0 && D == 80) return int(smem_bytes<80>());
  if (dtype == 0 && D == 128) return int(smem_bytes<128>());
  if (dtype == 0 && D == 256) return int(smem_bytes<256>());
  return -1;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

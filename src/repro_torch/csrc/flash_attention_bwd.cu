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
// What bounds it: at qwen3-32b's training shape (B=2, S=4096, H=64, KV=8,
// D=128) the least work is 10 D operations per live (query, key) pair (the
// S recompute, dP, dV, dK, dQ: 2 D each), 1.375 TFLOP against ~0.61 GB in
// and out, so it is bound by arithmetic (1.39 ms at 989 TFLOP/s bf16), and
// the arithmetic has to run on the tensor cores at the rate only `wgmma`
// reaches.
//
// bfloat16: FlashAttention-3's decomposition, three launches.
//   1. dsum   D = rowsum(dO o O) in f32, one warp a (b, h, s) row over S
//      padded to whole 64-query tiles; it also writes lse in log2 units
//      (+inf on padded rows, so they get P = 0) and zeroes the row of the
//      f32 dQ accumulator (and of the split dK/dV accumulators), so no
//      memset runs.
//   2. `flash_bwd_wgmma_kernel<D, DO>`: one block per (128-key tile, KV
//      head, b, group split), key tile 0 (it sees the most queries) first.
//      384 threads. Warpgroup 0 is the producer (`setmaxnreg` 24): one
//      thread loads K and V once by TMA, then streams, per step of 64
//      queries of one query head, the Q and dO tiles (TMA) and that tile's
//      lse and D (bulk copies) into a 2-stage ring with full/empty
//      mbarriers. Warpgroups 1 and 2 (240 registers) each own 64 of the
//      block's keys and keep dK and dV in f32 registers. The block walks
//      (query head of its split) x (query tiles that can see the key tile:
//      the causal and window skips), in the order `walk` gives, so that the
//      blocks of one (b, KV head) add into the same dQ tiles close in time;
//      only tiles that cross the diagonal, the window edge or S are masked.
//      Per step, in each consumer:
//        S^T  = K Q^T      wgmma SS m64n64 (K-major both)
//        dP^T = V dO^T     wgmma SS m64n64, in flight while P is computed
//        P^T  = exp2(S^T scale log2e - lse log2e), dead pairs exactly 0
//        dS^T = P^T o (dP^T - D)
//        dV  += P^T dO     wgmma RS: P^T rounded to bf16 in registers (as
//                          the forward rounds P), dO the MN-major B operand
//        dK  += dS^T Q     wgmma RS, scaled once at the end
//      dS^T also goes to shared memory as bf16 (128-byte swizzle); after a
//      named barrier of the two consumers, dQ_partial (64 queries x 64
//      columns) = dS K over all 128 keys is wgmma SS with both operands
//      MN-major (A = dS^T, B = K, as V is read in the forward's P V). At
//      D = 128 the two consumers take one 64-column slab each; at D = 64
//      they take the one slab in turns, step by step. dQ_partial goes to an
//      f32 tile in shared memory and one thread adds the whole tile to the
//      f32 accumulator with one TMA bulk reduce-add
//      (cp.reduce.async.bulk .add.f32): the adds run in L2, the consumers
//      spend no instructions on 32 `red`s each, and the copy overlaps the
//      next step. Its source must be contiguous and match the destination
//      byte for byte, so the accumulator is (B, H, S_pad, DO + 8): a
//      64-query tile is one contiguous run, and the 8 pad columns put the
//      tile's rows 8 banks apart, so the float2 stores of a warp's 8 rows
//      fill the 32 banks twice (2 wavefronts, the least for 256 bytes)
//      instead of conflicting 8 ways.
//      After the walk dK and dV leave the registers once: as bf16 when the
//      group is not split, else added (`atomicAdd`, f32) into (B,S,KV,DO)
//      accumulators.
//   3. convert  the f32 accumulators to bf16 (dq x scale always; dk x
//      scale and dv when the group is split).
// The split plan (`bwd_split_plan` in kernels/flash_attention.py) comes
// from the shapes alone: 1 where key tiles x KV x B fill the 132 SMs
// (qwen3's and h2o's training shapes), else the smallest divisor of G that
// does (granite-20b's G = 48 at B = 1, S = 4096: 6 splits, 192 blocks);
// split sp takes query heads [sp G / n, (sp + 1) G / n).
// Determinism: dQ (always) and dK/dV (when split) are sums whose order
// changes from run to run (the bulk reduce-adds and atomics of different
// blocks land in any order), so the bf16 backward is not bit-reproducible;
// each result stays within the same tolerance of the plain version.
// Registers at D = 128 (a consumer thread): dK 64 + dV 64 + S^T 32 + dP^T
// 32 f32, the dQ product's 32 once S^T and dP^T are packed to bf16; the
// budget is 240. Shared memory at D = 128: K and V 64 KB, the ring 2 x 32.5
// KB, dS^T 16 KB, the dQ tile 34 KB: 180 KB of 227.
// head_dim 80 (h2o-danube-1.8b) runs the D = 128 instance, as the forward
// does: TMA maps of d-extent 80 zero-fill columns 80-127 of every tile in
// shared memory, S^T and dP^T issue only the 5 k-steps that hold data, dV,
// dK and dQ run at n = 128 and 80 columns are written; nothing is padded
// in device memory.
// The wgmma, TMA and mbarrier helpers below are copies of those in
// csrc/flash_attention.cu (kept apart so that the forward's build and
// register record do not depend on this file).
//
// float32: the CUDA cores, so that f32 keeps f32 products (the tensor
// cores would round to TF32). dsum as above over unpadded rows, then two
// kernels, 256 threads: dk/dv one block per (64-key tile, KV head, b),
// looping over the group's query heads and the query tiles that see the
// key tile, and dq one block per (64-query tile, head, b) looping over the
// live key tiles; the tiles sit in shared memory with odd row strides,
// each thread scores 8 (key, query) pairs and then owns one row's D/4
// columns of the accumulators. Deterministic.
//
// Rows past S are zero-filled on load and never written. NEG_INF stays
// finite in the forward; here every dead pair is a select to exactly 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int DSUM_ROWS = 8;      // rows per dsum block: one warp each
constexpr int BKEYS = 128;        // keys per block of the wgmma kernel (two consumers x 64)
constexpr int BQ = 64;            // queries per step
constexpr int STAGES = 2;         // Q / dO ring depth
constexpr int WG_THREADS = 384;   // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;   // 128 x 24 + 256 x 240 <= 64K
constexpr int CONVERT_THREADS = 256;
constexpr int F_THREADS = 256;    // float32 kernels
constexpr int F_KB = 64, F_QB = 32;   // f32 dk/dv: keys per block, queries per step
constexpr int F_QD = 64, F_KD = 32;   // f32 dq: queries per block, keys per step

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

// step i of a wgmma block's walk -> (query head, first query of its tile).
// Without a binding window every key tile's query span ends at S, and the
// query tiles are walked from S down with the heads inner: the blocks of one
// (b, KV head) then add into the same dQ tile at the same step. With a
// binding window the spans have one length, and each head's tiles are walked
// upward from the key tile: neighbouring key tiles then reach a dQ tile two
// steps apart. (Each order measured the faster in its case, PERF.md.)
__device__ __forceinline__ int2 walk(int i, bool down, int h0, int n_h, int qt0, int n_qt) {
  return down ? make_int2(h0 + i % n_h, (qt0 + n_qt - 1 - i / n_h) * BQ)
              : make_int2(h0 + i / n_qt, (qt0 + i % n_qt) * BQ);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// Hopper helpers, copied from csrc/flash_attention.cu (mbarriers, TMA,
// wgmma descriptors and wrappers), plus the bulk copies, the bulk
// reduce-add, the proxy fence and the named barrier this kernel adds
// ---------------------------------------------------------------------------
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
// spin until the phase of parity `parity` has completed (try_wait alone in
// the loop: anything more made ptxas hold every warpgroup to its entry budget)
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
// `bytes` contiguous bytes (a multiple of 16, 16-byte aligned) into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// global f32 [dst, + bytes) += shared f32 [src, + bytes), in L2
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the issued bulk reduces have read their shared memory (it may be rewritten)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes become visible to the async proxy (wgmma, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier of the two consumer warpgroups (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * 128) : "memory");
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of accumulator registers across a wait
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// keep a register A operand alive (unmoved) until here, after the wait for its wgmma
template <int N>
__device__ __forceinline__ void reg_keep(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, the first in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

#define WGMMA_D32                                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),   \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),   \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WGMMA_D64                                                                                  \
  WGMMA_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),         \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),   \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),   \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]),   \
      "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define REGS32                                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                         \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define REGS64                                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                         \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"               \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"               \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (m64n64 f32) {+}= A (64x16 bf16, shared, K-major) * B (64x16 bf16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n64 f32) {+}= A (64x16 bf16, shared, MN-major) * B (16x64 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_ss_tt_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32 ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : WGMMA_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n64 f32) {+}= A (64x16 bf16, registers) * B (16x64 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (m64n128 f32) {+}= A (64x16 bf16, registers) * B (16x128 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else wgmma_rs_n128(d, a, db, 1);
}

// ---------------------------------------------------------------------------
// 1. dsum = rowsum(dO o O) (and, for the bf16 path, lse in log2 units and
//    the accumulators zeroed), one warp a (b, h, s) row, s < S_pad
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(32 * DSUM_ROWS)
flash_bwd_dsum_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ dsum,
                      float* __restrict__ lse2, float* __restrict__ dq_acc,
                      float* __restrict__ dk_acc, float* __restrict__ dv_acc, int S, int S_pad,
                      int H, int D, int DP, long long rows, long long kv_rows) {
  const long long row = (long long)blockIdx.x * DSUM_ROWS + (threadIdx.x >> 5);   // (b, h, s)
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int s = int(row % S_pad);
  const long long bh = row / S_pad;
  float acc = 0.f;
  if (s < S) {
    const long long src = ((bh / H * S + s) * H + bh % H) * D;     // row (b, s, h) of o and dO
    for (int c = lane; c < D; c += 32) acc = fmaf(to_f32(o[src + c]), to_f32(dout[src + c]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    dsum[row] = acc;
    if (lse2 != nullptr) lse2[row] = s < S ? lse[bh * S + s] * LOG2E : __int_as_float(0x7f800000);
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (dq_acc != nullptr)
    for (int c = 4 * lane; c < DP; c += 128) *reinterpret_cast<float4*>(dq_acc + row * DP + c) = zero;
  if (dk_acc != nullptr && row < kv_rows)
    for (int c = 4 * lane; c < D; c += 128) {
      *reinterpret_cast<float4*>(dk_acc + row * D + c) = zero;
      *reinterpret_cast<float4*>(dv_acc + row * D + c) = zero;
    }
}

// ---------------------------------------------------------------------------
// 2. bfloat16: the fused wgmma kernel
// ---------------------------------------------------------------------------
// D: the tile width in shared memory (whole 64-column slabs); DO <= D: the
// head_dim, the columns that hold data (the TMA zero-fills the rest)
template <int D, int DO>
struct BwdSmem {                 // byte offsets from a 1024-aligned base
  static constexpr int NSLAB = D / 64;
  static constexpr int DP = DO + 8;                                     // f32 row of the dQ tile
  static constexpr size_t kv_tile = size_t(NSLAB) * BKEYS * 128;        // [NSLAB][128 keys][64]
  static constexpr size_t q_tile = size_t(NSLAB) * BQ * 128;            // [NSLAB][64 queries][64]
  static constexpr size_t k = 0;
  static constexpr size_t v = k + kv_tile;
  static constexpr size_t q = v + kv_tile;                              // [STAGES] Q tiles
  static constexpr size_t dout = q + STAGES * q_tile;                   // [STAGES] dO tiles
  static constexpr size_t ds = dout + STAGES * q_tile;                  // dS^T [128 keys][64] bf16
  static constexpr size_t dq = ds + size_t(BKEYS) * 128;                // [64][DP] f32
  static constexpr size_t lse = dq + size_t(BQ) * DP * 4;               // [STAGES][64] f32, log2
  static constexpr size_t dsum = lse + size_t(STAGES) * BQ * 4;         // [STAGES][64] f32
  static constexpr size_t bar = dsum + size_t(STAGES) * BQ * 4;         // mbarriers
  static constexpr size_t bytes = bar + 8 * (2 * STAGES + 1) + 1024;    // + alignment slack
};

template <int D, int DO>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse2, const float* __restrict__ dsum,
                       float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                       float* __restrict__ dk_acc, float* __restrict__ dv_acc, int S, int S_pad,
                       int H, int KV, int window, float scale, float scale2, int B, int n_split) {
  using L = BwdSmem<D, DO>;
  constexpr int NSLAB = L::NSLAB, DP = L::DP;
  extern __shared__ unsigned char smem_bwd[];
  const uint32_t raw = smem_u32(smem_bwd);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_bwd + (base - raw);       // the same base as a generic pointer
  const uint32_t sK = base + L::k, sV = base + L::v, sQ = base + L::q, sO = base + L::dout;
  const uint32_t sDS = base + L::ds, sDQ = base + L::dq, sL = base + L::lse, sD = base + L::dsum;
  const uint32_t sBar = base + L::bar;
  // mbarriers: full [STAGES], empty [STAGES], K/V full
  auto full = [&](int s) { return sBar + 8u * s; };
  auto empty = [&](int s) { return sBar + 8u * (STAGES + s); };
  const uint32_t kv_full = sBar + 8u * (2 * STAGES);

  int x = blockIdx.x;
  const int kvh = x % KV;
  x /= KV;
  const int b = x % B;
  x /= B;
  const int sp = x % n_split;
  const int k0 = (x / n_split) * BKEYS;            // key tile 0 sees the most queries: it runs first
  const int G = H / KV;
  const int h0 = kvh * G + sp * G / n_split;       // this split's query heads [h0, h0 + n_h)
  const int n_h = kvh * G + (sp + 1) * G / n_split - h0;
  const int2 qs = query_span(k0, BKEYS, S, window);
  const int qt0 = qs.x / BQ, n_qt = (qs.y + BQ - 1) / BQ - qt0;
  const int n_steps = n_h * n_qt;                  // (query head, query tile) steps
  const bool down = window < 0 || window >= S;     // no binding window (see walk)

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);                      // lane 0 of each consumer warp
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role is warp-uniform by construction (a shuffle from lane 0), so ptxas
  // gives each branch the register budget of its setmaxnreg
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * BKEYS * D * 2);
      for (int sl = 0; sl < NSLAB; ++sl) {
        tma_load4(sK + sl * BKEYS * 128, &tm_k, kv_full, sl * 64, kvh, k0, b);
        tma_load4(sV + sl * BKEYS * 128, &tm_v, kv_full, sl * 64, kvh, k0, b);
      }
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % STAGES;
        const int2 hq = walk(i, down, h0, n_h, qt0, n_qt);
        const int h = hq.x, q0 = hq.y;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), 2 * BQ * D * 2 + 2 * BQ * 4);
        for (int sl = 0; sl < NSLAB; ++sl) {
          tma_load4(sQ + s * L::q_tile + sl * BQ * 128, &tm_q, full(s), sl * 64, h, q0, b);
          tma_load4(sO + s * L::q_tile + sl * BQ * 128, &tm_do, full(s), sl * 64, h, q0, b);
        }
        const size_t row = (size_t(b) * H + h) * S_pad + q0;
        bulk_load(sL + s * BQ * 4, lse2 + row, BQ * 4, full(s));
        bulk_load(sD + s * BQ * 4, dsum + row, BQ * 4, full(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns keys k0 + 64 cw .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = wg - 1;
  const int ctid = tid - 128;                      // 0 .. 255 over both consumers
  const int lane = tid & 31, wl = (tid >> 5) & 3;
  const int rl = 16 * wl + (lane >> 2);            // this thread's fragment rows: rl, rl + 8
  const int c2 = (lane & 3) * 2;                   // and column pairs 8 j + c2
  const int kw0 = k0 + 64 * cw;
  const uint32_t sKw = sK + cw * 64 * 128, sVw = sV + cw * 64 * 128;
  float* dq_tile = reinterpret_cast<float*>(gbase + L::dq);
  const float* lse_s = reinterpret_cast<const float*>(gbase + L::lse);
  const float* dsum_s = reinterpret_cast<const float*>(gbase + L::dsum);

  for (int i = ctid; i < BQ * DP; i += 256) dq_tile[i] = 0.f;    // the pad columns stay 0

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dka[e] = dva[e] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int2 hq = walk(i, down, h0, n_h, qt0, n_qt);
    const int h = hq.x, q0 = hq.y;
    const uint32_t sQs = sQ + st * L::q_tile, sOs = sO + st * L::q_tile;
    const float* lse_t = lse_s + st * BQ;
    const float* dsum_t = dsum_s + st * BQ;
    mbar_wait(full(st), ph);

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries), two commit groups
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < NSLAB; ++sl)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (sl * 64 + kk * 16 < DO)          // k-steps past the head_dim hold only zeros
          wgmma_ss_n64(s, gmma_desc(sKw + sl * BKEYS * 128 + kk * 32, 16, 1024),
                       gmma_desc(sQs + sl * BQ * 128 + kk * 32, 16, 1024), sl | kk);
    wgmma_commit();
#pragma unroll
    for (int sl = 0; sl < NSLAB; ++sl)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (sl * 64 + kk * 16 < DO)
          wgmma_ss_n64(dp, gmma_desc(sVw + sl * BKEYS * 128 + kk * 32, 16, 1024),
                       gmma_desc(sOs + sl * BQ * 128 + kk * 32, 16, 1024), sl | kk);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence<32>(s);

    // P^T on the fragment: s[e] is key kw0 + rl + 8 ((e >> 1) & 1), query
    // q0 + 8 (e >> 2) + c2 + (e & 1); masked only where the tile crosses the
    // diagonal, the window edge or S
    const bool full_tile = q0 + BQ <= S && kw0 + 63 <= q0 &&
                           (window < 0 || kw0 > q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + c2);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int e = 4 * j + e4;
        float p = fast_exp2(s[e] * scale2 - ((e & 1) ? l2.y : l2.x));
        if (!full_tile && !live(q0 + 8 * j + c2 + (e & 1), kw0 + rl + 8 * ((e >> 1) & 1), S, window))
          p = 0.f;
        s[e] = p;
      }
    }
    wgmma_wait<0>();
    reg_fence<32>(dp);
    // dS^T = P^T o (dP^T - D); P^T and dS^T as the A fragments of 16-query k-steps
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dsum_t + 8 * j + c2);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int e = 4 * j + e4;
        dp[e] = s[e] * (dp[e] - ((e & 1) ? d2.y : d2.x));
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }

    // dV += P^T dO, dK += dS^T Q (dO and Q as MN-major B operands)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dva, pa[kk], gmma_desc(sOs + kk * 16 * 128, BQ * 128, 1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dka, da[kk], gmma_desc(sQs + kk * 16 * 128, BQ * 128, 1024));
    wgmma_commit();

    // dS^T to shared memory, [key][query] bf16 under the 128-byte swizzle:
    // da[kk][r] holds queries 16 kk + 8 (r >> 1) + c2 (+1) of key row rl + 8 (r & 1)
    unsigned char* ds_smem = gbase + L::ds;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = 64 * cw + rl + 8 * (r & 1), qq = 16 * kk + 8 * (r >> 1) + c2;
        *reinterpret_cast<uint32_t*>(ds_smem + key * 128 + ((((qq >> 3) ^ (key & 7)) << 4) | ((qq & 7) * 2))) =
            da[kk][r];
      }
    fence_proxy_async();
    if (ctid == 0) bulk_wait_read();               // the previous step's dQ tile has been read
    consumer_sync(1);                              // every dS^T row is in shared memory

    // dQ_partial = dS K: 64 queries x one 64-column slab over the 128 keys
    if (NSLAB == 2 || (i & 1) == cw) {
      const int slab = NSLAB == 2 ? cw : 0;
      float dqa[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dqa[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKEYS / 16; ++kk)
        wgmma_ss_tt_n64(dqa, gmma_desc(sDS + kk * 16 * 128, BKEYS * 128, 1024),
                        gmma_desc(sK + slab * BKEYS * 128 + kk * 16 * 128, BKEYS * 128, 1024), kk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence<32>(dqa);
      // dqa[e] is query rl + 8 ((e >> 1) & 1), column 64 slab + 8 (e >> 2) + c2 + (e & 1)
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int col = 64 * slab + 8 * (e >> 2) + c2;
        if (col < DO)
          *reinterpret_cast<float2*>(dq_tile + (rl + 8 * ((e >> 1) & 1)) * DP + col) =
              make_float2(dqa[e], dqa[e + 1]);
      }
      fence_proxy_async();
    } else {
      wgmma_wait<0>();
    }
    reg_fence<D / 2>(dva);
    reg_fence<D / 2>(dka);
    reg_keep<16>(&pa[0][0]);
    reg_keep<16>(&da[0][0]);
    consumer_sync(2);                              // the dQ tile is whole; dS^T has been read
    if (ctid == 0)
      bulk_reduce_add(dq_acc + ((size_t(b) * H + h) * S_pad + q0) * DP, sDQ, BQ * DP * 4);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));         // Q, dO, lse and D of this stage are read
  }
  if (ctid == 0) bulk_wait_all();

  // dK and dV leave the registers once: dka[e] is key kw0 + rl + 8 ((e >> 1) & 1),
  // column 8 (e >> 2) + c2 + (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + rl + 8 * r;
    if (key >= S) continue;
    const size_t off = ((size_t(b) * S + key) * KV + kvh) * DO + c2;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n) {
      const int e = 4 * n + 2 * r;
      if (n_split == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
            __floats2bfloat162_rn(dka[e] * scale, dka[e + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) = __floats2bfloat162_rn(dva[e], dva[e + 1]);
      } else {
        atomicAdd(dk_acc + off + 8 * n, dka[e]);
        atomicAdd(dk_acc + off + 8 * n + 1, dka[e + 1]);
        atomicAdd(dv_acc + off + 8 * n, dva[e]);
        atomicAdd(dv_acc + off + 8 * n + 1, dva[e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the f32 accumulators to bf16: dq (B,H,S_pad,DP) x scale -> (B,S,H,DO);
//    when split, dk (x scale) and dv (B,S,KV,DO). Four columns a thread.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store4_bf16(bf16* dst, float4 a, float m) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x * m, a.y * m);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a.z * m, a.w * m);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

__global__ void __launch_bounds__(CONVERT_THREADS)
flash_bwd_convert_kernel(const float* __restrict__ dq_acc, const float* __restrict__ dk_acc,
                         const float* __restrict__ dv_acc, bf16* __restrict__ dq, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int S, int S_pad, int H, int DO, int DP, float scale,
                         long long n_dq, long long n_kv) {
  const int C4 = DO / 4;
  for (long long i = (long long)blockIdx.x * CONVERT_THREADS + threadIdx.x; i < n_dq + n_kv;
       i += (long long)gridDim.x * CONVERT_THREADS) {
    if (i < n_dq) {
      const long long r = i / C4;                  // row (b, s, h) of dq
      const int c = int(i % C4) * 4;
      const int h = int(r % H), s = int(r / H % S);
      const long long b = r / H / S;
      const float4 a = *reinterpret_cast<const float4*>(dq_acc + ((b * H + h) * S_pad + s) * DP + c);
      store4_bf16(dq + r * DO + c, a, scale);
    } else {
      const long long j = (i - n_dq) * 4;          // element of the (B,S,KV,DO) dk / dv
      store4_bf16(dk + j, *reinterpret_cast<const float4*>(dk_acc + j), scale);
      store4_bf16(dv + j, *reinterpret_cast<const float4*>(dv_acc + j), 1.f);
    }
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

// cuTensorMapEncodeTiled from the driver, fetched through the runtime
// (copied from csrc/flash_attention.cu)
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
// a box's columns past d (d = 80) and rows past `rows` are zero-filled (copied from
// csrc/flash_attention.cu)
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

int pad_rows(int S) { return (S + BQ - 1) / BQ * BQ; }

// the bf16 path's f32 scratch, in floats: lse (log2 units) and D, (B,H,S_pad)
// each; the dQ accumulator (B,H,S_pad,DO + 8); with a split group the dK and
// dV accumulators (B,S,KV,DO) each. float32: D (B,H,S).
long long scratch_floats(int B, int S, int H, int KV, int D, int dtype, int n_split) {
  if (dtype == 0) return (long long)B * H * S;
  const long long rows = (long long)B * H * pad_rows(S);
  return rows * (2 + D + 8) + (n_split > 1 ? 2LL * B * S * KV * D : 0);
}

template <typename T>
cudaError_t launch_dsum(const void* o, const void* dout, const float* lse, float* dsum, float* lse2,
                        float* dq_acc, float* dk_acc, float* dv_acc, int B, int S, int S_pad, int H,
                        int KV, int D, int DP, cudaStream_t st) {
  const long long rows = (long long)B * H * S_pad;
  const long long blocks = (rows + DSUM_ROWS - 1) / DSUM_ROWS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dsum_kernel<T><<<unsigned(blocks), 32 * DSUM_ROWS, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, dsum, lse2, dq_acc, dk_acc, dv_acc,
      S, S_pad, H, D, DP, rows, (long long)B * S * KV);
  return cudaGetLastError();
}

// head_dim DO in tiles of D columns (D = DO, or 128 for DO = 80)
template <int D, int DO = D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                        const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int S,
                        int H, int KV, int window, int n_split, float scale, cudaStream_t st) {
  using L = BwdSmem<D, DO>;
  static_assert(L::bytes <= 232448, "shared memory of one block");
  static_assert(DO <= D && DO % 16 == 0, "whole k-steps of 16 columns");
  const int S_pad = pad_rows(S);
  const long long rows = (long long)B * H * S_pad;
  float* lse2 = scratch;
  float* dsum = lse2 + rows;
  float* dq_acc = dsum + rows;
  float* dk_acc = n_split > 1 ? dq_acc + rows * L::DP : nullptr;
  float* dv_acc = n_split > 1 ? dk_acc + (long long)B * S * KV * DO : nullptr;
  cudaError_t err = launch_dsum<bf16>(o, dout, lse, dsum, lse2, dq_acc, dk_acc, dv_acc, B, S, S_pad,
                                      H, KV, DO, L::DP, st);
  if (err != cudaSuccess) return err;

  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(enc, &tq, q, DO, H, S, B, BQ) || !make_map(enc, &tdo, dout, DO, H, S, B, BQ) ||
      !make_map(enc, &tk, k, DO, KV, S, B, BKEYS) || !make_map(enc, &tv, v, DO, KV, S, B, BKEYS))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)((S + BKEYS - 1) / BKEYS) * KV * B * n_split;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if ((err = set_smem(flash_bwd_wgmma_kernel<D, DO>, L::bytes)) != cudaSuccess) return err;
  flash_bwd_wgmma_kernel<D, DO><<<unsigned(blocks), WG_THREADS, L::bytes, st>>>(
      tq, tk, tv, tdo, lse2, dsum, dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dk_acc,
      dv_acc, S, S_pad, H, KV, window, scale, scale * LOG2E, B, n_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long n_dq = (long long)B * S * H * (DO / 4);
  const long long n_kv = n_split > 1 ? (long long)B * S * KV * (DO / 4) : 0;
  const long long want = (n_dq + n_kv + CONVERT_THREADS - 1) / CONVERT_THREADS;
  const unsigned grid = unsigned(want < 132 * 16 ? want : 132 * 16);
  flash_bwd_convert_kernel<<<grid, CONVERT_THREADS, 0, st>>>(
      dq_acc, dk_acc, dv_acc, static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S,
      S_pad, H, DO, L::DP, scale, n_dq, n_kv);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
                       const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int S,
                       int H, int KV, int window, int, float scale, cudaStream_t st) {
  const float scale2 = scale * LOG2E;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* op = static_cast<const float*>(dout);
  float* dsum = scratch;
  cudaError_t err = launch_dsum<float>(o, dout, lse, dsum, nullptr, nullptr, nullptr, nullptr, B, S,
                                       S, H, KV, D, 0, st);
  if (err != cudaSuccess) return err;
  const long long kv_blocks = (long long)((S + F_KB - 1) / F_KB) * KV * B;
  const int n_qt = (S + F_QD - 1) / F_QD;
  const long long q_blocks = (long long)n_qt * H * B;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if ((err = set_smem(flash_bwd_dkdv_f32_kernel<D>, FDkvSmem<D>::bytes)) != cudaSuccess) return err;
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D = 64, 80 or 128. Causal self-attention:
// q, o, dout, dq (B,S,H,D); k, v, dk, dv (B,S,KV,D); lse (B,H,S) float32;
// scratch float32 of flash_attention_bwd_scratch_floats(...) elements.
// window < 0 means no window. n_split: the bf16 kernel's split of each KV
// head's query group (1..H/KV; float32 ignores it). All tensors contiguous
// and 16-byte aligned. Runs three kernels on `stream`; returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* scratch, void* dq, void* dk,
                        void* dv, int B, int S, int H, int KV, int D, int dtype, int window,
                        int n_split, float scale, void* stream) {
  if (S <= 0 || B <= 0) return int(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || (D != 64 && D != 80 && D != 128) || (dtype != 0 && dtype != 1) ||
      n_split < 1 || n_split > H / KV)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
#define BWD_ARGS q, k, v, o, dout, lp, sc, dq, dk, dv, B, S, H, KV, window, n_split, scale, st
  if (dtype == 1 && D == 64) return int(launch_bf16<64>(BWD_ARGS));
  if (dtype == 1 && D == 80) return int(launch_bf16<128, 80>(BWD_ARGS));
  if (dtype == 1) return int(launch_bf16<128>(BWD_ARGS));
  if (D == 64) return int(launch_f32<64>(BWD_ARGS));
  if (D == 80) return int(launch_f32<80>(BWD_ARGS));
  return int(launch_f32<128>(BWD_ARGS));
#undef BWD_ARGS
}

// Elements of the float32 scratch that flash_attention_bwd needs.
long long flash_attention_bwd_scratch_floats(int B, int S, int H, int KV, int D, int dtype,
                                             int n_split) {
  return scratch_floats(B, S, H, KV, D, dtype, n_split);
}

// Dynamic shared memory of one block, in bytes: bfloat16 (dtype 1) the
// wgmma kernel (kernel 0); float32 kernel 0 = dk/dv, 1 = dq.
int flash_attention_bwd_smem_bytes(int dtype, int D, int kernel) {
  if (dtype == 1 && kernel == 0) {
    if (D == 64) return int(BwdSmem<64, 64>::bytes);
    if (D == 80) return int(BwdSmem<128, 80>::bytes);
    if (D == 128) return int(BwdSmem<128, 128>::bytes);
  }
  if (dtype == 0) {
    if (D == 64) return int(kernel == 0 ? FDkvSmem<64>::bytes : FDqSmem<64>::bytes);
    if (D == 80) return int(kernel == 0 ? FDkvSmem<80>::bytes : FDqSmem<80>::bytes);
    if (D == 128) return int(kernel == 0 ? FDkvSmem<128>::bytes : FDqSmem<128>::bytes);
  }
  return -1;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Whisper encoder self-attention: non-causal softmax attention per head,
// read straight from the [B, T, D] projections. Heads are 64-wide column
// blocks (offset h * 64, row stride D), so no [B, H, T, dh] transpose is
// ever materialised.
//
// Replaces clearconverse_tpu/ops/pallas/encoder_attention.py::
// encoder_attention_pallas (its forward `_forward`, Pallas TPU kernel
// `_kernel`). It computes the same function as the library flash kernel
// behind clearconverse_tpu/models/whisper.py::_flash_attention, so it is
// that function's counterpart too. Forward only: serving has no backward.
//
// What bounds it on an H100: operations. At small.en's shapes (T = 1500,
// 12 heads of 64) one batch row is 4 * 12 * 1500^2 * 64 = 6.9 GFLOP against
// 9.2 MB of bf16 q/k/v/out. At dh = 64 two units share that bound: the
// tensor cores (989 TFLOP/s in bf16) and the exponentials, B * H * T^2 of
// them at 16 a clock per SM, which take about as long as the products.
//
// bf16 (the serving path): a flash-style Hopper kernel.
//  * One CTA per (192-query tile, head, batch row): three warpgroups, each
//    owning 64 query rows (the M of one wgmma). Thread 0 of the last
//    warpgroup also issues the TMA loads. There is no producer warp:
//    ptxas budgets registers for the whole kernel at 65536 / (threads
//    rounded up to warpgroups), setmaxnreg did not raise that budget, and
//    a fourth (producer) warpgroup would cut it from 168 to 128 registers,
//    which spills. Three consumers without a producer keep 168.
//  * TMA copies 64-column boxes (192 rows of Q, 128 of K or V) from a 3-D
//    map over [B, T, D] (columns, rows, batch; innermost first) with the
//    128-byte swizzle: one head row is exactly 128 bytes. Rows >= T come
//    back zero-filled, so T needs no padding. Q (24 KB) lands once; K and V
//    tiles of 128 keys stream through a 4-stage ring (32 KB a stage)
//    guarded by full/empty mbarriers. The loader refills a stage as soon
//    as every consumer has released it; being last in the ping-pong order,
//    it rarely waits. Shared memory is 153 KB, one CTA per SM.
//  * S = Q K^T: wgmma m64n128k16, four k-steps over dh, both operands read
//    from swizzled shared memory. K [keys, dh] is the K-major B operand
//    that wgmma takes natively.
//  * Online softmax in registers: dh^-0.5 * log2(e) folds into one scale
//    before ex2; the row max needs two shuffles across the four threads
//    that share a row; keys >= T are masked with -inf on the last tile.
//  * O += P V: P, rounded to bf16 in registers, is the register A operand
//    (the f32 accumulator layout of S maps pairwise onto the A fragments).
//    V [keys, dh] is the MN-major B operand (the transpose bit).
//  * Ping-pong: a warpgroup issues tile j's Q K^T and tile j-1's P V in one
//    round, then lets the next warpgroup issue its round (named barriers),
//    so the softmax of one warpgroup runs while the tensor cores work for
//    the others. (ptxas schedules the wait for P V ahead of the softmax, so
//    a warpgroup does not overlap its own softmax with its own products.)
//  * Epilogue: divide by the running sum, round to bf16, store rows < T.
//
// f32 (the phase that holds the card against the CPU at HIGHEST
// precision): one thread per query with scalar FMAs, K and V staged in
// shared memory as f32. TF32 tensor cores would break its 1e-4 agreement.
//
// Rounding departs from the Pallas kernel in one place. Pallas normalises p
// first, rounds it to v's dtype and then multiplies by V. The bf16 kernel
// rounds p = exp(s - running max) to bf16 unnormalised and feeds it to the
// f32 P V sum; the running sum takes p before rounding, as the Pallas
// denominator does, and the division comes last. So each weight is rounded
// against the running max rather than after normalisation; the two differ
// by about one bf16 step per weight. The f32 kernel rounds nothing.

#include <cuda.h>   // CUtensorMap types only; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;   // head width (every Whisper size)

// ---------------------------------------------------------- f32: scalar

constexpr int kBq = 64;      // queries per block = threads per block
constexpr int kBk = 64;      // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax update

__global__ void __launch_bounds__(kBq)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int t_len, int d_model, float scale) {
  __shared__ float4 ks[kBk][kDh / 4];
  __shared__ float4 vs[kBk][kDh / 4];

  const int b = blockIdx.z;
  const int col = blockIdx.y * kDh;
  const int qi = blockIdx.x * kBq + threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * t_len;
  const bool valid = qi < t_len;

  float qr[kDh], acc[kDh];
  const float* qrow = q + (row0 + (valid ? qi : 0)) * d_model + col;
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    qr[d] = valid ? qrow[d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < t_len; k0 += kBk) {
    __syncthreads();   // every thread is done with the previous tile
    float* kf = reinterpret_cast<float*>(ks);
    float* vf = reinterpret_cast<float*>(vs);
    for (int e = threadIdx.x; e < kBk * kDh; e += kBq) {
      const int key = k0 + e / kDh;
      const size_t off = (row0 + key) * d_model + col + e % kDh;
      const bool in = key < t_len;
      kf[e] = in ? k[off] : 0.f;
      vf[e] = in ? v[off] : 0.f;
    }
    __syncthreads();

    const int nk = min(kBk, t_len - k0);
    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float s[kChunk];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < kDh / 4; ++d4) {
          const float4 kv = ks[j0 + jj][d4];
          dot = fmaf(qr[4 * d4], kv.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
        }
        s[jj] = (j0 + jj < nk) ? dot : -INFINITY;
        mx = fmaxf(mx, s[jj]);
      }
      const float corr = expf(m - mx);   // 0 on the first chunk (m = -inf)
      l *= corr;
#pragma unroll
      for (int d = 0; d < kDh; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - mx);
        l += p;
#pragma unroll
        for (int d4 = 0; d4 < kDh / 4; ++d4) {
          const float4 vv = vs[j0 + jj][d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = mx;
    }
  }

  if (valid) {
    const float inv = 1.f / l;
    float* orow = out + (row0 + qi) * d_model + col;
#pragma unroll
    for (int d = 0; d < kDh; ++d) orow[d] = acc[d] * inv;
  }
}

// ------------------------------------------------- bf16: wgmma + TMA

constexpr int kConsumers = 3;                 // consumer warpgroups, 64 rows each
constexpr int kTileQ = 64 * kConsumers;       // queries per CTA
constexpr int kTileK = 128;                   // keys per ring stage (wgmma N)
constexpr int kStages = 4;                    // K/V ring depth
constexpr int kS = kTileK / 2;                // logits a consumer thread holds
constexpr int kThreads = 128 * kConsumers;
static_assert(kTileK == 128, "wgmma_qk is m64n128k16");
constexpr int kQBytes = kTileQ * kDh * 2;
constexpr int kTileBytes = kTileK * kDh * 2;  // one K or V tile: 16 KB
constexpr int kSwizzleAtom = 1024;            // 8 rows of 128 B
// Q, K[kStages], V[kStages], then the barriers; +1 KB to align the base.
constexpr int kSmemBytes =
    kQBytes + 2 * kStages * kTileBytes + 64 + kSwizzleAtom;
constexpr uint64_t kStuckNs = 2000000000ull;  // a wait this long is a bug

struct Barriers {
  uint64_t q_full;
  uint64_t full[kStages];    // K and V of a stage have landed
  uint64_t empty[kStages];   // every consumer is done with a stage
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the phase of `bar` with this parity to complete. A wait that
// lasts seconds can only be a broken pipeline: trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (global_ns() - t0 > kStuckNs) __trap();
  }
}

// One 64-column x 128-row box at (column c0, row c1, batch c2).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor for a tile written by TMA with the
// 128-byte swizzle (layout type 1): start address, leading and stride byte
// offsets, all in 16-byte units. Adding n to it moves the start by 16n B.
__device__ __forceinline__ uint64_t smem_desc(const void* tile, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" :: "r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Tells the compiler that registers change here, so that it neither reads
// a wgmma result before the wait nor reuses an operand's registers while
// an issued wgmma may still read them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define CC_ACC8(a, i)                                                  \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),          \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// d(64 x 128, f32) (+)= A(64 x 16) * B(128 x 16)^T; A and B K-major in
// shared memory. accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n\t}"
      : CC_ACC8(d, 0), CC_ACC8(d, 8), CC_ACC8(d, 16), CC_ACC8(d, 24),
        CC_ACC8(d, 32), CC_ACC8(d, 40), CC_ACC8(d, 48), CC_ACC8(d, 56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d(64 x 64, f32) += A(64 x 16, bf16 in registers) * B(16 x 64); B is
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : CC_ACC8(d, 0), CC_ACC8(d, 8), CC_ACC8(d, 16), CC_ACC8(d, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

#undef CC_ACC8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q K^T for one warpgroup: four k-steps of 16 (32 bytes) over dh.
__device__ __forceinline__ void issue_qk(float (&s)[kS], uint64_t q_desc,
                                         uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wgmma_qk(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
}

// O += P V: eight k-steps of 16 keys (2 KB of V each).
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[kS / 2],
                                         uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk)
    wgmma_pv(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             v_desc + kk * (16 * kDh * 2 >> 4));
}

// Accumulator layout of an m64nN f32 wgmma, thread t of the warpgroup:
// s[4i + e] is row 16 * (t / 32) + (t % 32) / 4 + 8 * (e / 2), column
// 8i + 2 * (t % 4) + e % 2. Each thread holds two rows; four threads (lanes
// differing in the low two bits) share each row.
//
// One online-softmax update of a 64 x 128 tile of logits, in place: s
// becomes p = 2^(s * scale - m) against the new running max m (scaled by
// log2(e)); l (this thread's part of each row sum) and corr (the factor
// for O) follow.
__device__ __forceinline__ void softmax_tile(float (&s)[kS], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale_log2, int key0,
                                             int t_len, int col2) {
  if (key0 + kTileK > t_len) {
#pragma unroll
    for (int i = 0; i < kTileK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + 8 * i + col2 + (e & 1) >= t_len) s[4 * i + e] = -INFINITY;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kTileK / 8; ++i)
      mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale_log2);
    corr[r] = ex2(m[r] - m_new);   // 0 on the first tile (m = -inf)
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kTileK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * i + 2 * r + e];
        x = ex2(fmaf(x, scale_log2, -m_new));
        sum += x;
      }
    l[r] = l[r] * corr[r] + sum;
    m[r] = m_new;
  }
}

// P in bf16 as the A fragments of eight m64k16 steps: the accumulator's
// column pairs (8i + 2c, +1) of rows r and r + 8 are exactly the A
// fragment's registers, so fragment step kk takes s[8kk .. 8kk + 7].
__device__ __forceinline__ void pack_p(uint32_t (&p)[kS / 2], const float (&s)[kS]) {
#pragma unroll
  for (int i = 0; i < kS / 2; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

__global__ void __launch_bounds__(kThreads, 1)
attention_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      __nv_bfloat16* __restrict__ out, int t_len, int d_model,
                      float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleAtom - 1) &
      ~static_cast<uintptr_t>(kSwizzleAtom - 1));
  uint8_t* q_s = smem;
  uint8_t* k_s = smem + kQBytes;
  uint8_t* v_s = k_s + kStages * kTileBytes;
  Barriers* bars = reinterpret_cast<Barriers*>(v_s + kStages * kTileBytes);

  const int col = blockIdx.y * kDh;
  const int q0 = blockIdx.x * kTileQ;
  const int b = blockIdx.z;
  const int n_tiles = (t_len + kTileK - 1) / kTileK;
  const int wg = threadIdx.x / 128;
  // The loader: thread 0 of the last warpgroup, which is the last to finish
  // each tile in the ping-pong order.
  const bool loader = threadIdx.x == 128 * (kConsumers - 1);

  if (threadIdx.x == 0) {
    mbar_init(&bars->q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bars->full[st], 1);
      mbar_init(&bars->empty[st], 128 * kConsumers);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (loader) {   // Q and the first ring of K/V tiles
    mbar_expect_tx(&bars->q_full, kQBytes);
    tma_load(q_s, &q_map, &bars->q_full, col, q0, b);
    for (int j = 0; j < min(n_tiles, kStages); ++j) {
      mbar_expect_tx(&bars->full[j], 2 * kTileBytes);
      tma_load(k_s + j * kTileBytes, &k_map, &bars->full[j], col, j * kTileK,
               b);
      tma_load(v_s + j * kTileBytes, &v_map, &bars->full[j], col, j * kTileK,
               b);
    }
  }

  // Warpgroup wg takes query rows q0 + 64 wg .. q0 + 64 wg + 63.
  const int t = threadIdx.x - 128 * wg;
  const int row = q0 + 64 * wg + 16 * (t / 32) + (t % 32) / 4;
  const int col2 = 2 * (t % 4);
  // Q and K: K-major, 8-row groups 1 KB apart (SBO); the leading offset is
  // unused with this swizzle. V: MN-major, 8-key groups 1 KB apart; its
  // one 64-wide column block needs no leading offset either.
  const uint64_t q_desc =
      smem_desc(q_s + wg * 64 * kDh * 2, 16, kSwizzleAtom);
  const uint64_t k_desc = smem_desc(k_s, 16, kSwizzleAtom);
  const uint64_t v_desc = smem_desc(v_s, kSwizzleAtom, kSwizzleAtom);
  constexpr uint64_t kStageStep = kTileBytes >> 4;

  float s[kS], o[32];
  uint32_t p[kS / 2];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int i = 0; i < kS; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  // Ping-pong: a warpgroup issues its products only after the one before
  // it in the ring has issued its own (named barrier wg + 1, 256 threads:
  // 128 wait, 128 arrive), so one warpgroup's softmax runs while the
  // others' products do. Warpgroup 0 goes first; every issue round ends by
  // letting the next one go.
  const int own = wg + 1, next = (wg + 1) % kConsumers + 1;
  if (wg == kConsumers - 1) named_arrive(1);

  mbar_wait(&bars->q_full, 0);
  mbar_wait(&bars->full[0], 0);
  named_sync(own);
  wgmma_fence();
  issue_qk(s, q_desc, k_desc);
  wgmma_commit();
  named_arrive(next);
  wgmma_wait<0>();
  pin(s);
  softmax_tile(s, m, l, corr, scale_log2, 0, t_len, col2);
  pack_p(p, s);

  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % kStages;
    const int prev = (j - 1) % kStages;
    mbar_wait(&bars->full[st], (j / kStages) & 1);
    pin(o);
    pin(p);
    named_sync(own);
    wgmma_fence();
    issue_qk(s, q_desc, k_desc + st * kStageStep);
    wgmma_commit();
    issue_pv(o, p, v_desc + prev * kStageStep);
    wgmma_commit();
    named_arrive(next);
    wgmma_wait<1>();   // S of tile j is in; P V of tile j-1 may still run
    pin(s);
    softmax_tile(s, m, l, corr, scale_log2, j * kTileK, t_len, col2);
    wgmma_wait<0>();
    pin(o);
    pin(p);
    mbar_arrive(&bars->empty[prev]);
    if (loader && j - 1 + kStages < n_tiles) {
      // Refill the stage of tile j-1 with tile j-1+kStages once every
      // consumer is done with it.
      const int next_tile = j - 1 + kStages;
      mbar_wait(&bars->empty[prev], ((j - 1) / kStages) & 1);
      mbar_expect_tx(&bars->full[prev], 2 * kTileBytes);
      tma_load(k_s + prev * kTileBytes, &k_map, &bars->full[prev], col,
               next_tile * kTileK, b);
      tma_load(v_s + prev * kTileBytes, &v_map, &bars->full[prev], col,
               next_tile * kTileK, b);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= corr[(i / 2) % 2];
    pack_p(p, s);
  }
  pin(o);
  pin(p);
  named_sync(own);
  wgmma_fence();
  issue_pv(o, p, v_desc + ((n_tiles - 1) % kStages) * kStageStep);
  wgmma_commit();
  if (wg != kConsumers - 1) named_arrive(next);   // warpgroup 0 is done
  wgmma_wait<0>();
  pin(o);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= t_len) continue;
    __nv_bfloat16* orow = out +
        (static_cast<size_t>(b) * t_len + row + 8 * r) * d_model + col + col2;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = __floats2bfloat162_rn(
          o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library links nothing beyond the CUDA runtime.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// A map over a contiguous bf16 [batch, t_len, d_model] tensor that TMA
// reads in 64-column x 128-row boxes with the 128-byte swizzle; rows past
// t_len read as zeros.
bool tile_map(CUtensorMap* map, const void* base, int batch, int t_len,
              int d_model, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d_model),
                              static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d_model) * 2,
                                 static_cast<cuuint64_t>(d_model) * t_len * 2};
  const cuuint32_t box[3] = {kDh, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k, v, out: contiguous [batch, t_len, n_head * 64], 16-byte aligned.
// Each returns cudaGetLastError() of the launch (or an invalid-value code
// before it).
extern "C" int cc_encoder_attention_f32(const void* q, const void* k,
                                        const void* v, void* out, int batch,
                                        int t_len, int n_head, float scale,
                                        cudaStream_t stream) {
  if (batch < 1 || t_len < 1 || n_head < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((t_len + kBq - 1) / kBq, n_head, batch);
  attention_f32_kernel<<<grid, kBq, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), t_len,
      n_head * kDh, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_encoder_attention_bf16(const void* q, const void* k,
                                         const void* v, void* out, int batch,
                                         int t_len, int n_head, float scale,
                                         cudaStream_t stream) {
  if (batch < 1 || t_len < 1 || n_head < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d_model = n_head * kDh;
  CUtensorMap q_map, k_map, v_map;
  if (!tile_map(&q_map, q, batch, t_len, d_model, kTileQ) ||
      !tile_map(&k_map, k, batch, t_len, d_model, kTileK) ||
      !tile_map(&v_map, v, batch, t_len, d_model, kTileK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((t_len + kTileQ - 1) / kTileQ, n_head, batch);
  attention_bf16_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), t_len, d_model,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

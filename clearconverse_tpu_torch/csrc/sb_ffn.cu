// RE-SepFormer's position-wise feed-forward sublayer in one pass:
// h' = h + fc2(ReLU(fc1(LayerNorm(h)))) over rows of 128, with the
// 1024-wide hidden kept on the SM, at float32 accuracy on the tensor cores.
//
// Replaces no TPU kernel: the JAX package runs this sublayer as plain
// products (clearconverse_tpu/models/resepformer.py), as did the port until
// this kernel (models/resepformer.py::_sb_block: LN2, fc1 and fc2 as float32
// SIMT GEMMs, a ReLU and a residual add). Each segment-layer wrote 150 x
// 1024 x 4 B = 614 KB of hidden that the ReLU read and wrote and fc2 read.
//
// What bounds it on an H100: operations. A row is 2 x 2 x 128 x 1024 =
// 524 K flops against 1 KB read and written. The separator is served in
// float32 with TF32 off, and one TF32 product a product misses it (the
// benchmark's TF32 control reads 40x its limit), so every product runs as
// three TF32 products (3xTF32, as K1 in csrc/logmel.cu): 1.57 M tensor
// flops a row, 3.2 us a thousand rows at 495 TFLOP/s.
//
// Rounding: a value x is split as hi = rna(x), lo = rna(x - hi), rna being
// cvt.rna.tf32.f32's rounding; x * w is taken as lo_x*hi_w + hi_x*lo_w +
// hi_x*hi_w, dropping lo_x*lo_w (about 2^-22 of the product). Every TF32
// product is exact in f32. The tensor cores add into their accumulator
// with an alignment of their own that loses more than f32's round to
// nearest, and the loss grows with the accumulator and with the number of
// additions: summed over all 1024 hidden units in one accumulator, three
// products each, fc2 left the sublayer 7.8e-6 of its norm from float64
// (cuBLAS's float32 SGEMM: 4.7e-7). So each chunk of 64 units is summed
// apart in the tensor cores and added to the output in f32 registers, and
// each stage issues its small products before its large ones: 9.5e-7
// (measured on the card at published widths). The weights are split once,
// on the host with K1's helpers, and uploaded (ops/sb_ffn.py::ffn_operands);
// the normalised rows and the hidden in the kernel, with two integer
// instructions for rna.
//
// Design (128 rows per CTA, two consumer warpgroups of 64 rows):
//  * Prologue: each warp normalises 16 rows (eps and the affine of the
//    layer's norm2), 8 rows at a time with 4 lanes a row, and stores them
//    split into hi and lo as the A operand of fc1: 16 k8-step tiles [64
//    rows, 8] each, K-major under the 32-byte swizzle that the wgmma
//    descriptors name (row r at byte 32r, its 16-byte halves swapped where
//    bit 2 of r is set). The 8 lanes of a quarter-warp write 8 rows, so
//    the stores meet no bank conflict. 64 KB a warpgroup.
//  * The hidden in chunks of 64: hid = x̂ W1[c]^T by m64n64k8 wgmmas with
//    both operands in shared memory (16 k8-steps, 48 wgmmas); then bias
//    and ReLU in the accumulator, split in place into hi and lo, which are
//    the register A operand of fc2's m64n128k8 wgmmas (8 k8-steps, 24
//    wgmmas) into the chunk's part of the output, as K1 chains its DFT into
//    its mel product. The accumulator holds columns {2t, 2t+1} of each 8-column
//    group where a TF32 A fragment wants k-slots {t, t+4}, so the host
//    permutes W2's columns within each group of 8 ([0, 2, 4, 6, 1, 3, 5,
//    7]) instead of the kernel shuffling registers.
//  * Weights stream through a ring of 3 shared-memory stages of 32 KB, one
//    TMA bulk copy each, four stages a chunk (fc1's two halves of K, fc2's
//    two halves of the chunk), laid out on the host in the order the
//    consumers take them and in the swizzle the descriptors name. Both
//    warpgroups read every stage; one arrive per warp releases it. Thread 0
//    refills the ring without blocking right after issuing its own wgmmas,
//    and blocks only when it must issue the stage it is about to read. A
//    wait that lasts 2 s traps instead of hanging.
//  * Epilogue: out = (acc + b2) + h for the CTA's rows, h read again (the
//    plain version's order: the linear's bias first, then the residual).
//
// Budgets: shared memory 1 KB alignment + 3 x 32 KB ring + 2 x 64 KB rows
// = 230,448 B with the barriers, one CTA per SM; registers: the output
// sum 64, a chunk's part of it 64, the hidden 32 (dead while its hi and lo,
// 64, feed fc2), addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                          // model width
constexpr int kChunk = 64;                       // hidden units a chunk
constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kRows = 64 * kConsumers;           // rows a CTA
constexpr int kThreads = 128 * kConsumers;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 32768;
constexpr int kStagesPerChunk = 4;               // fc1 x 2, fc2 x 2
constexpr int kRing = 3;
constexpr int kXTile = 64 * 32;                  // [64 rows, 8] tf32
constexpr int kXHalf = (kD / 8) * kXTile;        // hi (or lo) of 64 rows
constexpr int kXBytes = 2 * kXHalf;
constexpr int kW1Tile = kChunk * 32;             // [64 hidden, 8] tf32
constexpr int kW2Tile = kD * 32;                 // [128 out, 8] tf32
constexpr int kAlign = 1024;
constexpr int kSmemBytes =
    kAlign + kRing * kStageBytes + kConsumers * kXBytes + 16 * kRing;
constexpr uint64_t kStuckNs = 2000000000ull;     // a wait this long is a bug
static_assert(kSmemBytes <= 232448, "shared memory");
static_assert(16 * kW1Tile == kStageBytes && 8 * kW2Tile == kStageBytes,
              "a stage is half of fc1's K or half of fc2's chunk");

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

__device__ __forceinline__ uint32_t mbar_test_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
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

// One TMA bulk copy of `bytes` contiguous bytes into shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tf32 tile laid out with the 32-byte swizzle
// (layout type 3): rows of 8 values (32 B), 8-row groups 256 B apart (SBO);
// the leading offset is unused when one k-step fills the swizzle width. The
// same layout serves an A operand [64 rows, 8] and a B operand [N, 8].
__device__ __forceinline__ uint64_t sw32_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         1ull << 16 | static_cast<uint64_t>(256 >> 4) << 32 | 3ull << 62;
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
template <int M, int N>
__device__ __forceinline__ void pin(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// TF32 rounding to nearest, ties away from zero, as cvt.rna.tf32.f32 for a
// finite x, in two integer instructions.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo (+ about 2^-22 x), both exactly TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

#define CC_ACC4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define CC_ACC8(a, i) CC_ACC4(a, i), CC_ACC4(a, i + 4)
#define CC_OUT4(a, i) "=f"(a[i]), "=f"(a[i + 1]), "=f"(a[i + 2]), "=f"(a[i + 3])
#define CC_OUT8(a, i) CC_OUT4(a, i), CC_OUT4(a, i + 4)

// d(64 x 64, f32) += A(64 x 8) * B(64 x 8)^T, both tf32 K-major tiles in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n\t}"
      : CC_ACC8(d, 0), CC_ACC8(d, 8), CC_ACC8(d, 16), CC_ACC8(d, 24)
      : "l"(a), "l"(b), "r"(1));
}

// d(64 x 128, f32) += A(64 x 8, tf32 in registers) * B(128 x 8, tf32)^T, B
// K-major in shared memory. A fragment (thread t of the warpgroup, lane
// l = t % 32): a[0] row 16 (t / 32) + l / 4, k-slot l % 4; a[1] 8 rows
// lower; a[2] and a[3] the same rows at k-slot l % 4 + 4.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n\t}"
      : CC_ACC8(d, 0), CC_ACC8(d, 8), CC_ACC8(d, 16), CC_ACC8(d, 24),
        CC_ACC8(d, 32), CC_ACC8(d, 40), CC_ACC8(d, 48), CC_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The first product of a sum: d = A * B^T, d written only (so the compiler
// knows that the registers' old values are dead), A and B as wgmma_ss.
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n\t}"
      : CC_OUT8(d, 0), CC_OUT8(d, 8), CC_OUT8(d, 16), CC_OUT8(d, 24)
      : "l"(a), "l"(b), "r"(0));
}

// The first product of a sum: d = A * B^T, A and B as wgmma_rs.
__device__ __forceinline__ void wgmma_rs_first(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n\t}"
      : CC_OUT8(d, 0), CC_OUT8(d, 8), CC_OUT8(d, 16), CC_OUT8(d, 24),
        CC_OUT8(d, 32), CC_OUT8(d, 40), CC_OUT8(d, 48), CC_OUT8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

#undef CC_OUT8
#undef CC_OUT4
#undef CC_ACC8
#undef CC_ACC4

// h, out: [n_rows, 128]; ln_w, ln_b: [128]; ops: the weight stages of
// ops/sb_ffn.py::ffn_operands, n_chunks x 4 of kStageBytes (per chunk of 64
// hidden units: fc1 k8-steps 0-7 then 8-15, each a hi and a lo [64 hidden,
// 8] tile; fc2 k8-steps 0-3 then 4-7 of the chunk, each a hi and a lo [128
// out, 8 permuted hidden] tile); b1: [n_chunks * 64]; b2: [128].
__global__ void __launch_bounds__(kThreads, 1)
sb_ffn_kernel(const float* __restrict__ h, int n_rows,
              const float* __restrict__ ln_w, const float* __restrict__ ln_b,
              float eps, const float* __restrict__ ops, int n_chunks,
              const float* __restrict__ b1, const float* __restrict__ b2,
              float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) &
                              (kAlign - 1));
  uint8_t* xs_all = ring + kRing * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs_all + kConsumers * kXBytes);
  uint64_t* empty = full + kRing;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;   // warp within the warpgroup
  const int lane = tid % 32;
  const int n_stages = n_chunks * kStagesPerChunk;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(ops);
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows + 64 * wg;

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int k) {
    const int slot = k % kRing;
    mbar_expect_tx(&full[slot], kStageBytes);
    bulk_load(ring + slot * kStageBytes,
              src + static_cast<size_t>(k) * kStageBytes, kStageBytes,
              &full[slot]);
  };
  int next = 0;   // the next stage thread 0 issues
  if (tid == 0) {
    for (; next < kRing && next < n_stages; ++next) issue(next);
  }

  // LayerNorm of the warpgroup's 64 rows into its A tiles (hi, then lo).
  // Lane l takes row 8 it + l % 8 of the warp's 16, columns 32 (l / 8) ..
  // 32 (l / 8) + 31; rows past n_rows normalise to zero.
  uint8_t* xs = xs_all + wg * kXBytes;
  {
    const int part = lane / 8;
#pragma unroll 1
    for (int it = 0; it < 2; ++it) {
      const int r = 16 * warp + 8 * it + lane % 8;
      const long long row = row0 + r;
      const bool valid = row < n_rows;
      const float4* hx =
          reinterpret_cast<const float4*>(h + (valid ? row : 0) * kD + 32 * part);
      float x[32];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v = hx[j];
        x[4 * j] = v.x;
        x[4 * j + 1] = v.y;
        x[4 * j + 2] = v.z;
        x[4 * j + 3] = v.w;
      }
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) s += x[e];
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      const float mean = s * (1.f / kD);
      float v = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float d = x[e] - mean;
        v = fmaf(d, d, v);
      }
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      const float rstd = rsqrtf(v * (1.f / kD) + eps);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 32 * part + 4 * j;
        const float4 gw = __ldg(reinterpret_cast<const float4*>(ln_w + col));
        const float4 gb = __ldg(reinterpret_cast<const float4*>(ln_b + col));
        const float y[4] = {(x[4 * j] - mean) * rstd * gw.x + gb.x,
                            (x[4 * j + 1] - mean) * rstd * gw.y + gb.y,
                            (x[4 * j + 2] - mean) * rstd * gw.z + gb.z,
                            (x[4 * j + 3] - mean) * rstd * gw.w + gb.w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(valid ? y[e] : 0.f, hi[e], lo[e]);
        const int off = (col / 8) * kXTile + 32 * r +
                        16 * (((col / 4) & 1) ^ ((r >> 2) & 1));
        *reinterpret_cast<uint4*>(xs + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(xs + kXHalf + off) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }
  // The tiles were written by the threads and are read by the tensor cores.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");

  auto top_up = [&]() {
    if (tid == 0) {
      while (next < n_stages &&
             mbar_test_wait(smem_u32(&empty[next % kRing]),
                            ((next / kRing) + 1) & 1)) {
        issue(next);
        ++next;
      }
    }
    __syncwarp();
  };
  // Stage k's slot, once its data has landed; thread 0 first issues every
  // stage up to k that it has not issued yet, waiting for each slot to be
  // released. (Each warpgroup holds at most its current stage and the one
  // before it, so the slot of stage k - kRing is always released in time.)
  const uint64_t ring_desc = sw32_desc(ring);
  auto acquire = [&](int k) -> uint64_t {
    if (tid == 0) {
      for (; next <= k; ++next) {
        mbar_wait(&empty[next % kRing], ((next / kRing) + 1) & 1);
        issue(next);
      }
    }
    __syncwarp();
    const int slot = k % kRing;
    mbar_wait(&full[slot], (k / kRing) & 1);
    return ring_desc + slot * (kStageBytes >> 4);
  };
  auto release = [&](int k) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[k % kRing]);
  };

  const int t = lane % 4;
  const uint64_t x_desc = sw32_desc(xs);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float hid[32], part[64];

  // Each stage issues its small products (lo*hi, hi*lo) before its large
  // ones (hi*hi): the tensor cores add into the accumulator with a rounding
  // of their own, whose error scales with the accumulator, so the small
  // products land while it is small where they can.
  int k = 0;
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c, k += kStagesPerChunk) {
    // hid = x̂ W1[c]^T: two stages of 8 k8-steps.
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint64_t st = acquire(k + s);
      wgmma_fence();
#pragma unroll
      for (int q8 = 0; q8 < 8; ++q8) {
        const uint64_t a = x_desc + (8 * s + q8) * (kXTile >> 4);
        const uint64_t b = st + q8 * ((2 * kW1Tile) >> 4);
        if (s == 0 && q8 == 0) {
          wgmma_ss_first(hid, a + (kXHalf >> 4), b);
        } else {
          wgmma_ss(hid, a + (kXHalf >> 4), b);
        }
        wgmma_ss(hid, a, b + (kW1Tile >> 4));
      }
#pragma unroll
      for (int q8 = 0; q8 < 8; ++q8)
        wgmma_ss(hid, x_desc + (8 * s + q8) * (kXTile >> 4),
                 st + q8 * ((2 * kW1Tile) >> 4));
      wgmma_commit();
      top_up();
    }
    wgmma_wait<1>();
    release(k);
    wgmma_wait<0>();
    pin(hid);
    release(k + 1);

    // Bias and ReLU, split: hid[4i + e] is row r0 + 8 (e / 2), hidden unit
    // 64c + 8i + 2t + e % 2. As an A fragment with k-slots {t, t + 4},
    // k8-step i is entries {4i, 4i + 2, 4i + 1, 4i + 3}.
    uint32_t ah[8][4], al[8][4];
    const float* bc = b1 + c * kChunk + 2 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bc + 8 * i));
      const int perm[4] = {0, 2, 1, 3};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = perm[j];
        split(fmaxf(hid[4 * i + e] + (e & 1 ? bb.y : bb.x), 0.f), ah[i][j],
              al[i][j]);
      }
    }
    pin(ah);
    pin(al);

    // part = hid W2[:, c]^T: two stages of 4 k8-steps, summed in the tensor
    // cores over the chunk only, then added to acc in f32 (round to
    // nearest), so that their rounding never sees the whole sum.
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint64_t st = acquire(k + 2 + s);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint64_t b = st + u * ((2 * kW2Tile) >> 4);
        if (s == 0 && u == 0) {
          wgmma_rs_first(part, al[0], b);
        } else {
          wgmma_rs(part, al[4 * s + u], b);
        }
        wgmma_rs(part, ah[4 * s + u], b + (kW2Tile >> 4));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wgmma_rs(part, ah[4 * s + u], st + u * ((2 * kW2Tile) >> 4));
      wgmma_commit();
      top_up();
    }
    wgmma_wait<1>();
    release(k + 2);
    wgmma_wait<0>();
    pin(part);
    pin(ah);
    pin(al);
    release(k + 3);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  // acc[4i + e]: row r0 + 8 (e / 2), column 8i + 2t + e % 2.
  const int r0 = 16 * warp + lane / 4;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long row = row0 + r0 + 8 * rr;
    if (row >= n_rows) continue;
    const float* hr = h + row * kD + 2 * t;
    float* orow = out + row * kD + 2 * t;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(hr + 8 * i);
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + 8 * i + 2 * t));
      *reinterpret_cast<float2*>(orow + 8 * i) =
          make_float2((acc[4 * i + 2 * rr] + bb.x) + x.x,
                      (acc[4 * i + 2 * rr + 1] + bb.y) + x.y);
    }
  }
}

}  // namespace

// h, out: contiguous [n_rows, 128] f32, 16-byte aligned; ln_w, ln_b:
// [128], 16-byte aligned; ops: ops/sb_ffn.py::ffn_operands of fc1's [d_ffn,
// 128] and fc2's [128, d_ffn] weights, 16-byte aligned, ops_bytes long
// (checked against d_ffn); b1: [d_ffn], b2: [128], 8-byte aligned; d_ffn a
// multiple of 64. Returns cudaGetLastError() of the launch (or an
// invalid-value code before it).
extern "C" int cc_sb_ffn(const float* h, int n_rows, const float* ln_w,
                         const float* ln_b, float eps, const float* ops,
                         long long ops_bytes, int d_ffn, const float* b1,
                         const float* b2, float* out, cudaStream_t stream) {
  auto misaligned = [](const void* p, uintptr_t a) {
    return (reinterpret_cast<uintptr_t>(p) & (a - 1)) != 0;
  };
  if (n_rows < 1 || d_ffn < kChunk || d_ffn % kChunk ||
      misaligned(h, 16) || misaligned(out, 16) || misaligned(ops, 16) ||
      misaligned(ln_w, 16) || misaligned(ln_b, 16) || misaligned(b1, 8) ||
      misaligned(b2, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = d_ffn / kChunk;
  if (ops_bytes !=
      static_cast<long long>(n_chunks) * kStagesPerChunk * kStageBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      sb_ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (n_rows + kRows - 1) / kRows;
  sb_ffn_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      h, n_rows, ln_w, ln_b, eps, ops, n_chunks, b1, b2, out);
  return static_cast<int>(cudaGetLastError());
}

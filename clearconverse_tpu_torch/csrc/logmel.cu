// Whisper mel power in one fused pass: reflect pad, framing, Hann-windowed
// real DFT, power re^2 + im^2 and the slaney mel projection, at f32
// accuracy on the tensor cores.
//
// Replaces clearconverse_tpu/ops/pallas/logmel.py::mel_power_pallas (the
// Pallas TPU kernel `_kernel`, launched through `pl.pallas_call`).
//
// What bounds the function on an H100: bytes. A 30 s row is 1.92 MB read
// and 0.96 MB written, 0.86 us at 3.35 TB/s; a real FFT and the sparse
// filterbank need about 10,400 flops a frame, less time than that at the
// f32 rate. This kernel runs dense products instead, 3000 frames x
// (2 x 2 x 400 x 201 + 2 x 201 x 80) = 1.06 GFLOP a row before the fold
// below. The reference is f32 at HIGHEST precision, and one TF32 product
// per f32 product misses it by 20-40x. So every product runs as three TF32
// products (3xTF32) on the tensor cores (495 TFLOP/s): 3.2 GFLOP a row at
// the dense count, 6.4 us at best.
//
// Rounding: a value x is split as hi = rna(x), lo = rna(x - hi), rna being
// cvt.rna.tf32.f32's rounding (to 10 mantissa bits, ties away from zero),
// and x * w is taken as hi_x*hi_w + hi_x*lo_w + lo_x*hi_w, dropping
// lo_x*lo_w (about 2^-22 of the product). Every TF32 product is exact in
// f32; the tensor cores add them in f32 in an order of their own, so the
// sums differ from cuBLAS's SGEMM (the plain version) by f32 rounding, not
// by TF32's. The DFT and filterbank are split on the host
// (ops/logmel.py::kernel_operands); audio and power in registers, with two
// integer instructions for rna (ptxas expands cvt.rna.tf32 into nine).
//
// Design (192 frames of one row per CTA, three consumer warpgroups of 64):
//  * Framing without gathers, as in the Pallas kernel: frame f, sample
//    160a + c is hop-row f + a, column c. The CTA stages the 194 hop-rows
//    of its frames once in shared memory: rows wholly inside the audio by
//    one TMA bulk copy each, the rows of the reflect pad (or past the end)
//    by the threads, so the kernel reads the unpadded audio. Rows are 164
//    floats apart (164 = 4 mod 32): a TF32 A fragment (row lane/4, column
//    lane%4) then falls on 32 distinct banks.
//  * The fold: the periodic Hann window and the DFT basis are symmetric
//    about sample 200 (w[0] = 0), so re = sum_n (x[n] + x[400-n]) cos_f[n]
//    and im = sum_n (x[n] - x[400-n]) sin_f[n] over n < 208, 26 k8-steps
//    instead of 50 (ops/logmel.py::folded_dft). This halves the DFT's
//    products and operand bytes.
//  * DFT: for each chunk of kNc bins, re and im are two m64nNk8 tf32 wgmma
//    accumulators (N = kNc). A (the folded frames) comes from registers:
//    wgmma cannot describe overlapping frame rows in shared memory, so each
//    thread reads its fragment from the strip, folds and splits it. B
//    (cos_f and sin_f, K-major [bins, 208], split into hi/lo and padded to
//    kChunks * kNc bins with zeros) streams through a ring of shared-memory
//    stages, each one TMA bulk copy (cp.async.bulk) of a block the host
//    laid out in the 32-byte swizzle that the wgmma descriptors name. A
//    stage is two k8-steps of cos hi, cos lo, sin hi, sin lo; a warpgroup
//    waits for its wgmmas after each k8-step, so its A registers serve
//    both. Fewer, larger stages pay the ring's per-stage protocol less
//    often; a filterbank stage holds three k8-steps of bins [one].
//  * Power -> mel without leaving registers: power = re^2 + im^2 in the
//    accumulator fragment, split into hi/lo in place, is the register A
//    operand of m64n{kMelN}k8 wgmmas against filterbank stages from the same
//    ring; the mel accumulator lives across the chunks. The accumulator
//    holds columns {2t, 2t+1} of each 8-column group where a TF32 A fragment
//    wants k-slots {t, t+4}, so the host permutes the filterbank's rows
//    within each group of 8 bins ([0, 2, 4, 6, 1, 3, 5, 7]) instead of the
//    kernel shuffling registers.
//  * The ring (full/empty mbarriers): lane 0 of warp w issues the stages
//    k = w (mod 12). Right after issuing its own wgmmas it tops the ring up
//    with those of its stages whose slots all 384 consumer threads have
//    released, without blocking, so the refills overlap the products and no
//    single thread carries them all; it blocks only when the ring has run
//    dry at a stage of its own. A wait that lasts 2 s traps instead of
//    hanging.
//  * Epilogue: the mel accumulator goes straight to out[b, f, :] for
//    f < n_frames (the last tile is ragged: 3000 = 15 * 192 + 120).
//
// Budgets (80 mels; 128 mels in brackets):
//  * Tiles: 3000 frames = 16 CTAs a row; B = 8 is 128 CTAs, one wave on
//    132 SMs; B = 32 is 512 CTAs, 3.9 waves. One CTA per SM.
//  * Bins: kNc = 72 [48], 3 [5] chunks, 216 [240] bins for 201. With the
//    fold and the padding the tensor cores do 61 % [70 %] of the dense
//    3xTF32 count.
//  * Shared memory: strip 194 x 164 x 4 = 127,264 B; ring 5 [8] slots of
//    18,432 [12,288] B; 220,536 [226,728] B with barriers and alignment,
//    under the 232,448 B limit.
//  * Registers: 384 threads leave 168 a thread. re + im 72 [48], mel 40
//    [64], the stage's A fragments 16, plus addresses.
//  * L2: every CTA streams 0.86 [1.04] MB of operand stages.
//
// The log10, clamp, scale and transpose stay in the PyTorch wrapper
// (audio/mel.py::log_mel_from_power), as the JAX wrapper keeps them outside
// its kernel: the clamp needs a per-item global max.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHop = 160;
constexpr int kNfft = 400;
constexpr int kFreq = kNfft / 2 + 1;               // 201 bins
constexpr int kConsumers = 3;                      // warpgroups of 64 frames
constexpr int kTileFrames = 64 * kConsumers;       // frames per CTA
constexpr int kThreads = 128 * kConsumers;
constexpr int kStripRows = kTileFrames + 2;        // hop-rows a tile spans
constexpr int kStride = kHop + 4;                  // floats between strip rows
constexpr int kStripBytes = kStripRows * kStride * 4;
constexpr int kFold = 208;                         // folded samples n < 208
constexpr int kDftPer = 2;                         // k8-steps a DFT stage
constexpr int kDftStages = kFold / 8 / kDftPer;
constexpr int kSmemLimit = 232448;
constexpr int kAlign = 1024;
constexpr uint64_t kStuckNs = 2000000000ull;       // a wait this long is a bug

template <int kMelN>
struct Shape {
  static constexpr int kNc = kMelN == 80 ? 72 : 48;        // bins a chunk
  static constexpr int kChunks = (kFreq + kNc - 1) / kNc;
  static constexpr int kTile = kNc * 32;                   // [kNc, 8] tf32
  // A DFT stage: kDftPer k8-steps of cos hi, cos lo, sin hi, sin lo.
  static constexpr int kDftBytes = kDftPer * 4 * kTile;
  static constexpr int kFbTile = kMelN * 32;               // [kMelN, 8] tf32
  static constexpr int kFbStep = 2 * kFbTile;              // hi, lo
  // A filterbank stage: as many k8-steps of bins as a DFT stage's bytes hold.
  static constexpr int kFbPer = kDftBytes >= kFbStep ? kDftBytes / kFbStep : 1;
  static constexpr int kFbBytes = kFbPer * kFbStep;
  static constexpr int kStageBytes = kDftBytes > kFbBytes ? kDftBytes : kFbBytes;
  static constexpr int kFbSteps = kNc / 8;
  static constexpr int kFbStages = (kFbSteps + kFbPer - 1) / kFbPer;
  static constexpr int kPerChunk = kDftStages + kFbStages;
  static constexpr int kStages = kChunks * kPerChunk;
  static constexpr int kRingFit =
      (kSmemLimit - kStripBytes - kAlign - 256) / kStageBytes;
  static constexpr int kRing = kRingFit < 8 ? kRingFit : 8;
  static constexpr int kSmemBytes =
      kAlign + kRing * kStageBytes + kStripBytes + 16 * kRing + 8;
  static_assert(kNc % 8 == 0, "tile");
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
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
// the leading offset is unused when one k-step fills the swizzle width.
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
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
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
template <int M, int N>
__device__ __forceinline__ void pin(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) pin(r[i]);
}

// TF32 rounding to nearest, ties away from zero, as cvt.rna.tf32.f32 for a
// finite x, in two integer instructions (cvt.rna.tf32 is emulated in nine).
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

// d(64 x N, f32) (+)= A(64 x 8, tf32 in registers) * B(N x 8, tf32)^T, B
// K-major in shared memory; N = 2 x the length of d. accumulate = 0
// overwrites d. A fragment (thread t of the warpgroup, lane l = t % 32):
// a[0] row 16 (t / 32) + l / 4, k-slot l % 4; a[1] 8 rows lower; a[2] and
// a[3] the same rows at k-slot l % 4 + 4.
__device__ __forceinline__ void wgmma_tf32(float (&d)[24], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %29, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n\t}"
      : CC_ACC8(d, 0), CC_ACC8(d, 8), CC_ACC8(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[36], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %41, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n\t}"
      : CC_ACC8(d, 0), CC_ACC8(d, 8), CC_ACC8(d, 16), CC_ACC8(d, 24),
        CC_ACC4(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[40], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %45, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n\t}"
      : CC_ACC8(d, 0), CC_ACC8(d, 8), CC_ACC8(d, 16), CC_ACC8(d, 24),
        CC_ACC8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef CC_ACC8
#undef CC_ACC4

// ops: the host-built stages in the order the consumers take them (per
// chunk: kDftStages DFT stages, then kFbStages filterbank stages), each
// kStageBytes apart. A DFT stage is kDftPer k8-steps of folded samples,
// each four tiles [kNc bins, 8 samples]: cos hi, cos lo, sin hi, sin lo. A
// filterbank stage is kFbPer k8-steps of bins, each two tiles [kMelN mels, 8
// permuted bins], hi then lo.
template <int kMelN>
__global__ void __launch_bounds__(kThreads, 1)
mel_power_kernel(const float* __restrict__ x, int t_len, int n_frames,
                 const float* __restrict__ ops, int n_mels,
                 float* __restrict__ out) {
  using S = Shape<kMelN>;
  // Offsets from the shared array itself (no integer round trip), so that
  // the compiler keeps shared-memory loads and stores.
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) &
                              (kAlign - 1));
  float* strip = reinterpret_cast<float*>(ring + S::kRing * S::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(strip + kStripRows * kStride);
  uint64_t* empty = full + S::kRing;
  uint64_t* strip_full = empty + S::kRing;

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTileFrames;
  const int tid = threadIdx.x;
  // Lane 0 of warp w loads the stages k = w (mod kWarps).
  constexpr int kWarps = kThreads / 32;
  const bool loader = tid % 32 == 0;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(ops);

  // Strip rows [row_lo, row_hi) lie wholly inside the audio and come by TMA,
  // one bulk copy a row; the few rows around the reflect pad (or past the
  // end) are filled by the threads.
  const int first = f0 * kHop - kNfft / 2;       // audio index of strip (0, 0)
  const int row_lo = first >= 0 ? 0 : (kHop - 1 - first) / kHop;
  const int row_hi = max(row_lo, min(kStripRows, (t_len - first) / kHop));
  if (tid == 0) {
    for (int i = 0; i < S::kRing; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kThreads);
    }
    mbar_init(strip_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(strip_full, (row_hi - row_lo) * kHop * 4);
  }
  __syncthreads();
  // Stage k (slot k % kRing) goes to TMA: a DFT or a filterbank stage,
  // each copying only what it fills of its kStageBytes slot.
  auto issue = [&](int k) {
    const int slot = k % S::kRing;
    const uint32_t bytes =
        k % S::kPerChunk < kDftStages ? S::kDftBytes : S::kFbBytes;
    mbar_expect_tx(&full[slot], bytes);
    bulk_load(ring + slot * S::kStageBytes,
              src + static_cast<size_t>(k) * S::kStageBytes, bytes,
              &full[slot]);
  };
  int mine = tid / 32;   // the next stage this warp's loader issues
  if (loader) {
    for (; mine < S::kRing && mine < S::kStages; mine += kWarps) issue(mine);
  }

  // The strip: hop-rows f0 .. f0 + kStripRows - 1 of the reflect-padded
  // row, sample p of it being audio index p - 200, reflected into [0, T).
  // By hand, four samples at a time: T and every group start are multiples
  // of 4, so a group lies wholly inside the row or wholly outside it.
  const float* xb = x + static_cast<size_t>(b) * t_len;
  for (int row = row_lo + tid; row < row_hi; row += kThreads)
    bulk_load(strip + row * kStride, xb + first + row * kHop, kHop * 4,
              strip_full);
  const int n_edge = (row_lo + kStripRows - row_hi) * (kHop / 4);
  for (int v = tid; v < n_edge; v += kThreads) {
    int row = v / (kHop / 4);
    const int c = (v - row * (kHop / 4)) * 4;
    row = row < row_lo ? row : row - row_lo + row_hi;
    const int idx = first + row * kHop + c;
    float e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int i = idx + j;
      i = i < 0 ? -i : i;
      i = i >= t_len ? 2 * (t_len - 1) - i : i;
      e[j] = (i >= 0 && i < t_len) ? xb[i] : 0.f;
    }
    *reinterpret_cast<float4*>(strip + row * kStride + c) =
        make_float4(e[0], e[1], e[2], e[3]);
  }
  __syncthreads();
  mbar_wait(strip_full, 0);

  const int wg = tid / 128;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 64 * wg + 16 * ((tid % 128) / 32) + g;   // frame in the tile
  const float* xr = strip + r0 * kStride;

  float mel[kMelN / 2];
#pragma unroll
  for (int i = 0; i < kMelN / 2; ++i) mel[i] = 0.f;
  float re[S::kNc / 2], im[S::kNc / 2];
  // Descriptor of ring slot 0; a tile at byte offset o of the ring is
  // ring_desc + o / 16 (the start address field is the low 14 bits).
  const uint64_t ring_desc = sw32_desc(ring);
#pragma unroll
  for (int i = 0; i < S::kNc / 2; ++i) re[i] = im[i] = 0.f;

  // A loader issues its stages up to k + kRing - 1 whose slots all
  // consumers have released, without blocking. It does so right after
  // issuing its own wgmmas, so the refill overlaps the products.
  auto top_up = [&](int k) {
    if (loader) {
      while (mine < S::kStages && mine < k + S::kRing &&
             mbar_test_wait(smem_u32(&empty[mine % S::kRing]),
                            ((mine / S::kRing) + 1) & 1)) {
        issue(mine);
        mine += kWarps;
      }
    }
    __syncwarp();
  };
  // Stage k's slot, once its data has landed. Should the ring have run dry
  // at one of its own stages, a loader first waits for the slot to be
  // released and issues the stage. (Every stage before k has been consumed
  // here, so it has been issued: no loader waits on another in a cycle.)
  auto acquire = [&](int k) -> uint64_t {
    if (loader && mine == k) {
      mbar_wait(&empty[k % S::kRing], ((k / S::kRing) + 1) & 1);
      issue(k);
      mine += kWarps;
    }
    __syncwarp();
    const int slot = k % S::kRing;
    mbar_wait(&full[slot], (k / S::kRing) & 1);
    __syncwarp();
    return ring_desc + slot * (S::kStageBytes >> 4);
  };

  int k = 0;
  for (int chunk = 0; chunk < S::kChunks; ++chunk) {
    // re (+)= even x cos_f and im (+)= odd x sin_f, k8-step q over folded
    // samples n = 8q .. 8q+7: even = x[n] + x[400 - n], odd =
    // x[n] - x[400 - n]. Sample s of frame row r0 is strip row r0 + s / 160,
    // column s % 160: xr + s + 4 (s / 160), where n < 208 and 400 - n > 192.
    for (int stage = 0; stage < kDftStages; ++stage, ++k) {
      uint32_t eh[4], el[4], oh[4], ol[4];
      uint64_t st = 0;
#pragma unroll
      for (int h = 0; h < kDftPer; ++h) {
        const int q = kDftPer * stage + h;
#pragma unroll
        for (int half = 0; half < 2; ++half) {   // k-slots t and t + 4
          const int n = 8 * q + t + 4 * half;
          const int m = kNfft - n;
          const float* pn = xr + n + (n >= kHop ? 4 : 0);
          const float* pm = xr + m + (m >= 2 * kHop ? 8 : 4);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {       // rows r0 and r0 + 8
            const float xn = pn[8 * kStride * rr], xm = pm[8 * kStride * rr];
            const int j = 2 * half + rr;
            split(xn + xm, eh[j], el[j]);
            split(xn - xm, oh[j], ol[j]);
          }
        }
        if (h == 0) st = acquire(k);
        pin(eh);
        pin(el);
        pin(oh);
        pin(ol);
        wgmma_fence();
        constexpr int kT = S::kTile >> 4;
        const uint64_t b = st + h * 4 * kT;
        wgmma_tf32(re, el, b, q > 0);
        wgmma_tf32(re, eh, b + kT, 1);
        wgmma_tf32(re, eh, b, 1);
        wgmma_tf32(im, ol, b + 2 * kT, q > 0);
        wgmma_tf32(im, oh, b + 3 * kT, 1);
        wgmma_tf32(im, oh, b + 2 * kT, 1);
        wgmma_commit();
        if (h == 0) top_up(k + 1);
        wgmma_wait0();
        pin(re);
        pin(im);
        pin(eh);
        pin(el);
        pin(oh);
        pin(ol);
      }
      mbar_arrive(&empty[k % S::kRing]);
    }

    // Power, split in place: re holds its hi part, im its lo part.
#pragma unroll
    for (int i = 0; i < S::kNc / 2; ++i) {
      const float pw = re[i] * re[i] + im[i] * im[i];
      uint32_t hi, lo;
      split(pw, hi, lo);
      re[i] = __uint_as_float(hi);
      im[i] = __uint_as_float(lo);
    }

    // mel += power x filterbank. Accumulator entries 4i .. 4i+3 are bins
    // (2t, 2t+1) of group i for rows r0 and r0 + 8; as an A fragment with
    // k-slots {t, t+4} they are {4i, 4i+2, 4i+1, 4i+3}.
#pragma unroll
    for (int fs = 0; fs < S::kFbStages; ++fs, ++k) {
      uint32_t ah[S::kFbPer][4], al[S::kFbPer][4];
      const int perm[4] = {0, 2, 1, 3};
#pragma unroll
      for (int u = 0; u < S::kFbPer; ++u) {
        const int i = fs * S::kFbPer + u < S::kFbSteps ? fs * S::kFbPer + u : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ah[u][j] = __float_as_uint(re[4 * i + perm[j]]);
          al[u][j] = __float_as_uint(im[4 * i + perm[j]]);
        }
      }
      const uint64_t st = acquire(k);
      pin(ah);
      pin(al);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < S::kFbPer; ++u) {
        if (fs * S::kFbPer + u >= S::kFbSteps) break;
        const uint64_t b = st + u * (S::kFbStep >> 4);
        wgmma_tf32(mel, al[u], b, 1);
        wgmma_tf32(mel, ah[u], b + (S::kFbTile >> 4), 1);
        wgmma_tf32(mel, ah[u], b, 1);
      }
      wgmma_commit();
      top_up(k + 1);
      wgmma_wait0();
      pin(mel);
      pin(ah);
      pin(al);
      mbar_arrive(&empty[k % S::kRing]);
    }
  }

  // mel[4i + e]: frame r0 + 8 (e / 2), mel 8i + 2t + e % 2.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int f = f0 + r0 + 8 * r;
    if (f >= n_frames) continue;
    float* orow = out + (static_cast<size_t>(b) * n_frames + f) * n_mels;
#pragma unroll
    for (int i = 0; i < kMelN / 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (col + 1 < n_mels && !(n_mels & 1)) {
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(mel[4 * i + 2 * r], mel[4 * i + 2 * r + 1]);
      } else {
        if (col < n_mels) orow[col] = mel[4 * i + 2 * r];
        if (col + 1 < n_mels) orow[col + 1] = mel[4 * i + 2 * r + 1];
      }
    }
  }
}

template <int kMelN>
int launch(const float* x, int batch, int t_len, const float* ops,
           long long ops_bytes, int n_mels, float* out, cudaStream_t stream) {
  using S = Shape<kMelN>;
  // The host lays the stages out (ops/logmel.py::kernel_operands); a buffer
  // of another size was laid out for another Shape.
  if (ops_bytes != static_cast<long long>(S::kStages) * S::kStageBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      mel_power_kernel<kMelN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_frames = t_len / kHop;
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames, batch);
  mel_power_kernel<kMelN><<<grid, kThreads, S::kSmemBytes, stream>>>(
      x, t_len, n_frames, ops, n_mels, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous [batch, t_len] f32 audio, 16-byte aligned, t_len a multiple
// of 160 above 200 (unpadded: the kernel folds in the reflect pad);
// ops: the operand stages of ops/logmel.py::kernel_operands(n_mels),
// 16-byte aligned, ops_bytes long (checked against the kernel's Shape);
// out: [batch, t_len / 160, n_mels]. Returns cudaGetLastError() of the
// launch (or an invalid-value code before it).
extern "C" int cc_mel_power(const float* x, int batch, int t_len,
                            const float* ops, long long ops_bytes, int n_mels,
                            float* out, cudaStream_t stream) {
  if (batch < 1 || t_len % kHop != 0 || t_len <= kNfft / 2 || n_mels < 1 ||
      n_mels > 128 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(ops) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  return n_mels <= 80
             ? launch<80>(x, batch, t_len, ops, ops_bytes, n_mels, out, stream)
             : launch<128>(x, batch, t_len, ops, ops_bytes, n_mels, out, stream);
}

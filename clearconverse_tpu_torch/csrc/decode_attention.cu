// Voxtral's loop-step attention (models/voxtral.step_forward): from the
// bf16 outputs of a layer's q, k and v projections to the bf16 input of its
// o projection, for B = U x R rows (R replicas of each of U unique rows)
// against each unique row's shared prompt K/V (the prefix) and each row's
// own generated K/V (the suffix). Two launches a layer: the attention over
// key splits, then a small combine of the splits.
//
// Replaces no TPU kernel: Voxtral is port-only. Before this kernel the
// step ran the block as about 31 launches a layer (two f32 RoPEs, two
// index_copy_ slot writes, four batched f32-output products, a mask add, a
// cat, a scale, a softmax, casts, slice and permute copies) and wrote and
// read its [U, 8, R, 4, P + M] f32 scores about six times.
//
// What it computes, as the plain version (ops/decode_attention.py) does:
//  1. RoPE on q and k in f32 (x cos + rotate_half(x) sin, each product and
//     the sum rounded as PyTorch's elementwise kernels round them, with no
//     fused multiply-add), rounded to bf16.
//  2. The step's rotated k and its v written into suffix slot step - 1:
//     the same bytes index_copy_ wrote.
//  3. For each unique row and K/V head, the prefix K/V read once for all
//     R x 4 query rows (R replicas x the head's group of 4 query heads).
//  4. Each replica's own suffix, slots 0 .. step - 1 only: ``step`` is read
//     from its 0-d device tensor, so a captured CUDA graph stays valid as it
//     advances. Slots at or past step are never read (the plain version's
//     -1e9 mask gives them a weight of exactly 0).
//  5. Scores as bf16 x bf16 products summed in f32 (mma.sync m16n8k16), the
//     scale and an online softmax in f32, the weights rounded to bf16 for
//     the value product (the plain version rounds its normalised weights to
//     bf16), value sums in f32, one rounding of the output to bf16.
//
// What bounds it on an H100: bytes. At the voxtral-mini-batch cell's shape
// (U 32, R 5, P 387, M 136) a step reads 1.52 GB of prefix K/V and, at step
// 64, 1.26 GB of suffix over its 30 layers (0.83 ms at 3.35 TB/s) against
// about 70 GFLOP of tensor-core work (0.1 ms). The design is
// flash-decoding:
//  * The grid is (job, unique row x K/V head). A job is one of the prefix's
//    key splits (all R x 4 query rows, two m16 tiles at R = 5) or one
//    replica's suffix (its 4 query rows, one m16 tile): 256 (row, head)
//    pairs alone would give fewer than two CTAs an SM.
//  * Keys stream through shared memory in tiles of 16 (K and V rows of 256
//    contiguous bytes each), four tiles a stage, two stages, by 16-byte
//    cp.async loads that neighbouring threads issue on neighbouring
//    addresses; keys past a job's end are zero-filled, never read.
//  * Each warp takes one m16 tile and every n-th tile of a stage, keeps its
//    own running max, sum and f32 output in registers, and the warps of a
//    tile merge through shared memory at the end. Each job writes its rows'
//    (max, sum, unnormalised output) in f32; the combine kernel merges a
//    row's prefix splits and its suffix and writes the bf16 output.
//  * Shared-memory rows are swizzled (16-byte chunk c of row r at c ^ (r &
//    7)) so that ldmatrix reads them without bank conflicts.
//
// Layout: K is held position-major, as V is (prefix [U, H, P, 128], suffix
// [U, H, R, M, 128]): a key is one 256-byte row, 16-byte aligned whatever
// P is (a head-major row of P = 387 positions starts 2-byte aligned), and a
// 16-key tile is 4 KB contiguous. The decode graphs' arena holds that
// layout (models/decode_graph._PrefixArena); the prefill writes it with a
// copy beside the head-major K its own products read, so its results are
// unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 128;          // head width
constexpr int kGroup = 4;         // query heads a K/V head serves
constexpr int kMaxReplicas = 8;   // R x 4 query rows fit two m16 tiles
constexpr int kTile = 16;         // keys a tile
constexpr int kStageTiles = 4;    // tiles a pipeline stage
constexpr int kStages = 2;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowBytes = kDh * 2;                        // one key's row
constexpr int kHalfTileBytes = kTile * kRowBytes;         // K or V: 4 KB
constexpr int kTileBytes = 2 * kHalfTileBytes;
constexpr int kStageBytes = kStageTiles * kTileBytes;     // 32 KB
constexpr int kSmemBytes = kStages * kStageBytes;         // 64 KB
constexpr int kRedStride = kDh + 4;   // floats a row of the warps' merge
static_assert(kWarps * 16 * (kRedStride + 2) * 4 <= kSmemBytes,
              "the warps' merge reuses the stage buffers");

struct Params {
  const __nv_bfloat16* q;   // [B, 4H * 128]
  const __nv_bfloat16* k;   // [B, H * 128]
  const __nv_bfloat16* v;   // [B, H * 128]
  const float* cos;         // [128]
  const float* sin;         // [128]
  const long long* step;    // 0-d
  const __nv_bfloat16* pk;  // [U, H, P, 128]
  const __nv_bfloat16* pv;  // [U, H, P, 128]
  __nv_bfloat16* sk;        // [U, H, R, M, 128]
  __nv_bfloat16* sv;        // [U, H, R, M, 128]
  float* part_o;            // [U * H, n_split + 1, R * 4, 128]
  float* part_ml;           // [U * H, n_split + 1, R * 4, 2]: max, sum
  int H, R, P, M, n_split, split_keys;
  float scale_log2;         // 128^-0.5 * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a (16 x 16, row-major) x b (16 x 8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x cos + rotate_half(x) sin at one position, as apply_rope rounds it:
// rot = -x[d + 64] below the half, x[d - 64] above it.
__device__ __forceinline__ float rope(float x, float partner, float c,
                                      float s, bool low_half) {
  const float rot = low_half ? -partner : partner;
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(rot, s));
}

// Byte offset of 16-byte chunk c of row r (0..15) of a swizzled half tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

__global__ void __launch_bounds__(kThreads)
vx_decode_attn_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int uh = blockIdx.y;
  const int h = uh % p.H, u = uh / p.H;
  const int R = p.R, RG = R * kGroup;
  const int n_head = p.H * kGroup;
  const int job = blockIdx.x;
  const bool suffix = job >= p.n_split;
  const int rs = job - p.n_split;        // the suffix job's replica

  const long long step = *p.step;
  int key0, n_keys, n_rows;
  const __nv_bfloat16 *kbase, *vbase;
  if (!suffix) {
    key0 = job * p.split_keys;
    n_keys = min(p.P - key0, p.split_keys);
    n_rows = RG;
    const size_t off = (static_cast<size_t>(uh) * p.P + key0) * kDh;
    kbase = p.pk + off;
    vbase = p.pv + off;
  } else {
    key0 = 0;
    n_keys = static_cast<int>(step < 0 ? 0 : (step > p.M ? p.M : step));
    n_rows = kGroup;
    const size_t off = (static_cast<size_t>(uh) * R + rs) * p.M * kDh;
    // The step's k (rotated) and v into slot step - 1 of this replica.
    if (step >= 1 && step <= p.M) {
      const size_t src = ((static_cast<size_t>(u) * R + rs) * p.H + h) * kDh;
      const int d = tid;                       // kThreads == kDh
      const bool low = d < kDh / 2;
      const int dp = low ? d + kDh / 2 : d - kDh / 2;
      const float x = __bfloat162float(p.k[src + d]);
      const float xp = __bfloat162float(p.k[src + dp]);
      const size_t dst = off + static_cast<size_t>(step - 1) * kDh + d;
      p.sk[dst] = __float2bfloat16_rn(rope(x, xp, p.cos[d], p.sin[d], low));
      p.sv[dst] = p.v[src + d];
    }
    __threadfence_block();
    __syncthreads();                           // the slot is read below
    kbase = p.sk + off;
    vbase = p.sv + off;
  }

  const int n_tiles = (n_keys + kTile - 1) / kTile;
  const int n_st = (n_tiles + kStageTiles - 1) / kStageTiles;
  const uint32_t sbase = smem_u32(smem);

  auto load_stage = [&](int st) {
    const uint32_t dst0 = sbase + (st % kStages) * kStageBytes;
#pragma unroll 4
    for (int e = tid; e < kStageTiles * 2 * kTile * 16; e += kThreads) {
      const int c = e & 15, row = (e >> 4) & 15, kv = (e >> 8) & 1;
      const int t = e >> 9;
      const int tile = st * kStageTiles + t;
      if (tile >= n_tiles) continue;
      const int key = tile * kTile + row;
      const bool ok = key < n_keys;
      const __nv_bfloat16* src =
          (kv ? vbase : kbase) + static_cast<size_t>(ok ? key : 0) * kDh +
          c * 8;
      cp_async16(dst0 + t * kTileBytes + kv * kHalfTileBytes + swz(row, c),
                 src, ok);
    }
  };

  // The first stages in flight while q is read and rotated.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) load_stage(s);
    cp_async_commit();
  }
  // Warps: m16 tile mt of the job's query rows, every nk-th tile of a stage.
  const int n_mt = (n_rows + 15) / 16;
  const int nk = kWarps / n_mt;
  const int mt = warp % n_mt, kl = warp / n_mt;

  // q's A fragments for the warp's rows g and g + 8, rotated and rounded.
  uint32_t qa[8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = mt * 16 + g + 8 * half;
    const bool ok = i < n_rows;
    const int r = suffix ? rs : i / kGroup;
    const int j = suffix ? i : i % kGroup;
    const __nv_bfloat16* qrow =
        p.q + ((static_cast<size_t>(u) * R + r) * n_head + h * kGroup + j) *
                  kDh;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = kc * 16 + e * 8 + tig * 2;   // below the half
        float lo0 = 0.f, lo1 = 0.f, hi0 = 0.f, hi1 = 0.f;
        if (ok) {
          const __nv_bfloat162 a =
              *reinterpret_cast<const __nv_bfloat162*>(qrow + d);
          const __nv_bfloat162 b =
              *reinterpret_cast<const __nv_bfloat162*>(qrow + d + kDh / 2);
          const float xa0 = __low2float(a), xa1 = __high2float(a);
          const float xb0 = __low2float(b), xb1 = __high2float(b);
          lo0 = rope(xa0, xb0, p.cos[d], p.sin[d], true);
          lo1 = rope(xa1, xb1, p.cos[d + 1], p.sin[d + 1], true);
          hi0 = rope(xb0, xa0, p.cos[d + 64], p.sin[d + 64], false);
          hi1 = rope(xb1, xa1, p.cos[d + 65], p.sin[d + 65], false);
        }
        qa[kc][half + 2 * e] = pack_bf16(lo0, lo1);
        qa[kc + 4][half + 2 * e] = pack_bf16(hi0, hi1);
      }
    }
  }

  float o[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage st landed; every warp is done with st - 1
    if (st + kStages - 1 < n_st) load_stage(st + kStages - 1);
    cp_async_commit();
    const uint32_t buf = sbase + (st % kStages) * kStageBytes;
    for (int t = kl; t < kStageTiles; t += nk) {
      const int tile = st * kStageTiles + t;
      if (tile >= n_tiles) break;
      const int valid = n_keys - tile * kTile;   // keys of the tile, >= 1
      const uint32_t kaddr = buf + t * kTileBytes;
      const uint32_t vaddr = kaddr + kHalfTileBytes;

      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      {
        const int row = ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
        for (int kc = 0; kc < 8; ++kc) {
          const int c = kc * 2 + ((lane >> 3) & 1);
          uint32_t b0, b1, b2, b3;
          ldsm_x4(kaddr + swz(row, c), b0, b1, b2, b3);
          mma_bf16(sc[0], qa[kc], b0, b1);
          mma_bf16(sc[1], qa[kc], b2, b3);
        }
      }
      float mx0 = m_r[0], mx1 = m_r[1];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = nt * 8 + tig * 2 + (e & 1);
          sc[nt][e] = key < valid ? sc[nt][e] * p.scale_log2 : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      const float c0 = exp2f(m_r[0] - mx0), c1 = exp2f(m_r[1] - mx1);
      m_r[0] = mx0;
      m_r[1] = mx1;
      l_r[0] *= c0;
      l_r[1] *= c1;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        o[nt][0] *= c0;
        o[nt][1] *= c0;
        o[nt][2] *= c1;
        o[nt][3] *= c1;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        sc[nt][0] = exp2f(sc[nt][0] - mx0);
        sc[nt][1] = exp2f(sc[nt][1] - mx0);
        sc[nt][2] = exp2f(sc[nt][2] - mx1);
        sc[nt][3] = exp2f(sc[nt][3] - mx1);
        l_r[0] += sc[nt][0] + sc[nt][1];
        l_r[1] += sc[nt][2] + sc[nt][3];
      }
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                              pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]),
                              pack_bf16(sc[1][2], sc[1][3])};
      {
        const int row = (((lane >> 3) & 1) << 3) + (lane & 7);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          const int c = np * 2 + (lane >> 4);
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(vaddr + swz(row, c), b0, b1, b2, b3);
          mma_bf16(o[2 * np], pa, b0, b1);
          mma_bf16(o[2 * np + 1], pa, b2, b3);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l_r[0] += __shfl_xor_sync(0xffffffffu, l_r[0], sh);
    l_r[1] += __shfl_xor_sync(0xffffffffu, l_r[1], sh);
  }
  __syncthreads();   // the stage buffers become the warps' merge

  float* red_o = reinterpret_cast<float*>(smem);        // [warp][16][stride]
  float* red_m = red_o + kWarps * 16 * kRedStride;      // [warp][16]
  float* red_l = red_m + kWarps * 16;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = nt * 8 + tig * 2;
    float* r0 = red_o + (warp * 16 + g) * kRedStride + col;
    float* r1 = r0 + 8 * kRedStride;
    *reinterpret_cast<float2*>(r0) = make_float2(o[nt][0], o[nt][1]);
    *reinterpret_cast<float2*>(r1) = make_float2(o[nt][2], o[nt][3]);
  }
  if (tig == 0) {
    red_m[warp * 16 + g] = m_r[0];
    red_m[warp * 16 + g + 8] = m_r[1];
    red_l[warp * 16 + g] = l_r[0];
    red_l[warp * 16 + g + 8] = l_r[1];
  }
  __syncthreads();

  const int slot0 = suffix ? p.n_split : job;
  const int row0 = suffix ? rs * kGroup : 0;
  for (int i = 0; i < n_rows; ++i) {
    const int it = i >> 4, rr = i & 15;
    float m = -INFINITY;
    for (int kk = 0; kk < nk; ++kk)
      m = fmaxf(m, red_m[(it + kk * n_mt) * 16 + rr]);
    float l = 0.f, acc = 0.f;
    for (int kk = 0; kk < nk; ++kk) {
      const int w = it + kk * n_mt;
      const float f = m == -INFINITY ? 0.f : exp2f(red_m[w * 16 + rr] - m);
      l += red_l[w * 16 + rr] * f;
      acc += red_o[(w * 16 + rr) * kRedStride + tid] * f;
    }
    const size_t prow =
        (static_cast<size_t>(uh) * (p.n_split + 1) + slot0) * RG + row0 + i;
    p.part_o[prow * kDh + tid] = acc;
    if (tid == 0) {
      p.part_ml[2 * prow] = m;
      p.part_ml[2 * prow + 1] = l;
    }
  }
}

// One warp a query row (unique row x head, replica, group member): its
// prefix splits and its suffix merged, divided by the sum, rounded to bf16
// once, written where the o projection reads it.
__global__ void __launch_bounds__(128)
vx_decode_combine_kernel(const float* __restrict__ part_o,
                         const float* __restrict__ part_ml,
                         __nv_bfloat16* __restrict__ out, int UH, int H,
                         int R, int n_slots) {
  const int RG = R * kGroup;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= UH * RG) return;
  const int uh = row / RG, i = row % RG;
  const int u = uh / H, h = uh % H;
  const int r = i / kGroup, j = i % kGroup;
  const size_t base = static_cast<size_t>(uh) * n_slots * RG + i;
  float m = -INFINITY;
  for (int s = 0; s < n_slots; ++s)
    m = fmaxf(m, part_ml[2 * (base + static_cast<size_t>(s) * RG)]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_slots; ++s) {
    const size_t prow = base + static_cast<size_t>(s) * RG;
    const float ms = part_ml[2 * prow];
    const float f = ms == -INFINITY ? 0.f : exp2f(ms - m);
    l += part_ml[2 * prow + 1] * f;
    const float4 x = reinterpret_cast<const float4*>(part_o + prow * kDh)[lane];
    acc.x += x.x * f;
    acc.y += x.y * f;
    acc.z += x.z * f;
    acc.w += x.w * f;
  }
  const size_t dst =
      ((static_cast<size_t>(u) * R + r) * H * kGroup + h * kGroup + j) * kDh +
      lane * 4;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + dst);
  o2[0] = __floats2bfloat162_rn(acc.x / l, acc.y / l);
  o2[1] = __floats2bfloat162_rn(acc.z / l, acc.w / l);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// q [U R, 4 H, 128], k and v [U R, H, 128] bf16 (the projections' rows, R
// replicas of each unique row consecutive); cos, sin [128] f32; step a 0-d
// int64 on the device; pk, pv [U, H, P, 128] and sk, sv [U, H, R, M, 128]
// bf16; part_o [U H, n_split + 1, 4 R, 128] and part_ml [U H, n_split + 1,
// 4 R, 2] f32 scratch; out [U R, 4 H, 128] bf16. The prefix's keys are cut
// into n_split runs of split_keys (the last one shorter). Every pointer
// 16-byte aligned, every tensor contiguous. Returns cudaGetLastError() after
// each launch, or an invalid-value code before the first.
extern "C" int cc_vx_decode_attention(
    const void* q, const void* k, const void* v, const float* cos,
    const float* sin, const long long* step, const void* pk, const void* pv,
    void* sk, void* sv, float* part_o, float* part_ml, void* out, int U,
    int H, int R, int P, int M, int n_split, int split_keys, float scale,
    cudaStream_t stream) {
  if (U < 1 || H < 1 || R < 1 || R > kMaxReplicas || P < 1 || M < 1 ||
      split_keys < 1 || n_split < 1 ||
      static_cast<long long>(n_split) * split_keys < P ||
      static_cast<long long>(n_split - 1) * split_keys >= P ||
      static_cast<long long>(U) * H > 65535 || n_split + R > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {q, k, v, cos, sin, step, pk, pv, sk, sv,
                        part_o, part_ml, out};
  for (const void* ptr : ptrs)
    if (ptr == nullptr || !aligned16(ptr))
      return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        vx_decode_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.cos = cos;
  p.sin = sin;
  p.step = step;
  p.pk = static_cast<const __nv_bfloat16*>(pk);
  p.pv = static_cast<const __nv_bfloat16*>(pv);
  p.sk = static_cast<__nv_bfloat16*>(sk);
  p.sv = static_cast<__nv_bfloat16*>(sv);
  p.part_o = part_o;
  p.part_ml = part_ml;
  p.H = H;
  p.R = R;
  p.P = P;
  p.M = M;
  p.n_split = n_split;
  p.split_keys = split_keys;
  p.scale_log2 = scale * 1.4426950408889634f;
  vx_decode_attn_kernel<<<dim3(n_split + R, U * H), kThreads, kSmemBytes,
                          stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = U * H * R * kGroup;
  vx_decode_combine_kernel<<<(rows + 3) / 4, 128, 0, stream>>>(
      part_o, part_ml, static_cast<__nv_bfloat16*>(out), U * H, H, R,
      n_split + 1);
  return static_cast<int>(cudaGetLastError());
}

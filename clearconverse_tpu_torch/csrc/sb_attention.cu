// RE-SepFormer segment attention: softmax(q k^T / sqrt(16)) v for every
// (segment, head) of a segment block's self-attention, read straight from
// the in-projection's output and written straight into the out-projection's
// input, with the scores kept on the SM.
//
// Replaces no TPU kernel: the JAX package runs this attention as explicit
// products and a softmax (clearconverse_tpu/models/resepformer.py), as did
// the port until this kernel (models/resepformer.py::_sb_mha: chunk,
// transpose and scale copies, a batched Q K^T, a softmax, a batched P V and
// a transpose copy, about 0.5 s of device time a pass of the overlap cell).
// Each segment-layer wrote 150 x 150 x 8 heads x 4 B = 720 KB of scores
// that the softmax read and wrote again and P V read once more.
//
// What bounds it on an H100: instructions. A segment of 150 frames is
// 2 x 150^2 x 128 = 5.8 M multiply-adds a layer against 230 KB of q/k/v
// read and 77 KB written (23 us of FMA at 67 TFLOP/s against 0.09 us of
// HBM for one segment, so the float32 FMA rate, not the bytes, is the
// roof). The separator is served in float32 with TF32 off, so the products
// run as float32 FMAs: exact float32, and the work is small (about 3.7
// TFLOP a pass of the overlap cell).
//
// Design: one CTA per (segment, head), two queries a thread (t and t +
// ceil(T / 2), the threads rounded up to a warp; T <= 256). The head's K
// and V rows (16 floats, 64 B each) are staged in shared memory,
// zero-padded to a multiple of 16 keys; every thread reads the same key at
// once, so the reads broadcast, and each read feeds both queries' FMAs (one
// query a thread left the kernel bound by those shared-memory reads). q is scaled
// by 16^-0.5 = 0.25 (exact) as the plain version scales it. The softmax is
// online over chunks of 16 keys (running max and sum, the accumulator
// rescaled once a chunk), and the output is divided by the sum at the end.
// Rows of qkv are [q | k | v] of 3 x d_model floats; head h is the 16
// columns at h * 16 of each part.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 16;        // head width of the published separator
constexpr int kMaxKeys = 256;  // the longest segment one CTA takes
constexpr int kChunk = 16;     // keys a softmax update
constexpr int kQ = 2;          // queries a thread

__global__ void __launch_bounds__(kMaxKeys / kQ)
sb_seg_attn_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                   int seg_len, int padded, int d_model, float scale) {
  extern __shared__ float4 kv[];   // K rows, then V rows: [padded][4] each
  float4* ks = kv;
  float4* vs = kv + padded * (kDh / 4);

  const int col = blockIdx.y * kDh;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * seg_len;
  const int ld = 3 * d_model;
  const int half = (seg_len + kQ - 1) / kQ;   // thread t: queries t, t + half

  for (int e = threadIdx.x; e < padded * (kDh / 4); e += blockDim.x) {
    const int key = e / (kDh / 4);
    const int part = e % (kDh / 4);
    float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
    if (key < seg_len) {
      const float* r = qkv + (row0 + key) * ld + col + 4 * part;
      kk = *reinterpret_cast<const float4*>(r + d_model);
      vv = *reinterpret_cast<const float4*>(r + 2 * d_model);
    }
    ks[e] = kk;
    vs[e] = vv;
  }
  int qi[kQ];
  float q[kQ][kDh], acc[kQ][kDh], m[kQ], l[kQ];
#pragma unroll
  for (int a = 0; a < kQ; ++a) {
    qi[a] = threadIdx.x + a * half;
    // A thread past the last query repeats it and stores nothing.
    const int row = qi[a] < seg_len ? qi[a] : seg_len - 1;
    const float4* qrow =
        reinterpret_cast<const float4*>(qkv + (row0 + row) * ld + col);
#pragma unroll
    for (int d4 = 0; d4 < kDh / 4; ++d4) {
      const float4 x = qrow[d4];
      q[a][4 * d4] = x.x * scale;
      q[a][4 * d4 + 1] = x.y * scale;
      q[a][4 * d4 + 2] = x.z * scale;
      q[a][4 * d4 + 3] = x.w * scale;
    }
#pragma unroll
    for (int d = 0; d < kDh; ++d) acc[a][d] = 0.f;
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= half) return;

  for (int j0 = 0; j0 < padded; j0 += kChunk) {
    float s[kQ][kChunk], mx[kQ];
#pragma unroll
    for (int a = 0; a < kQ; ++a) mx[a] = m[a];
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const float4* kr = ks + (j0 + jj) * (kDh / 4);
      float dot[kQ];
#pragma unroll
      for (int a = 0; a < kQ; ++a) dot[a] = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kDh / 4; ++d4) {
        const float4 kk = kr[d4];
#pragma unroll
        for (int a = 0; a < kQ; ++a) {
          dot[a] = fmaf(q[a][4 * d4], kk.x, dot[a]);
          dot[a] = fmaf(q[a][4 * d4 + 1], kk.y, dot[a]);
          dot[a] = fmaf(q[a][4 * d4 + 2], kk.z, dot[a]);
          dot[a] = fmaf(q[a][4 * d4 + 3], kk.w, dot[a]);
        }
      }
#pragma unroll
      for (int a = 0; a < kQ; ++a) {
        s[a][jj] = j0 + jj < seg_len ? dot[a] : -INFINITY;
        mx[a] = fmaxf(mx[a], s[a][jj]);
      }
    }
#pragma unroll
    for (int a = 0; a < kQ; ++a) {
      const float corr = expf(m[a] - mx[a]);   // 0 on the first chunk
      l[a] *= corr;
#pragma unroll
      for (int d = 0; d < kDh; ++d) acc[a][d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[a][jj] = expf(s[a][jj] - mx[a]);     // 0 for the padded keys
        l[a] += s[a][jj];
      }
      m[a] = mx[a];
    }
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const float4* vr = vs + (j0 + jj) * (kDh / 4);
#pragma unroll
      for (int d4 = 0; d4 < kDh / 4; ++d4) {
        const float4 vv = vr[d4];
#pragma unroll
        for (int a = 0; a < kQ; ++a) {
          const float p = s[a][jj];
          acc[a][4 * d4] = fmaf(p, vv.x, acc[a][4 * d4]);
          acc[a][4 * d4 + 1] = fmaf(p, vv.y, acc[a][4 * d4 + 1]);
          acc[a][4 * d4 + 2] = fmaf(p, vv.z, acc[a][4 * d4 + 2]);
          acc[a][4 * d4 + 3] = fmaf(p, vv.w, acc[a][4 * d4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kQ; ++a) {
    if (qi[a] >= seg_len) continue;
    const float inv = 1.f / l[a];
    float4* orow =
        reinterpret_cast<float4*>(out + (row0 + qi[a]) * d_model + col);
#pragma unroll
    for (int d4 = 0; d4 < kDh / 4; ++d4)
      orow[d4] = make_float4(acc[a][4 * d4] * inv, acc[a][4 * d4 + 1] * inv,
                             acc[a][4 * d4 + 2] * inv,
                             acc[a][4 * d4 + 3] * inv);
  }
}

}  // namespace

// qkv: contiguous [n_seg * seg_len, 3 * n_heads * 16] f32, 16-byte aligned;
// out: [n_seg * seg_len, n_heads * 16]. Every run of seg_len rows is one
// segment, attended over alone (no mask), 1 <= seg_len <= 256. Returns
// cudaGetLastError() of the launch (or an invalid-value code before it).
extern "C" int cc_sb_seg_attention(const float* qkv, float* out, int n_seg,
                                   int seg_len, int n_heads, float scale,
                                   cudaStream_t stream) {
  if (n_seg < 1 || seg_len < 1 || seg_len > kMaxKeys || n_heads < 1 ||
      n_heads > 65535 || (reinterpret_cast<uintptr_t>(qkv) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int padded = (seg_len + kChunk - 1) / kChunk * kChunk;
  const int threads = ((seg_len + kQ - 1) / kQ + 31) / 32 * 32;
  const size_t smem = 2 * static_cast<size_t>(padded) * kDh * sizeof(float);
  sb_seg_attn_kernel<<<dim3(n_seg, n_heads), threads, smem, stream>>>(
      qkv, out, seg_len, padded, n_heads * kDh, scale);
  return static_cast<int>(cudaGetLastError());
}

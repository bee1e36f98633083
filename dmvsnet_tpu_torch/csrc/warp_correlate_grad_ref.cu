// Adjoint of the fused warp-correlate cost pass with respect to the
// REFERENCE features.
//
// Replaces the TPU kernel dmvsnet_tpu/ops/pallas/warp_correlate.py
// _make_grad_ref_kernel (called from _corr_view_tiled_bwd).  It computes that
// kernel's contract, not its blocking: the TPU body re-forms the warped
// source with band matmuls over a DMA'd window and revisits its output block
// once per depth group, one source view per call.  A CUDA thread gathers the
// taps directly and keeps its sum over planes AND views in registers, so one
// launch covers the whole pass and nothing is accumulated through memory.
//
// Contract (fp32, contiguous, natural channel order, group g(c) = c % 2):
//   feats (B, V, H, W, C)  rel (B, V-1, 3, 4)  depth (B, D, H, W)
//   cot   (B, D, H, W, 2)  cotangent of the cost volume
//   grad  (B, V, H, W, C)  only slot v = 0 is written:
//     grad[b,0,y,x,c] = 2/C * sum_d cot[b,d,y,x,g(c)]
//                            * sum_{v>=1} sum_t w_t(b,v,d,y,x) * feats[b,v,tap_t,c]
// with the taps and weights of warp_geometry.cuh (bit-identical to the
// forward's); the sampling grid carries no gradient.
//
// Design: one thread per (b, y, x, 8 channels), the C/8 threads of a pixel
// on consecutive lanes, so the lanes of a warp read each tap as contiguous
// 32-byte pieces.  The thread loops over the planes and, inside, the source
// views; it reads depth and the cotangent pair once per plane and writes two
// float4 at the end.  No atomics: each output element has one owner.
//
// What bounds it on an H100: per (pixel, plane, view) about 8*C + 20 fp32
// operations, per (pixel, plane) 12 bytes of compulsory traffic (depth and
// the cotangent pair) plus the features once.  Like the forward, the deep
// main sweeps (C = 32/16, D = 48/32) are bound by the fp32 operations, the
// 4-plane refine passes and the stage-3 sweep by the bytes.  This version
// recomputes the geometry in each of a pixel's C/8 threads and re-reads the
// taps from L1/L2 for every plane; chip_smoke.py reports its time beside the
// bound.  Later work: share the geometry across the lanes of a pixel with
// shuffles, split the planes of a deep sweep across threads.

#include <cuda_runtime.h>

#include "warp_geometry.cuh"

namespace {

__device__ __forceinline__ void axpy(float4& acc, float w, const float4 v) {
  acc.x += w * v.x;
  acc.y += w * v.y;
  acc.z += w * v.z;
  acc.w += w * v.w;
}

template <int C>
__global__ void __launch_bounds__(256) warp_correlate_grad_ref_kernel(
    const float* __restrict__ feats, const float* __restrict__ rel,
    const float* __restrict__ depth, const float* __restrict__ cot,
    float* __restrict__ grad, int B, int V, int D, int H, int W) {
  static_assert(C % 8 == 0, "C must be a multiple of 8");
  constexpr int G = C / 8;  // threads per pixel
  const long long hw = (long long)H * W;
  const long long n = (long long)B * hw * G;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const int k = (int)(i % G);
  const long long pixel = i / G;  // over (b, y, x)
  const int x = (int)(pixel % W);
  const long long row = pixel / W;
  const int y = (int)(row % H);
  const int b = (int)(row / H);
  const long long yx = (long long)y * W + x;
  const float fx = (float)x;
  const float fy = (float)y;
  const float* relb = rel + (long long)b * (V - 1) * 12;

  float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
  for (int d = 0; d < D; ++d) {
    const long long p = ((long long)b * D + d) * hw + yx;
    const float dep = __ldg(depth + p);
    const float2 ct = __ldg(reinterpret_cast<const float2*>(cot) + p);
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
    for (int v = 1; v < V; ++v) {
      const dmvs::Taps t = dmvs::sample_taps(relb + (v - 1) * 12, fx, fy, dep, H, W);
      const float* src = feats + ((long long)b * V + v) * hw * C + k * 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4* q = reinterpret_cast<const float4*>(src + (long long)t.pix[j] * C);
        axpy(s0, t.w[j], __ldg(q));
        axpy(s1, t.w[j], __ldg(q + 1));
      }
    }
    // channel 8k+j belongs to group j % 2
    a0.x += ct.x * s0.x;  a0.y += ct.y * s0.y;  a0.z += ct.x * s0.z;  a0.w += ct.y * s0.w;
    a1.x += ct.x * s1.x;  a1.y += ct.y * s1.y;  a1.z += ct.x * s1.z;  a1.w += ct.y * s1.w;
  }
  const float s = 2.0f / (float)C;  // exact: C/2 is a power of two
  float4* out = reinterpret_cast<float4*>(grad + ((long long)b * V * hw + yx) * C + k * 8);
  out[0] = make_float4(a0.x * s, a0.y * s, a0.z * s, a0.w * s);
  out[1] = make_float4(a1.x * s, a1.y * s, a1.z * s, a1.w * s);
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a channel
// count without an instantiation).
extern "C" int dmvs_warp_correlate_grad_ref(const float* feats, const float* rel,
                                            const float* depth, const float* cot,
                                            float* grad, int B, int V, int D, int H,
                                            int W, int C, void* stream) {
  const long long n = (long long)B * H * W * (C / 8);
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8:
      warp_correlate_grad_ref_kernel<8><<<blocks, threads, 0, s>>>(feats, rel, depth, cot, grad, B, V, D, H, W);
      break;
    case 16:
      warp_correlate_grad_ref_kernel<16><<<blocks, threads, 0, s>>>(feats, rel, depth, cot, grad, B, V, D, H, W);
      break;
    case 32:
      warp_correlate_grad_ref_kernel<32><<<blocks, threads, 0, s>>>(feats, rel, depth, cot, grad, B, V, D, H, W);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

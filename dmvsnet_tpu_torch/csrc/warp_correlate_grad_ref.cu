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
// forward's); the sampling grid carries no gradient.  H*W < 2^29 (the tap
// code passed between lanes; the wrappers refuse larger images).
//
// What bounds it on an H100: per (pixel, plane, view) 8*C + 20 fp32
// operations (4 taps x C multiply-adds, the geometry), per (pixel, plane)
// 12 bytes of compulsory traffic (depth, the cotangent pair) plus the
// features once: the deep main sweeps (C = 32/16, D = 48/32) are bound by
// the operations, the 4-plane refine passes and the stage-3 sweep by the
// bytes.  What sets its pace beyond that is not measured (no profiler on
// the card): the designs below were timed side by side instead.
//
// What bounded the first version (one thread per (b, y, x, 8 channels),
// looping over planes and views): each of a pixel's C/8 threads formed the
// same geometry for every sample (three IEEE divisions, 4x redundant at
// C = 32), and the deep s1 main sweep at 128x160 had only 163,840 threads,
// each working through 48 x 4 samples in sequence, so little latency was
// hidden.
//
// Design: a pixel's C channels lie on L = C/4 consecutive lanes (a lane
// group), one float4 each, as in the forward kernel, and a group takes all
// planes of its pixel in runs of P (8, 4, 2 at C = 32, 16, 8: a per-C
// constant).  Per source view the lanes of a group form the geometry of a
// run's planes once (lane k planes k, k + L, ...) and pass each plane's 4
// weights and packed tap pixels to the others by shuffles
// (dmvs::form_group_taps / group_taps, the forward kernel's code); then
// the taps of all P planes are loaded unconditionally (a plane past D has
// depth 0 and is read but never added), so that a run's loads are in
// flight together.  The sums of a run are kept per plane over all views and
// multiplied by the plane's cotangent pair once.  No atomics: each output
// element has one owner.
//
// Designs that lost, summed over the six passes of one backward on the
// smoke's synthetic inputs / on the model's train inputs (chip_smoke.py;
// NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6): shipped 1.070 / 0.948
// ms; the first version 1.534 / 1.338; P = 4 at every C 1.133 / 0.981; P = 8
// 1.500 / 1.279; P = 2 1.292 / 1.195; loads reused while a plane's cell
// repeats (so taken plane by plane) 1.185 / 1.035; that with the planes of
// a deep sweep split across 4 lane groups of the pixel in one warp,
// reduced by shuffles, 1.303 / 1.119: a warp's loads then fall on 4 planes
// of one pixel, far apart, where unsplit they fall on the same plane of 4
// neighbouring pixels.

#include <cuda_runtime.h>

#include "warp_geometry.cuh"

namespace {

// planes per run of a lane group
template <int C> struct Planes;
template <> struct Planes<8> { static constexpr int P = 2; };
template <> struct Planes<16> { static constexpr int P = 4; };
template <> struct Planes<32> { static constexpr int P = 8; };

template <int C, int P>
__global__ void __launch_bounds__(256) warp_correlate_grad_ref_kernel(
    const float* __restrict__ feats, const float* __restrict__ rel,
    const float* __restrict__ depth, const float* __restrict__ cot,
    float* __restrict__ grad, int B, int V, int D, int H, int W) {
  static_assert(C % 4 == 0 && 32 % (C / 4) == 0, "C/4 lanes must divide a warp");
  constexpr int L = C / 4;            // lanes per pixel, one float4 each
  constexpr int Q = (P + L - 1) / L;  // planes of a run whose geometry a lane forms
  const long long hw = (long long)H * W;
  const long long n = (long long)B * hw;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // every lane runs the shuffles below: a pixel's lanes lie inside one
  // warp, and a pixel past the end works on pixel 0 and writes nothing
  const bool live = t / L < n;
  const long long pixel = live ? t / L : 0;  // over (b, y, x), x fastest
  const int k = (int)(t % L);
  const int x = (int)(pixel % W);
  const long long row = pixel / W;
  const int y = (int)(row % H);
  const int b = (int)(row / H);
  const long long yx = (long long)y * W + x;
  const float fx = (float)x;
  const float fy = (float)y;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int d0 = 0; d0 < D; d0 += P) {
    // lane k forms the geometry of planes k, k + L, ... of the run; a plane
    // past D gets depth 0: its taps are read but it adds nothing
    float dep[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int d = d0 + q * L + k;
      dep[q] = (q * L + k < P && d < D) ? __ldg(depth + ((long long)b * D + d) * hw + yx) : 0.0f;
    }
    float4 a[P];
#pragma unroll
    for (int p = 0; p < P; ++p) a[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int v = 1; v < V; ++v) {
      const float* m = rel + ((long long)b * (V - 1) + (v - 1)) * 12;
      const dmvs::GroupTaps<Q> geo = dmvs::form_group_taps<Q>(m, dmvs::pixel_rays(m, fx, fy),
                                                              dep, H, W);
      const float4* src = reinterpret_cast<const float4*>(feats + ((long long)b * V + v) * hw * C) + k;
      // the loads of the run's planes are unconditional, so they are in
      // flight together
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const dmvs::PackedTaps tp = dmvs::group_taps<L>(geo, p);
        long long pix[4];
        dmvs::tap_pixels(tp.code, W, pix);
        const float4 e0 = __ldg(src + pix[0] * L), e1 = __ldg(src + pix[1] * L);
        const float4 e2 = __ldg(src + pix[2] * L), e3 = __ldg(src + pix[3] * L);
        a[p].x += e0.x * tp.w[0] + e1.x * tp.w[1] + e2.x * tp.w[2] + e3.x * tp.w[3];
        a[p].y += e0.y * tp.w[0] + e1.y * tp.w[1] + e2.y * tp.w[2] + e3.y * tp.w[3];
        a[p].z += e0.z * tp.w[0] + e1.z * tp.w[1] + e2.z * tp.w[2] + e3.z * tp.w[3];
        a[p].w += e0.w * tp.w[0] + e1.w * tp.w[1] + e2.w * tp.w[2] + e3.w * tp.w[3];
      }
    }
    // channel 4k+j belongs to group j % 2
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (d0 + p < D) {
        const float2 ct = __ldg(reinterpret_cast<const float2*>(cot)
                                + ((long long)b * D + d0 + p) * hw + yx);
        acc.x += ct.x * a[p].x;
        acc.y += ct.y * a[p].y;
        acc.z += ct.x * a[p].z;
        acc.w += ct.y * a[p].w;
      }
    }
  }
  if (live) {
    const float c2 = 2.0f / (float)C;  // exact: C/2 is a power of two
    reinterpret_cast<float4*>(grad + ((long long)b * V * hw + yx) * C)[k] =
        make_float4(acc.x * c2, acc.y * c2, acc.z * c2, acc.w * c2);
  }
}

template <int C>
int launch_grad_ref(const float* feats, const float* rel, const float* depth, const float* cot,
                    float* grad, int B, int V, int D, int H, int W, cudaStream_t s) {
  const long long n = (long long)B * H * W * (C / 4);
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  warp_correlate_grad_ref_kernel<C, Planes<C>::P><<<blocks, threads, 0, s>>>(
      feats, rel, depth, cot, grad, B, V, D, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a channel
// count without an instantiation).
extern "C" int dmvs_warp_correlate_grad_ref(const float* feats, const float* rel,
                                            const float* depth, const float* cot,
                                            float* grad, int B, int V, int D, int H,
                                            int W, int C, void* stream) {
  if ((long long)B * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return launch_grad_ref<8>(feats, rel, depth, cot, grad, B, V, D, H, W, s);
    case 16: return launch_grad_ref<16>(feats, rel, depth, cot, grad, B, V, D, H, W, s);
    case 32: return launch_grad_ref<32>(feats, rel, depth, cot, grad, B, V, D, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

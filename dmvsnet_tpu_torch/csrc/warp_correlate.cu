// Fused plane-sweep warp + 2-group correlation, summed over source views.
//
// Replaces the TPU kernel dmvsnet_tpu/ops/pallas/warp_correlate.py
// _make_kernel (called through _corr_view_tiled / aggregate_cost_volume_pallas).
// It computes that kernel's contract, not its TPU blocking: the TPU cannot
// gather, so it expresses bilinear sampling as band matmuls over lane-tiled
// windows with a span check and an XLA fallback.  A CUDA thread gathers
// directly and has no window limit, so none of that is carried over.
//
// Contract (fp32, natural channel order: group g owns channels {2k+g}):
//   feats (B, V, H, W, C)   view 0 = reference, views 1..V-1 = sources
//   rel   (B, V-1, 3, 4)    rows of src_v @ inv(ref) (fused projections)
//   depth (B, D, H, W)      per-pixel hypotheses
//   out   (B, D, H, W, 2)   out[b,d,y,x,g] =
//       sum_{v=1..V-1} mean_k( bilinear(src_v, p_v(x,y,d))[2k+g] * ref[y,x,2k+g] )
// with p_v = R (x, y, 1)^T d + t, (px, py) = (p0/z, p1/z), z == 0 -> 1e-5,
// zero padding outside the image, views summed in order 1..V-1.
//
// Design: one thread per (b, d, y, x), threads consecutive along x.  The
// thread keeps its C reference channels in registers, loops over the views
// in order, and for each view takes the 4 taps as float4 loads of C
// contiguous floats (channels-last), forming both group sums on the fly;
// it writes one float2.  px/py are clamped to [-2, W+1] x [-2, H+1] before
// floorf (warp_geometry.cuh, shared with the adjoint kernels): refine
// hypotheses can be negative or huge, a float->int conversion out of range
// is undefined, and taps outside the image carry weight 0 either way.
//
// What bounds it on an H100: per (pixel, plane, view) it does about
// 10*C + 20 fp32 operations against at least 12 bytes per (pixel, plane)
// of compulsory traffic (depth in, 2 floats out) plus the features once.
// The deep main sweeps of stages 1-2 (C = 32/16, D = 48/32) are bound by
// those fp32 operations (67 TFLOP/s without tensor cores); the stage-3
// sweep and the 4-plane refine passes by the bytes (3.35 TB/s), where the
// features read once dominate.  This first version re-reads each
// source tap from L1/L2 for every plane and keeps no shared-memory tile;
// chip_smoke.py reports its time beside both bounds.  Later work: several
// planes per thread (the reference channels and the ray R (x, y, 1)^T are
// shared across planes), shared-memory tiles of the source window.

#include <cuda_runtime.h>

#include "warp_geometry.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(256) warp_correlate_kernel(
    const float* __restrict__ feats, const float* __restrict__ rel,
    const float* __restrict__ depth, float* __restrict__ out,
    int B, int V, int D, int H, int W) {
  static_assert(C % 4 == 0, "C must be a multiple of 4");
  constexpr int C4 = C / 4;
  const long long hw = (long long)H * W;
  const long long n = (long long)B * D * hw;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const int x = (int)(i % W);
  const long long row = i / W;
  const int y = (int)(row % H);
  const int b = (int)(row / H / D);

  const float dep = __ldg(depth + i);
  const float fx = (float)x;
  const float fy = (float)y;

  const float4* ref4 = reinterpret_cast<const float4*>(
      feats + ((long long)b * V * hw + (long long)y * W + x) * C);
  float4 r[C4];
#pragma unroll
  for (int k = 0; k < C4; ++k) r[k] = __ldg(ref4 + k);

  const float inv_half = 2.0f / (float)C;  // exact: C/2 is a power of two
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int v = 1; v < V; ++v) {
    const float* m = rel + ((long long)b * (V - 1) + (v - 1)) * 12;
    // coordinates and tap weights round exactly as the plain version's
    // separate elementwise ops do (warp_geometry.cuh); a tap outside the
    // image reads a border pixel with weight 0
    const dmvs::Taps t = dmvs::sample_taps(m, fx, fy, dep, H, W);
    const float w00 = t.w[0], w10 = t.w[1], w01 = t.w[2], w11 = t.w[3];
    const float* src = feats + ((long long)b * V + v) * hw * C;
    const float4* t00 = reinterpret_cast<const float4*>(src + (long long)t.pix[0] * C);
    const float4* t10 = reinterpret_cast<const float4*>(src + (long long)t.pix[1] * C);
    const float4* t01 = reinterpret_cast<const float4*>(src + (long long)t.pix[2] * C);
    const float4* t11 = reinterpret_cast<const float4*>(src + (long long)t.pix[3] * C);

    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int k = 0; k < C4; ++k) {
      const float4 a = __ldg(t00 + k), c = __ldg(t10 + k);
      const float4 e = __ldg(t01 + k), g = __ldg(t11 + k);
      const float q0 = a.x * w00 + c.x * w10 + e.x * w01 + g.x * w11;  // channel 4k   (group 0)
      const float q1 = a.y * w00 + c.y * w10 + e.y * w01 + g.y * w11;  // channel 4k+1 (group 1)
      const float q2 = a.z * w00 + c.z * w10 + e.z * w01 + g.z * w11;  // channel 4k+2 (group 0)
      const float q3 = a.w * w00 + c.w * w10 + e.w * w01 + g.w * w11;  // channel 4k+3 (group 1)
      s0 += q0 * r[k].x + q2 * r[k].z;
      s1 += q1 * r[k].y + q3 * r[k].w;
    }
    acc0 += s0 * inv_half;
    acc1 += s1 * inv_half;
  }
  reinterpret_cast<float2*>(out)[i] = make_float2(acc0, acc1);
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a channel
// count without an instantiation).
extern "C" int dmvs_warp_correlate(const float* feats, const float* rel,
                                   const float* depth, float* out, int B,
                                   int V, int D, int H, int W, int C,
                                   void* stream) {
  const long long n = (long long)B * D * H * W;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8:
      warp_correlate_kernel<8><<<blocks, threads, 0, s>>>(feats, rel, depth, out, B, V, D, H, W);
      break;
    case 16:
      warp_correlate_kernel<16><<<blocks, threads, 0, s>>>(feats, rel, depth, out, B, V, D, H, W);
      break;
    case 32:
      warp_correlate_kernel<32><<<blocks, threads, 0, s>>>(feats, rel, depth, out, B, V, D, H, W);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

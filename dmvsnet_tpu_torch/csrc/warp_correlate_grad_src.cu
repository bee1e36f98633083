// Adjoint of the fused warp-correlate cost pass with respect to the SOURCE
// features.
//
// Replaces the TPU kernel dmvsnet_tpu/ops/pallas/warp_correlate.py
// _make_grad_src_kernel (called from _corr_view_tiled_bwd).  It computes that
// kernel's contract, not its blocking: the TPU body runs a sequential grid
// that reads, updates and writes back a window of the gradient in HBM with a
// transposed band matmul, one source view per call.  Blocks on a GPU run in
// no order, so a concurrent scatter needs atomics; a thread computes its 4
// taps and adds into them directly.  One launch covers every source view.
//
// Contract (fp32, contiguous, natural channel order, group g(c) = c % 2):
//   feats (B, V, H, W, C)  rel (B, V-1, 3, 4)  depth (B, D, H, W)
//   cot   (B, D, H, W, 2)  cotangent of the cost volume
//   grad  (B, V, H, W, C)  slots v >= 1 must be ZERO on entry and receive
//     grad[b,v,tap_t,c] += 2/C * cot[b,d,y,x,g(c)] * w_t(b,v,d,y,x) * feats[b,0,y,x,c]
//   for every (d, y, x) and each of its 4 taps; slot 0 is not touched.
// Taps and weights are those of warp_geometry.cuh (bit-identical to the
// forward's).  A tap outside the image has weight exactly 0 and is skipped:
// it adds nothing and nothing outside the buffer is addressed.
//
// Design: one thread per (b, d, y, x, 8 channels), the C/8 threads of a
// sample on consecutive lanes.  The thread forms its 8 values
// 2/C * cot[g(c)] * ref[c] once, loops over the source views, and issues per
// valid tap two float4 atomic adds (atomicAdd on float4, global memory,
// sm_90) to 32 contiguous bytes; the lanes of a sample cover C contiguous
// floats.  fp32 atomics make the sums order-dependent, so two runs differ in
// the last bits; chip_smoke.py prints the spread.
//
// What bounds it on an H100: the compulsory traffic is small (12 bytes per
// (pixel, plane) plus the reference features in and the gradient out once),
// and the arithmetic is about 2*C operations per valid tap, so the stated
// bound is far below what a scatter can reach: the kernel issues
// B*D*H*W*(V-1)*4*C/4 vector atomics, resolved in L2.  chip_smoke.py reports
// its time beside the bound and the count of atomic adds.  Later work:
// combine the planes of a pixel that hit the same tap before going to
// memory (shared-memory tiles of the gradient window).

#include <cuda_runtime.h>

#include "warp_geometry.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(256) warp_correlate_grad_src_kernel(
    const float* __restrict__ feats, const float* __restrict__ rel,
    const float* __restrict__ depth, const float* __restrict__ cot,
    float* __restrict__ grad, int B, int V, int D, int H, int W) {
  static_assert(C % 8 == 0, "C must be a multiple of 8");
  constexpr int G = C / 8;  // threads per (pixel, plane)
  const long long hw = (long long)H * W;
  const long long n = (long long)B * D * hw * G;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const int k = (int)(i % G);
  const long long p = i / G;  // over (b, d, y, x)
  const int x = (int)(p % W);
  const long long row = p / W;
  const int y = (int)(row % H);
  const int b = (int)(row / H / D);

  const float dep = __ldg(depth + p);
  const float2 ct = __ldg(reinterpret_cast<const float2*>(cot) + p);
  const float s = 2.0f / (float)C;  // exact: C/2 is a power of two
  const float c0 = ct.x * s, c1 = ct.y * s;
  const float4* ref = reinterpret_cast<const float4*>(
      feats + ((long long)b * V * hw + (long long)y * W + x) * C + k * 8);
  const float4 r0 = __ldg(ref), r1 = __ldg(ref + 1);
  // channel 8k+j belongs to group j % 2
  const float4 v0 = make_float4(r0.x * c0, r0.y * c1, r0.z * c0, r0.w * c1);
  const float4 v1 = make_float4(r1.x * c0, r1.y * c1, r1.z * c0, r1.w * c1);

  const float fx = (float)x;
  const float fy = (float)y;
  const float* relb = rel + (long long)b * (V - 1) * 12;
  for (int v = 1; v < V; ++v) {
    const dmvs::Taps t = dmvs::sample_taps(relb + (v - 1) * 12, fx, fy, dep, H, W);
    float* dst = grad + ((long long)b * V + v) * hw * C + k * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float w = t.w[j];
      if (w != 0.0f) {
        float4* q = reinterpret_cast<float4*>(dst + (long long)t.pix[j] * C);
        atomicAdd(q, make_float4(v0.x * w, v0.y * w, v0.z * w, v0.w * w));
        atomicAdd(q + 1, make_float4(v1.x * w, v1.y * w, v1.z * w, v1.w * w));
      }
    }
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a channel
// count without an instantiation).
extern "C" int dmvs_warp_correlate_grad_src(const float* feats, const float* rel,
                                            const float* depth, const float* cot,
                                            float* grad, int B, int V, int D, int H,
                                            int W, int C, void* stream) {
  const long long n = (long long)B * D * H * W * (C / 8);
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8:
      warp_correlate_grad_src_kernel<8><<<blocks, threads, 0, s>>>(feats, rel, depth, cot, grad, B, V, D, H, W);
      break;
    case 16:
      warp_correlate_grad_src_kernel<16><<<blocks, threads, 0, s>>>(feats, rel, depth, cot, grad, B, V, D, H, W);
      break;
    case 32:
      warp_correlate_grad_src_kernel<32><<<blocks, threads, 0, s>>>(feats, rel, depth, cot, grad, B, V, D, H, W);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

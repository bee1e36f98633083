// Rectified 1-D plane sweep + 2-group correlation for one (ref, src) pair
// per image slot.
//
// Replaces the TPU kernel dmvsnet_tpu/ops/pallas/epipolar_sweep.py
// _make_sweep1d_kernel (called through _sweep1d).  It computes that kernel's
// contract, not its TPU blocking: the band matmuls against a lane-tiled
// window, the static row-selection masks of the row-packed layout, the
// 128-aligned window origins with their span check, and the group-major
// channel permutation are the TPU's way of gathering along a scanline and do
// not cross.
//
// Contract (fp32, natural channel order: group g owns channels {2k+g}):
//   src_r (N, H, W, C)   rectified source features
//   ref_r (N, H, W, C)   rectified reference features
//   px    (N, D, H, W)   per plane, the column of src_r's row y that
//                        matches rect pixel (y, x)
//   out   (N, D, H, W, 2)
//     out[n,d,y,x,g] = mean_k( lerp(src_r[n,y,:,2k+g], px[n,d,y,x]) * ref_r[n,y,x,2k+g] )
// The lerp runs between columns floor(px) and floor(px)+1; a column outside
// [0, W-1] contributes 0.  px is clamped to [-2, W+1] before floorf (huge
// refine-fan coordinates), and the two weights are rounded op by op, as
// ops/epipolar_sweep.sweep1d_plain rounds them.
//
// Design: one thread per rect pixel (n, y, x), threads consecutive along x.
// The thread keeps its C reference channels in registers and loops over the
// D planes: per plane one coalesced px load, two float4-vectorised taps of C
// contiguous floats from its own scanline, both group sums on the fly, one
// coalesced float2 store.  Neighbouring threads share the scanline and
// their px are neighbours too, so a warp's taps of one plane fall into one
// short run of the row.
//
// What bounds it on an H100: bytes.  Per (pixel, plane) it does about
// 5*C + 10 fp32 operations against 12 compulsory bytes (px in, 2 floats
// out), plus both feature maps once:
// 4*N*(2*H*W*C + 3*D*H*W) bytes over 3.35 TB/s, against 67 TFLOP/s.  The
// taps are re-read per plane from L1/L2; chip_smoke.py reports the time
// beside the bound.  Later work: folding the fan (px = P0 + d*P1) into the
// kernel removes a third of the bytes; a shared-memory row tile removes the
// re-reads.

#include <cuda_runtime.h>

namespace {

template <int C>
__global__ void __launch_bounds__(128) sweep1d_kernel(
    const float* __restrict__ src_r, const float* __restrict__ ref_r,
    const float* __restrict__ px, float* __restrict__ out,
    long long n_pixels, int D, int H, int W) {
  static_assert(C % 4 == 0, "C must be a multiple of 4");
  constexpr int C4 = C / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // (n, y, x)
  if (i >= n_pixels) return;
  const long long hw = (long long)H * W;
  const long long n = i / hw;
  const long long yx = i - n * hw;
  const int x = (int)(yx % W);

  const float4* ref4 = reinterpret_cast<const float4*>(ref_r + i * C);
  float4 r[C4];
#pragma unroll
  for (int k = 0; k < C4; ++k) r[k] = __ldg(ref4 + k);
  // the thread's scanline: row y of image n
  const float* row = src_r + (i - x) * C;

  const float inv_half = 2.0f / (float)C;  // exact: C/2 is a power of two
  const float* pxp = px + n * D * hw + yx;
  float2* outp = reinterpret_cast<float2*>(out) + n * D * hw + yx;
  for (int d = 0; d < D; ++d) {
    const float p = fminf(fmaxf(__ldg(pxp + d * hw), -2.0f), (float)W + 1.0f);
    const float x0f = floorf(p);
    const float wx = __fsub_rn(p, x0f);
    const float ux = __fsub_rn(1.0f, wx);
    const int x0 = (int)x0f;
    const int x1 = x0 + 1;
    const float w0 = (x0 >= 0 && x0 < W) ? ux : 0.0f;
    const float w1 = (x1 >= 0 && x1 < W) ? wx : 0.0f;
    const float4* t0 = reinterpret_cast<const float4*>(row + (long long)min(max(x0, 0), W - 1) * C);
    const float4* t1 = reinterpret_cast<const float4*>(row + (long long)min(max(x1, 0), W - 1) * C);
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int k = 0; k < C4; ++k) {
      const float4 a = __ldg(t0 + k), b = __ldg(t1 + k);
      s0 += (a.x * w0 + b.x * w1) * r[k].x + (a.z * w0 + b.z * w1) * r[k].z;  // channels 4k, 4k+2
      s1 += (a.y * w0 + b.y * w1) * r[k].y + (a.w * w0 + b.w * w1) * r[k].w;  // channels 4k+1, 4k+3
    }
    outp[d * hw] = make_float2(s0 * inv_half, s1 * inv_half);
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a channel
// count without an instantiation).
extern "C" int dmvs_sweep1d(const float* src_r, const float* ref_r, const float* px,
                            float* out, int N, int D, int H, int W, int C,
                            void* stream) {
  const long long n_pixels = (long long)N * H * W;
  if (n_pixels == 0 || D == 0) return 0;
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((n_pixels + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8:
      sweep1d_kernel<8><<<blocks, threads, 0, s>>>(src_r, ref_r, px, out, n_pixels, D, H, W);
      break;
    case 16:
      sweep1d_kernel<16><<<blocks, threads, 0, s>>>(src_r, ref_r, px, out, n_pixels, D, H, W);
      break;
    case 32:
      sweep1d_kernel<32><<<blocks, threads, 0, s>>>(src_r, ref_r, px, out, n_pixels, D, H, W);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

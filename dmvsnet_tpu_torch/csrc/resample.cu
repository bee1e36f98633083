// Depth-independent bilinear resample of channels-last images at per-pixel
// coordinates, zero padding.
//
// Replaces the TPU kernel dmvsnet_tpu/ops/pallas/epipolar_sweep.py
// _make_resample_kernel (called through resample_tiled).  It computes that
// kernel's contract, not its TPU blocking: the TPU cannot gather, so it
// expresses the resample as band matmuls over row-packed, lane-tiled windows
// fetched by double-buffered DMA, with a span check on every tile and a
// chunk ladder for wide channel counts.  A CUDA thread gathers directly, so
// none of that is carried over, and any channel count that is a multiple of
// 4 goes through one launch.
//
// Contract (fp32):
//   img (N, H, W, C)     channels-last images, C % 4 == 0
//   px, py (N, Ho, Wo)   where output pixel (n, y, x) samples image n
//   out (N, Ho, Wo, C)   out[n,y,x,:] = sum over the 4 taps of weight * img,
//                        taps outside the image contributing 0
// with the taps, weights and clamping of warp_geometry.cuh (those of
// ops/warp.bilinear_sample), summed in the order (x0,y0), (x0+1,y0),
// (x0,y0+1), (x0+1,y0+1).
//
// Design: one thread per (n, y, x, 4 channels), the C/4 threads of a pixel
// consecutive, so a warp reads the taps of 128/C neighbouring pixels as
// contiguous float4 runs and writes 512 contiguous bytes.  Each of a
// pixel's threads recomputes the taps (a dozen operations against 5 float4
// memory operations).
//
// What bounds it on an H100: bytes.  Per output pixel it does about 8*C + 20
// fp32 operations and must move at least 4*(C + 2) bytes out and in, plus
// the image once: 4*N*(H*W*C + 2*Ho*Wo + Ho*Wo*C) bytes over 3.35 TB/s.
// The 4 taps of neighbouring pixels overlap, so this version counts on
// L1/L2 to serve the re-reads; chip_smoke.py reports its time beside the
// bound.  Later work: shared-memory row tiles for the rectify passes, whose
// coordinates are smooth.

#include <cuda_runtime.h>

#include "warp_geometry.cuh"

namespace {

__global__ void __launch_bounds__(256) resample_kernel(
    const float* __restrict__ img, const float* __restrict__ px,
    const float* __restrict__ py, float* __restrict__ out,
    long long n_threads, int H, int W, long long out_hw, int C4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_threads) return;
  const int k = (int)(i % C4);
  const long long pixel = i / C4;  // n * Ho * Wo + y * Wo + x
  const long long n = pixel / out_hw;

  const dmvs::Taps t = dmvs::bilinear_taps(__ldg(px + pixel), __ldg(py + pixel), H, W);
  const float4* src = reinterpret_cast<const float4*>(img) + n * H * W * C4 + k;
  const float4 a = __ldg(src + (long long)t.pix[0] * C4);
  const float4 b = __ldg(src + (long long)t.pix[1] * C4);
  const float4 c = __ldg(src + (long long)t.pix[2] * C4);
  const float4 d = __ldg(src + (long long)t.pix[3] * C4);
  const float w0 = t.w[0], w1 = t.w[1], w2 = t.w[2], w3 = t.w[3];
  float4 r;
  r.x = a.x * w0 + b.x * w1 + c.x * w2 + d.x * w3;
  r.y = a.y * w0 + b.y * w1 + c.y * w2 + d.y * w3;
  r.z = a.z * w0 + b.z * w1 + c.z * w2 + d.z * w3;
  r.w = a.w * w0 + b.w * w1 + c.w * w2 + d.w * w3;
  reinterpret_cast<float4*>(out)[i] = r;
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a channel
// count that is not a positive multiple of 4).
extern "C" int dmvs_resample(const float* img, const float* px, const float* py,
                             float* out, int N, int H, int W, int Ho, int Wo,
                             int C, void* stream) {
  if (C <= 0 || C % 4) return (int)cudaErrorInvalidValue;
  const int C4 = C / 4;
  const long long out_hw = (long long)Ho * Wo;
  const long long n_threads = (long long)N * out_hw * C4;
  if (n_threads == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_threads + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  resample_kernel<<<(unsigned int)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, px, py, out, n_threads, H, W, out_hw, C4);
  return (int)cudaGetLastError();
}

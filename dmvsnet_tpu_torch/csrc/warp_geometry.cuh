// Plane-sweep sampling geometry shared by the warp-correlate forward kernel
// and its two adjoint kernels; the bilinear taps also serve the resample
// kernel.
//
// The three kernels must agree bit for bit on where a (pixel, plane, view)
// samples the source image and with which bilinear weights: the adjoints
// recompute the geometry instead of saving it, and a coordinate that rounds
// differently (an FMA contraction, say) moves a tap weight by ~6e-5 at
// 1152 px, which white-noise features turn into visible differences.  So
// every coordinate and weight is rounded op by op, in the order of the plain
// PyTorch version (core/geometry.plane_sweep_coords, ops/warp.bilinear_sample).

#pragma once

#include <cuda_runtime.h>

namespace dmvs {

// (m[0] x + m[1] y + m[2]) d + m[3], rounded op by op in that order
__device__ __forceinline__ float ray(const float* m, float x, float y, float d) {
  const float r = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m + 0), x), __fmul_rn(__ldg(m + 1), y)),
                            __ldg(m + 2));
  return __fadd_rn(__fmul_rn(r, d), __ldg(m + 3));
}

// The 4 bilinear taps of one sample, in the order (x0,y0), (x0+1,y0),
// (x0,y0+1), (x0+1,y0+1).  pix[t] = y*W + x of the tap, clamped into the
// image so it can always be addressed; w[t] is exactly 0 for a tap outside
// the image (zero padding), so such a tap reads or adds nothing.
struct Taps {
  float w[4];
  int pix[4];
};

// The taps of one bilinear sample at pixel coordinates (px, py), which are
// clamped to [-2, W+1] x [-2, H+1] before floorf: refine hypotheses can be
// negative or huge, a float->int conversion out of range is undefined, and
// taps outside the image carry weight 0 either way.
__device__ __forceinline__ Taps bilinear_taps(float px, float py, int H, int W) {
  px = fminf(fmaxf(px, -2.0f), (float)W + 1.0f);
  py = fminf(fmaxf(py, -2.0f), (float)H + 1.0f);

  const float x0f = floorf(px);
  const float y0f = floorf(py);
  const float wx = __fsub_rn(px, x0f);
  const float wy = __fsub_rn(py, y0f);
  const float ux = __fsub_rn(1.0f, wx);
  const float uy = __fsub_rn(1.0f, wy);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;

  Taps t;
  t.w[0] = (vx0 && vy0) ? __fmul_rn(ux, uy) : 0.0f;
  t.w[1] = (vx1 && vy0) ? __fmul_rn(wx, uy) : 0.0f;
  t.w[2] = (vx0 && vy1) ? __fmul_rn(ux, wy) : 0.0f;
  t.w[3] = (vx1 && vy1) ? __fmul_rn(wx, wy) : 0.0f;
  const int xa = min(max(x0, 0), W - 1), xb = min(max(x1, 0), W - 1);
  const int ya = min(max(y0, 0), H - 1), yb = min(max(y1, 0), H - 1);
  t.pix[0] = ya * W + xa;
  t.pix[1] = ya * W + xb;
  t.pix[2] = yb * W + xa;
  t.pix[3] = yb * W + xb;
  return t;
}

// m: the 12 floats (3 x 4, row major) of one relative projection.
// p = M (x, y, 1)^T d + t, (px, py) = (p0/z, p1/z), z == 0 -> 1e-5.
__device__ __forceinline__ Taps sample_taps(const float* m, float fx, float fy, float dep,
                                            int H, int W) {
  const float p0 = ray(m + 0, fx, fy, dep);
  const float p1 = ray(m + 4, fx, fy, dep);
  float z = ray(m + 8, fx, fy, dep);
  if (z == 0.0f) z += 1e-5f;
  return bilinear_taps(__fdiv_rn(p0, z), __fdiv_rn(p1, z), H, W);
}

}  // namespace dmvs

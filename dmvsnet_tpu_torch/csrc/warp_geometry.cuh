// Plane-sweep sampling geometry shared by the warp-correlate forward kernel
// and its two adjoint kernels; the bilinear taps also serve the resample
// kernel, and the lane-group broadcast of a sample's taps (below) serves the
// forward and the reference-gradient kernels.
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

// The ray of one relative projection row m at pixel (x, y), split as
// r = (m[0] x + m[1] y) + m[2] once per (pixel, view) and r d + m[3] per
// plane: each op rounded on its own in that order, so the split gives the
// same floats whether r is kept across planes or formed anew.
__device__ __forceinline__ float ray_base(const float* m, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m + 0), x), __fmul_rn(__ldg(m + 1), y)),
                   __ldg(m + 2));
}

__device__ __forceinline__ float ray_at(const float* m, float r, float d) {
  return __fadd_rn(__fmul_rn(r, d), __ldg(m + 3));
}

// The three ray bases of one (pixel, view): rows 0, 1, 2 of the 3 x 4
// projection m.
struct Rays {
  float r[3];
};

__device__ __forceinline__ Rays pixel_rays(const float* m, float x, float y) {
  return Rays{{ray_base(m + 0, x, y), ray_base(m + 4, x, y), ray_base(m + 8, x, y)}};
}

// The 4 bilinear taps of one sample, in the order (x0,y0), (x0+1,y0),
// (x0,y0+1), (x0+1,y0+1).  pix[t] = y*W + x of the tap, clamped into the
// image so it can always be addressed; w[t] is exactly 0 for a tap outside
// the image (zero padding), so such a tap reads or adds nothing.  (x0, y0)
// is the cell's corner before clamping: tap t lies at (x0 + t % 2, y0 + t / 2),
// inside the image wherever w[t] != 0.
struct Taps {
  float w[4];
  int pix[4];
  int x0, y0;
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
  t.x0 = x0;
  t.y0 = y0;
  return t;
}

// m: the 12 floats (3 x 4, row major) of one relative projection, rays its
// bases at the sample's pixel (pixel_rays).
// p = M (x, y, 1)^T d + t, (px, py) = (p0/z, p1/z), z == 0 -> 1e-5.
__device__ __forceinline__ Taps plane_taps(const float* m, const Rays& rays, float dep,
                                           int H, int W) {
  const float p0 = ray_at(m + 0, rays.r[0], dep);
  const float p1 = ray_at(m + 4, rays.r[1], dep);
  float z = ray_at(m + 8, rays.r[2], dep);
  if (z == 0.0f) z += 1e-5f;
  return bilinear_taps(__fdiv_rn(p0, z), __fdiv_rn(p1, z), H, W);
}

// The same for a sample whose rays are not kept.
__device__ __forceinline__ Taps sample_taps(const float* m, float fx, float fy, float dep,
                                            int H, int W) {
  return plane_taps(m, pixel_rays(m, fx, fy), dep, H, W);
}

// ---------------------------------------------------------------------------
// Geometry shared across a lane group.  A sample's C channels lie on L
// consecutive lanes (one float4 each) and all L lanes need the same taps.
// Instead of each lane forming them, lane k of the group forms the taps of
// planes k, k + L, ..., k + (Q-1) L of a run of P planes and passes each
// plane's 4 weights and packed tap pixels to the others with __shfl_sync.
// ---------------------------------------------------------------------------

// The taps of one sample as they travel between lanes: the 4 weights and
// the 4 tap pixels packed into one int,
//   (pix[0] << 2) | (pix[1] - pix[0]) << 1 | (pix[2] != pix[0]),
// which needs H*W < 2^29 (the wrappers refuse larger images).
struct PackedTaps {
  float w[4];
  int code;
};

// What lane k of a group formed: the taps of its Q planes.
template <int Q>
struct GroupTaps {
  float w[Q][4];
  int code[Q];
};

// Lane k's part: dep[q] is the depth of plane q*L + k of the run (any
// finite value where that plane does not exist; its taps go unused).
template <int Q>
__device__ __forceinline__ GroupTaps<Q> form_group_taps(const float* m, const Rays& rays,
                                                        const float (&dep)[Q], int H, int W) {
  GroupTaps<Q> g;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const Taps tp = plane_taps(m, rays, dep[q], H, W);
#pragma unroll
    for (int j = 0; j < 4; ++j) g.w[q][j] = tp.w[j];
    g.code[q] = (tp.pix[0] << 2) | ((tp.pix[1] - tp.pix[0]) << 1) | (tp.pix[2] != tp.pix[0]);
  }
  return g;
}

// Plane p's taps from lane p % L of the group.  Every lane of the warp
// must call it with the same p (a full-warp shuffle); p is a constant of
// an unrolled loop, so g stays in registers.
template <int L, int Q>
__device__ __forceinline__ PackedTaps group_taps(const GroupTaps<Q>& g, int p) {
  PackedTaps t;
#pragma unroll
  for (int j = 0; j < 4; ++j) t.w[j] = __shfl_sync(0xffffffffu, g.w[p / L][j], p % L, L);
  t.code = __shfl_sync(0xffffffffu, g.code[p / L], p % L, L);
  return t;
}

// The 4 tap pixels (y*W + x) of a packed code, in the order of Taps.pix.
__device__ __forceinline__ void tap_pixels(int c, int W, long long (&pix)[4]) {
  pix[0] = c >> 2;
  pix[1] = pix[0] + ((c >> 1) & 1);
  pix[2] = pix[0] + (c & 1) * (long long)W;
  pix[3] = pix[2] + ((c >> 1) & 1);
}

}  // namespace dmvs

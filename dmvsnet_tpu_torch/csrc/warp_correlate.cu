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
// zero padding outside the image.  px/py are clamped to [-2, W+1] x
// [-2, H+1] before floorf (warp_geometry.cuh, shared with the adjoint
// kernels): refine hypotheses can be negative or huge, a float->int
// conversion out of range is undefined, and taps outside the image carry
// weight 0 either way.
//
// What bounded the first version on an H100: one thread per (b, d, y, x)
// holding all C channels, so neighbouring lanes were neighbouring pixels
// whose taps lie 4*C bytes apart and every warp-wide float4 tap load touched
// up to 32 different 128-byte lines: the L1 load pipeline, not the
// arithmetic (4-16% of the bound).  It also reloaded the reference channels
// and re-formed the ray R (x, y, 1)^T in every plane's thread.
//
// Design: a sample's C channels lie on L = C/4 consecutive lanes (a lane
// group), one float4 each, so a
// warp-wide tap load reads 32/L whole pixels of C contiguous floats.  Lane
// groups are consecutive pixels along x, whose taps lie next to each other
// in the source.  Each group owns P consecutive planes (a per-C constant;
// the tail group of a D that P does not divide masks its missing planes):
// the lane's reference float4 is loaded once, and per view the lanes of a
// group form the geometry of different planes (the ray bases once, then
// one plane each while P <= L) and pass each plane's 4 weights and packed
// tap pixels to the others with __shfl_sync, instead of all L lanes forming
// the same floats (dmvs::form_group_taps / group_taps in warp_geometry.cuh,
// shared with the reference-gradient kernel).  A plane whose taps fall in the previous plane's cell
// reuses its loads.  The group sums of a plane are kept per lane over all
// views and reduced across the L lanes with __shfl_xor_sync once; one lane
// per plane writes the float2.  Source taps are read through L1 (no
// shared-memory staging of a source window).  What bounds it now (5.8x
// its bound summed over a forward) is not known without a profiler on the
// card; chip_smoke.py prints its time beside the bound.  PERF.md records
// the designs it was chosen from (the first version, P = 1, 2, 4, 8).

#include <cuda_runtime.h>

#include "warp_geometry.cuh"

namespace {

// planes per lane group
template <int C> struct Planes;
template <> struct Planes<8> { static constexpr int P = 4; };
template <> struct Planes<16> { static constexpr int P = 8; };
template <> struct Planes<32> { static constexpr int P = 8; };

// e0 w0 + e1 w1 + e2 w2 + e3 w3, rounded as ((e1 w1 + e0 w0) + e2 w2) + e3 w3
// with each step after the first a fused multiply-add
__device__ __forceinline__ float lerp4(float e0, float e1, float e2, float e3, float w0,
                                       float w1, float w2, float w3) {
  return __fmaf_rn(e3, w3, __fmaf_rn(e2, w2, __fmaf_rn(e0, w0, __fmul_rn(e1, w1))));
}

template <int C, int P>
__global__ void __launch_bounds__(256) warp_correlate_kernel(
    const float* __restrict__ feats, const float* __restrict__ rel,
    const float* __restrict__ depth, float* __restrict__ out,
    int B, int V, int D, int H, int W) {
  static_assert(C % 4 == 0 && 32 % (C / 4) == 0, "C/4 lanes must divide a warp");
  constexpr int L = C / 4;            // lanes per sample, one float4 each
  constexpr int Q = (P + L - 1) / L;  // planes whose geometry a lane forms
  const long long hw = (long long)H * W;
  const int DP = (D + P - 1) / P;  // plane groups
  const long long n = (long long)B * DP * hw;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // every lane runs the shuffles below: a lane group lies inside one warp,
  // and a group past the end works on group 0 and writes nothing
  const bool live = t / L < n;
  const long long g = live ? t / L : 0;  // over (b, plane group, y, x), x fastest
  const int k = (int)(t % L);

  const int x = (int)(g % W);
  const long long row = g / W;
  const int y = (int)(row % H);
  const int dp = (int)((row / H) % DP);
  const int b = (int)(row / H / DP);
  const int d0 = dp * P;
  const long long yx = (long long)y * W + x;
  const float fx = (float)x;
  const float fy = (float)y;

  // lane k forms the geometry of planes k, k + L, ... of the group
  float dep[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int d = d0 + q * L + k;
    dep[q] = (q * L + k < P && d < D) ? __ldg(depth + ((long long)b * D + d) * hw + yx) : 0.0f;
  }
  const float4 r = __ldg(reinterpret_cast<const float4*>(feats + ((long long)b * V * hw + yx) * C) + k);
  float a0[P], a1[P];
#pragma unroll
  for (int p = 0; p < P; ++p) a0[p] = a1[p] = 0.0f;

  for (int v = 1; v < V; ++v) {
    const float* m = rel + ((long long)b * (V - 1) + (v - 1)) * 12;
    const dmvs::Rays rays = dmvs::pixel_rays(m, fx, fy);
    // coordinates and tap weights round exactly as the plain version's
    // separate elementwise ops do (warp_geometry.cuh); a tap outside the
    // image reads a border pixel with weight 0
    const dmvs::GroupTaps<Q> geo = dmvs::form_group_taps<Q>(m, rays, dep, H, W);
    const float4* src = reinterpret_cast<const float4*>(feats + ((long long)b * V + v) * hw * C) + k;
    // a plane whose taps fall in the previous plane's cell reuses its loads
    int held = -1;
    float4 e0, e1, e2, e3;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      // plane p's geometry from lane p % L of the group
      const dmvs::PackedTaps tp = dmvs::group_taps<L>(geo, p);
      const float w0 = tp.w[0], w1 = tp.w[1], w2 = tp.w[2], w3 = tp.w[3];
      if (d0 + p < D) {
        if (tp.code != held) {
          long long pix[4];
          dmvs::tap_pixels(tp.code, W, pix);
          e0 = __ldg(src + pix[0] * L);
          e1 = __ldg(src + pix[1] * L);
          e2 = __ldg(src + pix[2] * L);
          e3 = __ldg(src + pix[3] * L);
          held = tp.code;
        }
        // the roundings are written out (the FMAs nvcc chose for this
        // kernel's first lane-group build), so that code moving around
        // these lines cannot change the kernel's output bits
        const float q0 = lerp4(e0.x, e1.x, e2.x, e3.x, w0, w1, w2, w3);  // channel 4k   (group 0)
        const float q1 = lerp4(e0.y, e1.y, e2.y, e3.y, w0, w1, w2, w3);  // channel 4k+1 (group 1)
        const float q2 = lerp4(e0.z, e1.z, e2.z, e3.z, w0, w1, w2, w3);  // channel 4k+2 (group 0)
        const float q3 = lerp4(e0.w, e1.w, e2.w, e3.w, w0, w1, w2, w3);  // channel 4k+3 (group 1)
        a0[p] = __fadd_rn(a0[p], __fmaf_rn(q2, r.z, __fmul_rn(q0, r.x)));
        a1[p] = __fadd_rn(a1[p], __fmaf_rn(q3, r.w, __fmul_rn(q1, r.y)));
      }
    }
  }
  const float inv_half = 2.0f / (float)C;  // exact: C/2 is a power of two
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      a0[p] += __shfl_xor_sync(0xffffffffu, a0[p], off);
      a1[p] += __shfl_xor_sync(0xffffffffu, a1[p], off);
    }
    // lane p % L of the group writes plane p
    if (live && p % L == k && d0 + p < D) {
      reinterpret_cast<float2*>(out)[((long long)b * D + d0 + p) * hw + yx] =
          make_float2(a0[p] * inv_half, a1[p] * inv_half);
    }
  }
}

template <int C, int P>
int launch_forward(const float* feats, const float* rel, const float* depth, float* out,
                   int B, int V, int D, int H, int W, cudaStream_t s) {
  const long long n = (long long)B * ((D + P - 1) / P) * H * W * (C / 4);
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  warp_correlate_kernel<C, P><<<blocks, threads, 0, s>>>(feats, rel, depth, out, B, V, D, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a channel
// count without an instantiation).
extern "C" int dmvs_warp_correlate(const float* feats, const float* rel,
                                   const float* depth, float* out, int B,
                                   int V, int D, int H, int W, int C,
                                   void* stream) {
  if ((long long)B * D * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return launch_forward<8, Planes<8>::P>(feats, rel, depth, out, B, V, D, H, W, s);
    case 16: return launch_forward<16, Planes<16>::P>(feats, rel, depth, out, B, V, D, H, W, s);
    case 32: return launch_forward<32, Planes<32>::P>(feats, rel, depth, out, B, V, D, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

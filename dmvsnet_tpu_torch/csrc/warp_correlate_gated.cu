// The adaptive cost pass of one (stage, pass) in one launch: plane-sweep
// warp, 2-group correlation, the weight net's gate and the sum over the
// source views.
//
// Replaces no TPU kernel.  The JAX package computes the adaptive pass
// (dmvsnet_tpu/ops/warp.py aggregate_cost_volume_adaptive) as one
// warp-correlate call per (reference, source) pair, each followed by the
// weight net's convolutions in XLA; the port's per-pair route
// (ops/warp_correlate.aggregate_cost_volume_adaptive) does the same with
// kernel 1 at V = 2 and cuDNN.  This kernel is the eval form of that
// route, for a weight net whose eval batch norms are folded into its two
// 1x1x1 convolutions (models/cost_reg.AggWeightNetVolume.gate_params).
//
// Contract (fp32, natural channel order: group g owns channels {2k+g}):
//   feats (B, V, H, W, C)   view 0 = reference, views 1..V-1 = sources
//   rel   (B, V-1, 3, 4)    rows of src_v @ inv(ref) (fused projections)
//   depth (B, D, H, W)      per-pixel hypotheses
//   gate  (5,)              w00, w01, b0, a1, b1: the two folded blocks
//   out   (B, D, H, W, 2)   out[b,d,y,x,:] = sum_{v=1..V-1} c_v * s_v,
//       c_v = kernel 1's correlation of the pair (reference, source v),
//       s_v = 1 / (1 + exp(-relu(a1 * relu(w00 c_v0 + w01 c_v1 + b0) + b1))),
//       views added in order, each op rounded as the plain version
//       (ops/warp_correlate.gated_warp_correlate_plain) rounds it.
// Sampling as kernel 1 (warp_geometry.cuh): zero padding, px/py clamped
// before floorf, z == 0 -> 1e-5.
//
// What bounded the route it replaces on an H100 (PERF.md §5, §6): per
// (stage, pass) V - 1 launches of kernel 1, each writing its pair's
// correlation to device memory, then per pair a copy into channels-first
// layout, two single-channel 1x1x1 convolutions on cuDNN's FFMA implicit
// GEMMs at ~130 GB/s, a sigmoid, a product and a running sum, and ~10
// host launches per pair; at Tanks' shapes 60 pairs a map, ~85 ms of device
// time and ~40 ms of host gaps.  The gate's arithmetic is a few operations
// on two floats per voxel and view, so none of that needs device memory.
//
// Design: kernel 1's lane groups (a sample's C channels on L = C/4
// consecutive lanes, one float4 each; a group owns P consecutive planes;
// geometry formed once per group and passed by __shfl_sync; a plane whose
// taps fall in the previous plane's cell reuses its loads).  Kernel 1 adds
// the views' lane partials and reduces across the lanes once; the gate is
// not linear, so here each view's group sums are finished before they are
// gated: a reduce-scatter of __shfl_xor_sync steps (as sweep1d.cu's) leaves
// lane k the whole sums of planes k*P/L .. (k+1)*P/L - 1, which it gates in
// registers and adds to its running sums; one lane writes each plane's
// float2.  The lane sums are combined pairwise in the order of kernel 1's
// butterfly, so each view's correlation rounds as kernel 1's V = 2 launch
// rounds it.  Reads and writes are kernel 1's at V = 11: the reference and
// the sources' taps, depth once, the output once.
//
// Measured on one tank_adaptive map's six passes (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md §6): 9.89 ms, against 9.08 ms for kernel 1 on the same
// inputs without the gate and 169.5 ms for the per-pair route it replaces;
// a butterfly that gives every lane every plane's sums (kernel 1's
// reduction, then P gates a lane and view instead of P/L) took 13.73 ms.

#include <cuda_runtime.h>

#include "warp_geometry.cuh"

namespace {

// planes per lane group, as kernel 1's
template <int C> struct Planes;
template <> struct Planes<8> { static constexpr int P = 4; };
template <> struct Planes<16> { static constexpr int P = 8; };
template <> struct Planes<32> { static constexpr int P = 8; };

// e0 w0 + e1 w1 + e2 w2 + e3 w3, rounded as kernel 1 rounds it
__device__ __forceinline__ float lerp4(float e0, float e1, float e2, float e3, float w0,
                                       float w1, float w2, float w3) {
  return __fmaf_rn(e3, w3, __fmaf_rn(e2, w2, __fmaf_rn(e0, w0, __fmul_rn(e1, w1))));
}

// hi where the mask is all ones, else lo: a select on the bits, so that the
// compiler cannot turn a select of two array elements into a load from a
// selected address, which moves the array to the stack
__device__ __forceinline__ float pick(int mask, float hi, float lo) {
  return __int_as_float((__float_as_int(hi) & mask) | (__float_as_int(lo) & ~mask));
}

// Sums a0[0..N), a1[0..N) over the lanes of a group, O = half the lanes
// still to combine: the lanes whose bit O is set keep the upper half of the
// planes, the others the lower half, and each adds what its partner sends.
// Lane k ends with planes [k * P/L, (k + 1) * P/L) in a0/a1[0..P/L).
template <int O, int N>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float* a0, float* a1, int k) {
    const int upper = -((k & O) != 0);  // all ones in the lanes that keep the upper half
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float keep0 = pick(upper, a0[i + N / 2], a0[i]);
      const float keep1 = pick(upper, a1[i + N / 2], a1[i]);
      const float send0 = pick(upper, a0[i], a0[i + N / 2]);
      const float send1 = pick(upper, a1[i], a1[i + N / 2]);
      a0[i] = __fadd_rn(keep0, __shfl_xor_sync(0xffffffffu, send0, O));
      a1[i] = __fadd_rn(keep1, __shfl_xor_sync(0xffffffffu, send1, O));
    }
    ReduceScatter<O / 2, N / 2>::run(a0, a1, k);
  }
};
template <int N>
struct ReduceScatter<0, N> {
  static __device__ __forceinline__ void run(float*, float*, int) {}
};

struct Gate {
  float w00, w01, b0, a1, b1;
};

// (t0, t1) += (c0, c1) * s, s the gate of (c0, c1), each op rounded on its
// own in the plain version's order; the sigmoid with expf, not __expf
__device__ __forceinline__ void add_gated(const Gate& g, float c0, float c1, float& t0,
                                          float& t1) {
  const float h = fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(g.w00, c0), __fmul_rn(g.w01, c1)), g.b0),
                        0.0f);
  const float z = fmaxf(__fadd_rn(__fmul_rn(g.a1, h), g.b1), 0.0f);
  const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
  t0 = __fadd_rn(t0, __fmul_rn(c0, s));
  t1 = __fadd_rn(t1, __fmul_rn(c1, s));
}

template <int C, int P>
__global__ void __launch_bounds__(256) gated_warp_correlate_kernel(
    const float* __restrict__ feats, const float* __restrict__ rel,
    const float* __restrict__ depth, const float* __restrict__ gate, float* __restrict__ out,
    int B, int V, int D, int H, int W) {
  static_assert(C % 4 == 0 && 32 % (C / 4) == 0, "C/4 lanes must divide a warp");
  constexpr int L = C / 4;            // lanes per sample, one float4 each
  constexpr int Q = (P + L - 1) / L;  // planes whose geometry a lane forms
  static_assert(P % L == 0, "the reduce-scatter leaves each lane whole planes");
  constexpr int R = P / L;            // planes whose running sums a lane keeps
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
  const Gate gt{__ldg(gate + 0), __ldg(gate + 1), __ldg(gate + 2), __ldg(gate + 3),
                __ldg(gate + 4)};
  const float inv_half = 2.0f / (float)C;  // exact: C/2 is a power of two

  // lane k forms the geometry of planes k, k + L, ... of the group
  float dep[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int d = d0 + q * L + k;
    dep[q] = (q * L + k < P && d < D) ? __ldg(depth + ((long long)b * D + d) * hw + yx) : 0.0f;
  }
  const float4 r = __ldg(reinterpret_cast<const float4*>(feats + ((long long)b * V * hw + yx) * C) + k);
  float t0[R], t1[R];
#pragma unroll
  for (int j = 0; j < R; ++j) t0[j] = t1[j] = 0.0f;

  for (int v = 1; v < V; ++v) {
    const float* m = rel + ((long long)b * (V - 1) + (v - 1)) * 12;
    const dmvs::Rays rays = dmvs::pixel_rays(m, fx, fy);
    const dmvs::GroupTaps<Q> geo = dmvs::form_group_taps<Q>(m, rays, dep, H, W);
    const float4* src = reinterpret_cast<const float4*>(feats + ((long long)b * V + v) * hw * C) + k;
    // this view's lane partials of each plane's two group sums
    float a0[P], a1[P];
    int held = -1;
    float4 e0, e1, e2, e3;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      // plane p's geometry from lane p % L of the group
      const dmvs::PackedTaps tp = dmvs::group_taps<L>(geo, p);
      a0[p] = a1[p] = 0.0f;
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
        const float q0 = lerp4(e0.x, e1.x, e2.x, e3.x, tp.w[0], tp.w[1], tp.w[2], tp.w[3]);
        const float q1 = lerp4(e0.y, e1.y, e2.y, e3.y, tp.w[0], tp.w[1], tp.w[2], tp.w[3]);
        const float q2 = lerp4(e0.z, e1.z, e2.z, e3.z, tp.w[0], tp.w[1], tp.w[2], tp.w[3]);
        const float q3 = lerp4(e0.w, e1.w, e2.w, e3.w, tp.w[0], tp.w[1], tp.w[2], tp.w[3]);
        a0[p] = __fmaf_rn(q2, r.z, __fmul_rn(q0, r.x));  // group 0: channels 4k, 4k+2
        a1[p] = __fmaf_rn(q3, r.w, __fmul_rn(q1, r.y));  // group 1: channels 4k+1, 4k+3
      }
    }
    ReduceScatter<L / 2, P>::run(a0, a1, k);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      add_gated(gt, __fmul_rn(a0[j], inv_half), __fmul_rn(a1[j], inv_half), t0[j], t1[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int p = k * R + j;  // lane k holds planes k*R .. k*R + R - 1
    if (live && d0 + p < D) {
      reinterpret_cast<float2*>(out)[((long long)b * D + d0 + p) * hw + yx] =
          make_float2(t0[j], t1[j]);
    }
  }
}

template <int C>
int launch_gated(const float* feats, const float* rel, const float* depth, const float* gate,
                 float* out, int B, int V, int D, int H, int W, cudaStream_t s) {
  constexpr int P = Planes<C>::P;
  const long long n = (long long)B * ((D + P - 1) / P) * H * W * (C / 4);
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  gated_warp_correlate_kernel<C, P><<<blocks, threads, 0, s>>>(
      feats, rel, depth, gate, out, B, V, D, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a channel
// count without an instantiation).
extern "C" int dmvs_gated_warp_correlate(const float* feats, const float* rel,
                                         const float* depth, const float* gate, float* out,
                                         int B, int V, int D, int H, int W, int C,
                                         void* stream) {
  if ((long long)B * D * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return launch_gated<8>(feats, rel, depth, gate, out, B, V, D, H, W, s);
    case 16: return launch_gated<16>(feats, rel, depth, gate, out, B, V, D, H, W, s);
    case 32: return launch_gated<32>(feats, rel, depth, gate, out, B, V, D, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

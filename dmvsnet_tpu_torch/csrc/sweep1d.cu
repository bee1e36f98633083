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
// What bounds it on an H100: bytes.  Per (pixel, plane) it does about
// 5*C + 10 fp32 operations against 12 compulsory bytes (px in, 2 floats
// out), plus both feature maps once: 4*N*(2*H*W*C + 3*D*H*W) bytes over
// 3.35 TB/s, against 67 TFLOP/s.  What a design can waste is the tap
// traffic through L1: 2 taps x 4*C bytes per (pixel, plane), 4-10x the
// compulsory bytes, re-read from the scanline for every plane.
//
// What bounded the first version (one thread per rect pixel holding all C
// reference channels in registers, plane by plane): at C = 32 neighbouring
// lanes were neighbouring pixels whose taps lie 128 bytes apart, so every
// warp-wide float4 tap load touched 32 different 128-byte lines (16 such
// loads per plane); 8% of its bound at the s1 main pass (C = 32, D = 48).
// At C = 8 the same layout is near its bound (77% at s3 main).
//
// Design: a rect pixel's C channels lie on L = C/(4F) consecutive lanes
// (a lane group), F float4s each, lane k holding float4s k, k + L, ... of
// the pixel, so a warp-wide tap load reads 32/L pixels' 16*L contiguous
// bytes; F = 2 at every C (L = 4, 2, 1 at C = 32, 16, 8).  A group loops
// over all D planes of its pixel in runs of P = 4 (F and P are per-C
// constants): it loads the run's P px values, then the 2F float4 taps of
// each plane, all unconditionally (a plane past D reads plane D - 1 again
// and is never written), so that a run's loads are in flight together;
// every lane forms the two weights itself.  The two group sums of a plane
// stay per lane over the run and are then reduced across the L lanes by a
// reduce-scatter of __shfl_xor_sync steps (2 (1 - 1/L) shuffles a plane,
// instead of 2 log2(L)), which leaves each lane P/L whole planes to write.
// Source taps are read through L1.
//
// Designs that lost, summed over the six passes of one forward on the
// smoke's synthetic inputs / on the model's own (chip_smoke.py; NVIDIA H100
// 80GB HBM3, 700.00 W; PERF.md §6): shipped 2.106 / 2.000 ms; the first
// version 3.579 / 3.412; F = 1 (one float4 a lane) 2.457 / 2.420; one lane a
// pixel (F = C/4) with batched loads 3.531 / 3.365; a shared-memory
// scanline tile per (image, row) 2.137 / 2.138 (faster at s2 main only);
// F = 1 with the previous plane's loads reused while a column repeats,
// which takes the loads plane by plane, 3.597 / 3.427.  Not done here:
// forming px = P0 + d*P1 in the kernel (the fan) would drop a third of the
// compulsory bytes, but changes the contract this kernel shares with the
// TPU kernel and the plain version.

#include <cuda_runtime.h>

namespace {

// Per C: F float4s of a pixel's channels per lane, so L = C / (4 F) lanes
// serve a pixel, and runs of P planes (a multiple of L).
template <int C> struct Run;
template <> struct Run<8> { static constexpr int F = 2, P = 4; };
template <> struct Run<16> { static constexpr int F = 2, P = 4; };
template <> struct Run<32> { static constexpr int F = 2, P = 4; };

// hi where the mask is all ones, else lo: a select on the bits, a guard
// against the compiler turning a select of two array elements into a load
// from a selected address, which moves the array to the stack
__device__ __forceinline__ float pick(int mask, float hi, float lo) {
  return __int_as_float((__float_as_int(hi) & mask) | (__float_as_int(lo) & ~mask));
}

// Sums a0[0..N), a1[0..N) over the lanes of a group, O = half the lanes
// still to combine: the lanes whose bit O is set keep the upper half of
// the planes, the others the lower half, and each adds what its partner
// sends.  Lane k ends with planes [k * P/L, (k + 1) * P/L) in a0/a1[0..P/L).
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
      a0[i] = keep0 + __shfl_xor_sync(0xffffffffu, send0, O);
      a1[i] = keep1 + __shfl_xor_sync(0xffffffffu, send1, O);
    }
    ReduceScatter<O / 2, N / 2>::run(a0, a1, k);
  }
};
template <int N>
struct ReduceScatter<0, N> {
  static __device__ __forceinline__ void run(float*, float*, int) {}
};

template <int C, int F, int P>
__global__ void __launch_bounds__(256) sweep1d_kernel(
    const float* __restrict__ src_r, const float* __restrict__ ref_r,
    const float* __restrict__ px, float* __restrict__ out,
    long long n_pixels, int D, int H, int W) {
  constexpr int C4 = C / 4;      // float4s of a pixel
  constexpr int L = C4 / F;      // lanes per pixel
  static_assert(C % 4 == 0 && L * F == C4 && 32 % L == 0, "L = C/(4F) lanes must divide a warp");
  static_assert(P % L == 0, "a run must leave each lane whole planes");
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // every lane runs the shuffles: a group lies inside one warp, and a group
  // past the end works on pixel 0 and writes nothing
  const bool live = t / L < n_pixels;
  const long long i = live ? t / L : 0;  // over (n, y, x), x fastest
  const int k = (int)(t % L);
  const long long hw = (long long)H * W;
  const long long n = i / hw;
  const long long yx = i - n * hw;
  const int x = (int)(yx % W);

  // lane k holds float4s k, k + L, ... of a pixel (channels 4j..4j+3 of
  // float4 j: groups 0, 1, 0, 1)
  float4 r[F];
#pragma unroll
  for (int f = 0; f < F; ++f) r[f] = __ldg(reinterpret_cast<const float4*>(ref_r) + i * C4 + f * L + k);
  // lane k's first float4 of column 0 of the pixel's scanline
  const float4* row = reinterpret_cast<const float4*>(src_r) + (i - x) * C4 + k;
  const float* pxp = px + n * D * hw + yx;
  float2* outp = reinterpret_cast<float2*>(out) + n * D * hw + yx;

  for (int d0 = 0; d0 < D; d0 += P) {
    // all loads of a run are unconditional, so they are in flight together:
    // a plane past D reads plane D - 1 again and is never written
    float q[P];
#pragma unroll
    for (int p = 0; p < P; ++p) q[p] = __ldg(pxp + min(d0 + p, D - 1) * hw);
    float a0[P], a1[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float c = fminf(fmaxf(q[p], -2.0f), (float)W + 1.0f);
      const float x0f = floorf(c);
      const float wx = __fsub_rn(c, x0f);
      const float ux = __fsub_rn(1.0f, wx);
      const int x0 = (int)x0f;
      const int x1 = x0 + 1;
      const float w0 = (x0 >= 0 && x0 < W) ? ux : 0.0f;
      const float w1 = (x1 >= 0 && x1 < W) ? wx : 0.0f;
      const float4* t0 = row + (long long)min(max(x0, 0), W - 1) * C4;
      const float4* t1 = row + (long long)min(max(x1, 0), W - 1) * C4;
      a0[p] = a1[p] = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float4 ea = __ldg(t0 + f * L), eb = __ldg(t1 + f * L);
        a0[p] += (ea.x * w0 + eb.x * w1) * r[f].x + (ea.z * w0 + eb.z * w1) * r[f].z;
        a1[p] += (ea.y * w0 + eb.y * w1) * r[f].y + (ea.w * w0 + eb.w * w1) * r[f].w;
      }
    }
    ReduceScatter<L / 2, P>::run(a0, a1, k);
    const float inv_half = 2.0f / (float)C;  // exact: C/2 is a power of two
#pragma unroll
    for (int j = 0; j < P / L; ++j) {
      const int d = d0 + k * (P / L) + j;
      if (live && d < D) outp[d * hw] = make_float2(a0[j] * inv_half, a1[j] * inv_half);
    }
  }
}

template <int C>
int launch_sweep(const float* src_r, const float* ref_r, const float* px, float* out,
                 long long n_pixels, int D, int H, int W, cudaStream_t s) {
  constexpr int F = Run<C>::F, P = Run<C>::P;
  const long long n = n_pixels * (C / 4 / F);
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  sweep1d_kernel<C, F, P><<<blocks, threads, 0, s>>>(src_r, ref_r, px, out, n_pixels, D, H, W);
  return (int)cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return launch_sweep<8>(src_r, ref_r, px, out, n_pixels, D, H, W, s);
    case 16: return launch_sweep<16>(src_r, ref_r, px, out, n_pixels, D, H, W, s);
    case 32: return launch_sweep<32>(src_r, ref_r, px, out, n_pixels, D, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Adjoint of the fused warp-correlate cost pass with respect to the SOURCE
// features.
//
// Replaces the TPU kernel dmvsnet_tpu/ops/pallas/warp_correlate.py
// _make_grad_src_kernel (called from _corr_view_tiled_bwd).  That kernel
// adds all planes of a tile into a window of the gradient held in VMEM
// (grads[j]) and writes the window back once.  Blocks on a GPU run in no
// order, so whatever leaves a block is added with atomics; this kernel keeps
// the TPU kernel's idea, combining many taps before they reach device
// memory, in registers.
//
// Contract (fp32, contiguous, natural channel order, group g(c) = c % 2):
//   feats (B, V, H, W, C)  rel (B, V-1, 3, 4)  depth (B, D, H, W)
//   cot   (B, D, H, W, 2)  cotangent of the cost volume
//   grad  (B, V, H, W, C)  slots v >= 1 must be ZERO on entry and receive
//     grad[b,v,tap_t,c] += 2/C * cot[b,d,y,x,g(c)] * w_t(b,v,d,y,x) * feats[b,0,y,x,c]
//   for every (d, y, x) and each of its 4 taps; slot 0 is not touched.
//   stats  NULL, or 2 counters this launch adds to: the float4 atomic adds
//     it issued to device memory, and the times a lane's bilinear cell
//     changed from one plane to the next.
// Taps and weights are those of warp_geometry.cuh (bit-identical to the
// forward's).  A tap outside the image has weight exactly 0 and is skipped:
// it adds nothing and nothing outside the buffer is addressed.
//
// What bounds it on an H100: the float4 atomic adds that reach L2 (54-81e9
// a second: counted atomics over measured ms, chip_smoke.py); the
// compulsory bytes and the arithmetic are far below that.  The first
// version (one thread per (b, d, y, x, 8 channels), two float4 atomic adds
// per valid tap: 866e6 per train backward on the smoke's inputs) sat at 53x
// its byte bound.  Yet a pixel's consecutive planes move its taps by
// 0.05-0.5 px on the cascade's fans, so most of them land in the same
// bilinear cell.
//
// Design: a block is 4 warps, each a tile row of 32/(C/8) pixels of one
// batch element and ONE source view, C/8 lanes per pixel, each lane holding
// float4 slots k and k + C/8 of its pixel (8 channels).  A lane loops over
// the planes and keeps in registers the sums of its 4 taps while they stay
// in the same bilinear cell; when the cell changes it adds the 4 sums to
// device memory (two float4 atomic adds per nonzero tap inside the image)
// and starts anew.  The designs it was measured against on the card are in
// PERF.md: the first version; the same loop without the register cells;
// with a per-warp shared-memory window of the gradient, with and without
// the cells (the TPU kernel's idea: far fewer atomics, but slower:
// shared-memory float atomics are compare-and-swap loops on sm_90, and a
// window without them must find the lanes that share a cell and order its
// warp's steps); a 3-column register strip that slides with the cell.
// fp32 atomics make the sums order-dependent, so two runs differ in the
// last bits; chip_smoke.py prints the spread and the counters.

#include <climits>
#include <cuda_runtime.h>

#include "warp_geometry.cuh"

namespace {

constexpr int kWarps = 4;  // warps per block, one tile row each

__device__ __forceinline__ void axpy4(float4& a, float w, const float4 b) {
  a.x += w * b.x;
  a.y += w * b.y;
  a.z += w * b.z;
  a.w += w * b.w;
}

__device__ __forceinline__ bool nonzero(const float4 a) {
  return a.x != 0.0f || a.y != 0.0f || a.z != 0.0f || a.w != 0.0f;
}

template <int C>
__global__ void __launch_bounds__(32 * kWarps) warp_correlate_grad_src_kernel(
    const float* __restrict__ feats, const float* __restrict__ rel,
    const float* __restrict__ depth, const float* __restrict__ cot,
    float* __restrict__ grad, unsigned long long* __restrict__ stats,
    int B, int V, int D, int H, int W) {
  static_assert(C % 8 == 0 && 32 % (C / 8) == 0, "C/8 lanes must divide a warp");
  constexpr int G = C / 8;    // lanes per pixel
  constexpr int TW = 32 / G;  // pixels per tile row
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const int lane = threadIdx.x & 31;
  const int k = lane % G;  // float4 slots k and k + G: channels 4k.. and 4(k+G)..
  const int x = blockIdx.x * TW + lane / G;
  const int y = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.z / (V - 1);
  const int v = 1 + blockIdx.z % (V - 1);
  const bool live = x < W && y < H;
  const long long hw = (long long)H * W;
  // a lane past the image's edge reads pixel 0 and adds nothing
  const long long yx = live ? (long long)y * W + x : 0;

  const float4* ref4 = reinterpret_cast<const float4*>(feats + ((long long)b * V * hw + yx) * C);
  const float4 r0 = __ldg(ref4 + k), r1 = __ldg(ref4 + k + G);
  const float* m = rel + ((long long)b * (V - 1) + (v - 1)) * 12;
  const dmvs::Rays rays = dmvs::pixel_rays(m, (float)x, (float)y);
  float* dst = grad + ((long long)b * V + v) * hw * C;
  const float s = 2.0f / (float)C;  // exact: C/2 is a power of two
  unsigned int n_atomics = 0, n_moves = 0;

  // the sums of the 4 taps of the lane's current bilinear cell (cx, cy),
  // acc[tap][slot], tap t at (cx + t % 2, cy + t / 2); cx == INT_MIN while
  // the lane holds no cell
  float4 acc[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = zero;
  int cx = INT_MIN, cy = 0;

  // adds the cell's nonzero sums inside the image to device memory
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tx = cx + (j & 1), ty = cy + (j >> 1);
      if (tx >= 0 && tx < W && ty >= 0 && ty < H && (nonzero(acc[j][0]) || nonzero(acc[j][1]))) {
        float4* q = reinterpret_cast<float4*>(dst + ((long long)ty * W + tx) * C);
        atomicAdd(q + k, acc[j][0]);
        atomicAdd(q + k + G, acc[j][1]);
        n_atomics += 2;
      }
    }
  };

  // the depth and cotangent of plane d at this lane's pixel
  auto load = [&](int d, float& dep, float2& ct) {
    const long long p = ((long long)b * D + d) * hw + yx;
    dep = __ldg(depth + p);
    ct = __ldg(reinterpret_cast<const float2*>(cot) + p);
  };
  // each plane's depth and cotangent are loaded one plane ahead
  float dep_next;
  float2 ct_next;
  load(0, dep_next, ct_next);
  for (int d = 0; d < D; ++d) {
    const float dep = dep_next;
    const float2 ct = ct_next;
    if (d + 1 < D) load(d + 1, dep_next, ct_next);
    if (!live) continue;
    const dmvs::Taps tp = dmvs::plane_taps(m, rays, dep, H, W);
    if (tp.x0 != cx || tp.y0 != cy) {
      if (cx != INT_MIN) {
        flush();
        ++n_moves;
      }
      cx = tp.x0;
      cy = tp.y0;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = zero;
    }
    // the plane's 8 values 2/C * cot[g(c)] * ref[c]: channel c belongs to
    // group c % 2, so .x/.z take ct.x and .y/.w take ct.y
    const float c0 = ct.x * s, c1 = ct.y * s;
    const float4 u0 = make_float4(r0.x * c0, r0.y * c1, r0.z * c0, r0.w * c1);
    const float4 u1 = make_float4(r1.x * c0, r1.y * c1, r1.z * c0, r1.w * c1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      axpy4(acc[j][0], tp.w[j], u0);
      axpy4(acc[j][1], tp.w[j], u1);
    }
  }

  if (cx != INT_MIN) flush();

  if (stats != nullptr) {
    n_atomics = __reduce_add_sync(0xffffffffu, n_atomics);
    n_moves = __reduce_add_sync(0xffffffffu, n_moves);
    if (lane == 0) {
      atomicAdd(stats, (unsigned long long)n_atomics);
      atomicAdd(stats + 1, (unsigned long long)n_moves);
    }
  }
}

template <int C>
int launch_grad_src(const float* feats, const float* rel, const float* depth, const float* cot,
                    float* grad, unsigned long long* stats, int B, int V, int D, int H, int W,
                    cudaStream_t s) {
  constexpr int TW = 32 / (C / 8);
  const dim3 grid((W + TW - 1) / TW, (H + kWarps - 1) / kWarps, B * (V - 1));
  warp_correlate_grad_src_kernel<C><<<grid, 32 * kWarps, 0, s>>>(feats, rel, depth, cot, grad,
                                                                  stats, B, V, D, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a channel
// count without an instantiation).  `stats` may be NULL.
extern "C" int dmvs_warp_correlate_grad_src(const float* feats, const float* rel,
                                            const float* depth, const float* cot,
                                            float* grad, unsigned long long* stats, int B,
                                            int V, int D, int H, int W, int C, void* stream) {
  if ((long long)B * D * H * W == 0 || V < 2) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return launch_grad_src<8>(feats, rel, depth, cot, grad, stats, B, V, D, H, W, s);
    case 16: return launch_grad_src<16>(feats, rel, depth, cot, grad, stats, B, V, D, H, W, s);
    case 32: return launch_grad_src<32>(feats, rel, depth, cot, grad, stats, B, V, D, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

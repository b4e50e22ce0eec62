// Backward of the bilinear forward splat: gradients with respect to the
// splatted values and to the flow.
//
// Replaces: tcs_tpu/ops/splat.py, splat_sum_gatherbwd (:116) and the backward
// of its custom_vjp (_splat_gatherbwd_bwd, :139-185); the reference wrote the
// same two passes as CUDA kernels (softsplat.py:368-524). The adjoint of a
// bilinear scatter is a bilinear gather: source pixel (x, y) with target
// (tx, ty) = (x + fx, y + fy) reads the output cotangent g at the four
// integer neighbours (xi, yi) of the target and gets
//   dvalues[c] = sum_taps wx * wy * g_tap[c],
//   dflow_x    = sum_taps sx * wy * <values, g_tap>,
//   dflow_y    = sum_taps wx * sy * <values, g_tap>,
// with wx = 1 - |tx - xi|, wy = 1 - |ty - yi|, sx (sy) = -1 at the floor tap
// and +1 at the floor + 1 tap. Taps outside the image contribute nothing and
// a non-finite target gives zero gradients.
//
// What bounds it on the H100: memory. It reads values and flow, gathers g at
// four taps (neighbouring pixels share taps, so the re-reads mostly hit L2;
// the bound counts g once) and writes dvalues and dflow; about ten operations
// per element of g read.
//
// Design: a gather, so no atomics and a deterministic result. One warp per
// source pixel, as in the forward kernel: every lane computes the target, the
// tap weights and their validity once, the lanes then walk the channel-last
// channels, so the warp reads 32 neighbouring floats of each tap and writes 32
// neighbouring floats of dvalues. Each lane keeps four partial dot products
// <values, g_tap>; a butterfly of warp shuffles sums them and lane 0 writes
// the two flow components. Products and sums use round-to-nearest intrinsics
// so that dvalues matches the plain PyTorch version's rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void splat_sum_bwd_kernel(const float* __restrict__ g,
                                     const float* __restrict__ values,
                                     const float* __restrict__ flow,
                                     float* __restrict__ dvalues,
                                     float* __restrict__ dflow, int B, int H,
                                     int W, int C) {
  long long pix = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.y;
  long long npix = (long long)B * H * W;
  if (pix >= npix) return;
  int lane = threadIdx.x;
  long long hw = (long long)H * W;
  long long b = pix / hw;
  int rem = (int)(pix - b * hw);
  int y = rem / W;
  int x = rem - y * W;

  float tx = (float)x + flow[2 * pix];
  float ty = (float)y + flow[2 * pix + 1];
  bool finite = isfinite(tx) && isfinite(ty);
  float x0 = floorf(tx), y0 = floorf(ty);

  long long tgt[4];
  float wx[4], wy[4], w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float xi = x0 + (float)(k & 1);
    float yi = y0 + (float)(k >> 1);
    bool ok = finite && xi >= 0.0f && xi <= (float)(W - 1) && yi >= 0.0f &&
              yi <= (float)(H - 1);
    wx[k] = ok ? __fsub_rn(1.0f, fabsf(tx - xi)) : 0.0f;
    wy[k] = ok ? __fsub_rn(1.0f, fabsf(ty - yi)) : 0.0f;
    w[k] = __fmul_rn(wx[k], wy[k]);
    tgt[k] = ok ? (b * hw + (long long)yi * W + (long long)xi) * C : -1;
  }

  const float* src = values + pix * C;
  float* dst = dvalues + pix * C;
  float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = lane; c < C; c += 32) {
    float v = src[c];
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float gv = tgt[k] >= 0 ? g[tgt[k] + c] : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(w[k], gv));
      dot[k] = fmaf(v, gv, dot[k]);
    }
    dst[c] = acc;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], off);
  }
  if (lane == 0) {
    float dtx = 0.0f, dty = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float sx = (k & 1) ? 1.0f : -1.0f;
      float sy = (k >> 1) ? 1.0f : -1.0f;
      dtx += sx * wy[k] * dot[k];
      dty += wx[k] * sy * dot[k];
    }
    dflow[2 * pix] = dtx;
    dflow[2 * pix + 1] = dty;
  }
}

}  // namespace

// g, values: (B, H, W, C) fp32; flow: (B, H, W, 2) fp32; dvalues: (B, H, W, C)
// and dflow: (B, H, W, 2) fp32, every element of which is written.
// Returns the launch's error.
extern "C" int tcs_splat_sum_bwd(const void* g, const void* values,
                                 const void* flow, void* dvalues, void* dflow,
                                 int B, int H, int W, int C, void* stream) {
  long long npix = (long long)B * H * W;
  if (npix == 0) return (int)cudaSuccess;
  dim3 block(32, kWarpsPerBlock);
  unsigned grid = (unsigned)((npix + kWarpsPerBlock - 1) / kWarpsPerBlock);
  splat_sum_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(values),
      static_cast<const float*>(flow), static_cast<float*>(dvalues),
      static_cast<float*>(dflow), B, H, W, C);
  return (int)cudaGetLastError();
}

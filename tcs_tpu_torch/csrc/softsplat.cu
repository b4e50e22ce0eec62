// Bilinear forward splat (scatter-add) of a channel-last payload, forward only.
//
// Replaces: tcs_tpu/ops/splat.py, splat_sum (:30), an XLA scatter-add under
// softsplat(mode='soft-clipeps') (:191). It is not a Pallas kernel there; the
// reference wrote it as its own CUDA atomicAdd kernel (softsplat.py:284-345).
// Each source pixel (x, y) adds values[b, y, x, :] * w to the four integer
// neighbours of (x + fx, y + fy), w = (1 - |tx - xi|)(1 - |ty - yi|); taps
// outside the image are dropped and non-finite targets skipped.
//
// What bounds it on the H100: memory and L2 atomics. At the main path's
// shapes (1, 96, 320, 258) fp32 it reads about 32 MB of payload and its
// output (32 MB) receives 4 fp32 atomic adds per element, which resolve in
// the 50 MB L2.
//
// Design: one warp per source pixel. The target and the four weights are
// computed once per pixel (by every lane, which is cheaper than a shuffle);
// the lanes then walk the C channels, so a warp reads 32 neighbouring values
// and adds into 32 neighbouring addresses of each target cell. The output
// must be zeroed by the caller; the kernel allocates nothing. Float atomics
// make the order of the sums, and so the last bits, vary from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void splat_sum_kernel(const float* __restrict__ values,
                                 const float* __restrict__ flow,
                                 float* __restrict__ out, int B, int H, int W,
                                 int C) {
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
  if (!isfinite(tx) || !isfinite(ty)) return;
  float x0 = floorf(tx), y0 = floorf(ty);

  long long tgt[4];
  float w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float xi = x0 + (float)(k & 1);
    float yi = y0 + (float)(k >> 1);
    bool ok = xi >= 0.0f && xi <= (float)(W - 1) && yi >= 0.0f && yi <= (float)(H - 1);
    w[k] = ok ? __fmul_rn(__fsub_rn(1.0f, fabsf(tx - xi)), __fsub_rn(1.0f, fabsf(ty - yi)))
              : 0.0f;
    tgt[k] = ok ? (b * hw + (long long)yi * W + (long long)xi) * C : -1;
  }

  const float* src = values + pix * C;
  for (int c = lane; c < C; c += 32) {
    float v = src[c];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (tgt[k] >= 0) atomicAdd(out + tgt[k] + c, __fmul_rn(v, w[k]));
    }
  }
}

}  // namespace

// values: (B, H, W, C) fp32; flow: (B, H, W, 2) fp32; out: (B, H, W, C) fp32,
// zeroed by the caller. Returns the launch's error.
extern "C" int tcs_splat_sum(const void* values, const void* flow, void* out,
                             int B, int H, int W, int C, void* stream) {
  long long npix = (long long)B * H * W;
  if (npix == 0 || C == 0) return (int)cudaSuccess;
  dim3 block(32, kWarpsPerBlock);
  unsigned grid = (unsigned)((npix + kWarpsPerBlock - 1) / kWarpsPerBlock);
  splat_sum_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(flow),
      static_cast<float*>(out), B, H, W, C);
  return (int)cudaGetLastError();
}

// Backward of the radius lookup across the correlation pyramid: the gradient
// with respect to every pyramid level, all levels in one launch.
//
// Replaces: tcs_tpu/ops/corr.py, lookup_onehot_w2major_vjp (:375) and the
// backward of its custom_vjp (_lookup_w2major_vjp.bwd, :341-369). The lookup
// is linear in the pyramid, so its transpose needs the coordinates and the
// output cotangent g only. Per level i, with c = coords_x * 2^-i,
// base = floor(c), frac = c - base, the row of pixel p receives
//   dlevel_i[p, base + k] = (1 - frac) * g_k + frac * g_{k-1},  k in [-r, r+1]
// (g_k = g[p, i*(2r+1) + k + r], zero outside its 2r+1 entries) and zero in
// every other cell. The gradient with respect to the coordinates is defined
// as zero, as in the JAX package.
//
// What bounds it on the H100: memory. It writes the whole gradient pyramid
// once (rows * sum_i (W2 >> i) elements) and reads rows * L * (2r+1) floats of
// g and the coordinates; the arithmetic is two multiplies and an add for
// 2r+2 cells of a row.
//
// Design: each (pixel, level) owns one row of dlevel_i, so nothing is shared
// between threads: no atomics, no zero fill before the launch, and the result
// is deterministic. One warp takes one (pixel, level); its lanes stride the
// row, so a warp's stores are contiguous, and every cell of the row is
// written exactly once, the window value inside the window and zero outside
// it. The window test is made in float before any integer conversion, as in
// the forward kernel, so a far-out or non-finite coordinate writes a row of
// zeros. Arithmetic is fp32 with round-to-nearest intrinsics (no FMA
// contraction), then one rounding into bf16 where the pyramid is bf16, so the
// kernel matches the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

template <typename T>
struct GradLevels {
  T* ptr[kMaxLevels];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void corr_lookup_bwd_kernel(GradLevels<T> dlevels, int num_levels,
                                       int w2, const float* __restrict__ coords,
                                       const float* __restrict__ g,
                                       long long rows, int radius) {
  long long t = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (t >= rows * num_levels) return;
  long long p = t / num_levels;
  int lvl = (int)(t - p * num_levels);
  int w2i = w2 >> lvl;
  int nt = 2 * radius + 1;
  T* row = dlevels.ptr[lvl] + p * (long long)w2i;
  const float* gl = g + (p * num_levels + lvl) * (long long)nt;

  float c = coords[p] * (1.0f / (float)(1 << lvl));
  float base = floorf(c);
  float frac = __fsub_rn(c, base);
  float one_minus = __fsub_rn(1.0f, frac);
  float lo = (float)(-radius), hi = (float)(radius + 1);

  for (int j = threadIdx.x; j < w2i; j += 32) {
    float d = (float)j - base;  // NaN or +-inf fails the test below
    float v = 0.0f;
    if (d >= lo && d <= hi) {
      int k = (int)d + radius;  // 0 .. 2r+1
      float a = k < nt ? __fmul_rn(one_minus, gl[k]) : 0.0f;
      float b = k >= 1 ? __fmul_rn(frac, gl[k - 1]) : 0.0f;
      v = __fadd_rn(a, b);
    }
    store(row + j, v);
  }
}

template <typename T>
cudaError_t launch(void* const* ptrs, int num_levels, int w2, const float* coords,
                   const float* g, long long rows, int radius,
                   cudaStream_t stream) {
  GradLevels<T> lv;
  for (int i = 0; i < kMaxLevels; ++i)
    lv.ptr[i] = i < num_levels ? static_cast<T*>(ptrs[i]) : nullptr;
  long long work = rows * num_levels;
  if (work == 0) return cudaSuccess;
  dim3 block(32, kWarpsPerBlock);
  unsigned grid = (unsigned)((work + kWarpsPerBlock - 1) / kWarpsPerBlock);
  corr_lookup_bwd_kernel<T><<<grid, block, 0, stream>>>(lv, num_levels, w2, coords,
                                                        g, rows, radius);
  return cudaGetLastError();
}

}  // namespace

// dlevels: num_levels device pointers to row-contiguous (rows, w2 >> i) arrays
// of fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1), every cell of which is written;
// coords: (rows,) fp32; g: (rows, num_levels * (2*radius+1)) fp32.
// Returns the launch's error.
extern "C" int tcs_corr_lookup_bwd(void* const* dlevels, int num_levels, int w2,
                                   const void* coords, const void* g, int rows,
                                   int radius, int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(coords);
  auto gp = static_cast<const float*>(g);
  cudaError_t err = is_bf16
      ? launch<__nv_bfloat16>(dlevels, num_levels, w2, c, gp, rows, radius, s)
      : launch<float>(dlevels, num_levels, w2, c, gp, rows, radius, s);
  return (int)err;
}

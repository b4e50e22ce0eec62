// Radius lookup across the correlation pyramid, forward only.
//
// Replaces: tcs_tpu/ops/pallas/corr_kernel.py, lookup_pallas (:76) and its
// body _lookup_kernel (:42). Per pyramid level i, c = coords_x * 2^-i; the
// 2r+2 integer taps T_k = corr_i[floor(c)+k], k in [-r, r+1], are zero
// outside [0, W2_i - 1]; the output is (1-frac)*T_t + frac*T_{t+1} in fp32,
// level-major, (rows, L*(2r+1)).
//
// What bounds it on the H100: memory. Each (pixel, level) reads 2r+2 values
// of its own row of the level and writes 2r+1 floats, a few operations per
// byte. At the main path's shapes (96x320 pixels, W2 = 320, 4 levels, r = 4)
// a launch moves about 2.5 MB of bf16 window reads and 4.4 MB of fp32 output,
// a few microseconds at HBM rate, so launch overhead dominates.
//
// Design: one thread per (pixel, level). The TPU kernel scanned whole rows
// with one-hot compares because lanes cannot gather; on the GPU each thread
// reads its window directly: 2r+2 contiguous elements of one row, in the
// pyramid's storage type, bounds-checked for zero padding. Thread p*L+i
// writes its 2r+1 outputs at out[p*L*(2r+1) + i*(2r+1)], so a warp writes one
// contiguous span. The lerp uses round-to-nearest intrinsics so that nvcc
// does not contract it into an FMA, and the result matches the plain
// PyTorch version's rounding.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxLevels = 8;

template <typename T>
struct Levels {
  const T* ptr[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int R>
__global__ void corr_lookup_kernel(Levels<T> levels, int num_levels, int w2,
                                   const float* __restrict__ coords,
                                   float* __restrict__ out, long long rows) {
  constexpr int kTaps = 2 * R + 1;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * num_levels) return;
  long long p = t / num_levels;
  int lvl = (int)(t - p * num_levels);
  int w2i = w2 >> lvl;
  const T* row = levels.ptr[lvl] + p * (long long)w2i;

  float c = coords[p] * (1.0f / (float)(1 << lvl));
  float base = floorf(c);
  float frac = __fsub_rn(c, base);
  float tap[kTaps + 1];
#pragma unroll
  for (int k = 0; k < kTaps + 1; ++k) {
    float idx = base + (float)(k - R);
    // Compare in float before converting: a far-out or non-finite
    // coordinate then never forms an out-of-range int.
    tap[k] = (idx >= 0.0f && idx <= (float)(w2i - 1)) ? to_f32(row[(int)idx]) : 0.0f;
  }
  float one_minus = __fsub_rn(1.0f, frac);
  float* o = out + p * (long long)num_levels * kTaps + lvl * kTaps;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    o[k] = __fadd_rn(__fmul_rn(one_minus, tap[k]), __fmul_rn(frac, tap[k + 1]));
  }
}

template <typename T>
cudaError_t launch(const void* const* ptrs, int num_levels, int w2,
                   const float* coords, float* out, long long rows, int radius,
                   cudaStream_t stream) {
  Levels<T> lv;
  for (int i = 0; i < kMaxLevels; ++i)
    lv.ptr[i] = i < num_levels ? static_cast<const T*>(ptrs[i]) : nullptr;
  const int threads = 256;
  long long work = rows * num_levels;
  unsigned blocks = (unsigned)((work + threads - 1) / threads);
  if (blocks == 0) return cudaSuccess;
  switch (radius) {
#define TCS_CASE(R)                                                             \
  case R:                                                                       \
    corr_lookup_kernel<T, R><<<blocks, threads, 0, stream>>>(lv, num_levels, w2, \
                                                             coords, out, rows); \
    break;
    TCS_CASE(1) TCS_CASE(2) TCS_CASE(3) TCS_CASE(4)
    TCS_CASE(5) TCS_CASE(6) TCS_CASE(7) TCS_CASE(8)
#undef TCS_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// levels: num_levels device pointers to row-contiguous (rows, w2 >> i) arrays
// of fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); coords: (rows,) fp32;
// out: (rows, num_levels * (2*radius+1)) fp32. Returns the launch's error.
extern "C" int tcs_corr_lookup(const void* const* levels, int num_levels, int w2,
                               const void* coords, void* out, int rows,
                               int radius, int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(coords);
  auto o = static_cast<float*>(out);
  cudaError_t err = is_bf16
      ? launch<__nv_bfloat16>(levels, num_levels, w2, c, o, rows, radius, s)
      : launch<float>(levels, num_levels, w2, c, o, rows, radius, s);
  return (int)err;
}

// Radius lookup across the correlation pyramid, forward only.
//
// Replaces: tcs_tpu/ops/pallas/corr_kernel.py, lookup_pallas (:76) and its
// body _lookup_kernel (:42). Per pyramid level i, c = coords_x * 2^-i; the
// 2r+2 integer taps T_k = corr_i[floor(c)+k], k in [-r, r+1], are zero
// outside [0, W2_i - 1]; the output is (1-frac)*T_t + frac*T_{t+1} in fp32,
// level-major, (rows, L*(2r+1)).
//
// What bounds it on the H100: memory. Each output reads two taps of one
// level's row and is written once, a few operations per byte. At the training
// shapes (B4, 80x180 grid, 4 levels, r = 4, bf16 pyramid) a launch must move
// 12.4 MB (window taps, coordinates, fp32 output): 0.0037 ms at 3.35 TB/s; at
// the inference shapes (B1, 96x320) 6.6 MB, 0.0020 ms, under the card's cost
// of one launch.
//
// The first design gave one thread to each (pixel, level): 122,880 threads at
// the inference shapes and 230,400 in training, less than one wave of 132
// SMs. Each thread ran a serial chain of 10 tap loads and 9 stores, its lanes
// in different rows, so each load touched 32 sectors and each store wrote 32
// addresses 36 bytes apart; a 64-bit divide by the runtime level count opened
// every thread. Latency-bound: 0.0279 ms in training (bf16), 13 % of the
// bound.
//
// This design gives one thread to each output element. With the level count L
// and the radius R template constants, thread e finds its pixel, level and
// tap by 32-bit division by constants, reads the pixel's coordinate (shared by
// the L(2R+1) neighbouring lanes, an L1 hit) and the two taps it blends, and
// writes one float: a warp's stores are one contiguous 128-byte span, its
// loads fall in a few sectors, and the grid is many waves (8,100 blocks in
// training). Rows are cut into segments of fewer than 2^31 outputs, one per
// grid row, so the index arithmetic stays 32-bit. The taps are tested in
// float before any integer conversion, so a far-out or non-finite coordinate
// never forms an out-of-range index, and the lerp uses round-to-nearest
// intrinsics so that nvcc does not contract it into an FMA: the result is
// the plain PyTorch version's, bit for bit.
//
// Measured (scripts/bench_lookup_kernels.py, NVIDIA H100 80GB HBM3, 700 W),
// bf16, L2 warm / cold: training 0.0108 / 0.0202 ms (first design 0.0281 /
// 0.0339), 34 % of the bound; inference 0.0065 / 0.0141 ms (0.0151 / 0.0226),
// where one empty launch costs 0.0017 back to back. Half the bound, the goal
// of the design, is missed: the bound counts the 20 bytes of a window, but
// the memory system moves whole 32-byte sectors, one or two for each (pixel,
// level) row, and each thread waits on two dependent round trips (its
// coordinate, then its taps). Four outputs a thread, with all their loads in
// flight at once, measured 0.0105 ms against this design's 0.0112 in the same
// call: the chain per thread is not what holds it back.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

template <typename T>
struct Levels {
  const T* ptr[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int L, int R>
__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(Levels<T> levels, int w2, const float* __restrict__ coords,
                   float* __restrict__ out, int rows, int seg_rows) {
  constexpr int kTaps = 2 * R + 1;
  constexpr unsigned kRow = L * kTaps;  // outputs per pixel
  const long long row0 = (long long)blockIdx.y * seg_rows;
  const unsigned n = (unsigned)min((long long)seg_rows, rows - row0) * kRow;
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const unsigned q = e / kRow;
  const unsigned rem = e - q * kRow;
  const int lvl = (int)(rem / kTaps);
  const int k = (int)(rem - lvl * kTaps);
  const long long p = row0 + q;

  const T* level = levels.ptr[0];
#pragma unroll
  for (int i = 1; i < L; ++i)
    if (lvl == i) level = levels.ptr[i];
  const int w2i = w2 >> lvl;
  const T* row = level + p * w2i;

  float c = __ldg(coords + p) * (1.0f / (float)(1 << lvl));
  float base = floorf(c);
  float frac = __fsub_rn(c, base);
  float hi = (float)(w2i - 1);
  float i0 = base + (float)(k - R);
  float i1 = base + (float)(k + 1 - R);
  float t0 = (i0 >= 0.0f && i0 <= hi) ? to_f32(__ldg(row + (int)i0)) : 0.0f;
  float t1 = (i1 >= 0.0f && i1 <= hi) ? to_f32(__ldg(row + (int)i1)) : 0.0f;
  out[row0 * kRow + e] =
      __fadd_rn(__fmul_rn(__fsub_rn(1.0f, frac), t0), __fmul_rn(frac, t1));
}

template <typename T, int L, int R>
cudaError_t launch_lr(const Levels<T>& lv, int w2, const float* coords, float* out,
                      int rows, cudaStream_t stream) {
  constexpr long long kRow = L * (2 * R + 1);
  const long long seg_rows = 0x7fffffffLL / kRow;
  const long long nseg = (rows + seg_rows - 1) / seg_rows;
  const long long seg = rows < seg_rows ? rows : seg_rows;
  dim3 grid((unsigned)((seg * kRow + kThreads - 1) / kThreads), (unsigned)nseg);
  corr_lookup_kernel<T, L, R><<<grid, kThreads, 0, stream>>>(lv, w2, coords, out, rows,
                                                             (int)seg_rows);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_l(const Levels<T>& lv, int w2, const float* coords, float* out,
                     int rows, int radius, cudaStream_t stream) {
  switch (radius) {
#define TCS_CASE(R) \
  case R: return launch_lr<T, L, R>(lv, w2, coords, out, rows, stream);
    TCS_CASE(1) TCS_CASE(2) TCS_CASE(3) TCS_CASE(4)
    TCS_CASE(5) TCS_CASE(6) TCS_CASE(7) TCS_CASE(8)
#undef TCS_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const void* const* ptrs, int num_levels, int w2, const float* coords,
                   float* out, int rows, int radius, cudaStream_t stream) {
  if (rows <= 0) return rows == 0 ? cudaSuccess : cudaErrorInvalidValue;
  Levels<T> lv;
  for (int i = 0; i < kMaxLevels; ++i)
    lv.ptr[i] = i < num_levels ? static_cast<const T*>(ptrs[i]) : nullptr;
  switch (num_levels) {
#define TCS_CASE(L) \
  case L: return launch_l<T, L>(lv, w2, coords, out, rows, radius, stream);
    TCS_CASE(1) TCS_CASE(2) TCS_CASE(3) TCS_CASE(4)
    TCS_CASE(5) TCS_CASE(6) TCS_CASE(7) TCS_CASE(8)
#undef TCS_CASE
    default: return cudaErrorInvalidValue;
  }
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

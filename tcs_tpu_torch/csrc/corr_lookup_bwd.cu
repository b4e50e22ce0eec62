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
// g and the coordinates: at the training shapes (B4, 80x180 grid, bf16) 47.3
// MB, 0.0141 ms at 3.35 TB/s. The arithmetic is two multiplies and an add for
// 2r+2 cells of a row.
//
// The first design gave one warp to each (pixel, level): 230,400 short warps
// in training, each paying a 64-bit divide and a dependent load of its
// coordinate before it wrote one row of 22 to 180 cells as 2-byte stores,
// rows that are not aligned to sectors. 0.1404 ms in training (bf16), 10 % of
// the bound.
//
// This design is flat and level-fused. Level i's gradient is one contiguous
// (rows x W2_i) array, 16-byte aligned (the wrapper allocates it), cut into
// 16-byte chunks of 8 bf16 or 4 fp32 cells. One launch covers every level: a
// block takes a run of up to 8 chunks a thread of one level (blocks
// [off_i, off_{i+1}) belong to level i) and writes each chunk with one 16-byte
// store, so a warp's store instruction is one contiguous 512-byte span. The
// block first stages, one pixel a thread, the 2r+2 window values of every
// pixel its chunks touch and the column where the window starts into shared
// memory: the 2r+1 loads of g and the coordinate's are issued together, one
// round trip for the block. A thread then finds the pixel and column of its
// chunk's first cell with one divide: a row is at least a chunk wide at the
// model's shapes (widths 22, 45, 90 and 180 are not multiples of 8), so a
// chunk holds cells of at most two rows, and a cell's place in its window is
// one add and one compare; narrower rows carry the pixel across the chunk
// cell by cell. A level's ragged tail, where its cell count is not a
// multiple of the chunk, is written cell by cell. Every cell is written
// exactly once, the window value inside the window and zero outside it: no
// atomics, no zero fill, deterministic. The window test is made in float
// before any integer conversion, so a far-out or non-finite coordinate
// writes a row of zeros. Arithmetic is fp32 with round-to-nearest
// intrinsics (no FMA contraction), then one rounding into bf16 where the
// pyramid is bf16: the plain PyTorch version's result, bit for bit, for rows
// shorter than 2^24 cells (the wrapper raises above).
//
// Measured (scripts/bench_lookup_kernels.py, NVIDIA H100 80GB HBM3, 700 W),
// training shapes, L2 warm / cold: bf16 0.0228 / 0.0268 ms (first design
// 0.1426 / 0.1460), 62 % of the bound; fp32 0.0362 / 0.0389 ms (0.1519 /
// 0.1554), 71 %. In one call, bf16 / fp32: 1, 2, 4 and 8 chunks a thread
// 0.0331 / 0.0550, 0.0269 / 0.0420, 0.0251 / 0.0364 and 0.0231 / 0.0360 ms;
// the two-row path off, 0.0269 / 0.0379.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kChunksPerThread = 8;
constexpr int kMaxChunks = kThreads * kChunksPerThread;  // per block
constexpr int kMaxPixels = kThreads;  // staged per block, one per thread

template <typename T>
struct Plan {
  T* ptr[kMaxLevels];
  long long block_off[kMaxLevels + 1];  // first block of each level
  int chunks_per_block[kMaxLevels];
};

// a / b for a >= 0, b > 0, in 32 bits where a fits.
__device__ __forceinline__ long long div_nonneg(long long a, int b) {
  return a <= 0xffffffffLL ? (long long)((unsigned)a / (unsigned)b) : a / b;
}

__device__ __forceinline__ void store_chunk(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst, const float* v) {
  uint4 pk;
  unsigned* w = reinterpret_cast<unsigned*>(&pk);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    w[e] = *reinterpret_cast<unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = pk;
}
__device__ __forceinline__ void store_cell(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_cell(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
corr_lookup_bwd_kernel(Plan<T> plan, int num_levels, int w2,
                       const float* __restrict__ coords,
                       const float* __restrict__ g, int rows) {
  constexpr int kTaps = 2 * R + 1;
  constexpr int kWin = 2 * R + 2;  // cells of a row the window can touch
  constexpr int kStride = kWin + 1;  // odd: a warp's staging stores hit distinct banks
  constexpr int kCell = 16 / (int)sizeof(T);  // cells per 16-byte chunk
  constexpr int kFar = -(1 << 30);  // a window start no row can reach
  __shared__ float s_win[kMaxPixels * kStride];
  __shared__ int s_first[kMaxPixels];  // column of a pixel's window cell 0

  const long long bx = blockIdx.x;
  int lvl = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i < num_levels && bx >= plan.block_off[i]) lvl = i;
  T* dst = plan.ptr[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (lvl == i) dst = plan.ptr[i];
  const int w2i = w2 >> lvl;
  const int chunks = plan.chunks_per_block[lvl];
  const long long n = (long long)rows * w2i;  // cells of the level
  const long long cell0 = (bx - plan.block_off[lvl]) * chunks * kCell;
  const long long cell_end = min(cell0 + (long long)chunks * kCell, n);
  const long long p_lo = div_nonneg(cell0, w2i);
  const int np = (int)(div_nonneg(cell_end - 1, w2i) - p_lo) + 1;

  // Stage the window of every pixel the block touches, one pixel a thread
  // (np < kThreads: one pass): s_win[q * kStride + t] is the value of cell
  // s_first[q] + t of pixel p_lo + q. A window that cannot touch the row,
  // from a far-out or non-finite coordinate (the float test fails for NaN),
  // starts at kFar, so that no cell of the row falls in it.
  const float scale = 1.0f / (float)(1 << lvl);
  for (int q = threadIdx.x; q < np; q += kThreads) {
    const long long p = p_lo + q;
    const float* gl = g + (p * num_levels + lvl) * kTaps;
    float gk[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) gk[k] = __ldg(gl + k);
    float c = __ldg(coords + p) * scale;
    float base = floorf(c);
    float frac = __fsub_rn(c, base);
    float one_minus = __fsub_rn(1.0f, frac);
    float* w = s_win + q * kStride;
#pragma unroll
    for (int t = 0; t < kWin; ++t) {
      float a = t < kTaps ? __fmul_rn(one_minus, gk[t]) : 0.0f;
      float b = t >= 1 ? __fmul_rn(frac, gk[t - 1]) : 0.0f;
      w[t] = __fadd_rn(a, b);
    }
    s_first[q] = (base >= (float)(-R - 1) && base <= (float)(w2i - 1 + R)) ? (int)base - R
                                                                         : kFar;
  }
  __syncthreads();

  const int col0 = (int)(cell0 - p_lo * w2i);  // column of the block's first cell
#pragma unroll
  for (int it = 0; it < kChunksPerThread; ++it) {
    const int local = it * kThreads + threadIdx.x;  // chunk within the block
    const long long cell = cell0 + (long long)local * kCell;
    if (local >= chunks || cell >= n) break;
    const int valid = (int)min((long long)kCell, n - cell);  // < kCell in the ragged tail
    const int f = col0 + local * kCell;
    int q = f / w2i;
    int j = f - q * w2i;
    float v[kCell];
    if (w2i >= kCell) {
      // The chunk holds cells of row q and at most the first cells of row
      // q + 1: cell e sits at window column t0 + e, or t1 + e past the row's end.
      const int t0 = j - s_first[q];
      const int t1 = j - w2i - (q + 1 < np ? s_first[q + 1] : kFar);
#pragma unroll
      for (int e = 0; e < kCell; ++e) {
        const bool next = j + e >= w2i;
        const int t = (next ? t1 : t0) + e;
        v[e] = (e < valid && (unsigned)t < (unsigned)kWin)
                   ? s_win[(q + next) * kStride + t] : 0.0f;
      }
    } else {  // rows narrower than a chunk: carry the row across the cells
#pragma unroll
      for (int e = 0; e < kCell; ++e) {
        v[e] = 0.0f;
        if (e < valid) {
          const int t = j - s_first[q];
          if ((unsigned)t < (unsigned)kWin) v[e] = s_win[q * kStride + t];
        }
        if (++j == w2i) { j = 0; ++q; }
      }
    }
    if (valid == kCell) {
      store_chunk(dst + cell, v);
    } else {  // the level's ragged tail, cell by cell
#pragma unroll
      for (int e = 0; e < kCell; ++e)
        if (e < valid) store_cell(dst + cell + e, v[e]);
    }
  }
}

template <typename T>
cudaError_t launch(void* const* ptrs, int num_levels, int w2, const float* coords,
                   const float* g, int rows, int radius, cudaStream_t stream) {
  constexpr int kCell = 16 / (int)sizeof(T);
  Plan<T> plan;
  long long blocks = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    plan.ptr[i] = i < num_levels ? static_cast<T*>(ptrs[i]) : nullptr;
    plan.block_off[i] = blocks;
    plan.chunks_per_block[i] = 0;
    if (i >= num_levels) continue;
    if (reinterpret_cast<uintptr_t>(plan.ptr[i]) % 16 != 0) return cudaErrorMisalignedAddress;
    const long long w2i = w2 >> i;
    const long long chunks = ((long long)rows * w2i + kCell - 1) / kCell;
    if (chunks == 0) continue;
    // The cells of one block span at most kMaxPixels - 2 pixels, all staged.
    long long per_block = ((kMaxPixels - 3) * w2i + 1) / kCell;
    if (per_block > kMaxChunks) per_block = kMaxChunks;
    plan.chunks_per_block[i] = (int)per_block;
    blocks += (chunks + per_block - 1) / per_block;
  }
  plan.block_off[kMaxLevels] = blocks;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  switch (radius) {
#define TCS_CASE(R)                                                          \
  case R:                                                                    \
    corr_lookup_bwd_kernel<T, R><<<(unsigned)blocks, kThreads, 0, stream>>>( \
        plan, num_levels, w2, coords, g, rows);                              \
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

// dlevels: num_levels device pointers, 16-byte aligned, to row-contiguous
// (rows, w2 >> i) arrays of fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1), every
// cell of which is written; coords: (rows,) fp32; g: (rows, num_levels *
// (2*radius+1)) fp32. Returns the launch's error.
extern "C" int tcs_corr_lookup_bwd(void* const* dlevels, int num_levels, int w2,
                                   const void* coords, const void* g, int rows,
                                   int radius, int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 1 || rows < 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(coords);
  auto gp = static_cast<const float*>(g);
  cudaError_t err = is_bf16
      ? launch<__nv_bfloat16>(dlevels, num_levels, w2, c, gp, rows, radius, s)
      : launch<float>(dlevels, num_levels, w2, c, gp, rows, radius, s);
  return (int)err;
}

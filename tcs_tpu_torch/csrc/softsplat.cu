// Bilinear forward splat (scatter-add) of a channel-last payload, forward only,
// deterministic and bit-exact with the plain version.
//
// Replaces: tcs_tpu/ops/splat.py, splat_sum (:30), an XLA scatter-add under
// softsplat(mode='soft-clipeps') (:191). It is not a Pallas kernel there; the
// reference wrote it as its own CUDA atomicAdd kernel (softsplat.py:284-345).
// Each source pixel (x, y) adds values[b, y, x, :] * w to the four integer
// neighbours of (x + fx, y + fy), w = (1 - |tx - xi|)(1 - |ty - yi|); taps
// outside the image are dropped and non-finite targets skipped. The JAX
// function and the plain version (index_add_ on the CPU) add each target
// cell's contributions in (tap, source index) order, each product rounded
// before its add.
//
// What bounds it on the H100: bytes. At the inference path's shapes
// (1, 96, 320, 258) fp32 it must read 32 MB of payload and write 32 MB of
// output. Each source row is wanted by up to four target cells, so a gather
// reads the payload about four times: from HBM once, from L2 (50 MB) after.
//
// Design: the scatter becomes a gather, so that no float is added atomically
// and every output row is written once, by one warp, in a fixed order.
//   1. count: one thread per (source, tap) finds the target cell with the
//      plain version's arithmetic and adds 1 to its int count (int atomics
//      give the same counts on every run);
//   2. scan: an exclusive prefix sum of the counts (one pass, tiles chained
//      by a decoupled look-back) gives each cell its bucket in a key array;
//   3. fill: each valid tap writes its key tap * (B*H*W) + source into its
//      target's bucket, in an order that varies from run to run;
//   4. gather: one warp per target cell orders its bucket's keys ascending,
//      which is the reference's (tap, source) order (buckets of up to 32 keys
//      are ranked in registers; longer ones, which collapsing flows make,
//      take the next smallest key again and again), recomputes each weight
//      from the flow, and walks the channels (two a lane where C is even)
//      adding v * w with round-to-nearest intrinsics, which nvcc does not fuse
//      into an FMA. Empty buckets write zeros, so the output needs no fill.
// Passes 2-4 are programmatic dependent launches: each starts while the one
// before it ends and waits for its results. The caller passes int32 scratch
// of tcs_splat_sum_scratch_ints() entries; the kernel allocates nothing.
// Index arithmetic on the payload is 64-bit; keys are int32, so 4 * B * H * W
// must stay below 2^31.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;                         // count and fill
constexpr int kScanThreads = 512;
constexpr int kScanItems = 8;                         // per thread, consecutive
constexpr int kScanTile = kScanThreads * kScanItems;  // counts per block
constexpr int kGatherWarps = 4;                       // target cells per block

// Programmatic dependent launch (sm_90): a pass lets the next one launch
// early, and the next one waits for its results before it reads them.
__device__ __forceinline__ void let_next_pass_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous_pass() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The target cell of tap `tap` (0..3: +x, then +y) of source pixel `src`, or -1
// where the tap falls outside the image or the target is not finite; its
// weight in *w where w is given. The arithmetic is splat_sum_plain's.
__device__ __forceinline__ int tap_target(const float* __restrict__ flow, int src, int tap,
                                          int H, int W, float* w) {
  int hw = H * W;
  int b = src / hw;
  int rem = src - b * hw;
  int y = rem / W;
  int x = rem - y * W;
  float tx = __fadd_rn((float)x, flow[2 * src]);
  float ty = __fadd_rn((float)y, flow[2 * src + 1]);
  if (!isfinite(tx) || !isfinite(ty)) return -1;
  float xi = __fadd_rn(floorf(tx), (float)(tap & 1));
  float yi = __fadd_rn(floorf(ty), (float)(tap >> 1));
  if (!(xi >= 0.0f && xi <= (float)(W - 1) && yi >= 0.0f && yi <= (float)(H - 1))) return -1;
  if (w != nullptr)
    *w = __fmul_rn(__fsub_rn(1.0f, fabsf(__fsub_rn(tx, xi))),
                   __fsub_rn(1.0f, fabsf(__fsub_rn(ty, yi))));
  return b * hw + (int)yi * W + (int)xi;
}

// grid (ceil(n / kThreads), 4): blockIdx.y is the tap.
__global__ void splat_sum_count_kernel(const float* __restrict__ flow, int* __restrict__ count,
                                       int n, int H, int W) {
  let_next_pass_launch();
  int src = blockIdx.x * kThreads + threadIdx.x;
  if (src >= n) return;
  int t = tap_target(flow, src, blockIdx.y, H, W, nullptr);
  if (t >= 0) atomicAdd(count + t, 1);
}

__device__ __forceinline__ int scan_slot(int p) { return p + (p >> 5); }  // no bank conflicts

// offset[i] = count[0] + ... + count[i - 1] for i in [0, n]. Tiles take their
// index from a ticket, so a tile only waits on tiles that started before it;
// each publishes its own total (flag 1) at once and its inclusive prefix
// (flag 2) when known, both in one 64-bit word: flag << 32 | value.
__global__ void __launch_bounds__(kScanThreads)
splat_sum_scan_kernel(const int* __restrict__ count, int* __restrict__ offset,
                      unsigned long long* status, int* ticket, int n) {
  __shared__ int sm[kScanTile + kScanTile / 32];
  __shared__ int warp_excl[kScanThreads / 32];
  __shared__ int tile_s, prefix_s;
  let_next_pass_launch();
  wait_for_previous_pass();
  int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_s = atomicAdd(ticket, 1);
  __syncthreads();
  int tile = tile_s;
  long long base = (long long)tile * kScanTile;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    int p = j * kScanThreads + tid;
    sm[scan_slot(p)] = base + p < n ? count[base + p] : 0;
  }
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) s += sm[scan_slot(tid * kScanItems + j)];
  int incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_excl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kScanThreads / 32 ? warp_excl[lane] : 0;
    int wincl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int u = __shfl_up_sync(kFull, wincl, d);
      if (lane >= d) wincl += u;
    }
    if (lane < kScanThreads / 32) warp_excl[lane] = wincl - v;
    int total = __shfl_sync(kFull, wincl, 31);
    if (lane == 0) atomicExch(status + tile, ((tile == 0 ? 2ull : 1ull) << 32) | (unsigned)total);
    // Look back 32 tiles at a time, lane j at tile - 1 - j (before tile 0: an
    // inclusive 0): add every total down to the nearest inclusive prefix,
    // reading the window again while a tile before that has not published.
    int excl = 0;
    for (int p = tile - 1 - lane; tile > 0; p -= 32) {
      unsigned long long st;
      unsigned ready, first;
      do {
        st = p >= 0 ? *(volatile unsigned long long*)(status + p) : 2ull << 32;
        unsigned inclusive = __ballot_sync(kFull, (st >> 32) == 2);
        first = inclusive ? __ffs(inclusive) - 1 : 31;  // the last lane that counts
        ready = __ballot_sync(kFull, (st >> 32) != 0) | ~(0xffffffffu >> (31 - first));
      } while (ready != kFull);
      excl += __reduce_add_sync(kFull, lane <= (int)first ? (int)(unsigned)st : 0);
      if ((__shfl_sync(kFull, st, first) >> 32) == 2) break;
    }
    if (lane == 0) {
      if (tile > 0) atomicExch(status + tile, (2ull << 32) | (unsigned)(excl + total));
      prefix_s = excl;
    }
  }
  __syncthreads();
  int run = prefix_s + warp_excl[warp] + incl - s;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    int p = scan_slot(tid * kScanItems + j);
    int c = sm[p];
    sm[p] = run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    int p = j * kScanThreads + tid;
    if (base + p <= n) offset[base + p] = sm[scan_slot(p)];
  }
}

// grid (ceil(n / kThreads), 4). Takes the counts back to 0 as it places keys.
__global__ void splat_sum_fill_kernel(const float* __restrict__ flow, int* __restrict__ count,
                                      const int* __restrict__ offset, int* __restrict__ keys,
                                      int n, int H, int W) {
  let_next_pass_launch();
  int src = blockIdx.x * kThreads + threadIdx.x;
  int tap = blockIdx.y;
  int t = src < n ? tap_target(flow, src, tap, H, W, nullptr) : -1;
  wait_for_previous_pass();
  if (t >= 0) keys[offset[t] + atomicSub(count + t, 1) - 1] = tap * n + src;
}

__device__ __forceinline__ float add_product(float acc, float v, float w) {
  return __fadd_rn(acc, __fmul_rn(v, w));
}
__device__ __forceinline__ float2 add_product(float2 acc, float2 v, float w) {
  return make_float2(add_product(acc.x, v.x, w), add_product(acc.y, v.y, w));
}
template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float2 zero<float2>() { return make_float2(0.0f, 0.0f); }

// A bucket of more than 32 keys: take the next smallest key, k times over,
// and add its row into the output row, which only this warp touches.
template <typename V>
__device__ void gather_long_bucket(const V* __restrict__ values, const float* __restrict__ flow,
                                   const int* __restrict__ keys, V* dst, int k, int n, int H,
                                   int W, int Cv, int lane) {
  int prev = -1;
  for (int i = 0; i < k; ++i) {
    int m = INT_MAX;
    for (int j = lane; j < k; j += 32) {
      int key = keys[j];
      if (key > prev && key < m) m = key;
    }
    m = __reduce_min_sync(kFull, m);
    prev = m;
    int tap = m / n, src = m - tap * n;
    float w;
    tap_target(flow, src, tap, H, W, &w);
    const V* row = values + (long long)src * Cv;
    for (int c = lane; c < Cv; c += 32) dst[c] = add_product(i == 0 ? zero<V>() : dst[c], row[c], w);
  }
}

// One warp per target cell: its bucket's keys ordered, each source row times
// its weight added in that order. V = float2 walks two channels a lane (C even).
template <typename V>
__global__ void __launch_bounds__(32 * kGatherWarps)
splat_sum_gather_kernel(const V* __restrict__ values, const float* __restrict__ flow,
                        const int* __restrict__ offset, const int* __restrict__ keys,
                        V* __restrict__ out, int n, int H, int W, int Cv) {
  __shared__ int s_src[kGatherWarps][32];
  __shared__ float s_w[kGatherWarps][32];
  wait_for_previous_pass();
  int cell = blockIdx.x * kGatherWarps + threadIdx.y;
  if (cell >= n) return;
  int lane = threadIdx.x;
  int lo = offset[cell];
  int k = offset[cell + 1] - lo;
  V* dst = out + (long long)cell * Cv;
  if (k > 32) {
    gather_long_bucket(values, flow, keys + lo, dst, k, n, H, W, Cv, lane);
    return;
  }
  // Rank the keys (all distinct); then lane i fetches the key of rank i.
  int key = lane < k ? keys[lo + lane] : INT_MAX;
  int rank = 0;
  for (int j = 0; j < k; ++j) rank += __shfl_sync(kFull, key, j) < key;
  int from = 0;
  for (int i = 0; i < k; ++i) {
    unsigned hit = __ballot_sync(kFull, lane < k && rank == i);
    if (lane == i) from = __ffs(hit) - 1;
  }
  key = __shfl_sync(kFull, key, from);
  int* srcs = s_src[threadIdx.y];
  float* ws = s_w[threadIdx.y];
  if (lane < k) {
    int tap = key / n, src = key - tap * n;
    tap_target(flow, src, tap, H, W, &ws[lane]);
    srcs[lane] = src;
  }
  __syncwarp();
  for (int c = lane; c < Cv; c += 32) {
    V acc = zero<V>();
    int i = 0;
    for (; i + 4 <= k; i += 4) {  // four loads in flight, then the adds in order
      V v0 = values[(long long)srcs[i] * Cv + c];
      V v1 = values[(long long)srcs[i + 1] * Cv + c];
      V v2 = values[(long long)srcs[i + 2] * Cv + c];
      V v3 = values[(long long)srcs[i + 3] * Cv + c];
      acc = add_product(acc, v0, ws[i]);
      acc = add_product(acc, v1, ws[i + 1]);
      acc = add_product(acc, v2, ws[i + 2]);
      acc = add_product(acc, v3, ws[i + 3]);
    }
    for (; i < k; ++i) acc = add_product(acc, values[(long long)srcs[i] * Cv + c], ws[i]);
    dst[c] = acc;
  }
}

struct Layout {  // offsets into the int32 scratch
  long long status, ticket, count, zero_end, offset, keys, end;
};

Layout layout(long long n) {
  auto up4 = [](long long v) { return (v + 3) / 4 * 4; };
  long long tiles = (n + 1 + kScanTile - 1) / kScanTile;
  Layout l;
  l.status = 0;  // tiles 64-bit words
  l.ticket = 2 * tiles;
  l.count = l.ticket + 4;
  l.zero_end = up4(l.count + n);
  l.offset = l.zero_end;
  l.keys = up4(l.offset + n + 1);
  l.end = l.keys + 4 * n;
  return l;
}

// Launches `kernel` on `s`; with `dependent`, as a programmatic dependent of
// the kernel before it on the stream.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t s,
                   bool dependent, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// int32 entries of scratch that tcs_splat_sum needs for B * H * W = n pixels.
extern "C" long long tcs_splat_sum_scratch_ints(long long n) { return layout(n).end; }

// values: (B, H, W, C) fp32; flow: (B, H, W, 2) fp32; out: (B, H, W, C) fp32,
// every element written; scratch: tcs_splat_sum_scratch_ints(B * H * W) int32,
// 16-byte aligned, its contents free. Five launches on `stream`: a fill of the
// counts with zeros, count, scan, fill, gather. Returns the first error.
extern "C" int tcs_splat_sum(const void* values, const void* flow, void* out, void* scratch,
                             int B, int H, int W, int C, void* stream) {
  long long n = (long long)B * H * W;
  if (n == 0 || C == 0) return (int)cudaSuccess;
  if (4 * n > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Layout l = layout(n);
  int* base = static_cast<int*>(scratch);
  int* count = base + l.count;
  int* offset = base + l.offset;
  int* keys = base + l.keys;
  const float* f = static_cast<const float*>(flow);
  int ni = (int)n;
  cudaError_t err = cudaMemsetAsync(base, 0, l.zero_end * sizeof(int), s);
  dim3 taps((unsigned)((n + kThreads - 1) / kThreads), 4);
  if (err == cudaSuccess)
    err = launch(splat_sum_count_kernel, taps, dim3(kThreads), s, false, f, count, ni, H, W);
  if (err == cudaSuccess)
    err = launch(splat_sum_scan_kernel, dim3((unsigned)((n + kScanTile) / kScanTile)),
                 dim3(kScanThreads), s, true, (const int*)count, offset,
                 reinterpret_cast<unsigned long long*>(base + l.status), base + l.ticket, ni);
  if (err == cudaSuccess)
    err = launch(splat_sum_fill_kernel, taps, dim3(kThreads), s, true, f, count,
                 (const int*)offset, keys, ni, H, W);
  if (err != cudaSuccess) return (int)err;
  dim3 block(32, kGatherWarps);
  dim3 grid((unsigned)((n + kGatherWarps - 1) / kGatherWarps));
  if (C % 2 == 0)
    err = launch(splat_sum_gather_kernel<float2>, grid, block, s, true,
                 static_cast<const float2*>(values), f, (const int*)offset, (const int*)keys,
                 static_cast<float2*>(out), ni, H, W, C / 2);
  else
    err = launch(splat_sum_gather_kernel<float>, grid, block, s, true,
                 static_cast<const float*>(values), f, (const int*)offset, (const int*)keys,
                 static_cast<float*>(out), ni, H, W, C);
  return (int)err;
}

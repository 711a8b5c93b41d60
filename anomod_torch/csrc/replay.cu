// Replay fold kernels for Hopper (sm_90a): the per-(service, window)
// moment + log-latency histogram planes of the TT span replay.
//
// Replaces the two Pallas TPU kernels of anomod/ops/pallas_replay.py and
// the roofline probe's ablations of the second:
//   anomod_replay_dense  <- make_pallas_replay_fn         (pallas_replay.py:85)
//   anomod_replay_sorted <- make_pallas_replay_sorted_fn  (pallas_replay.py:257)
//   anomod_replay_sorted_ablation <- make_ablation
//                                    (scripts/bench_kernel_roofline.py:73)
//
// What they compute: for spans with segment id sid[i] and feature-major
// planes[6][N] (valid, err, 5xx, dur_raw, dur, dur^2), out[SW][6+H] sums,
// per segment, each span's payload row, rounded exactly as the TPU kernel's
// bf16 right-hand side (_build_rhs_t): the three exact planes as bf16, each
// moment m as bf16_rn(m) + bf16_rn(m - bf16_rn(m)) (the two-way hi/lo
// split, recombined in f32 per span), and a histogram one-hot at bucket
// clamp((int)dur, 0, H-1) carrying bf16(valid).  Rows with sid == SW are
// the dead padding lane and are dropped.
//
// The TPU formulation (a [B, SW+1] one-hot contracted on the MXU) is the
// wrong shape here: it does SW+1 multiply-adds per span where a scatter
// does one.  On the card both kernels are scatter reductions into a
// shared-memory accumulator; the bytes they must read are 28 B per span
// (sid + 6 planes).  Only nonzero terms are added (x + 0.0f == x, so every
// sum is unchanged).
//
// dense_fold takes spans in staging order, so its shared atomics land on
// scattered rows.  sorted_fold takes the sorted staging, where a warp's
// 32 spans mostly share one segment: one shared atomic a span and column
// would then serialize 32-way on one address, and that was most of the
// kernel's time (PERF.md section 5).  So a warp first reduces each run of
// equal ids in registers (a segmented shuffle scan; the run's tail lane
// issues one atomic a nonzero column), which cuts the same-address
// atomics up to 32x; the histogram adds per (segment, bucket) group found
// with __match_any_sync.  And a staged block runs 1024 threads (32 warps
// an SM, not 8), each warp walking a contiguous 128-span chunk so
// its runs stay long, so that enough loads are in flight to approach the
// byte bound.
//
// The ablations are the sorted kernel itself (same grid, block, staging
// and run-aggregated shared atomics) with its payload cut, so their times
// against the full kernel's split its time by what each payload adds.
// `counts` adds bf16(valid) into row 0.  `no_hist` adds the three exact
// planes into rows 0-2, bf16(m) into rows 3-5 and bf16(m - bf16(m)) into
// rows 6-8: the hi and lo halves stay separate rows, as in the TPU
// ablation's [9, NWK] output (the full kernel adds hi + lo once).  Their
// reduction writes the raw feature-major [ROWS, NWK] of the TPU kernel,
// the dead lane's column SW and the padding columns included.  No kernel
// forms a span x repeat index: a repeat walks the same block again, so
// replicate = 4096 over 475,358 spans (1.9e9 span folds) overflows nothing.
//
// The cross-block reductions walk, for each output column, only the block
// range of the column's window (binary search in the non-decreasing wids),
// in block order.
//
// Determinism: the cross-block reduction runs in fixed block order.  Inside
// a block, f32 atomics add in arrival order (run sums and, in the dense
// kernel, single spans), so the moment planes vary in the last bits from
// run to run; the count / err / 5xx / histogram planes add small integers
// and are exact in any order below 2^24.
//
// Interface: plain C, pointers and the stream as void*, loaded with ctypes
// (anomod_torch/ops/replay_kernels.py).  Each entry returns cudaGetLastError().
// The caller allocates `partials` and `out`; the kernels allocate nothing.

#include <cassert>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanes = 6;           // valid, err, 5xx, dur_raw, dur, dur^2
// what the sorted kernel adds a span: the replay's payload, or one of the
// roofline probe's two ablations of it
enum Payload : int { kFull = 0, kCounts = 1, kNoHist = 2 };
constexpr int kFoldThreads = 512;
constexpr int kSortedThreads = 1024;
constexpr int kSortedWarps = kSortedThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Add span i's payload row into `row` (a [6+H] accumulator row in shared
// memory).  `stride` is the plane stride of `planes` (its span count).
__device__ __forceinline__ void fold_span(float* row, const float* planes,
                                          long long stride, long long i,
                                          int n_hist) {
  const float valid = bf16_rn(planes[i]);
  const float err = bf16_rn(planes[stride + i]);
  const float s5 = bf16_rn(planes[2 * stride + i]);
  if (valid != 0.f) atomicAdd(row + 0, valid);
  if (err != 0.f) atomicAdd(row + 1, err);
  if (s5 != 0.f) atomicAdd(row + 2, s5);
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float x = planes[(3 + m) * stride + i];
    const float hi = bf16_rn(x);
    const float v = hi + bf16_rn(x - hi);
    if (v != 0.f) atomicAdd(row + 3 + m, v);
  }
  if (valid != 0.f) {
    // truncation toward zero, as astype(int32); saturates, NaN -> 0
    int b = __float2int_rz(planes[4 * stride + i]);
    b = min(max(b, 0), n_hist - 1);
    atomicAdd(row + kPlanes + b, valid);
  }
}

// Accumulator row width of each payload.
__host__ __device__ constexpr int payload_rows(int payload, int n_hist) {
  return payload == kFull ? kPlanes + n_hist : (payload == kCounts ? 1 : 9);
}

// v summed over the warp's lanes [start, lane]: a segmented inclusive scan
// (a run's sum lands on its tail lane).  Every lane must call it.
__device__ __forceinline__ float run_sum(float v, int lane, int start) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kAll, v, d);
    if (lane - d >= start) v += y;
  }
  return v;
}

// A warp's run of equal segment ids adds column c's run sum into `row`:
// one shared atomic, from the run's tail lane, when the sum is nonzero.
__device__ __forceinline__ void add_run(float* row, int c, float v, int lane,
                                        int start, bool tail) {
  v = run_sum(v, lane, start);
  if (tail && v != 0.f) atomicAdd(row + c, v);
}

// One warp step of the sorted fold: lane `lane` holds span i (when `live`)
// of local segment s, in a run of equal ids that starts at lane `start`
// and, on its `tail` lane, adds the run's payload into `row` (a
// [payload_rows] accumulator row).  `stride` is the planes' span count.
// The histogram adds per (segment, bucket): lanes of one key whose
// bf16(valid) is exactly 1 add their count at once (an integer, exact);
// any other value adds on its own.
template <int P>
__device__ __forceinline__ void fold_step(float* row, const float* planes,
                                          long long stride, long long i,
                                          bool live, int s, int n_hist,
                                          int lane, int start, bool tail) {
  tail = tail && live;
  if constexpr (P == kCounts) {
    add_run(row, 0, live ? bf16_rn(planes[i]) : 0.f, lane, start, tail);
  } else {
    float e[3] = {0.f, 0.f, 0.f}, x[3] = {0.f, 0.f, 0.f};
    if (live) {
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        e[m] = bf16_rn(planes[m * stride + i]);
        x[m] = planes[(3 + m) * stride + i];
      }
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) add_run(row, m, e[m], lane, start, tail);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const float hi = bf16_rn(x[m]);
      const float lo = bf16_rn(x[m] - hi);
      if constexpr (P == kFull) {
        add_run(row, 3 + m, hi + lo, lane, start, tail);
      } else {
        add_run(row, 3 + m, hi, lane, start, tail);
        add_run(row, 6 + m, lo, lane, start, tail);
      }
    }
    if constexpr (P == kFull) {
      const float valid = e[0];
      const bool adds = live && valid != 0.f;
      // truncation toward zero, as astype(int32); saturates, NaN -> 0
      const int b = min(max(__float2int_rz(x[1]), 0), n_hist - 1);
      const bool unit = valid == 1.f;
      const int key = adds ? (unit ? s * n_hist + b : -2 - lane) : -1;
      const unsigned peers = __match_any_sync(kAll, key);
      if (adds && !unit)
        atomicAdd(row + kPlanes + b, valid);
      else if (adds && (peers & ((1u << lane) - 1u)) == 0)
        atomicAdd(row + kPlanes + b, (float)__popc(peers));
    }
  }
}

// Dense pass 1.  Grid (n_parts, n_tiles): block (x, y) folds the spans
// x, x + n_parts*blockDim, ... whose segment lies in tile y, columns
// [y*tile_w, min(SW, (y+1)*tile_w)), into shared memory, then writes its
// tile of partials[x][SW][F].  Tiling the segment axis keeps the
// accumulator inside one block's shared memory at any SW.
__global__ void dense_fold(const int* __restrict__ sid,
                           const float* __restrict__ planes, long long n,
                           int n_segments, int n_hist, int tile_w,
                           int inner_repeats, float* __restrict__ partials) {
  extern __shared__ float acc[];
  const int F = kPlanes + n_hist;
  const int lo = blockIdx.y * tile_w;
  const int hi = min(n_segments, lo + tile_w);
  const int len = (hi - lo) * F;
  for (int j = threadIdx.x; j < len; j += blockDim.x) acc[j] = 0.f;
  __syncthreads();
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // inner_repeats replays the same spans again: the port of the TPU
  // kernel's outer grid axis
  for (int r = 0; r < inner_repeats; ++r) {
    for (long long i = first; i < n; i += step) {
      const int s = sid[i];
      if (s >= lo && s < hi) fold_span(acc + (s - lo) * F, planes, n, i, n_hist);
    }
  }
  __syncthreads();
  float* dst = partials + ((long long)blockIdx.x * n_segments + lo) * F;
  for (int j = threadIdx.x; j < len; j += blockDim.x) dst[j] = acc[j];
}

// Dense pass 2: out[j] = sum over parts b = 0, 1, ... of partials[b][j],
// always in that order.
__global__ void reduce_parts(const float* __restrict__ partials, int n_parts,
                             long long len, float* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < len; j += step) {
    float s = 0.f;
    for (int b = 0; b < n_parts; ++b) s += partials[b * len + j];
    out[j] = s;
  }
}

// Sorted pass 1.  One CUDA block of kSortedThreads per staged block of
// `block` spans; the host staging (stage_sorted_planes) put all of them in
// one aligned window of k segments, so the accumulator is [k][F] and local
// ids are < k.  Warp w walks the contiguous spans [w*chunk, (w+1)*chunk)
// of the block, 32 at a time (coalesced loads, and in sorted staging
// mostly one run of equal ids a step).  Padding rows carry all-zero planes
// and add nothing.  P picks the payload (F = payload_rows(P, n_hist)).
template <int P>
__global__ void __launch_bounds__(kSortedThreads)
sorted_fold(const int* __restrict__ sid_local, const float* __restrict__ planes,
            long long t, int block, int k, int n_hist, int inner_repeats,
            float* __restrict__ partials) {
  extern __shared__ float acc[];
  const int F = payload_rows(P, n_hist);
  const int len = k * F;
  for (int j = threadIdx.x; j < len; j += blockDim.x) acc[j] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = (block + kSortedWarps - 1) / kSortedWarps;
  const int j0 = min(block, warp * chunk);
  const int j1 = min(block, j0 + chunk);
  const long long base = (long long)blockIdx.x * block;
  const unsigned upto = 0xffffffffu >> (31 - lane);      // lanes <= lane
  for (int r = 0; r < inner_repeats; ++r) {
    for (int j = j0; j < j1; j += 32) {
      const long long i = base + j + lane;
      int s = j + lane < j1 ? sid_local[i] : -1;
      const bool live = s >= 0 && s < k;
      if (!live) s = -1;
      const int prev = __shfl_up_sync(kAll, s, 1);
      const unsigned heads = __ballot_sync(kAll, lane == 0 || s != prev);
      const int start = 31 - __clz(heads & upto);
      const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
      fold_step<P>(acc + (live ? s : 0) * F, planes, t, i, live, s, n_hist,
                   lane, start, tail);
    }
  }
  __syncthreads();
  float* dst = partials + (long long)blockIdx.x * len;
  for (int j = threadIdx.x; j < len; j += blockDim.x) dst[j] = acc[j];
}

// The reductions' binary search needs wids non-decreasing: a device-side
// assert (cudaErrorAssert at the caller's next sync) where it is not, as
// PyTorch's kernels treat an index they cannot check on the host.
__device__ __forceinline__ void assert_ordered(const int* __restrict__ wids,
                                               int n_blocks) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       b + 1 < n_blocks; b += step)
    assert(wids[b] <= wids[b + 1]);
}

// First staged block of window w or later: wids is non-decreasing
// (stage_sorted_planes), so window w's blocks are
// [window_first(w), window_first(w + 1)).
__device__ __forceinline__ int window_first(const int* __restrict__ wids,
                                            int n_blocks, int w) {
  int lo = 0, hi = n_blocks;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (wids[mid] < w) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Sorted pass 2: out[col][f] sums the partials of the blocks whose window
// holds col, in block order, walking only that window's block range.
// Global segment col lives at window col / k, local column col % k
// (aligned windows keep segment s at column s).
__global__ void sorted_reduce(const float* __restrict__ partials,
                              const int* __restrict__ wids, int n_blocks,
                              int k, int n_segments, int n_hist,
                              float* __restrict__ out) {
  assert_ordered(wids, n_blocks);
  const int F = kPlanes + n_hist;
  const long long len = (long long)n_segments * F;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < len; j += step) {
    const int col = (int)(j / F);
    const int f = (int)(j % F);
    const int w = col / k;
    const long long off = (long long)(col % k) * F + f;
    const int b1 = window_first(wids, n_blocks, w + 1);
    float s = 0.f;
    for (int b = window_first(wids, n_blocks, w); b < b1; ++b)
      s += partials[(long long)b * k * F + off];
    out[j] = s;
  }
}

// Ablation pass 2: the raw feature-major out[f][col] over all nwk = nw * k
// columns, each the sum of the partials of the blocks in window col / k,
// in block order over the window's block range.  Columns no block touches
// (padding past the dead lane, windows without spans) are written as 0.
__global__ void sorted_reduce_raw(const float* __restrict__ partials,
                                  const int* __restrict__ wids, int n_blocks,
                                  int k, int rows, int nwk,
                                  float* __restrict__ out) {
  assert_ordered(wids, n_blocks);
  const long long len = (long long)rows * nwk;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < len; j += step) {
    const int f = (int)(j / nwk);
    const int col = (int)(j % nwk);
    const int w = col / k;
    const long long off = (long long)(col % k) * rows + f;
    const int b1 = window_first(wids, n_blocks, w + 1);
    float s = 0.f;
    for (int b = window_first(wids, n_blocks, w); b < b1; ++b)
      s += partials[(long long)b * k * rows + off];
    out[j] = s;
  }
}

int reduce_blocks(long long len) {
  long long b = (len + kReduceThreads - 1) / kReduceThreads;
  if (b < 1) b = 1;
  return (int)(b < 4096 ? b : 4096);
}

// Sorted pass 1 with payload P over n_blocks staged blocks (none: no
// launch).
template <int P>
cudaError_t launch_sorted_fold(const void* sid_local, const void* planes,
                               long long t, int n_blocks, int block, int k,
                               int n_hist, int inner_repeats, void* partials,
                               cudaStream_t st) {
  if (n_blocks <= 0) return cudaSuccess;
  const int smem = k * payload_rows(P, n_hist) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      sorted_fold<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  sorted_fold<P><<<n_blocks, kSortedThreads, smem, st>>>(
      static_cast<const int*>(sid_local), static_cast<const float*>(planes),
      t, block, k, n_hist, inner_repeats, static_cast<float*>(partials));
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* anomod_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" int anomod_replay_dense(const void* sid, const void* planes,
                                   long long n, int n_segments, int n_hist,
                                   int inner_repeats, int n_parts, int n_tiles,
                                   int tile_w, void* partials, void* out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int F = kPlanes + n_hist;
  const int smem = tile_w * F * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      dense_fold, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dense_fold<<<dim3(n_parts, n_tiles), kFoldThreads, smem, st>>>(
      static_cast<const int*>(sid), static_cast<const float*>(planes), n,
      n_segments, n_hist, tile_w, inner_repeats, static_cast<float*>(partials));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long len = (long long)n_segments * F;
  reduce_parts<<<reduce_blocks(len), kReduceThreads, 0, st>>>(
      static_cast<const float*>(partials), n_parts, len,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int anomod_replay_sorted(const void* sid_local, const void* planes,
                                    long long t, const void* wids,
                                    int n_blocks, int block, int k,
                                    int n_segments, int n_hist,
                                    int inner_repeats,
                                    void* partials, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int F = kPlanes + n_hist;
  cudaError_t e =
      launch_sorted_fold<kFull>(sid_local, planes, t, n_blocks, block, k,
                                n_hist, inner_repeats, partials, st);
  if (e != cudaSuccess) return (int)e;
  const long long len = (long long)n_segments * F;
  sorted_reduce<<<reduce_blocks(len), kReduceThreads, 0, st>>>(
      static_cast<const float*>(partials), static_cast<const int*>(wids),
      n_blocks, k, n_segments, n_hist, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The roofline probe's ablations: mode 1 = counts (out f32[1][nwk]),
// mode 2 = no_hist (out f32[9][nwk]); partials hold n_blocks * k * rows.
extern "C" int anomod_replay_sorted_ablation(
    const void* sid_local, const void* planes, long long t, const void* wids,
    int n_blocks, int block, int k, int nwk, int mode, int inner_repeats,
    void* partials, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == kCounts)
    e = launch_sorted_fold<kCounts>(sid_local, planes, t, n_blocks, block, k,
                                    0, inner_repeats, partials, st);
  else if (mode == kNoHist)
    e = launch_sorted_fold<kNoHist>(sid_local, planes, t, n_blocks, block, k,
                                    0, inner_repeats, partials, st);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  const int rows = payload_rows(mode, 0);
  sorted_reduce_raw<<<reduce_blocks((long long)rows * nwk), kReduceThreads, 0,
                      st>>>(static_cast<const float*>(partials),
                            static_cast<const int*>(wids), n_blocks, k, rows,
                            nwk, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

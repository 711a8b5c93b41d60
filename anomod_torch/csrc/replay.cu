// Replay fold kernels for Hopper (sm_90a): the per-(service, window)
// moment + log-latency histogram planes of the TT span replay.
//
// Replaces the two Pallas TPU kernels of anomod/ops/pallas_replay.py:
//   anomod_replay_dense  <- make_pallas_replay_fn         (pallas_replay.py:85)
//   anomod_replay_sorted <- make_pallas_replay_sorted_fn  (pallas_replay.py:257)
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
// shared-memory accumulator, and what bounds them is the bytes read
// (28 B per span: sid + 6 planes) plus shared-memory atomic throughput on
// hot segments.  Only nonzero terms are added (x + 0.0f == x, so every sum
// is unchanged), which cuts the shared atomics from 6+H to about 6 per span.
//
// Determinism: the cross-block reduction runs in fixed block order.  Inside
// a block, f32 atomics add in arrival order, so the moment planes vary in
// the last bits from run to run; the count / err / 5xx / histogram planes
// add small integers and are exact in any order below 2^24.
//
// Interface: plain C, pointers and the stream as void*, loaded with ctypes
// (anomod_torch/ops/replay_kernels.py).  Each entry returns cudaGetLastError().
// The caller allocates `partials` and `out`; the kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanes = 6;           // valid, err, 5xx, dur_raw, dur, dur^2
constexpr int kFoldThreads = 512;
constexpr int kSortedThreads = 256;
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

// Sorted pass 1.  One CUDA block per staged block of `block` spans; the
// host staging (stage_sorted_planes) put all of them in one aligned window
// of k segments, so the accumulator is [k][F] and local ids are < k.
// Padding rows carry all-zero planes and add nothing.
__global__ void sorted_fold(const int* __restrict__ sid_local,
                            const float* __restrict__ planes, long long t,
                            int block, int k, int n_hist, int inner_repeats,
                            float* __restrict__ partials) {
  extern __shared__ float acc[];
  const int F = kPlanes + n_hist;
  const int len = k * F;
  for (int j = threadIdx.x; j < len; j += blockDim.x) acc[j] = 0.f;
  __syncthreads();
  const long long base = (long long)blockIdx.x * block;
  for (int r = 0; r < inner_repeats; ++r) {
    for (int j = threadIdx.x; j < block; j += blockDim.x) {
      const long long i = base + j;
      const int s = sid_local[i];
      if (s >= 0 && s < k) fold_span(acc + s * F, planes, t, i, n_hist);
    }
  }
  __syncthreads();
  float* dst = partials + (long long)blockIdx.x * len;
  for (int j = threadIdx.x; j < len; j += blockDim.x) dst[j] = acc[j];
}

// Sorted pass 2: out[col][f] sums the partials of the blocks whose window
// holds col, in block order.  Global segment col lives at window col / k,
// local column col % k (aligned windows keep segment s at column s).
__global__ void sorted_reduce(const float* __restrict__ partials,
                              const int* __restrict__ wids, int n_blocks,
                              int k, int n_segments, int n_hist,
                              float* __restrict__ out) {
  const int F = kPlanes + n_hist;
  const long long len = (long long)n_segments * F;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < len; j += step) {
    const int col = (int)(j / F);
    const int f = (int)(j % F);
    const int w = col / k;
    const long long off = (long long)(col % k) * F + f;
    float s = 0.f;
    for (int b = 0; b < n_blocks; ++b)
      if (wids[b] == w) s += partials[(long long)b * k * F + off];
    out[j] = s;
  }
}

int reduce_blocks(long long len) {
  long long b = (len + kReduceThreads - 1) / kReduceThreads;
  if (b < 1) b = 1;
  return (int)(b < 4096 ? b : 4096);
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
                                    int inner_repeats, void* partials,
                                    void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int F = kPlanes + n_hist;
  cudaError_t e;
  if (n_blocks > 0) {
    const int smem = k * F * (int)sizeof(float);
    e = cudaFuncSetAttribute(
        sorted_fold, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sorted_fold<<<n_blocks, kSortedThreads, smem, st>>>(
        static_cast<const int*>(sid_local), static_cast<const float*>(planes),
        t, block, k, n_hist, inner_repeats, static_cast<float*>(partials));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long len = (long long)n_segments * F;
  sorted_reduce<<<reduce_blocks(len), kReduceThreads, 0, st>>>(
      static_cast<const float*>(partials), static_cast<const int*>(wids),
      n_blocks, k, n_segments, n_hist, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

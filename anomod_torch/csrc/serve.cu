// Serve-tick kernels for Hopper (sm_90a): the fused lane-stacked delta of
// the multi-tenant serve tick, and the tenant-pool window gather that feeds
// batched window scoring.
//
// Replaces two Pallas TPU kernels of anomod/ops/pallas_replay.py:
//   anomod_lane_delta    <- make_pallas_lane_delta_fn     (pallas_replay.py:150)
//   anomod_window_gather <- make_pallas_window_gather_fn  (pallas_replay.py:354)
//
// lane_delta.  sid[L][W] int32 and lane-major planes[L][6][W] f32 (valid,
// err, 5xx, dur_raw, dur, dur^2) give out[L][SW][6+H], per lane l and
// segment s the sum of the payload rows of lane l's spans with sid == s.
// The arithmetic is the JAX scatter engine's (_scatter_rhs and
// make_lane_delta's segment sum in anomod/replay.py), not the Pallas
// kernel's looser bf16 envelope: each row carries 25 f32 payload columns,
// bf16(valid, err, 5xx), hi = bf16(m) and lo = bf16(m - hi) of each moment
// m, and bf16(valid) at histogram bucket clamp((int)dur, 0, H-1); every
// (lane, segment, column) sums its rows in ROW ORDER starting from +0.0;
// only at the end is hi_sum + lo_sum written to the three moment columns.
// Rows with sid == SW are the dead padding lane and add to nothing.  That
// order is what XLA:CPU's segment sum and torch's CPU index_add_ do, so
// the serve tick's states are bit-identical to the JAX engine's and to a
// single-lane dispatch (fused == sequential holds by construction).
//
// Design: no float atomics anywhere.  Grid (L, segment tiles), one thread
// per segment of the tile.  The lane's rows stream through shared memory
// in tiles of kRows, each row's payload computed once by the block; then
// every thread walks the tile in row order and adds the rows whose sid is
// its own segment into registers (9 moment/exact sums) and a shared-memory
// histogram row that only it writes.  The cost is O(W) shared-memory
// compares per thread, W x SW per lane: deterministic, and independent of
// L and of the lane's position.  A stable per-lane counting sort that
// makes it O(W) in all is later work.  What bounds it on this card is
// instruction throughput in the compare loop, not bytes (28 B per span read).
//
// window_gather.  pool[P][S*Wn][F], slots[T], cols[T] give out[T][S][F] =
// pool[slots[t]][s*Wn + cols[t]][f]: tenant t's scored window column.  One
// block per requested tenant, a pure copy, bit-identical to indexing.  An
// index outside the pool writes NaN (the caller validates on the host).
// Bound by bytes: T*S*F*4 read and written.
//
// Interface: plain C, pointers and the stream as void*, loaded with ctypes
// (anomod_torch/ops/serve_kernels.py).  Each entry returns
// cudaGetLastError().  The caller allocates the outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanes = 6;         // valid, err, 5xx, dur_raw, dur, dur^2
constexpr int kPay = 9;            // exact x3, moment hi x3, moment lo x3
constexpr int kRows = 512;         // rows staged in shared memory at once
constexpr int kTile = 128;         // segments (threads) per block
constexpr int kGatherThreads = 128;

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Grid (L, ceil(SW / kTile)), blockDim.x == kTile.  Shared memory:
// hist[H][kTile] (column-major by thread: conflict-free), then the row
// tile: sid[kRows], bucket[kRows], hval[kRows], pay[kRows][kPay].
__global__ void lane_delta_kernel(const int* __restrict__ sid,
                                  const float* __restrict__ planes, int W,
                                  int n_segments, int n_hist,
                                  float* __restrict__ out) {
  extern __shared__ float smem[];
  float* hist = smem;                                   // [H][kTile]
  int* sid_t = reinterpret_cast<int*>(hist + n_hist * kTile);
  int* bkt_t = sid_t + kRows;
  float* hv_t = reinterpret_cast<float*>(bkt_t + kRows);
  float* pay_t = hv_t + kRows;                          // [kRows][kPay]

  const int lane = blockIdx.x;
  const int seg = blockIdx.y * kTile + threadIdx.x;
  const int* lsid = sid + (long long)lane * W;
  const float* lp = planes + (long long)lane * kPlanes * W;

  for (int h = 0; h < n_hist; ++h) hist[h * kTile + threadIdx.x] = 0.f;
  float acc[kPay];
#pragma unroll
  for (int c = 0; c < kPay; ++c) acc[c] = 0.f;

  for (int base = 0; base < W; base += kRows) {
    const int n = min(kRows, W - base);
    __syncthreads();                  // the previous tile is fully read
    for (int r = threadIdx.x; r < n; r += kTile) {
      const int i = base + r;
      const float valid = bf16_rn(lp[i]);
      float* p = pay_t + r * kPay;
      p[0] = valid;
      p[1] = bf16_rn(lp[W + i]);
      p[2] = bf16_rn(lp[2 * W + i]);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float x = lp[(3 + m) * W + i];
        const float hi = bf16_rn(x);
        p[3 + m] = hi;
        p[6 + m] = bf16_rn(x - hi);
      }
      // truncation toward zero, as astype(int32); then clamped
      int b = __float2int_rz(lp[4 * W + i]);
      bkt_t[r] = min(max(b, 0), n_hist - 1);
      hv_t[r] = valid;
      sid_t[r] = lsid[i];
    }
    __syncthreads();
    if (seg < n_segments) {
      for (int r = 0; r < n; ++r) {
        if (sid_t[r] != seg) continue;
        const float* p = pay_t + r * kPay;
#pragma unroll
        for (int c = 0; c < kPay; ++c) acc[c] += p[c];
        hist[bkt_t[r] * kTile + threadIdx.x] += hv_t[r];
      }
    }
  }
  if (seg < n_segments) {
    float* o = out + ((long long)lane * n_segments + seg) * (kPlanes + n_hist);
    o[0] = acc[0];
    o[1] = acc[1];
    o[2] = acc[2];
    o[3] = acc[3] + acc[6];
    o[4] = acc[4] + acc[7];
    o[5] = acc[5] + acc[8];
    for (int h = 0; h < n_hist; ++h) o[kPlanes + h] = hist[h * kTile + threadIdx.x];
  }
}

__global__ void window_gather_kernel(const float* __restrict__ pool, int P,
                                     int S, int Wn, int F,
                                     const int* __restrict__ slots,
                                     const int* __restrict__ cols,
                                     float* __restrict__ out) {
  const int t = blockIdx.x;
  const int slot = slots[t];
  const int col = cols[t];
  const bool ok = slot >= 0 && slot < P && col >= 0 && col < Wn;
  const long long row = (long long)slot * S * Wn;
  float* o = out + (long long)t * S * F;
  for (int j = threadIdx.x; j < S * F; j += blockDim.x) {
    const int s = j / F;
    const int f = j - s * F;
    o[j] = ok ? pool[(row + (long long)s * Wn + col) * F + f] : __int_as_float(0x7fc00000);
  }
}

}  // namespace

extern "C" const char* anomod_serve_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" int anomod_lane_delta_smem(int n_hist) {
  return (n_hist * kTile + 3 * kRows + kRows * kPay) * (int)sizeof(float);
}

extern "C" int anomod_lane_delta(const void* sid, const void* planes, int L,
                                 int W, int n_segments, int n_hist, void* out,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L < 1 || n_segments < 1) return (int)cudaSuccess;
  const int smem = anomod_lane_delta_smem(n_hist);
  cudaError_t e = cudaFuncSetAttribute(
      lane_delta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n_segments + kTile - 1) / kTile;
  lane_delta_kernel<<<dim3(L, tiles), kTile, smem, st>>>(
      static_cast<const int*>(sid), static_cast<const float*>(planes), W,
      n_segments, n_hist, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int anomod_window_gather(const void* pool, int P, int S, int Wn,
                                    int F, const void* slots, const void* cols,
                                    int T, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1) return (int)cudaSuccess;
  window_gather_kernel<<<T, kGatherThreads, 0, st>>>(
      static_cast<const float*>(pool), P, S, Wn, F,
      static_cast<const int*>(slots), static_cast<const int*>(cols),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

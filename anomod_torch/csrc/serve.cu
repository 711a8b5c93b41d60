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
// Design: a stable per-lane counting sort, then one serial walk per
// (segment, column); no float atomics anywhere.  Grid (L, G): block (l, g)
// owns lane l's segments [g*Sg, min(SW, (g+1)*Sg)), so a lane is spread
// over G blocks and the card is filled at any L.  The lane's rows stream
// through in tiles of kRows, in order; per tile:
//   1. count: each warp takes a contiguous chunk of the tile and counts its
//      rows per owned segment (__match_any_sync peers, the lowest peer adds
//      popc: integer counts, no atomics);
//   2. scan: per segment, an exclusive prefix over the warps, then one over
//      the segments: where each warp's rows of each segment go;
//   3. place: the warps walk their chunks again, each row's slot being its
//      segment's start + the earlier warps' count + its rank among its
//      peers (popc of the lower peers): a stable sort.  The row's payload
//      is computed here, once, from its planes (loaded, with the ids, at
//      the top of the tile, so the loads are in flight during 1 and 2),
//      and stored at its slot in shared memory as bf16 (every payload
//      value is a bf16, so this is exact), columns padded apart so the
//      fold's lanes hit distinct banks;
//   4. fold: one warp per segment, one lane per column (the 9 payload
//      columns and the H histogram buckets), each lane adding its column
//      of the segment's rows in slot order, i.e. row order, into an
//      accumulator in shared memory that carries over to the next tile.
// So every (lane, segment, column) is one f32 chain from +0.0 in row order
// across all tiles, whatever G, kRows or the warp count: the result's bits
// do not depend on the launch shape.  The cost is O(W) a block for the
// sort and O(rows of the segment) a warp for the fold.  What bounds it on
// this card: for spread lanes, the fixed work of a tile (two memory round
// trips, six barriers) and the launch, about 25 us at W 4096, L 32 against
// a 1.2 us byte bound; for a lane whose rows all fall in one segment, that
// segment's fold, which one warp runs row by row (order forbids splitting
// the chain; the 25 columns run side by side in its lanes): about 4 ns a
// row on this card, 0.11 ms at W 16384, L 1, where index_add_'s atomics
// take about 0.06 ms.
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
constexpr int kLaneThreads = 512;
constexpr int kLaneWarps = kLaneThreads / 32;
constexpr int kRows = 2048;        // rows of a lane sorted per tile
constexpr int kChunk = kRows / kLaneWarps;   // a warp's rows of a tile
constexpr int kPerLane = kChunk / 32;        // a thread's rows of a tile
// payload column stride (bf16): two past kRows, so the fold's lanes, each
// reading its own column at one row, hit distinct shared-memory banks
constexpr int kPayStride = kRows + 2;
constexpr int kFoldBatch = 8;      // rows a fold lane loads ahead
constexpr unsigned kAll = 0xffffffffu;
constexpr int kGatherThreads = 128;

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Shared memory of a lane-delta block owning `sg` segments: the carried
// accumulator acc[sg][kPay+H] (f32), the tile's sorted payload
// pay[kPay][kPayStride] (bf16: every payload value is a bf16, so storing
// it so is exact) and buckets bkt[kRows] (u16), the per-warp counts
// wcnt[kLaneWarps][sg] and the per-segment start[sg] and cnt[sg].
__host__ __device__ constexpr int lane_smem_bytes(int sg, int n_hist) {
  return sg * (kPay + n_hist) * 4 + kPay * kPayStride * 2 + kRows * 2 +
         (kLaneWarps + 2) * sg * 4;
}

// Grid (L, G), blockDim.x == kLaneThreads; block (l, g) owns segments
// [g*sg, min(SW, (g+1)*sg)) of lane l.
__global__ void __launch_bounds__(kLaneThreads, 2)
lane_delta_kernel(const int* __restrict__ sid, const float* __restrict__ planes,
                  int W, int n_segments, int sg, int n_hist,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  const int F = kPay + n_hist;
  float* acc = smem;                                    // [sg][F]
  int* wcnt = reinterpret_cast<int*>(acc + sg * F);     // [warps][sg]
  int* start = wcnt + kLaneWarps * sg;                  // [sg]
  int* cnt = start + sg;                                // [sg]
  __nv_bfloat16* pay = reinterpret_cast<__nv_bfloat16*>(cnt + sg);
  unsigned short* bkt =                                 // [kRows]
      reinterpret_cast<unsigned short*>(pay + kPay * kPayStride);

  const int lane_id = blockIdx.x;
  const int lo = blockIdx.y * sg;
  const int n_own = min(sg, n_segments - lo);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const int* lsid = sid + (long long)lane_id * W;
  const float* lp = planes + (long long)lane_id * kPlanes * W;

  for (int j = threadIdx.x; j < sg * F; j += kLaneThreads) acc[j] = 0.f;

  for (int base = 0; base < W; base += kRows) {
    const int first = base + warp * kChunk + lane;
    // this thread's rows of the tile (first + 32q): their owned-segment
    // keys (-1: not owned, dead or past W), then the planes of the owned
    // ones, all loads issued at once so they are in flight during the
    // count and the scan
    int key[kPerLane];
    float pl[kPerLane][kPlanes];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int i = first + 32 * q;
      const int s = i < W ? lsid[i] - lo : -1;
      key[q] = (s >= 0 && s < n_own) ? s : -1;
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)
        pl[q][p] = key[q] >= 0 ? lp[p * W + first + 32 * q] : 0.f;
    }
    // 1. count this warp's rows per owned segment
    for (int j = threadIdx.x; j < kLaneWarps * sg; j += kLaneThreads)
      wcnt[j] = 0;
    __syncthreads();
    unsigned peers[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      peers[q] = __match_any_sync(kAll, key[q]);
      if (key[q] >= 0 && (peers[q] & lower) == 0)
        wcnt[warp * sg + key[q]] += __popc(peers[q]);
      __syncwarp();
    }
    __syncthreads();
    // 2. where each warp's rows of each segment start
    for (int s = threadIdx.x; s < n_own; s += kLaneThreads) {
      int run = 0;
      for (int w = 0; w < kLaneWarps; ++w) {
        const int c = wcnt[w * sg + s];
        wcnt[w * sg + s] = run;
        run += c;
      }
      cnt[s] = run;
    }
    __syncthreads();
    if (warp == 0) {
      const int per = (n_own + 31) / 32;
      const int s0 = min(n_own, lane * per), s1 = min(n_own, s0 + per);
      int sum = 0;
      for (int s = s0; s < s1; ++s) sum += cnt[s];
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kAll, incl, d);
        if (lane >= d) incl += y;
      }
      int run = incl - sum;
      for (int s = s0; s < s1; ++s) {
        start[s] = run;
        run += cnt[s];
      }
    }
    __syncthreads();
    // 3. place each owned row at its stable slot, with its payload
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int k = key[q];
      if (k >= 0) {
        const int slot = start[k] + wcnt[warp * sg + k] +
                         __popc(peers[q] & lower);
        pay[slot] = __float2bfloat16_rn(pl[q][0]);
        pay[kPayStride + slot] = __float2bfloat16_rn(pl[q][1]);
        pay[2 * kPayStride + slot] = __float2bfloat16_rn(pl[q][2]);
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const float x = pl[q][3 + m];
          const float hi = bf16_rn(x);
          pay[(3 + m) * kPayStride + slot] = __float2bfloat16_rn(hi);
          pay[(6 + m) * kPayStride + slot] = __float2bfloat16_rn(x - hi);
        }
        // truncation toward zero, as astype(int32); then clamped
        const int b = __float2int_rz(pl[q][4]);
        bkt[slot] = (unsigned short)min(max(b, 0), n_hist - 1);
      }
      __syncwarp();
      if (k >= 0 && (peers[q] & lower) == 0)
        wcnt[warp * sg + k] += __popc(peers[q]);
      __syncwarp();
    }
    __syncthreads();
    // 4. fold: warp per segment, lane per column, rows in slot order,
    // kFoldBatch rows' loads ahead of their adds.  A histogram lane adds
    // bf16(valid) at its bucket and +0.0 elsewhere, as the payload row's
    // one-hot does.
    for (int s = warp; s < n_own; s += kLaneWarps) {
      const int n = cnt[s];
      if (n == 0) continue;
      const int b0 = start[s];
      for (int c = lane; c < F; c += 32) {
        const __nv_bfloat16* col = pay + (c < kPay ? c : 0) * kPayStride + b0;
        const unsigned short* bk = bkt + b0;
        const int h = c < kPay ? -1 : c - kPay;
        float a = acc[s * F + c];
        int j = 0;
        for (; j + kFoldBatch <= n; j += kFoldBatch) {
          float v[kFoldBatch];
          int hb[kFoldBatch];
#pragma unroll
          for (int q = 0; q < kFoldBatch; ++q) {
            v[q] = __bfloat162float(col[j + q]);
            hb[q] = bk[j + q];
          }
#pragma unroll
          for (int q = 0; q < kFoldBatch; ++q)
            a += (h < 0 || hb[q] == h) ? v[q] : 0.f;
        }
        for (; j < n; ++j)
          a += (h < 0 || bk[j] == h) ? __bfloat162float(col[j]) : 0.f;
        acc[s * F + c] = a;
      }
    }
    __syncthreads();
  }
  __syncthreads();                    // acc is complete (also when W == 0)

  const int FO = kPlanes + n_hist;
  float* o = out + ((long long)lane_id * n_segments + lo) * FO;
  for (int j = threadIdx.x; j < n_own * FO; j += kLaneThreads) {
    const int s = j / FO;
    const int f = j - s * FO;
    const float* a = acc + s * F;
    o[j] = f < 3 ? a[f] : (f < kPlanes ? a[f] + a[f + 3] : a[kPay + f - kPlanes]);
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

extern "C" int anomod_lane_delta_smem(int seg_per_block, int n_hist) {
  return lane_smem_bytes(seg_per_block, n_hist);
}

extern "C" int anomod_lane_delta(const void* sid, const void* planes, int L,
                                 int W, int n_segments, int n_hist,
                                 int seg_per_block, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L < 1 || n_segments < 1) return (int)cudaSuccess;
  if (seg_per_block < 1 || n_hist < 1 || n_hist > 65536)
    return (int)cudaErrorInvalidValue;
  const int smem = lane_smem_bytes(seg_per_block, n_hist);
  cudaError_t e = cudaFuncSetAttribute(
      lane_delta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int groups = (n_segments + seg_per_block - 1) / seg_per_block;
  lane_delta_kernel<<<dim3(L, groups), kLaneThreads, smem, st>>>(
      static_cast<const int*>(sid), static_cast<const float*>(planes), W,
      n_segments, seg_per_block, n_hist, static_cast<float*>(out));
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

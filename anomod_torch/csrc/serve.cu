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
// window_gather.  pool[P][S*Wn][F] and the tenants' (slot, col) pairs give
// out[T][S][F] = pool[slot_t][s*Wn + col_t][f]: tenant t's scored window
// column.  A pure copy, bit-identical to indexing.  A pair outside the pool
// writes a NaN row (the caller validates on the host).  Bound by bytes:
// T*S*F*4 read and written, about 0.00004 ms at T = 256, S = 12, F = 6, so
// what the serve path pays is the launch and the memory round trips: on
// the H100 (chip_smoke.py phase 7, spun) T = 256 reads 0.0061-0.0062 ms
// and T = 1 0.0057-0.0058, the timed window's floor for a launch that
// reads one cold line after its L2 write.
//
// Design: no index is read from global memory.  The pairs travel by value
// in the kernel's parameter space, a __grid_constant__ struct of int2 (the
// constant bank), so a thread's first global access is its pool row.
// Parameters are held to the portable 4 KB limit: kGatherPairs = 507
// pairs a launch beside the header, and a larger request is split into
// several launches on the host (ops/serve_kernels.py gather_plan).  CUDA
// 12.1 raises the limit to 32,764 bytes on Volta and newer (the card's
// toolkit is 12.9, chip_smoke.py phase 1 prints it), which is not used:
// a launch copies its whole parameter block, and one block of 4,090
// pairs read 0.0080-0.0090 ms at T = 1 to 256 against this block's
// 0.0057-0.0062 (phase 7 over both builds in one run, H100 80GB HBM3 at
// 700 W).  It wins only where this block needs three launches or more
// (T = 1200: 0.0089 against 0.0127), and a serve scoring pass asks for at
// most one pair a tenant (200 at the bench deployment).
//
// One warp a tenant, 8 a block: ceil(T / 8) blocks.  The constant cache serves one address a warp at a
// time, so every warp reads one pair (a thread a (tenant, service) row
// put three tenants in a warp and serialized their reads).  With F even
// and the pool's base 8-byte aligned a row moves as F/2 8-byte elements
// (36 a tenant at S = 12, F = 6: two a lane, both loads in flight), else
// as F scalar ones, chosen in the C entry as tdigest_reduce chooses its
// vector path.
//
// Interface: plain C, pointers and the stream as void*, loaded with ctypes
// (anomod_torch/ops/serve_kernels.py).  Each entry returns
// cudaGetLastError().  The caller allocates the outputs; the window
// gather's pairs stay in host memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>
#include <type_traits>

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
constexpr int kGatherThreads = 256;  // 8 tenants a block
constexpr int kGatherRounds = 2;     // elements a lane loads ahead
// (slot, col) pairs one window-gather launch carries at most: the 4 KB
// portable kernel-parameter limit less GatherArgs' 40-byte header
constexpr int kGatherPairs = 507;

// The window gather's whole parameter block, passed by value.
struct GatherArgs {
  const float* pool;
  float* out;
  int P, S, Wn, F, T;
  int2 pairs[kGatherPairs];
};
static_assert(sizeof(GatherArgs) <= 4096,
              "window-gather parameters exceed the portable 4 KB limit");

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

template <typename V>
__device__ __forceinline__ V splat(float x);
template <>
__device__ __forceinline__ float splat<float>(float x) { return x; }
template <>
__device__ __forceinline__ float2 splat<float2>(float x) {
  return make_float2(x, x);
}

// Warp t copies tenant t's S*F floats: its pair is one uniform read of
// the parameter block (a broadcast from the constant cache), then lane j
// moves elements j, j + 32, ... (float2 elements when kVec: F even and
// pool and out 8-byte aligned), each round's loads issued before its
// stores.
template <bool kVec>
__global__ void __launch_bounds__(kGatherThreads)
window_gather_kernel(const __grid_constant__ GatherArgs a) {
  const int t = (blockIdx.x * kGatherThreads + threadIdx.x) >> 5;
  if (t >= a.T) return;                          // warp-uniform
  const int lane = threadIdx.x & 31;
  const int2 pc = a.pairs[t];
  const bool ok = pc.x >= 0 && pc.x < a.P && pc.y >= 0 && pc.y < a.Wn;
  using V = typename std::conditional<kVec, float2, float>::type;
  constexpr int kW = sizeof(V) / sizeof(float);  // floats an element
  const int per = a.F / kW;                      // elements a service row
  const int n = a.S * per;
  V* __restrict__ o = reinterpret_cast<V*>(a.out + (long long)t * a.S * a.F);
  const V* __restrict__ src = reinterpret_cast<const V*>(
      a.pool + ((long long)pc.x * a.S * a.Wn + pc.y) * a.F);
  const long long svc = (long long)a.Wn * per;   // elements between services
  const V nan = splat<V>(__int_as_float(0x7fc00000));
  for (int j0 = 0; j0 < n; j0 += 32 * kGatherRounds) {
    V v[kGatherRounds];
#pragma unroll
    for (int r = 0; r < kGatherRounds; ++r) {
      const int j = j0 + 32 * r + lane;
      const int s = j / per;
      v[r] = nan;
      if (ok && j < n) v[r] = src[s * svc + (j - s * per)];
    }
#pragma unroll
    for (int r = 0; r < kGatherRounds; ++r) {
      const int j = j0 + 32 * r + lane;
      if (j < n) o[j] = v[r];
    }
  }
}

// The dynamic shared-memory cap that cudaFuncSetAttribute sets is one
// per kernel for the whole process.  Serve shard threads launch the lane
// kernel at once with different segments per block, so different sizes:
// each sets the cap and launches under this lock, or another thread's
// smaller cap could land between one thread's set and its launch, which
// then fails with cudaErrorInvalidValue.
std::mutex lane_launch_mutex;

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
  const int groups = (n_segments + seg_per_block - 1) / seg_per_block;
  std::lock_guard<std::mutex> hold(lane_launch_mutex);
  cudaError_t e = cudaFuncSetAttribute(
      lane_delta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  lane_delta_kernel<<<dim3(L, groups), kLaneThreads, smem, st>>>(
      static_cast<const int*>(sid), static_cast<const float*>(planes), W,
      n_segments, seg_per_block, n_hist, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int anomod_window_gather_capacity() { return kGatherPairs; }

// pairs: host memory, int32[T][2] (slot, col); T <= kGatherPairs.  out:
// the T rows' [T][S][F] block on the card.
extern "C" int anomod_window_gather(const void* pool, int P, int S, int Wn,
                                    int F, const void* pairs, int T,
                                    void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || S < 1 || F < 1) return (int)cudaSuccess;
  if (T > kGatherPairs) return (int)cudaErrorInvalidValue;
  const int* pv = static_cast<const int*>(pairs);
  GatherArgs a;
  a.pool = static_cast<const float*>(pool);
  a.out = static_cast<float*>(out);
  a.P = P;
  a.S = S;
  a.Wn = Wn;
  a.F = F;
  a.T = T;
  for (int t = 0; t < T; ++t) a.pairs[t] = make_int2(pv[2 * t], pv[2 * t + 1]);
  const auto aligned8 = [](const void* q) {
    return (reinterpret_cast<unsigned long long>(q) & 7ull) == 0;
  };
  const int blocks = (T * 32 + kGatherThreads - 1) / kGatherThreads;
  if (F % 2 == 0 && aligned8(pool) && aligned8(out))
    window_gather_kernel<true><<<blocks, kGatherThreads, 0, st>>>(a);
  else
    window_gather_kernel<false><<<blocks, kGatherThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

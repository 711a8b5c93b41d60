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
// does one.  On the card both kernels are scatter reductions; the bytes
// they must read are 28 B per span (sid + 6 planes).  Only nonzero terms
// are added (x + 0.0f == x, so every sum is unchanged).
//
// The dense kernel takes spans in staging order (in a warp's 32 spans of
// the TT corpus, 13 segments on average).  The shared f32 atomicAdd is a
// compare-and-swap loop on sm_90a (ATOMS.CAST.SPIN), so the count of its
// atomics and their contention on hot rows, not the bytes, bound the
// first design.  Two plans, picked by the wrapper by span count:
// - owned slices (a stream chunk: 4096 spans, SW 4320): one launch, a
//   block per slice of about SW / n_SM segments owning those rows of
//   `out`.  Every block reads the whole chunk (115 KB, from L2 after the
//   first block), zeroes its rows and adds the spans it owns into them
//   with L2's native f32 reductions: a chunk touches a few hundred
//   segments, so a block's spans crowd onto a row or two, where shared
//   compare-and-swap loops contend.  The card is filled at any SW, the
//   output is written once and nothing else is.
// - clusters (a corpus pass: 491,520 spans, SW 1440): thread-block
//   clusters of kCluster blocks, one block an SM, each folding its own
//   contiguous range of spans into a whole [tile][F] accumulator in
//   shared memory, a warp step's spans by segment group (the group's
//   counts, and its moment sums gathered by shuffles; the histogram per
//   (segment, bucket)): one atomic a group and column, and each row's
//   count set from its histogram row.  The cluster then sums its members'
//   accumulators over distributed shared memory, member by member, each
//   block summing one kCluster-th of the rows, so one partial plane a
//   cluster (2 MB for 16 clusters, not one plane a block) reaches global
//   memory; dense_reduce sums those in cluster order (skipped when there
//   is one cluster).
// Both load kFoldUnroll spans a thread before adding any.
// sorted_fold takes the sorted staging, where a warp's
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
// Determinism: the cross-block reductions run in fixed order (cluster
// members, then clusters; blocks in the sorted kernel).  Inside a block
// (and in L2, for the owned slices), f32 atomics add in arrival order, so
// the moment planes vary in the last bits from run to run; the count /
// err / 5xx / histogram planes add small integers and are exact in any
// order below 2^24.
//
// Interface: plain C, pointers and the stream as void*, loaded with ctypes
// (anomod_torch/ops/replay_kernels.py).  Each entry returns cudaGetLastError().
// The caller allocates `partials` and `out`; the kernels allocate nothing.
// Global f32 atomics flush subnormal values to zero; no sum of trace
// moments or counts comes near one.

#include <cassert>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kPlanes = 6;           // valid, err, 5xx, dur_raw, dur, dur^2
// what the sorted kernel adds a span: the replay's payload, or one of the
// roofline probe's two ablations of it
enum Payload : int { kFull = 0, kCounts = 1, kNoHist = 2 };
constexpr int kSliceThreads = 1024;    // dense, owned slices
constexpr int kClusterThreads = 1024;  // dense, clusters: one block an SM
constexpr int kCluster = 8;            // blocks a cluster (portable size)
constexpr int kFoldUnroll = 4;         // spans a thread loads before adding
constexpr int kSortedThreads = 1024;
constexpr int kSortedWarps = kSortedThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Row stride of the dense kernels' shared accumulator: F = 6 + H floats
// padded to an odd count, so the scattered rows of a warp's spans fall on
// all 32 banks (an even stride reaches only 16).
__host__ __device__ constexpr int dense_stride(int n_hist) {
  return (kPlanes + n_hist) | 1;
}

// One span a lane, folded by the warp into `acc` (rows of `stride`
// floats, row s - lo for segment s).  `own`: the lane's span lies in this
// block's segments [lo, ...); x: its six plane values.  The lanes of one
// segment add as a group (__match_any_sync): its lowest lane adds the
// group's count of unit (exactly 1) err / 5xx values and its moment sums,
// gathered from the peers in lane order by shuffles; the histogram adds
// per (segment, bucket), a unit group's count at once.  Values other
// than 0 and 1 in the exact planes add lane by lane.  So a warp step
// issues a shared f32 atomic (a compare-and-swap loop on this card) per
// group and column, not per span and column.  The count column is not
// added: finish_counts sets it from the histogram row.  Every lane calls
// it.
__device__ __forceinline__ void fold_groups(float* acc, int stride, int lo,
                                            int s, bool own,
                                            const float (&x)[kPlanes],
                                            int n_hist, int lane) {
  const float valid = own ? bf16_rn(x[0]) : 0.f;
  const float err = own ? bf16_rn(x[1]) : 0.f;
  const float s5 = own ? bf16_rn(x[2]) : 0.f;
  float m[3], sum[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float hi = bf16_rn(x[3 + i]);
    m[i] = own ? hi + bf16_rn(x[3 + i] - hi) : 0.f;
    sum[i] = m[i];
  }
  const unsigned peers = __match_any_sync(kAll, own ? s : -1 - lane);
  const bool lead = own && (peers & ((1u << lane) - 1u)) == 0;
  const int rounds = __reduce_max_sync(kAll, own ? __popc(peers) - 1 : 0);
  unsigned rest = peers & (peers - 1u);      // a leader's peers above it
  for (int r = 0; r < rounds; ++r) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    rest &= rest - 1u;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float y = __shfl_sync(kAll, m[i], src);
      if (src != lane) sum[i] += y;
    }
  }
  const unsigned eu = __ballot_sync(kAll, err == 1.f);
  const unsigned su = __ballot_sync(kAll, s5 == 1.f);
  float* row = acc + (own ? s - lo : 0) * stride;
  if (lead) {
    const unsigned c1 = __popc(peers & eu), c2 = __popc(peers & su);
    if (c1) atomicAdd(row + 1, (float)c1);
    if (c2) atomicAdd(row + 2, (float)c2);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (sum[i] != 0.f) atomicAdd(row + 3 + i, sum[i]);
  }
  if (err != 0.f && err != 1.f) atomicAdd(row + 1, err);
  if (s5 != 0.f && s5 != 1.f) atomicAdd(row + 2, s5);
  // truncation toward zero, as astype(int32); saturates, NaN -> 0
  const int b = min(max(__float2int_rz(x[4]), 0), n_hist - 1);
  const bool adds = valid != 0.f;
  const bool unit = valid == 1.f;
  const int key = adds ? (unit ? s * n_hist + b : -2 - lane) : -1;
  const unsigned hp = __match_any_sync(kAll, key);
  if (adds && !unit)
    atomicAdd(row + kPlanes + b, valid);
  else if (adds && (hp & ((1u << lane) - 1u)) == 0)
    atomicAdd(row + kPlanes + b, (float)__popc(hp));
}

// The cluster fold's span loop: fold the spans [i0, i1) whose segment
// lies in [lo, hi) into `acc` (rows of `stride` floats in shared memory),
// `inner_repeats` times.  Warp w takes spans i0 + 32w + lane + k*T (T
// threads a block), kFoldUnroll of them a lane at a time: it loads their
// ids, then the planes of the spans it owns (a second round trip: an L2
// prefetch of those lines cost more than it saved), then folds them by
// segment group (fold_groups).
// `n` is the planes' span count (their stride).
__device__ __forceinline__ void fold_range(float* acc, int stride,
                                           const int* __restrict__ sid,
                                           const float* __restrict__ planes,
                                           long long n, long long i0,
                                           long long i1, int lo, int hi,
                                           int n_hist, int inner_repeats) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < inner_repeats; ++r) {
    for (long long wb = i0 + (threadIdx.x & ~31); wb < i1;
         wb += (long long)kFoldUnroll * kClusterThreads) {
      int s[kFoldUnroll];
      float x[kFoldUnroll][kPlanes];
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) {
        const long long i = wb + lane + (long long)u * kClusterThreads;
        s[u] = i < i1 ? sid[i] : -1;
      }
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) {
        const long long i = wb + lane + (long long)u * kClusterThreads;
        const bool own = s[u] >= lo && s[u] < hi;
#pragma unroll
        for (int c = 0; c < kPlanes; ++c)
          x[u][c] = own ? planes[c * n + i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) {
        const bool own = s[u] >= lo && s[u] < hi;
        if (__any_sync(kAll, own))
          fold_groups(acc, stride, lo, s[u], own, x[u], n_hist, lane);
      }
    }
  }
}

// After the fold (and a block barrier): each row's count column is the
// sum of its histogram row, in bucket order.  Every span with a nonzero
// bf16(valid) adds it to exactly one bucket, so this is the count: exact
// for integer counts (below 2^24), as summing them span by span would be.
__device__ __forceinline__ void finish_counts(float* acc, int stride,
                                              int rows, int n_hist) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float* row = acc + r * stride;
    float c = row[kPlanes];
    for (int b = 1; b < n_hist; ++b) c += row[kPlanes + b];
    row[0] = c;
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

// One span's payload into `row` (its segment's row of `out`) with native
// f32 reductions in L2 (RED.ADD.F32, fire and forget), a nonzero column
// at a time.
__device__ __forceinline__ void red_span(float* row, const float (&x)[kPlanes],
                                         int n_hist) {
  const float valid = bf16_rn(x[0]);
  const float err = bf16_rn(x[1]);
  const float s5 = bf16_rn(x[2]);
  if (valid != 0.f) atomicAdd(row + 0, valid);
  if (err != 0.f) atomicAdd(row + 1, err);
  if (s5 != 0.f) atomicAdd(row + 2, s5);
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float hi = bf16_rn(x[3 + m]);
    const float v = hi + bf16_rn(x[3 + m] - hi);
    if (v != 0.f) atomicAdd(row + 3 + m, v);
  }
  if (valid != 0.f) {
    // truncation toward zero, as astype(int32); saturates, NaN -> 0
    const int b = min(max(__float2int_rz(x[4]), 0), n_hist - 1);
    atomicAdd(row + kPlanes + b, valid);
  }
}

// Dense, owned slices: block b owns segments [b*tile_w, min(SW,
// (b+1)*tile_w)) and, alone, their rows of out[SW][F].  It zeroes them,
// then adds every span it owns into them with native f32 reductions in
// L2 (red_span): a stream chunk's 4096 spans touch a few hundred
// segments, so a block's spans crowd onto one or two rows, where shared
// compare-and-swap loops contend and L2's reductions do not stall the
// warp (grouping a warp's spans by segment first cost more than it
// saved).  One launch, nothing but `out` written.  Every block reads
// every span (ids and planes in one round trip, from L2 after the first
// block), the first batch before it zeroes its rows.  The block barrier
// orders its zero stores before its reductions to the same addresses (no
// other block touches them), so no gpu-scope fence is needed.
__global__ void __launch_bounds__(kSliceThreads)
dense_slice_fold(const int* __restrict__ sid, const float* __restrict__ planes,
                 long long n, int n_segments, int n_hist, int tile_w,
                 int inner_repeats, float* __restrict__ out) {
  const int F = kPlanes + n_hist;
  const int lo = blockIdx.x * tile_w;
  const int hi = min(n_segments, lo + tile_w);
  float* dst = out + (long long)lo * F;
  bool zeroed = false;
  for (int r = 0; r < inner_repeats; ++r) {
    for (long long base = threadIdx.x; base < n || !zeroed;
         base += (long long)kFoldUnroll * kSliceThreads) {
      int s[kFoldUnroll];
      float x[kFoldUnroll][kPlanes];
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) {
        const long long i = base + (long long)u * kSliceThreads;
        s[u] = i < n ? sid[i] : -1;
#pragma unroll
        for (int c = 0; c < kPlanes; ++c)
          x[u][c] = i < n ? planes[c * n + i] : 0.f;
      }
      if (!zeroed) {                     // every thread, once
        for (int j = threadIdx.x; j < (hi - lo) * F; j += blockDim.x)
          dst[j] = 0.f;
        __syncthreads();
        zeroed = true;
      }
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u)
        if (s[u] >= lo && s[u] < hi)
          red_span(dst + (long long)(s[u] - lo) * F, x[u], n_hist);
    }
  }
}

// Dense, clusters.  Grid (n_parts, n_tiles), clusters of kCluster blocks
// along x.  Block (x, y) folds the spans [x*per_part, (x+1)*per_part)
// whose segment lies in tile y, segments [y*tile_w, min(SW,
// (y+1)*tile_w)), into shared memory.  Then block `rank` of each cluster
// sums its kCluster-th of the tile's [rows][F] outputs over the C
// members' accumulators in member order (distributed shared memory) and
// stores them in dst[x / C][SW][F]: `out` itself when there is one
// cluster along x, else the partials dense_reduce sums.
__global__ void __launch_bounds__(kClusterThreads, 1)
dense_cluster_fold(const int* __restrict__ sid,
                   const float* __restrict__ planes, long long n,
                   int n_segments, int n_hist, int tile_w, long long per_part,
                   int inner_repeats, float* __restrict__ dst) {
  extern __shared__ float acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int F = kPlanes + n_hist;
  const int stride = dense_stride(n_hist);
  const int lo = blockIdx.y * tile_w;
  const int hi = min(n_segments, lo + tile_w);
  const int len = (hi - lo) * F;
  const int rank = (int)cluster.block_rank();
  const int j0 = (int)((long long)len * rank / kCluster);
  const int j1 = (int)((long long)len * (rank + 1) / kCluster);
  const long long i0 = min(n, (long long)blockIdx.x * per_part);
  const long long i1 = min(n, i0 + per_part);
  float* o = dst + ((long long)(blockIdx.x / kCluster) * n_segments + lo) * F;
  for (int j = threadIdx.x; j < (hi - lo) * stride; j += blockDim.x)
    acc[j] = 0.f;
  __syncthreads();
  fold_range(acc, stride, sid, planes, n, i0, i1, lo, hi, n_hist,
             inner_repeats);
  __syncthreads();
  finish_counts(acc, stride, hi - lo, n_hist);
  cluster.sync();
  const float* part[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) part[q] = cluster.map_shared_rank(acc, q);
  for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const int at = j / F * stride + j % F;
    float x[kCluster];
#pragma unroll
    for (int q = 0; q < kCluster; ++q) x[q] = part[q][at];
    float v = x[0];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) v += x[q];
    o[j] = v;
  }
  cluster.sync();  // no member leaves while its accumulator is read
}

// Dense, clusters, pass 2: out[j] = sum over clusters g = 0, 1, ... of
// partials[g][j], always in that order; four floats a thread where the
// plane's length allows (it does for every H the port runs: 22 columns).
__global__ void dense_reduce(const float* __restrict__ partials, int n_groups,
                             long long len, float* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (len % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(partials);
    float4* o4 = reinterpret_cast<float4*>(out);
    const long long len4 = len / 4;
    for (long long j = first; j < len4; j += step) {
      float4 s = p4[j];
#pragma unroll 8
      for (int g = 1; g < n_groups; ++g) {
        const float4 y = p4[g * len4 + j];
        s.x += y.x;
        s.y += y.y;
        s.z += y.z;
        s.w += y.w;
      }
      o4[j] = s;
    }
    return;
  }
  for (long long j = first; j < len; j += step) {
    float s = partials[j];
#pragma unroll 8
    for (int g = 1; g < n_groups; ++g) s += partials[g * len + j];
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

// Raise `fn`'s dynamic shared-memory limit to at least `smem` bytes on the
// current device, once: later calls that need no more set nothing.
cudaError_t ensure_smem(const void* fn, int slot, int smem) {
  constexpr int kDevices = 64, kSlots = 8;
  static int limit[kDevices][kSlots];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && limit[dev][slot] >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess && dev < kDevices) limit[dev][slot] = smem;
  return e;
}

// Slots of ensure_smem, one a kernel.
enum SmemSlot : int { kSlotCluster = 0, kSlotSorted = 1 };

// The cluster fold's launch configuration; `attr` must outlive it.
cudaLaunchConfig_t cluster_config(dim3 grid, int smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
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
  cudaError_t e = ensure_smem((const void*)sorted_fold<P>, kSlotSorted + P,
                              smem);
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

// The most clusters of the dense cluster fold that fit on the card at
// once with `smem` bytes of shared memory a block, into *n.
extern "C" int anomod_dense_cluster_capacity(int smem, int* n) {
  const void* fn = (const void*)dense_cluster_fold;
  cudaError_t e = ensure_smem(fn, kSlotCluster, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(dim3(kCluster), smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(n, fn, &cfg);
}

// The dense fold.  clustered = 0: owned slices, n_tiles blocks of tile_w
// segments (n_parts unused).  clustered = 1: grid (n_parts, n_tiles),
// n_parts a multiple of kCluster; with n_parts > kCluster, partials holds
// (n_parts / kCluster) * n_segments * (6 + n_hist) floats.
extern "C" int anomod_replay_dense(const void* sid, const void* planes,
                                   long long n, int n_segments, int n_hist,
                                   int inner_repeats, int clustered,
                                   int n_parts, int n_tiles, int tile_w,
                                   void* partials, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int F = kPlanes + n_hist;
  const int smem = tile_w * dense_stride(n_hist) * (int)sizeof(float);
  const int* s = static_cast<const int*>(sid);
  const float* p = static_cast<const float*>(planes);
  float* o = static_cast<float*>(out);
  if (!clustered) {
    dense_slice_fold<<<n_tiles, kSliceThreads, 0, st>>>(
        s, p, n, n_segments, n_hist, tile_w, inner_repeats, o);
    return (int)cudaGetLastError();
  }
  if (n_parts < kCluster || n_parts % kCluster) return (int)cudaErrorInvalidValue;
  const int n_groups = n_parts / kCluster;
  float* dst = n_groups > 1 ? static_cast<float*>(partials) : o;
  const long long per_part = (n + n_parts - 1) / n_parts;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(dim3(n_parts, n_tiles), smem, st,
                                          &attr);
  cudaError_t e = ensure_smem((const void*)dense_cluster_fold, kSlotCluster,
                              smem);
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&cfg, dense_cluster_fold, s, p, n, n_segments,
                           n_hist, tile_w, per_part, inner_repeats, dst);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess || n_groups == 1) return (int)e;
  const long long len = (long long)n_segments * F;
  dense_reduce<<<reduce_blocks(len % 4 ? len : len / 4), kReduceThreads, 0,
                 st>>>(
      static_cast<const float*>(partials), n_groups, len, o);
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

// Sketch kernels for Hopper (sm_90a): the fixed-K t-digest reduction pass
// and the HyperLogLog register update of the sketch featurization path.
//
// Replaces the two Pallas TPU kernels of anomod/ops/:
//   anomod_tdigest_reduce <- make_pallas_tdigest_fn  (pallas_tdigest.py:34)
//   anomod_hll_update     <- make_pallas_hll_fn      (pallas_hll.py:19)
//
// tdigest_reduce.  bucket[R][L] int32, w[R][L] and wv[R][L] f32 give, per
// digest lane r and centroid k, weight[r][k] = sum of w over the slots with
// bucket == k and mean[r][k] = (sum of wv) / weight (0 where the weight is
// 0).  A bucket outside [0, K) adds to nothing, as the TPU kernel's one-hot
// has no column for it.  The TPU contracted a [K, L] one-hot with the
// [L, 2] (w, wv) plane on the MXU at Precision.HIGHEST; here it is a
// scatter reduction in f32 on the CUDA cores (no TF32, no tensor cores).
//
// Design: one block of kTdWarps warps per digest lane.  What bounds it is
// bytes (12 B a slot read, 8 B a centroid written), so the lane's
// 128-slot steps are cut into kTdWarps contiguous ranges, one a warp, and
// a warp loads 4 consecutive slots of each plane a thread (one 16-byte
// load each where L % 4 == 0), the next step's while it folds this one.
// A step folds as four sub-steps: sub-step u takes slot 4t + u of lane t,
// a 32-slot sequence that is non-decreasing wherever the row is.  In a
// sub-step each run of equal in-range buckets over consecutive lanes sums
// (w, wv) by a segmented shuffle scan (Hillis-Steele: the run's sum lands
// on its tail lane in a fixed tree order; the four sub-steps' scans run
// interleaved), and the tails add into the warp's [K][2] partial in
// shared memory in sub-step order, then lane order (tails of one bucket,
// which only rows not sorted give, in rounds of their rank among that
// bucket's tails).  The block then sums its warps' partials in warp
// order.  No float atomics and a fixed order everywhere, so two launches
// on the same input give the same bits, and tests/torch_tdigest_order.py
// restates the order in numpy, bit for bit.  A step whose slots add
// nothing (weights and products all zero, or buckets outside [0, K): the
// padding of a lane) is skipped, which changes no bit (x + 0 == x for
// every partial sum, none of which is -0).  Nothing here depends on the
// rows being sorted.
//
// hll_update.  items[N] int32 (read as uint32) and an optional lane[N]
// int32 update regs[L][2^p] int32 in place: h = fmix32(item), bucket = the
// top p bits of h, rank = min(clz(fmix32(h ^ 0x9E3779B9)) + 1, 32), and
// regs[lane][bucket] = max(regs[lane][bucket], rank).  Without a lane
// column every item goes to lane 0 (L = 1: the single sketch); an item
// whose lane is outside [0, L) is dropped.  clz is the hardware __clz, exact
// for every input (the TPU kernel needed a bit-shift ladder).
//
// Design: one register copy a thread-block cluster, not one a block.  A
// cluster of kHllCluster (8, the portable size) blocks splits the L x 2^p
// registers into 8 slices, block r owning slice r in its shared memory
// (own = ceil(L*2^p / 8) registers: 2880, 11.5 KB, at the edge plane's
// 90 x 256), so a block zeroes and sweeps an eighth of the plane and a
// cluster, not every block, holds one copy.  A warp takes 128 consecutive
// rows a step, as four 32-row groups (thread t holds rows 32u + t, so each
// load is one coalesced 128-byte line and a group is 32 consecutive rows:
// the spans of one trace, which share a register, sit together), with the
// next step's loads issued before this step's hashing; the first step's
// loads are issued between the arrival at the barrier that follows the
// zeroing of the slices and the wait on it (issued before the arrival,
// whose release orders them, they would hold it up).  In each group the
// rows with one register find each other (__match_any_sync on the register
// index), their largest rank is found by six ballots, one a bit from the
// top, and the group's lowest lane sends one atomicMax to the register's
// owner: its own shared memory, or another block's over distributed shared
// memory (cluster.map_shared_rank); shared integer max is a native atomic.
// After a cluster barrier each block folds its slice into regs with
// atomicMax of its nonzero registers, consecutive threads on consecutive
// registers, so a warp's reductions fall on one 128-byte line of L2.  The
// grid (ops/sketch_kernels.py hll_plan) is about one block an SM, fewer
// clusters when there are few rows a block or when the clusters' sweeps
// would outnumber the rows.  A plane whose slice does not fit a block's
// shared memory (SMEM_LIMIT; p = 16 with many lanes) takes the direct
// path: the same warp merge, each group's register sent to regs in global
// memory with an atomicMax whose result is unused (a reduction in L2,
// RED.E.MAX; phase 1 of chip_smoke.py prints the opcodes), at most 8
// blocks of 256 threads an SM.  A dropped row (lane outside [0, L)) joins
// no register and sends nothing.  The byte bound is 4 B (8 B with lanes)
// a row, 0.0012 ms at the edge plane.  What bounds it on the H100
// (chip_smoke.py phase 10, spun): at the edge plane 0.0135 ms, of which
// 0.0099 is what a launch with every row dead takes (the launch, zeroing,
// two cluster barriers and the rows' reads after the timed window's L2
// write), the rest the updates over distributed shared memory; the direct
// path takes 0.0197 there, its 352,075 scattered reductions serialized in
// L2, which is why regs is written only by the slices' coalesced sweeps.
// Integer max does not depend on order, so the result is register-exact
// and two launches are identical.
//
// Interface: plain C, pointers and the stream as void*, loaded with ctypes
// (anomod_torch/ops/sketch_kernels.py).  Each entry returns
// cudaGetLastError().  The caller allocates the outputs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kTdWarps = 4;               // warps a digest lane
constexpr int kTdThreads = kTdWarps * 32;
constexpr int kTdSlots = 4;               // slots a thread a step
constexpr int kTdStep = 32 * kTdSlots;
constexpr int kHllThreads = 256;          // direct path
constexpr int kHllClusterThreads = 1024;  // cluster path: one block an SM
constexpr int kHllCluster = 8;            // blocks a cluster (portable size)
constexpr int kHllGroups = 4;             // 32-row groups a warp a step
constexpr int kHllStep = 32 * kHllGroups; // rows a warp a step
constexpr int kHllBlocksPerSm = 8;        // direct path

// Slots [base + 4t, base + 4t + 4) of a row, for lane t: buckets (-1 past
// the row's end) and the two planes (0 past it).
__device__ __forceinline__ void td_load(const int* __restrict__ bucket,
                                        const float* __restrict__ w,
                                        const float* __restrict__ wv,
                                        long long row, int L, int base,
                                        bool vec, int lane, int (&k)[kTdSlots],
                                        float (&a)[kTdSlots],
                                        float (&b)[kTdSlots]) {
  const int i = base + kTdSlots * lane;
  if (vec && i < L) {                    // L % 4 == 0: the 4 slots exist
    const int4 kv = *reinterpret_cast<const int4*>(bucket + row + i);
    const float4 av = *reinterpret_cast<const float4*>(w + row + i);
    const float4 bv = *reinterpret_cast<const float4*>(wv + row + i);
    k[0] = kv.x; k[1] = kv.y; k[2] = kv.z; k[3] = kv.w;
    a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
    b[0] = bv.x; b[1] = bv.y; b[2] = bv.z; b[3] = bv.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < kTdSlots; ++u) {
    const bool in = i + u < L;
    k[u] = in ? bucket[row + i + u] : -1;
    a[u] = in ? w[row + i + u] : 0.f;
    b[u] = in ? wv[row + i + u] : 0.f;
  }
}

// One step: lane t holds, in sub-step u, bucket k[u] (in [0, K), or
// -1 - t: adds nothing) with (a[u], b[u]) = (w, wv).  In each sub-step,
// runs of equal keys over consecutive lanes sum by a segmented inclusive
// scan (the four scans interleaved); then, sub-step by sub-step, each
// run's tail lane adds its sums into acc[key] ([K][2]), tails of one key
// in lane order.
__device__ __forceinline__ void td_step(float* acc, const int (&k)[kTdSlots],
                                        float (&a)[kTdSlots],
                                        float (&b)[kTdSlots], int lane) {
  int start[kTdSlots];
  bool emit[kTdSlots];
#pragma unroll
  for (int u = 0; u < kTdSlots; ++u) {
    const int prev = __shfl_up_sync(kAll, k[u], 1);
    const unsigned heads = __ballot_sync(kAll, lane == 0 || k[u] != prev);
    start[u] = 31 - __clz(heads & (kAll >> (31 - lane)));
    emit[u] = (lane == 31 || ((heads >> (lane + 1)) & 1u)) && k[u] >= 0;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int u = 0; u < kTdSlots; ++u) {
      const float ya = __shfl_up_sync(kAll, a[u], d);
      const float yb = __shfl_up_sync(kAll, b[u], d);
      if (lane - d >= start[u]) {
        a[u] += ya;
        b[u] += yb;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kTdSlots; ++u) {
    const unsigned peers = __match_any_sync(kAll, emit[u] ? k[u] : -1 - lane);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const int last = __reduce_max_sync(kAll, emit[u] ? rank : 0);
    for (int q = 0; q <= last; ++q) {
      if (emit[u] && rank == q) {
        acc[2 * k[u]] += a[u];
        acc[2 * k[u] + 1] += b[u];
      }
      __syncwarp();
    }
  }
}

// Dynamic shared memory: part[kTdWarps][K][2].  vec: L % 4 == 0 and the
// three planes 16-byte aligned.  Block r reduces digest lane r; 12 blocks
// an SM (at most 42 registers a thread) hold the service plane's 1440
// lanes in one wave.
__global__ void __launch_bounds__(kTdThreads, 12)
tdigest_reduce_kernel(const int* __restrict__ bucket,
                      const float* __restrict__ w,
                      const float* __restrict__ wv, int L, int K, int vec,
                      float* __restrict__ mean, float* __restrict__ weight) {
  extern __shared__ float part[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < kTdWarps * K * 2; j += blockDim.x)
    part[j] = 0.f;
  __syncthreads();
  float* acc = part + warp * K * 2;
  const long long row = (long long)blockIdx.x * L;
  const int steps = (L + kTdStep - 1) / kTdStep;
  const int end = steps * (warp + 1) / kTdWarps * kTdStep;
  int k[kTdSlots];
  float a[kTdSlots], b[kTdSlots];
  int base = steps * warp / kTdWarps * kTdStep;
  if (base < end) td_load(bucket, w, wv, row, L, base, vec, lane, k, a, b);
  for (; base < end; base += kTdStep) {
    const bool more = base + kTdStep < end;
    int nk[kTdSlots] = {};
    float na[kTdSlots] = {}, nb[kTdSlots] = {};
    if (more)
      td_load(bucket, w, wv, row, L, base + kTdStep, vec, lane, nk, na, nb);
    bool adds = false;
#pragma unroll
    for (int u = 0; u < kTdSlots; ++u) {
      if (k[u] < 0 || k[u] >= K) {
        k[u] = -1 - lane;
        a[u] = b[u] = 0.f;
      }
      adds = adds || (k[u] >= 0 && (a[u] != 0.f || b[u] != 0.f));
    }
    if (__any_sync(kAll, adds)) td_step(acc, k, a, b, lane);
#pragma unroll
    for (int u = 0; u < kTdSlots; ++u) {
      k[u] = nk[u];
      a[u] = na[u];
      b[u] = nb[u];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    float sw = part[2 * c], swv = part[2 * c + 1];
#pragma unroll
    for (int q = 1; q < kTdWarps; ++q) {
      sw += part[(q * K + c) * 2];
      swv += part[(q * K + c) * 2 + 1];
    }
    const long long o = (long long)blockIdx.x * K + c;
    weight[o] = sw;
    mean[o] = sw > 0.f ? swv / sw : 0.f;
  }
}

__device__ __forceinline__ unsigned fmix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Rows base + 32u + t of a warp step, for lane t: the items, and their
// lanes (-1 past the end; 0 without a lane column).
__device__ __forceinline__ void hll_load(const int* __restrict__ items,
                                         const int* __restrict__ lane,
                                         long long n, long long base, int t,
                                         int (&it)[kHllGroups],
                                         int (&ln)[kHllGroups]) {
#pragma unroll
  for (int u = 0; u < kHllGroups; ++u) {
    const long long i = base + 32 * u + t;
    const bool in = i < n;
    it[u] = in ? items[i] : 0;
    ln[u] = in ? (lane ? lane[i] : 0) : -1;
  }
}

// Grid-stride over warp steps of kHllStep rows; L << p < 2^31.  kCluster:
// grid of clusters of kHllCluster blocks, block r of a cluster owning
// registers [r*own, (r+1)*own) in its dynamic shared memory; else every
// update goes to regs.
template <bool kCluster>
__global__ void __launch_bounds__(kCluster ? kHllClusterThreads : kHllThreads)
hll_update_kernel(const int* __restrict__ items,
                  const int* __restrict__ lane, long long n, int p, int L,
                  int own, int* __restrict__ regs) {
  extern __shared__ int slice[];
  const int t = threadIdx.x & 31;
  const unsigned lower = (1u << t) - 1u;
  const int me = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  if (kCluster) {
    for (int j = threadIdx.x; j < own; j += blockDim.x) slice[j] = 0;
    // every slice zeroed before use: arrive now, wait once the first
    // step's loads are in flight
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  long long w = (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  int it[kHllGroups], ln[kHllGroups];
  if (w * kHllStep < n) hll_load(items, lane, n, w * kHllStep, t, it, ln);
  if (kCluster)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  for (; w * kHllStep < n; w += warps) {          // warp-uniform
    int nit[kHllGroups] = {}, nln[kHllGroups] = {};
    const long long next = (w + warps) * kHllStep;
    if (next < n) hll_load(items, lane, n, next, t, nit, nln);
#pragma unroll
    for (int u = 0; u < kHllGroups; ++u) {
      const bool keep = ln[u] >= 0 && ln[u] < L;
      int key = -1, rank = 0;
      if (keep) {
        const unsigned h = fmix32(static_cast<unsigned>(it[u]));
        const unsigned h2 = fmix32(h ^ 0x9E3779B9u);
        key = (ln[u] << p) + static_cast<int>(h >> (32 - p));
        rank = min(__clz(static_cast<int>(h2)) + 1, 32);
      }
      const unsigned peers = __match_any_sync(kAll, key);
      // the group's largest rank (<= 32 < 64), bit by bit from the top:
      // every lane of a group takes the same steps
      int m = 0;
#pragma unroll
      for (int bit = 5; bit >= 0; --bit) {
        const int c = m | (1 << bit);
        if (__ballot_sync(kAll, rank >= c) & peers) m = c;
      }
      if (keep && (peers & lower) == 0) {
        if (kCluster) {
          const int q = key / own;
          int* dst = slice + (key - q * own);
          if (q != me) dst = cg::this_cluster().map_shared_rank(dst, q);
          atomicMax(dst, m);
        } else {
          atomicMax(regs + key, m);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kHllGroups; ++u) {
      it[u] = nit[u];
      ln[u] = nln[u];
    }
  }
  if (kCluster) {
    // every update of the cluster has landed, and no block reads another's
    // slice from here on
    cg::this_cluster().sync();
    const long long base = (long long)me * own;
    const int n_own = (int)min((long long)own, ((long long)L << p) - base);
    for (int j = threadIdx.x; j < n_own; j += blockDim.x) {
      const int v = slice[j];
      if (v > 0) atomicMax(regs + base + j, v);
    }
  }
}

// Raise the cluster kernel's dynamic shared-memory limit to at least `smem`
// bytes on the current device, once: later calls that need no more set
// nothing.
cudaError_t hll_ensure_smem(int smem) {
  constexpr int kDevices = 64;
  static int limit[kDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && limit[dev] >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(hll_update_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < kDevices) limit[dev] = smem;
  return e;
}

// The cluster path's launch configuration; `attr` must outlive it.
cudaLaunchConfig_t hll_cluster_config(int n_clusters, int smem,
                                      cudaStream_t st,
                                      cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * kHllCluster);
  cfg.blockDim = dim3(kHllClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kHllCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" const char* anomod_sketch_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" int anomod_tdigest_smem(int K) {
  return kTdWarps * K * 2 * (int)sizeof(float);
}

extern "C" int anomod_tdigest_reduce(const void* bucket, const void* w,
                                     const void* wv, int R, int L, int K,
                                     void* mean, void* weight, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || K < 1) return (int)cudaSuccess;
  const int smem = anomod_tdigest_smem(K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tdigest_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const auto aligned = [](const void* q) {
    return (reinterpret_cast<unsigned long long>(q) & 15ull) == 0;
  };
  const int vec = L % kTdSlots == 0 && aligned(bucket) && aligned(w) &&
                  aligned(wv);
  tdigest_reduce_kernel<<<R, kTdThreads, smem, st>>>(
      static_cast<const int*>(bucket), static_cast<const float*>(w),
      static_cast<const float*>(wv), L, K, vec, static_cast<float*>(mean),
      static_cast<float*>(weight));
  return (int)cudaGetLastError();
}

// The most clusters of the cluster path that fit on the card at once with
// `smem` bytes of shared memory a block, into *n.
extern "C" int anomod_hll_cluster_capacity(int smem, int* n) {
  cudaError_t e = hll_ensure_smem(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = hll_cluster_config(1, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      n, (const void*)hll_update_kernel<true>, &cfg);
}

// n_clusters > 0: the cluster path, each block owning `own` registers
// (8 * own >= L << p); n_clusters == 0: the direct path, its grid from
// n_sm, the card's SM count.
extern "C" int anomod_hll_update(const void* items, const void* lane,
                                 long long n, int p, int L, void* regs,
                                 int n_clusters, int own, int n_sm,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || L < 1) return (int)cudaSuccess;
  if (p < 1 || p > 30 || ((long long)L << p) > 0x7fffffffLL || n_sm < 1 ||
      n_clusters < 0)
    return (int)cudaErrorInvalidValue;
  const int* it = static_cast<const int*>(items);
  const int* ln = static_cast<const int*>(lane);
  int* r = static_cast<int*>(regs);
  if (n_clusters > 0) {
    if ((long long)own * kHllCluster < ((long long)L << p))
      return (int)cudaErrorInvalidValue;
    const int smem = own * (int)sizeof(int);
    cudaError_t e = hll_ensure_smem(smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = hll_cluster_config(n_clusters, smem, st, &attr);
    e = cudaLaunchKernelEx(&cfg, hll_update_kernel<true>, it, ln, n, p, L,
                           own, r);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  constexpr int kRowsPerBlock = kHllThreads / 32 * kHllStep;
  long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > (long long)kHllBlocksPerSm * n_sm)
    blocks = (long long)kHllBlocksPerSm * n_sm;
  hll_update_kernel<false><<<(int)blocks, kHllThreads, 0, st>>>(
      it, ln, n, p, L, 0, r);
  return (int)cudaGetLastError();
}

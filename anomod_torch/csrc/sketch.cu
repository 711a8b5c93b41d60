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
// Design: a grid-stride pass over the items.  When the L x 2^p registers fit
// in shared memory each block keeps its own zeroed copy, updates it with
// shared atomicMax and, at the end, folds every nonzero register into regs
// with a global atomicMax; otherwise the updates go to regs directly.
// Integer max does not depend on order, so the result is register-exact
// whatever the schedule.  Bound by bytes: 4 B (8 B with lanes) an item.
//
// Interface: plain C, pointers and the stream as void*, loaded with ctypes
// (anomod_torch/ops/sketch_kernels.py).  Each entry returns
// cudaGetLastError().  The caller allocates the outputs.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kTdWarps = 4;               // warps a digest lane
constexpr int kTdThreads = kTdWarps * 32;
constexpr int kTdSlots = 4;               // slots a thread a step
constexpr int kTdStep = 32 * kTdSlots;
constexpr int kHllThreads = 512;
// items a shared-register block should see at least, so that zeroing and
// folding its register copy stays small beside the updates
constexpr int kHllItemsPerBlock = 4096;

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

// Dynamic shared memory (use_smem only): sreg[L << p].
__global__ void hll_update_kernel(const int* __restrict__ items,
                                  const int* __restrict__ lane, long long n,
                                  int p, int L, int* __restrict__ regs,
                                  int use_smem) {
  extern __shared__ int sreg[];
  const long long total = (long long)L << p;
  if (use_smem) {
    for (long long j = threadIdx.x; j < total; j += blockDim.x) sreg[j] = 0;
    __syncthreads();
  }
  int* dst = use_smem ? sreg : regs;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int l = lane ? lane[i] : 0;
    if (l < 0 || l >= L) continue;
    const unsigned h = fmix32(static_cast<unsigned>(items[i]));
    const int b = static_cast<int>(h >> (32 - p));
    const unsigned h2 = fmix32(h ^ 0x9E3779B9u);
    const int rank = min(__clz(static_cast<int>(h2)) + 1, 32);
    atomicMax(dst + (((long long)l << p) + b), rank);
  }
  if (use_smem) {
    __syncthreads();
    for (long long j = threadIdx.x; j < total; j += blockDim.x) {
      const int v = sreg[j];
      if (v > 0) atomicMax(regs + j, v);
    }
  }
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

// smem_limit: the most dynamic shared memory a block may take for its
// register copy (0: update regs directly).  n_sm: the card's SM count.
extern "C" int anomod_hll_update(const void* items, const void* lane,
                                 long long n, int p, int L, void* regs,
                                 int smem_limit, int n_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || L < 1) return (int)cudaSuccess;
  const long long bytes = ((long long)L << p) * (long long)sizeof(int);
  const int use_smem = bytes <= smem_limit;
  long long blocks = (n + kHllThreads - 1) / kHllThreads;
  int smem = 0;
  if (use_smem) {
    smem = (int)bytes;
    blocks = (n + kHllItemsPerBlock - 1) / kHllItemsPerBlock;
    if (blocks > n_sm) blocks = n_sm;
    cudaError_t e = cudaFuncSetAttribute(
        hll_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  } else if (blocks > 4LL * n_sm) {
    blocks = 4LL * n_sm;
  }
  hll_update_kernel<<<(int)blocks, kHllThreads, smem, st>>>(
      static_cast<const int*>(items), static_cast<const int*>(lane), n, p, L,
      static_cast<int*>(regs), use_smem);
  return (int)cudaGetLastError();
}

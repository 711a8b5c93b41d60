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
// Design: one block per lane, 8 warps.  Warp q walks its own contiguous
// slice of the lane in 32-slot chunks (coalesced loads).  In a chunk the
// lanes that share a bucket find each other with __match_any_sync; the
// lowest of them adds the group's (w, wv) into the warp's own [K][2]
// partial in shared memory, one slot at a time in lane order.  No float
// atomics: each partial is written by one thread at a time in a fixed
// order, and the block sums the 8 partials in warp order, so two launches
// on the same input give the same bits.  What bounds it is bytes (12 B a
// slot read, 8 B a centroid written); after the scale pass a bucket row
// is non-decreasing, so a chunk holds few groups and the leader's serial
// walk is the latency to beat in a later, run-length design.  Nothing here
// depends on the rows being sorted.
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

constexpr int kTdThreads = 256;
constexpr int kTdWarps = kTdThreads / 32;
constexpr int kHllThreads = 512;
// items a shared-register block should see at least, so that zeroing and
// folding its register copy stays small beside the updates
constexpr int kHllItemsPerBlock = 4096;

// Dynamic shared memory: part[kTdWarps][K][2], then stage[kTdWarps][32][2].
__global__ void tdigest_reduce_kernel(const int* __restrict__ bucket,
                                      const float* __restrict__ w,
                                      const float* __restrict__ wv, int L,
                                      int K, float* __restrict__ mean,
                                      float* __restrict__ weight) {
  extern __shared__ float smem[];
  float* part = smem;
  float* stage = part + kTdWarps * K * 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * L;

  for (int j = threadIdx.x; j < kTdWarps * K * 2; j += blockDim.x) part[j] = 0.f;
  __syncthreads();

  const int per = (L + kTdWarps - 1) / kTdWarps;
  const int lo = min(L, warp * per);
  const int hi = min(L, lo + per);
  float* wp = part + warp * K * 2;
  float* ws = stage + warp * 64;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    int key = -1 - lane;             // unique and negative: adds to nothing
    float a = 0.f, b = 0.f;
    if (i < hi) {
      const int bk = bucket[row + i];
      if (bk >= 0 && bk < K) {
        key = bk;
        a = w[row + i];
        b = wv[row + i];
      }
    }
    ws[2 * lane] = a;
    ws[2 * lane + 1] = b;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    __syncwarp();
    if (key >= 0 && lane == __ffs(peers) - 1) {
      float sw = wp[2 * key];
      float swv = wp[2 * key + 1];
      for (unsigned m = peers; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        sw += ws[2 * j];
        swv += ws[2 * j + 1];
      }
      wp[2 * key] = sw;
      wp[2 * key + 1] = swv;
    }
    __syncwarp();                    // stage is rewritten by the next chunk
  }
  __syncthreads();

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float sw = 0.f, swv = 0.f;
    for (int q = 0; q < kTdWarps; ++q) {
      sw += part[(q * K + k) * 2];
      swv += part[(q * K + k) * 2 + 1];
    }
    const long long o = (long long)blockIdx.x * K + k;
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
  return (kTdWarps * K * 2 + kTdWarps * 64) * (int)sizeof(float);
}

extern "C" int anomod_tdigest_reduce(const void* bucket, const void* w,
                                     const void* wv, int R, int L, int K,
                                     void* mean, void* weight, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || K < 1) return (int)cudaSuccess;
  const int smem = anomod_tdigest_smem(K);
  cudaError_t e = cudaFuncSetAttribute(
      tdigest_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  tdigest_reduce_kernel<<<R, kTdThreads, smem, st>>>(
      static_cast<const int*>(bucket), static_cast<const float*>(w),
      static_cast<const float*>(wv), L, K, static_cast<float*>(mean),
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

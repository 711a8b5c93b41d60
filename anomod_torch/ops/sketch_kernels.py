"""The sketch kernels (counterpart of ``anomod/ops/pallas_tdigest.py`` and
``anomod/ops/pallas_hll.py``).

``tdigest_reduce`` replaces ``make_pallas_tdigest_fn`` (pallas_tdigest.py:34):
the fixed-K t-digest reduction pass, per digest lane the per-centroid
weight and weighted mean of pre-bucketed slots.  ``hll_update`` replaces
``make_pallas_hll_fn`` (pallas_hll.py:19), the HyperLogLog register max;
with a lane column it also carries the per-lane plane the JAX package
builds with an XLA scatter-max (``replay.hll_scatter_update``).  The HLL
kernel keeps one register copy a thread-block cluster, split over its
blocks' shared memories (:func:`hll_plan`); each warp merges its 32-row
groups' rows by register before it sends them to their owners.  The CUDA
sources are in ``anomod_torch/csrc/sketch.cu``.

Beside each kernel is its plain PyTorch version (``*_plain``).  A wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches per
wrapper.

Tolerance: digest weights are sums of integer weights, exact in any add
order below 2^24, so the kernel's equal the plain version's; the weighted
means are f32 sums taken in another order (on the card each run of equal
buckets sums by a segmented shuffle scan and the run sums add in lane
order, a fixed order that ``tests/torch_tdigest_order.py`` restates;
index order in ``index_add_`` on the CPU) and agree to ``rtol=1e-5``.  HLL registers are integer maxima: equal, register for
register.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from anomod_torch.ops.replay_kernels import (_check, _on_cuda, _ptr,
                                             _sm_count, _stream)

#: kernel launches per wrapper, counted where the wrapper launches its
#: kernel and nowhere else (a CPU tensor takes the plain version: no count)
launches: Dict[str, int] = {"tdigest_reduce": 0, "hll_update": 0}

#: shared-memory ceiling a sketch block may ask for (H100: 227 KB a block)
SMEM_LIMIT = 200 * 1024
#: blocks a cluster of the HLL kernel's cluster path (``kHllCluster``)
HLL_CLUSTER = 8
#: rows an HLL cluster-path block should have at least (one 128-row step
#: for each of its 32 warps)
HLL_ROWS_PER_BLOCK = 4096
#: HLL precisions the hash supports (the bucket is the top p bits)
HLL_P_RANGE = (4, 16)

_M32 = 0xFFFFFFFF


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in ``[0, 2^32)``: the 32-bit
    constant splits into 16-bit halves so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of uint32 values held in int64, by the exact
    bit-shift ladder of the Pallas kernel (32 for 0)."""
    v = x
    msb = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        t = v >> s
        nz = t != 0
        msb = torch.where(nz, msb + s, msb)
        v = torch.where(nz, t, v)
    return torch.where(x != 0, 31 - msb, torch.full_like(x, 32))


def hll_hash(items: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 items (read as uint32) -> int64 ``(bucket, rank)``: bucket =
    the top ``p`` bits of ``fmix32(item)``, rank = ``min(clz(fmix32(h ^
    0x9E3779B9)) + 1, 32)``; the hash of ``anomod/ops/hll.py``."""
    h = _fmix32(items.to(torch.int64) & _M32)
    bucket = h >> (32 - p)
    h2 = _fmix32(h ^ 0x9E3779B9)
    rank = torch.clamp(_clz32(h2) + 1, max=32)
    return bucket, rank


def tdigest_reduce_plain(bucket: torch.Tensor, w: torch.Tensor,
                         wv: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`tdigest_reduce`: one ``index_add_``
    of ``[w, wv]`` into ``R * K`` rows, then the masked division."""
    R = bucket.shape[0]
    b = bucket.long()
    keep = (b >= 0) & (b < k)
    idx = (torch.arange(R, device=b.device)[:, None] * k + b)[keep]
    acc = torch.zeros((R * k, 2), dtype=torch.float32, device=b.device)
    acc.index_add_(0, idx, torch.stack([w[keep], wv[keep]], dim=1))
    weight = acc[:, 0].reshape(R, k)
    total = acc[:, 1].reshape(R, k)
    pos = weight > 0
    mean = torch.where(pos, total / torch.where(pos, weight, 1.0), 0.0)
    return mean, weight


def hll_update_plain(regs: torch.Tensor, items: torch.Tensor,
                     lane: Optional[torch.Tensor] = None,
                     p: int = 10) -> torch.Tensor:
    """Plain PyTorch version of :func:`hll_update`: the torch hash, then
    one ``scatter_reduce_(..., "amax")`` into ``regs`` (updated in place
    and returned)."""
    bucket, rank = hll_hash(items, p)
    if lane is not None:
        L = regs.shape[0]
        keep = (lane >= 0) & (lane < L)
        bucket = (lane.long() << p)[keep] + bucket[keep]
        rank = rank[keep]
    regs.view(-1).scatter_reduce_(0, bucket, rank.to(torch.int32),
                                  reduce="amax", include_self=True)
    return regs


class HllPlan(NamedTuple):
    """The HLL kernel's grid.  Clustered: ``n_clusters`` clusters of
    :data:`HLL_CLUSTER` blocks, block r of a cluster owning registers
    ``[r*own, (r+1)*own)`` of the flattened plane in its shared memory.
    Direct (``n_clusters == 0``): no copy, every update to the registers
    in device memory."""
    n_clusters: int
    own: int

    @property
    def clustered(self) -> bool:
        return self.n_clusters > 0

    def smem_bytes(self) -> int:
        """Shared memory a block of this plan takes."""
        return self.own * 4


def hll_plan(n_rows: int, n_regs: int, n_sm: int,
             cluster_capacity: Callable[[int], int]) -> HllPlan:
    """The HLL kernel's grid for ``n_rows`` rows into ``n_regs`` registers.

    Each cluster holds one copy of the plane, an eighth a block; the
    direct path exactly when that eighth does not fit :data:`SMEM_LIMIT`.
    Otherwise about one block an SM (``n_sm // 8`` clusters), but no more
    clusters than keep :data:`HLL_ROWS_PER_BLOCK` rows a block, than make
    the clusters' sweeps of the plane (``n_clusters x n_regs``) outnumber
    the rows, or than the card holds at once
    (``cluster_capacity(smem_bytes)``)."""
    own = -(-n_regs // HLL_CLUSTER)
    if own * 4 > SMEM_LIMIT:
        return HllPlan(0, 0)
    n = min(max(1, n_sm // HLL_CLUSTER),
            -(-n_rows // (HLL_CLUSTER * HLL_ROWS_PER_BLOCK)),
            max(1, n_rows // max(n_regs, 1)),
            cluster_capacity(own * 4))
    return HllPlan(max(1, n), own)


_LIB = None


def _lib() -> ctypes.CDLL:
    """The built kernel library, with every entry's C signature declared."""
    global _LIB
    if _LIB is None:
        from anomod_torch.ops._build import library
        lib = library("sketch")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.anomod_tdigest_reduce.argtypes = [vp, vp, vp, i32, i32, i32, vp,
                                              vp, vp]
        lib.anomod_tdigest_reduce.restype = i32
        lib.anomod_tdigest_smem.argtypes = [i32]
        lib.anomod_tdigest_smem.restype = i32
        lib.anomod_hll_update.argtypes = [vp, vp, i64, i32, i32, vp, i32,
                                          i32, i32, vp]
        lib.anomod_hll_update.restype = i32
        lib.anomod_hll_cluster_capacity.argtypes = [
            i32, ctypes.POINTER(ctypes.c_int)]
        lib.anomod_hll_cluster_capacity.restype = i32
        lib.anomod_sketch_error_string.argtypes = [i32]
        lib.anomod_sketch_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().anomod_sketch_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _hll_cluster_capacity(index: int, smem: int) -> int:
    """Clusters of the HLL kernel's cluster path the card holds at once
    with ``smem`` bytes of shared memory a block."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _lib().anomod_hll_cluster_capacity(smem, ctypes.byref(n))
    _raise_on(err, "anomod_hll_cluster_capacity")
    if n.value < 1:
        raise RuntimeError(f"no cluster of {HLL_CLUSTER} blocks with {smem} B "
                           "of shared memory fits this card")
    return n.value


def tdigest_reduce(bucket: torch.Tensor, w: torch.Tensor, wv: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bucket int32[R, L]``, ``w f32[R, L]``, ``wv f32[R, L]`` ->
    ``(mean, weight) f32[R, K]``: per lane and centroid, the sum of ``w``
    over the slots in that bucket and the weighted mean ``sum(wv) / sum(w)``
    (0 where the weight is 0).  Buckets outside ``[0, K)`` add to
    nothing.  CPU tensors take :func:`tdigest_reduce_plain`."""
    if bucket.dim() != 2:
        raise ValueError(f"bucket must be [R, L], got {tuple(bucket.shape)}")
    R, L = bucket.shape
    if k < 1:
        raise ValueError("k must be >= 1")
    _check("bucket", bucket, torch.int32, (R, L))
    _check("w", w, torch.float32, (R, L))
    _check("wv", wv, torch.float32, (R, L))
    if not _on_cuda(bucket, w, wv):
        return tdigest_reduce_plain(bucket, w, wv, k)
    lib = _lib()
    if lib.anomod_tdigest_smem(k) > SMEM_LIMIT:
        raise ValueError(f"k={k} needs more shared memory than a block has")
    mean = torch.empty((R, k), dtype=torch.float32, device=bucket.device)
    weight = torch.empty((R, k), dtype=torch.float32, device=bucket.device)
    if R == 0:                                  # nothing to launch
        return mean, weight
    err = lib.anomod_tdigest_reduce(_ptr(bucket), _ptr(w), _ptr(wv), R, L, k,
                                    _ptr(mean), _ptr(weight),
                                    _stream(bucket.device))
    _raise_on(err, "anomod_tdigest_reduce")
    launches["tdigest_reduce"] += 1
    return mean, weight


def hll_update(regs: torch.Tensor, items: torch.Tensor,
               lane: Optional[torch.Tensor] = None,
               p: int = 10) -> torch.Tensor:
    """Fold ``items int32[N]`` into HLL registers, in place; returns
    ``regs``.  Without ``lane``, ``regs`` is one sketch ``int32[2^p]``;
    with ``lane int32[N]`` it is the plane ``int32[L, 2^p]`` and an item
    whose lane lies outside ``[0, L)`` is dropped.  Any ``N`` is taken.
    CPU tensors take :func:`hll_update_plain`."""
    lo, hi = HLL_P_RANGE
    if not lo <= p <= hi:
        raise ValueError(f"p={p} outside [{lo}, {hi}]")
    m = 1 << p
    n = items.shape[0] if items.dim() == 1 else -1
    _check("items", items, torch.int32, (n,))
    if lane is None:
        _check("regs", regs, torch.int32, (m,))
        L, ts = 1, (regs, items)
    else:
        L = regs.shape[0] if regs.dim() == 2 else -1
        _check("regs", regs, torch.int32, (L, m))
        _check("lane", lane, torch.int32, (n,))
        ts = (regs, items, lane)
    if not _on_cuda(*ts):
        return hll_update_plain(regs, items, lane, p)
    if n == 0:                                  # nothing to launch
        return regs
    lib = _lib()
    dev = regs.device
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    n_sm = _sm_count(index)
    plan = hll_plan(n, L << p, n_sm,
                    functools.partial(_hll_cluster_capacity, index))
    err = lib.anomod_hll_update(
        _ptr(items), None if lane is None else _ptr(lane), n, p, L,
        _ptr(regs), plan.n_clusters, plan.own, n_sm, _stream(dev))
    _raise_on(err, "anomod_hll_update")
    launches["hll_update"] += 1
    return regs

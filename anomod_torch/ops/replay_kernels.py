"""The replay fold kernels (counterpart of ``anomod/ops/pallas_replay.py``).

``replay_dense`` replaces ``make_pallas_replay_fn`` (pallas_replay.py:85)
and ``replay_sorted`` replaces ``make_pallas_replay_sorted_fn``
(pallas_replay.py:257).  Both compute, per (service, window) segment, the
``[SW, 6+H]`` sum of each span's payload row — the three exact planes
(valid, err, 5xx), the three latency moments rounded through the bf16
hi/lo split, and a log-latency histogram one-hot — dropping the dead
padding lane ``sid == SW``.  The dense fold carries each moment's bf16
hi and lo halves as separate columns (``9 + H`` a row, the TPU kernel's
``_build_rhs_t`` rows) and adds the two sums only after the fold
(:func:`recombine_moments`, the TPU kernel's ``_recombine_moments``), so
its plain version on the CPU equals the JAX chunk step bit for bit.  The
sorted kernel adds ``hi + lo`` a span (:func:`sorted_payload`): no
detector reads it.  ``replay_sorted_ablation`` replaces the
roofline probe's ``make_ablation`` (scripts/bench_kernel_roofline.py:73):
the sorted kernel with its payload cut to the count row (``counts``) or
to the exact planes and the separate hi and lo moment rows (``no_hist``),
returned raw as the TPU kernel's feature-major ``[ROWS, NWK]``.  The CUDA
sources are in ``anomod_torch/csrc/replay.cu``.  Their bound is the bytes
they read (28 B per span).  :func:`dense_plan` picks the dense kernel's
grid: for a stream chunk, owned slices of the segments, each block adding
its spans into its own rows of the output with L2 reductions; for a
corpus pass, thread-block clusters that fold a warp's spans by segment
group into shared memory and sum over distributed shared memory.  The
sorted kernel (and its ablations) adds a warp's run of equal segment ids
at a time.

Beside each kernel is its plain PyTorch version (``*_plain``, an
``index_add_`` over the same rounded payload).  A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  ``launches`` counts kernel launches per wrapper.

Tolerance: the count / err / 5xx / histogram planes are small-integer f32
sums, exact in any add order below 2^24 per segment (the dense kernel's
corpus plan sets a row's count as its histogram row's sum: the same
integer).  The moment planes are f32 sums whose order differs between the
kernel (atomics), the plain version (``index_add_``) and the TPU kernels,
so they agree to ``rtol=1e-5, atol=1e-3``.  On the CPU, ``index_add_``
adds in row order, as the JAX CPU chunk step does, so the plain dense fold
equals it bit for bit (``tests/test_torch_replay_kernels.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

PLANES = ("valid", "err", "s5", "dur_raw", "dur", "dur2")
N_PLANES = len(PLANES)
#: payload columns a span carries into the dense fold: exact (valid, err,
#: 5xx), moment hi x3, moment lo x3; the histogram one-hot follows
N_PAYLOAD = 9

#: shared-memory budget of one dense cluster-plan block (H100: 227 KB)
DENSE_SMEM_BYTES = 200 * 1024
#: spans per dense-kernel block below which fewer clusters are launched
DENSE_SPANS_PER_PART = 2048
#: span count up to which the dense kernel takes its owned-slice plan
#: (every block reads every span: 8192 spans are 224 KB a block, from L2)
DENSE_SLICE_SPANS = 8192
#: blocks a cluster of the dense kernel's cluster plan (``kCluster``)
DENSE_CLUSTER = 8

#: kernel launches per wrapper, counted where the wrapper launches its
#: kernel and nowhere else (a CPU tensor takes the plain version: no count)
launches: Dict[str, int] = {"replay_dense": 0, "replay_sorted": 0,
                            "replay_sorted_counts": 0,
                            "replay_sorted_no_hist": 0}

#: payload rows of the sorted kernel's ablations, and the mode number of
#: each in ``anomod_replay_sorted_ablation``
ABLATION_ROWS = {"counts": 1, "no_hist": 9}
_ABLATION_MODE = {"counts": 1, "no_hist": 2}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def replay_payload(planes: torch.Tensor, n_hist: int) -> torch.Tensor:
    """``planes f32[..., 6, N]`` -> the ``[..., N, 9+H]`` per-span payload
    rows the dense fold sums, rounded as the TPU kernel's bf16 right-hand
    side (``_build_rhs_t``) and the JAX scatter engine's ``_scatter_rhs``:
    bf16 exact planes, each moment's ``bf16(m)`` and ``bf16(m - bf16(m))``
    as separate columns, and ``bf16(valid)`` at histogram bucket
    ``clamp(int(dur), 0, H-1)``."""
    p = planes.transpose(-1, -2)
    exact = _bf16(p[..., 0:3])
    mom = p[..., 3:6]
    hi = _bf16(mom)
    lo = _bf16(mom - hi)
    bucket = p[..., 4].to(torch.int32).clamp(0, n_hist - 1).long()
    hist = torch.zeros(p.shape[:-1] + (n_hist,), dtype=torch.float32,
                       device=planes.device)
    hist.scatter_(-1, bucket[..., None], exact[..., 0:1])
    return torch.cat([exact, hi, lo, hist], dim=-1)


def recombine_moments(acc: torch.Tensor) -> torch.Tensor:
    """Sums of :func:`replay_payload` rows, ``[..., 9+H]`` -> ``[...,
    6+H]``: each moment's hi sum plus its lo sum, one f32 add a cell, after
    the fold (``_recombine_moments`` / ``_split_acc``)."""
    return torch.cat([acc[..., 0:3], acc[..., 3:6] + acc[..., 6:9],
                      acc[..., 9:]], dim=-1)


def sorted_payload(planes: torch.Tensor, n_hist: int) -> torch.Tensor:
    """The ``[N, 6+H]`` rows the sorted kernel sums: each moment as ``hi +
    lo`` in f32 a span.  The sorted kernel feeds the throughput probes
    alone, no detector, so it keeps the narrower row that its shared
    accumulator and run sums were sized for."""
    return recombine_moments(replay_payload(planes, n_hist))


def replay_dense_plain(sid: torch.Tensor, planes: torch.Tensor,
                       n_segments: int, n_hist: int,
                       inner_repeats: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`replay_dense`: an ``index_add_`` of
    the ``9+H`` payload, then :func:`recombine_moments`."""
    payload = replay_payload(planes, n_hist)
    acc = torch.zeros((n_segments + 1, N_PAYLOAD + n_hist),
                      dtype=torch.float32, device=planes.device)
    idx = sid.long()
    for _ in range(inner_repeats):
        acc.index_add_(0, idx, payload)
    return recombine_moments(acc[:n_segments])


def sorted_global_ids(sid_local: torch.Tensor, wids: torch.Tensor, k: int,
                      block: int) -> torch.Tensor:
    """Global segment ids of sorted-window staged spans."""
    return sid_local.long() + torch.repeat_interleave(wids.long(), block) * k


def replay_sorted_plain(sid_local: torch.Tensor, planes: torch.Tensor,
                        wids: torch.Tensor, n_segments: int, n_hist: int,
                        k: int = 128, block: int = 4096,
                        inner_repeats: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`replay_sorted`."""
    return _sorted_fold_plain(sorted_payload(planes, n_hist), sid_local,
                              wids, n_segments, k, block,
                              inner_repeats)[:n_segments]


def _sorted_fold_plain(payload, sid_local, wids, n_segments, k, block,
                       inner_repeats) -> torch.Tensor:
    """``[NWK, F]`` sums of sorted-staged ``payload`` rows at their global
    segment ids, ``inner_repeats`` times."""
    acc = torch.zeros((n_window_cols(n_segments, k), payload.shape[1]),
                      dtype=torch.float32, device=payload.device)
    idx = sorted_global_ids(sid_local, wids, k, block)
    for _ in range(inner_repeats):
        acc.index_add_(0, idx, payload)
    return acc


def ablation_payload(planes: torch.Tensor, rows_mode: str) -> torch.Tensor:
    """The ``[T, ROWS]`` per-span rows an ablation folds, rounded as the
    TPU ablation's bf16 right-hand side: ``bf16(valid)`` for ``counts``;
    for ``no_hist`` the three exact planes as bf16, then ``bf16(m)`` and
    ``bf16(m - bf16(m))`` of the three moments as separate rows."""
    if rows_mode == "counts":
        return _bf16(planes[0:1]).T
    mom = planes[3:6]
    hi = _bf16(mom)
    return torch.cat([_bf16(planes[0:3]), hi, _bf16(mom - hi)]).T


def n_window_cols(n_segments: int, k: int) -> int:
    """``NWK``: the columns of ``ceil((SW + 1) / k)`` aligned windows."""
    return (n_segments + 1 + k - 1) // k * k


def replay_sorted_ablation_plain(sid_local: torch.Tensor,
                                 planes: torch.Tensor, wids: torch.Tensor,
                                 n_segments: int, rows_mode: str,
                                 k: int = 128, block: int = 4096,
                                 inner_repeats: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`replay_sorted_ablation`."""
    return _sorted_fold_plain(ablation_payload(planes, rows_mode), sid_local,
                              wids, n_segments, k, block,
                              inner_repeats).T.contiguous()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


_LIB = None


def _lib() -> ctypes.CDLL:
    """The built kernel library, with every entry's C signature declared."""
    global _LIB
    if _LIB is None:
        from anomod_torch.ops._build import library
        lib = library("replay")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.anomod_replay_dense.argtypes = [
            vp, vp, i64, i32, i32, i32, i32, i32, i32, i32, vp, vp, vp]
        lib.anomod_replay_dense.restype = i32
        lib.anomod_dense_cluster_capacity.argtypes = [
            i32, ctypes.POINTER(ctypes.c_int)]
        lib.anomod_dense_cluster_capacity.restype = i32
        lib.anomod_replay_sorted.argtypes = [
            vp, vp, i64, vp, i32, i32, i32, i32, i32, i32, vp, vp, vp]
        lib.anomod_replay_sorted.restype = i32
        lib.anomod_replay_sorted_ablation.argtypes = [
            vp, vp, i64, vp, i32, i32, i32, i32, i32, i32, vp, vp, vp]
        lib.anomod_replay_sorted_ablation.restype = i32
        lib.anomod_cuda_error_string.argtypes = [i32]
        lib.anomod_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().anomod_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


class DensePlan(NamedTuple):
    """The dense kernel's grid.  Owned slices (``clustered`` false):
    ``n_tiles`` blocks, block b owning segments ``[b*tile_w, min(SW,
    (b+1)*tile_w))`` and their rows of the output, reading every span and
    adding its own into those rows in L2; one launch, no shared memory.
    Clusters: ``n_parts`` x ``n_tiles`` blocks, ``n_parts`` a multiple of
    :data:`DENSE_CLUSTER`, block (x, y) folding span part x into tile y;
    each cluster's sum reaches global memory once, and a second launch
    sums the ``n_groups`` clusters' planes when there is more than one."""
    clustered: bool
    n_parts: int
    n_tiles: int
    tile_w: int

    @property
    def n_groups(self) -> int:
        """Clusters along the span axis (partial planes summed after)."""
        return self.n_parts // DENSE_CLUSTER if self.clustered else 1

    def smem_bytes(self, n_hist: int) -> int:
        """Shared memory a block of this plan takes."""
        return self.tile_w * dense_stride(n_hist) * 4 if self.clustered \
            else 0


def dense_stride(n_hist: int) -> int:
    """Floats a row of the dense kernel's shared accumulator: ``9 + H``
    padded to an odd count (``dense_stride`` in ``csrc/replay.cu``)."""
    return (N_PAYLOAD + n_hist) | 1


def dense_plan(n: int, n_segments: int, n_hist: int, n_sm: int,
               cluster_capacity: Callable[[int], int]) -> DensePlan:
    """The dense kernel's grid for ``n`` spans into ``n_segments`` rows.

    Up to :data:`DENSE_SLICE_SPANS` spans: about ``n_sm`` owned slices.
    Above: the segment axis in the fewest equal tiles whose ``[tile_w,
    dense_stride(H)]`` f32 accumulator fits :data:`DENSE_SMEM_BYTES`, and
    as many clusters along the spans as fit on the card at once with
    every tile (``cluster_capacity(smem_bytes)``: the card's count), but
    no more than keeps :data:`DENSE_SPANS_PER_PART` spans a block."""
    if n <= DENSE_SLICE_SPANS:
        tile_w = -(-n_segments // max(n_sm, 1))
        return DensePlan(False, 1, -(-n_segments // tile_w), tile_w)
    row = dense_stride(n_hist) * 4
    tile_max = DENSE_SMEM_BYTES // row
    if tile_max < 1:
        raise ValueError(f"n_hist={n_hist} leaves no room for one segment")
    n_tiles = -(-n_segments // tile_max)
    tile_w = -(-n_segments // n_tiles)
    groups = min(cluster_capacity(tile_w * row) // n_tiles,
                 -(-n // (DENSE_CLUSTER * DENSE_SPANS_PER_PART)))
    return DensePlan(True, DENSE_CLUSTER * max(1, groups), n_tiles, tile_w)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _cluster_capacity(index: int, smem: int) -> int:
    """Clusters of the dense cluster fold the card holds at once with
    ``smem`` bytes of shared memory a block."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _lib().anomod_dense_cluster_capacity(smem, ctypes.byref(n))
    _raise_on(err, "anomod_dense_cluster_capacity")
    if n.value < 1:
        raise RuntimeError(f"no cluster of {DENSE_CLUSTER} blocks with "
                           f"{smem} B of shared memory fits this card")
    return n.value


def replay_dense(sid: torch.Tensor, planes: torch.Tensor, n_segments: int,
                 n_hist: int, inner_repeats: int = 1) -> torch.Tensor:
    """``sid int32[N]``, ``planes f32[6, N]`` -> ``agg f32[SW, 6+H]``.

    ``sid`` may hold ``n_segments`` (the dead padding lane, dropped).  The
    kernel sums the ``9+H`` payload (hi and lo apart) and adds each
    moment's two sums as it writes ``agg``.
    ``inner_repeats`` folds the same spans that many times in one launch.
    CPU tensors take :func:`replay_dense_plain`."""
    n = sid.shape[0]
    if n_segments < 1 or n_hist < 1 or inner_repeats < 1:
        raise ValueError("n_segments, n_hist and inner_repeats must be >= 1")
    _check("sid", sid, torch.int32, (n,))
    _check("planes", planes, torch.float32, (N_PLANES, n))
    if not _on_cuda(sid, planes):
        return replay_dense_plain(sid, planes, n_segments, n_hist,
                                  inner_repeats)
    lib = _lib()
    dev = sid.device
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    plan = dense_plan(n, n_segments, n_hist, _sm_count(index),
                      functools.partial(_cluster_capacity, index))
    out = torch.empty((n_segments, N_PLANES + n_hist), dtype=torch.float32,
                      device=dev)
    # the raw [SW, 9+H] sums (hi and lo apart): the owned slices' L2
    # accumulator, or one plane a cluster when several are summed (a
    # lone cluster writes ``out`` as it sums its members)
    partials = out
    if not plan.clustered or plan.n_groups > 1:
        partials = torch.empty(
            plan.n_groups * n_segments * (N_PAYLOAD + n_hist),
            dtype=torch.float32, device=dev)
    err = lib.anomod_replay_dense(
        _ptr(sid), _ptr(planes), n, n_segments, n_hist, inner_repeats,
        int(plan.clustered), plan.n_parts, plan.n_tiles, plan.tile_w,
        _ptr(partials), _ptr(out), _stream(dev))
    _raise_on(err, "anomod_replay_dense")
    launches["replay_dense"] += 1
    return out


def _check_sorted(sid_local, planes, wids, n_segments, k, block,
                  inner_repeats) -> None:
    t = sid_local.shape[0]
    if n_segments < 1 or inner_repeats < 1 or k < 1:
        raise ValueError("n_segments, k and inner_repeats must be >= 1")
    if block < 1 or t % block:
        raise ValueError(f"span count {t} must be a multiple of {block}")
    _check("sid_local", sid_local, torch.int32, (t,))
    _check("planes", planes, torch.float32, (N_PLANES, t))
    _check("wids", wids, torch.int32, (t // block,))
    # the kernels find a window's blocks by binary search in wids; on the
    # card they assert the order themselves, so no call waits on a copy
    if wids.device.type == "cpu" and bool((wids[1:] < wids[:-1]).any()):
        raise ValueError("wids must be non-decreasing (stage_sorted_planes "
                         "writes it so)")


def replay_sorted(sid_local: torch.Tensor, planes: torch.Tensor,
                  wids: torch.Tensor, n_segments: int, n_hist: int,
                  k: int = 128, block: int = 4096,
                  inner_repeats: int = 1) -> torch.Tensor:
    """``sid_local int32[T]``, ``planes f32[6, T]``, ``wids int32[T/block]``
    (from :func:`stage_sorted_planes`) -> ``agg f32[SW, 6+H]``.

    Every ``block`` of spans lies in one aligned window of ``k`` segments
    (window ``wids[b]``, non-decreasing in ``b``, as the staging writes
    it: out of order, a ``ValueError`` on the host and a device-side
    assert on the card).  CPU tensors take :func:`replay_sorted_plain`."""
    t = sid_local.shape[0]
    if n_hist < 1:
        raise ValueError("n_hist must be >= 1")
    _check_sorted(sid_local, planes, wids, n_segments, k, block,
                  inner_repeats)
    if not _on_cuda(sid_local, planes, wids):
        return replay_sorted_plain(sid_local, planes, wids, n_segments,
                                   n_hist, k, block, inner_repeats)
    lib = _lib()
    dev = sid_local.device
    F = N_PLANES + n_hist
    n_blocks = t // block
    partials = torch.empty(n_blocks * k * F, dtype=torch.float32, device=dev)
    out = torch.empty((n_segments, F), dtype=torch.float32, device=dev)
    err = lib.anomod_replay_sorted(
        _ptr(sid_local), _ptr(planes), t, _ptr(wids), n_blocks, block, k,
        n_segments, n_hist, inner_repeats, _ptr(partials), _ptr(out),
        _stream(dev))
    _raise_on(err, "anomod_replay_sorted")
    launches["replay_sorted"] += 1
    return out


def replay_sorted_ablation(sid_local: torch.Tensor, planes: torch.Tensor,
                           wids: torch.Tensor, n_segments: int,
                           rows_mode: str, k: int = 128, block: int = 4096,
                           inner_repeats: int = 1) -> torch.Tensor:
    """The roofline probe's ablations of :func:`replay_sorted`, over the
    same staging -> raw ``f32[ROWS, NWK]``, ``NWK = ceil((SW+1)/k) * k``.

    ``rows_mode`` is ``"counts"`` (ROWS = 1: ``bf16(valid)``) or
    ``"no_hist"`` (ROWS = 9: exact planes, moment hi rows, moment lo
    rows).  Every column is kept, the dead lane's column SW and the
    padding after it included.  ``wids`` is non-decreasing, as for
    :func:`replay_sorted`.  CPU tensors take
    :func:`replay_sorted_ablation_plain`."""
    if rows_mode not in ABLATION_ROWS:
        raise ValueError(f"unknown ablation {rows_mode!r} (expected one of "
                         f"{tuple(ABLATION_ROWS)})")
    _check_sorted(sid_local, planes, wids, n_segments, k, block,
                  inner_repeats)
    if not _on_cuda(sid_local, planes, wids):
        return replay_sorted_ablation_plain(sid_local, planes, wids,
                                            n_segments, rows_mode, k, block,
                                            inner_repeats)
    lib = _lib()
    dev = sid_local.device
    t = sid_local.shape[0]
    rows, n_blocks = ABLATION_ROWS[rows_mode], t // block
    nwk = n_window_cols(n_segments, k)
    partials = torch.empty(n_blocks * k * rows, dtype=torch.float32,
                           device=dev)
    out = torch.empty((rows, nwk), dtype=torch.float32, device=dev)
    err = lib.anomod_replay_sorted_ablation(
        _ptr(sid_local), _ptr(planes), t, _ptr(wids), n_blocks, block, k,
        nwk, _ABLATION_MODE[rows_mode], inner_repeats, _ptr(partials),
        _ptr(out), _stream(dev))
    _raise_on(err, "anomod_replay_sorted_ablation")
    launches[f"replay_sorted_{rows_mode}"] += 1
    return out


def stage_sorted_planes(sid, planes, n_segments, k: int = 128,
                        block: int = 4096):
    """Host-side re-staging for :func:`replay_sorted`: sort spans by
    segment id, bucket them into aligned windows of ``k`` segments (window
    w owns segments [w*k, (w+1)*k)), and pad each window's span run to a
    ``block`` multiple so every block touches exactly one window.

    Returns numpy ``(sid_local[T], planes[6, T], wids[T // block])``;
    padding rows carry ``sid_local = 0`` with all-zero planes, which add
    nothing to any output plane."""
    sid = np.asarray(sid, np.int32)
    planes = np.asarray(planes, np.float32)
    n = sid.shape[0]
    nw = (n_segments + 1 + k - 1) // k      # + dead lane
    order = np.argsort(sid, kind="stable")
    sid_s = sid[order]
    wid_s = sid_s // k
    counts = np.bincount(wid_s, minlength=nw)
    padded = -(-counts // block) * block    # per-window ceil to block
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pad_starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    total = int(padded.sum())
    dst = (pad_starts[wid_s] + (np.arange(n) - starts[wid_s])).astype(np.int64)
    sid_local = np.zeros(total, np.int32)
    sid_local[dst] = sid_s - wid_s * k
    planes_out = np.zeros((planes.shape[0], total), np.float32)
    planes_out[:, dst] = planes[:, order]
    wids = np.repeat(np.arange(nw, dtype=np.int32), padded // block)
    return sid_local, planes_out, wids


def replay_planes_numpy(sid, planes, n_segments, n_hist):
    """Numpy oracle of both kernels (planes feature-major [6, N], no bf16
    rounding): the reference every kernel is checked against."""
    out = np.zeros((n_segments + 1, N_PLANES + n_hist), np.float32)
    np.add.at(out[:, :N_PLANES], sid, planes.T)
    valid = planes[0]
    bucket = np.clip(planes[4].astype(np.int32), 0, n_hist - 1)
    np.add.at(out, (sid, N_PLANES + bucket), valid)
    return out[:n_segments]

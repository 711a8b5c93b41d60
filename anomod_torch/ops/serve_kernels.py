"""The serve-tick kernels (counterpart of the serve half of
``anomod/ops/pallas_replay.py``).

``lane_delta`` replaces ``make_pallas_lane_delta_fn`` (pallas_replay.py:150)
and ``window_gather`` replaces ``make_pallas_window_gather_fn``
(pallas_replay.py:354).  The CUDA sources are in
``anomod_torch/csrc/serve.cu``.

``lane_delta`` computes the JAX scatter engine's per-lane deltas
(``make_lane_delta(engine="scatter")``): 25 f32 payload columns a span,
summed per (lane, segment, column) in row order, with ``hi + lo`` taken
only at the end.  Its plain version is an ``index_add_`` over the same
payload, which on the CPU adds in row order too, so on the CPU the port's
lane deltas equal the JAX engine's bit for bit.  The kernel sorts each
lane's rows by segment with a stable counting sort and sums each
(segment, column) in row order, so it equals the plain version run on
the host bit for bit (``tests/test_torch_serve_kernels.py`` restates its
order of operations in numpy).  On the card the plain version's
``index_add_`` adds in no fixed order: the kernel is held against it with
the exact planes equal and the moments within a stated tolerance.

``window_gather`` copies one window column per requested tenant out of
the device state pool, ``[P, S*W, F]`` -> ``[T, S, F]``; its plain
version is advanced indexing.  Both are pure copies and bit-identical.
It takes the tenants' slots and columns as host arrays: the kernel
receives them by value in its parameter space (:data:`GATHER_PAIRS`
pairs a launch; :func:`gather_plan` splits a larger request), so no
index is copied to the card and the kernel reads none from its memory.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises, on the calling thread's
current stream (a serve shard's own).  ``launches`` counts kernel
launches per wrapper, under a lock: shard workers launch concurrently.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from anomod_torch.ops.replay_kernels import (N_PAYLOAD, N_PLANES, _check,
                                             _on_cuda, _ptr, _stream,
                                             recombine_moments,
                                             replay_payload)

#: kernel launches per wrapper, counted where the wrapper launches its
#: kernel and nowhere else (a CPU tensor takes the plain version: no count)
launches: Dict[str, int] = {"lane_delta": 0, "window_gather": 0}
#: the serve engine's shard workers launch from several threads at once
_LAUNCH_LOCK = threading.Lock()

#: shared-memory ceiling a lane-delta block may ask for (H100: 227 KB)
SMEM_LIMIT = 200 * 1024
#: fewest segments a lane-delta block owns: below this, blocks would redo
#: the lane's counting sort for little fold work each
MIN_SEGMENTS_PER_BLOCK = 32
#: bytes of kernel parameters a launch may pass on every CUDA version
PARAM_LIMIT = 4096
#: bytes of the window gather's parameter block ahead of its pairs
GATHER_HEADER = 40
#: (slot, col) pairs one window-gather launch carries (``kGatherPairs``
#: in ``csrc/serve.cu``), 8 bytes each
GATHER_PAIRS = (PARAM_LIMIT - GATHER_HEADER) // 8


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _LAUNCH_LOCK:
        launches[name] += 1


def lane_delta_plain(sid: torch.Tensor, planes: torch.Tensor,
                     n_segments: int, n_hist: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`lane_delta`: one ``index_add_``
    over ``L * (SW+1)`` segments (each lane's dead segment absorbs its
    padding rows and is dropped)."""
    L, W = sid.shape
    SW1 = n_segments + 1
    pay = replay_payload(planes, n_hist).reshape(L * W, N_PAYLOAD + n_hist)
    lane = torch.arange(L, device=sid.device, dtype=torch.long)[:, None]
    idx = (lane * SW1 + sid.long()).reshape(-1)
    acc = torch.zeros((L * SW1, N_PAYLOAD + n_hist), dtype=torch.float32,
                      device=sid.device)
    acc.index_add_(0, idx, pay)
    return recombine_moments(acc.reshape(L, SW1, -1)[:, :n_segments])


def window_gather_plain(pool: torch.Tensor, slots: torch.Tensor,
                        cols: torch.Tensor, n_services: int,
                        n_windows: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`window_gather`: advanced indexing."""
    P, _, F = pool.shape
    rows = pool.reshape(P, n_services, n_windows, F)
    svc = torch.arange(n_services, device=pool.device)[None, :]
    return rows[slots.long()[:, None], svc, cols.long()[:, None]]


def gather_plan(n_tenants: int,
                capacity: int = GATHER_PAIRS) -> List[Tuple[int, int]]:
    """The window gather's launches for ``n_tenants`` requested tenants:
    ``[lo, hi)`` ranges in order, covering every tenant once, as few as
    ``capacity`` pairs a launch allows and of sizes within one of each
    other."""
    if n_tenants < 0 or capacity < 1:
        raise ValueError("n_tenants must be >= 0 and capacity >= 1")
    n = -(-n_tenants // capacity)
    return [(n_tenants * k // n, n_tenants * (k + 1) // n) for k in range(n)]


_LIB = None


def _lib() -> ctypes.CDLL:
    """The built kernel library, with every entry's C signature declared."""
    global _LIB
    if _LIB is None:
        from anomod_torch.ops._build import library
        lib = library("serve")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.anomod_lane_delta.argtypes = [vp, vp, i32, i32, i32, i32, i32,
                                          vp, vp]
        lib.anomod_lane_delta.restype = i32
        lib.anomod_lane_delta_smem.argtypes = [i32, i32]
        lib.anomod_lane_delta_smem.restype = i32
        lib.anomod_window_gather.argtypes = [vp, i32, i32, i32, i32, vp,
                                             i32, vp, vp]
        lib.anomod_window_gather.restype = i32
        lib.anomod_window_gather_capacity.restype = i32
        if lib.anomod_window_gather_capacity() != GATHER_PAIRS:
            raise RuntimeError("csrc/serve.cu's kGatherPairs != "
                               f"GATHER_PAIRS ({GATHER_PAIRS})")
        lib.anomod_serve_error_string.argtypes = [i32]
        lib.anomod_serve_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().anomod_serve_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def lane_segments_per_block(n_lanes: int, n_segments: int, n_sm: int,
                            max_per_block: int) -> int:
    """Segments each lane-delta block owns: a lane's ``SW`` segments are
    split over ``G = ceil(SW / Sg)`` blocks so that ``L x G`` gives the
    card's ``n_sm`` SMs two blocks each, with at least
    :data:`MIN_SEGMENTS_PER_BLOCK` a block (or all SW) and at most
    ``max_per_block`` (what shared memory holds).  The kernel's output
    does not depend on the choice."""
    if max_per_block < 1:
        raise ValueError("not one segment's accumulator fits a lane-delta "
                         "block's shared memory (n_hist too large)")
    groups = max(1, -(-2 * n_sm // max(n_lanes, 1)))
    per = max(-(-n_segments // groups), MIN_SEGMENTS_PER_BLOCK)
    return max(1, min(per, n_segments, max_per_block))


def lane_delta(sid: torch.Tensor, planes: torch.Tensor, n_segments: int,
               n_hist: int) -> torch.Tensor:
    """``sid int32[L, W]``, ``planes f32[L, 6, W]`` -> per-lane deltas
    ``f32[L, SW, 6+H]``.

    ``sid`` holds segment ids in ``[0, SW]``; ``SW`` is the dead padding
    lane, dropped, so an all-dead lane gives exact zeros.  CPU tensors
    take :func:`lane_delta_plain`."""
    if sid.dim() != 2:
        raise ValueError(f"sid must be [L, W], got {tuple(sid.shape)}")
    L, W = sid.shape
    if n_segments < 1 or not 1 <= n_hist <= 65536:
        raise ValueError("n_segments must be >= 1 and n_hist in [1, 65536]")
    _check("sid", sid, torch.int32, (L, W))
    _check("planes", planes, torch.float32, (L, N_PLANES, W))
    if not _on_cuda(sid, planes):
        return lane_delta_plain(sid, planes, n_segments, n_hist)
    lib = _lib()
    # the block's shared memory is linear in the segments it owns
    one = lib.anomod_lane_delta_smem(1, n_hist)
    per_seg = lib.anomod_lane_delta_smem(2, n_hist) - one
    n_sm = torch.cuda.get_device_properties(sid.device).multi_processor_count
    sg = lane_segments_per_block(L, n_segments, n_sm,
                                 1 + (SMEM_LIMIT - one) // per_seg)
    out = torch.empty((L, n_segments, N_PLANES + n_hist),
                      dtype=torch.float32, device=sid.device)
    err = lib.anomod_lane_delta(_ptr(sid), _ptr(planes), L, W, n_segments,
                                n_hist, sg, _ptr(out), _stream(sid.device))
    _raise_on(err, "anomod_lane_delta")
    _count("lane_delta")
    return out


def _host_index(name: str, x) -> np.ndarray:
    """A host index array (numpy or a CPU tensor) as int32 numpy; a
    tensor on any other device raises: the kernel takes its indices by
    value from the host."""
    if torch.is_tensor(x):
        if x.device.type != "cpu":
            raise ValueError(f"{name} must be a host array (numpy or a CPU "
                             f"tensor), got a tensor on {x.device}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {x.dtype}")
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype != np.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if x.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got shape {x.shape}")
    return x


def window_gather(pool: torch.Tensor, slots, cols, n_services: int,
                  n_windows: int) -> torch.Tensor:
    """``pool f32[P, S*W, F]`` and host ``slots int32[T]``, ``cols
    int32[T]`` (numpy or CPU tensors) -> ``f32[T, S, F]`` on the pool's
    device: tenant t's window column ``cols[t]`` of pool row
    ``slots[t]``.  A pool on the CPU takes :func:`window_gather_plain`;
    on the card, one launch a :func:`gather_plan` range."""
    if pool.dim() != 3:
        raise ValueError(f"pool must be [P, S*W, F], got {tuple(pool.shape)}")
    P, SW, F = pool.shape
    if SW != n_services * n_windows:
        raise ValueError(f"pool rows {SW} != {n_services} x {n_windows}")
    slots = _host_index("slots", slots)
    cols = _host_index("cols", cols)
    T = slots.shape[0]
    if cols.shape != (T,):
        raise ValueError(f"cols must have shape ({T},), got {cols.shape}")
    _check("pool", pool, torch.float32, (P, SW, F))
    if not _on_cuda(pool):
        return window_gather_plain(pool, torch.from_numpy(slots),
                                   torch.from_numpy(cols), n_services,
                                   n_windows)
    lib = _lib()
    out = torch.empty((T, n_services, F), dtype=torch.float32,
                      device=pool.device)
    pairs = np.stack([slots, cols], axis=1)
    stream = _stream(pool.device)
    row = n_services * F * 4
    for lo, hi in gather_plan(T):
        err = lib.anomod_window_gather(
            _ptr(pool), P, n_services, n_windows, F, pairs[lo:].ctypes.data,
            hi - lo, out.data_ptr() + lo * row, stream)
        _raise_on(err, "anomod_window_gather")
        _count("window_gather")
    return out

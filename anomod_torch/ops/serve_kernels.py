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

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``launches`` counts kernel
launches per wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from anomod_torch.ops.replay_kernels import (N_PLANES, _bf16, _check,
                                             _on_cuda, _ptr, _stream)

#: payload columns a span carries into the lane sums: exact (valid, err,
#: 5xx), moment hi x3, moment lo x3; the histogram one-hot follows
N_PAYLOAD = 9

#: kernel launches per wrapper, counted where the wrapper launches its
#: kernel and nowhere else (a CPU tensor takes the plain version: no count)
launches: Dict[str, int] = {"lane_delta": 0, "window_gather": 0}

#: shared-memory ceiling a lane-delta block may ask for (H100: 227 KB)
SMEM_LIMIT = 200 * 1024
#: fewest segments a lane-delta block owns: below this, blocks would redo
#: the lane's counting sort for little fold work each
MIN_SEGMENTS_PER_BLOCK = 32


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def lane_payload(planes: torch.Tensor, n_hist: int) -> torch.Tensor:
    """``planes f32[L, 6, W]`` -> the ``[L, W, 9+H]`` payload rows of the
    scatter engine (``_scatter_rhs``): bf16 exact planes, bf16 hi and lo
    of each moment, and ``bf16(valid)`` at histogram bucket
    ``clamp(int(dur), 0, H-1)``."""
    p = planes.transpose(1, 2)                         # [L, W, 6]
    exact = _bf16(p[..., 0:3])
    mom = p[..., 3:6]
    hi = _bf16(mom)
    lo = _bf16(mom - hi)
    bucket = p[..., 4].to(torch.int32).clamp(0, n_hist - 1).long()
    hist = torch.zeros(p.shape[:2] + (n_hist,), dtype=torch.float32,
                       device=planes.device)
    hist.scatter_(2, bucket[..., None], exact[..., 0:1])
    return torch.cat([exact, hi, lo, hist], dim=-1)


def lane_delta_plain(sid: torch.Tensor, planes: torch.Tensor,
                     n_segments: int, n_hist: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`lane_delta`: one ``index_add_``
    over ``L * (SW+1)`` segments (each lane's dead segment absorbs its
    padding rows and is dropped)."""
    L, W = sid.shape
    SW1 = n_segments + 1
    pay = lane_payload(planes, n_hist).reshape(L * W, N_PAYLOAD + n_hist)
    lane = torch.arange(L, device=sid.device, dtype=torch.long)[:, None]
    idx = (lane * SW1 + sid.long()).reshape(-1)
    acc = torch.zeros((L * SW1, N_PAYLOAD + n_hist), dtype=torch.float32,
                      device=sid.device)
    acc.index_add_(0, idx, pay)
    acc = acc.reshape(L, SW1, -1)[:, :n_segments]
    return torch.cat([acc[..., 0:3], acc[..., 3:6] + acc[..., 6:9],
                      acc[..., 9:]], dim=-1)


def window_gather_plain(pool: torch.Tensor, slots: torch.Tensor,
                        cols: torch.Tensor, n_services: int,
                        n_windows: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`window_gather`: advanced indexing."""
    P, _, F = pool.shape
    rows = pool.reshape(P, n_services, n_windows, F)
    svc = torch.arange(n_services, device=pool.device)[None, :]
    return rows[slots.long()[:, None], svc, cols.long()[:, None]]


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
        lib.anomod_window_gather.argtypes = [vp, i32, i32, i32, i32, vp, vp,
                                             i32, vp, vp]
        lib.anomod_window_gather.restype = i32
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
    launches["lane_delta"] += 1
    return out


def window_gather(pool: torch.Tensor, slots: torch.Tensor,
                  cols: torch.Tensor, n_services: int,
                  n_windows: int) -> torch.Tensor:
    """``pool f32[P, S*W, F]``, ``slots int32[T]``, ``cols int32[T]`` ->
    ``f32[T, S, F]``: tenant t's window column ``cols[t]`` of pool row
    ``slots[t]``.  CPU tensors take :func:`window_gather_plain`."""
    if pool.dim() != 3:
        raise ValueError(f"pool must be [P, S*W, F], got {tuple(pool.shape)}")
    P, SW, F = pool.shape
    if SW != n_services * n_windows:
        raise ValueError(f"pool rows {SW} != {n_services} x {n_windows}")
    T = slots.shape[0]
    _check("pool", pool, torch.float32, (P, SW, F))
    _check("slots", slots, torch.int32, (T,))
    _check("cols", cols, torch.int32, (T,))
    if not _on_cuda(pool, slots, cols):
        return window_gather_plain(pool, slots, cols, n_services, n_windows)
    lib = _lib()
    out = torch.empty((T, n_services, F), dtype=torch.float32,
                      device=pool.device)
    err = lib.anomod_window_gather(_ptr(pool), P, n_services, n_windows, F,
                                   _ptr(slots), _ptr(cols), T, _ptr(out),
                                   _stream(pool.device))
    _raise_on(err, "anomod_window_gather")
    launches["window_gather"] += 1
    return out

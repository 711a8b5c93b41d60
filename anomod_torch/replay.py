"""Span-stream replay on the card (counterpart of ``anomod/replay.py``).

An experiment corpus is replayed *as data*: span columns are staged on the
host (``stage_columns``), copied to the card, and folded into the
per-(service, window) planes — a ``[S*W, 6]`` moment plane (count, errors,
5xx, latency, log-latency, log-latency²) and a ``[S*W, H]`` log-latency
histogram.  The fold is the hand-written dense CUDA kernel
(``ops.replay_kernels.replay_dense``); the sorted-window kernel and the
one-hot matmul are the other engines ``measure_throughput`` can time.
Spans per second of that fold is the replay's headline metric.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.ops.replay_kernels import (replay_dense, replay_payload,
                                             replay_sorted,
                                             stage_sorted_planes)
from anomod_torch.schemas import SpanBatch

# Feature plane order: the three exact 0/1 columns, then the three latency
# moments.
F_COUNT, F_ERR, F_STATUS5XX, F_LAT, F_LOGLAT, F_LOGLAT2 = range(6)
N_FEATS = 6

KERNELS = ("cuda", "cuda-sorted", "matmul", "numpy")


class ReplayState(NamedTuple):
    agg: "object"          # [S*W, F] float32
    hist: "object"         # [S*W, H] float32 — log-latency histogram
    hll: "object" = None   # [S, 2^p] int32 — carried, not yet computed


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    n_services: int
    n_windows: int = 32
    n_hist_buckets: int = 16
    chunk_size: int = 1 << 15
    window_us: int = 60_000_000  # 60 s windows

    @property
    def sw(self) -> int:
        return self.n_services * self.n_windows


def segment_ids(batch: SpanBatch, cfg: ReplayConfig,
                t0_us: Optional[int] = None) -> np.ndarray:
    """[n] int32 (service, window) segment id per span — the one definition
    of the replay's segment binning."""
    n = batch.n_spans
    t0 = int(batch.start_us.min()) if t0_us is None and n else (t0_us or 0)
    window = np.minimum((batch.start_us - t0) // cfg.window_us,
                        cfg.n_windows - 1).astype(np.int32)
    window = np.maximum(window, 0)
    return batch.service.astype(np.int32) * cfg.n_windows + window


#: the chunk column schema's row order in the staged matrix
STAGE_KEYS = ("sid", "dur", "dur_raw", "err", "s5", "valid", "tid")


def stage_columns_fused(batch: SpanBatch, cfg: ReplayConfig,
                        t0_us: Optional[int] = None):
    """UNPADDED per-span chunk columns staged as ONE C-contiguous
    ``[7, n]`` float32 matrix (``sid``/``tid`` live as int32 row views) —
    ``(mat, columns)`` where ``columns`` maps :data:`STAGE_KEYS` to row
    views of ``mat``."""
    n = batch.n_spans
    mat = np.empty((len(STAGE_KEYS), n), np.float32)
    sid = mat[0].view(np.int32)
    sid[:] = segment_ids(batch, cfg, t0_us)
    dur_raw = mat[2]
    np.copyto(dur_raw, batch.duration_us, casting="unsafe")
    np.log1p(dur_raw, out=mat[1])
    np.copyto(mat[3], batch.is_error, casting="unsafe")
    np.copyto(mat[4], batch.status >= 500, casting="unsafe")
    mat[5].fill(1.0)
    tid = mat[6].view(np.int32)
    np.copyto(tid, batch.trace, casting="unsafe")
    return mat, dict(sid=sid, dur=mat[1], dur_raw=dur_raw, err=mat[3],
                     s5=mat[4], valid=mat[5], tid=tid)


def stage_columns_raw(batch: SpanBatch, cfg: ReplayConfig,
                      t0_us: Optional[int] = None) -> dict:
    """UNPADDED per-span chunk columns (row views of one staged matrix)."""
    return stage_columns_fused(batch, cfg, t0_us)[1]


def stage_columns(batch: SpanBatch, cfg: ReplayConfig,
                  t0_us: Optional[int] = None):
    """Host-side packing: SpanBatch -> padded ``[n_chunks, C]`` int32/float32
    chunk arrays, plus the real span count.  Padding rows target the dead
    segment ``SW`` with all-zero planes."""
    n = batch.n_spans
    pad = (-n) % cfg.chunk_size
    raw = stage_columns_raw(batch, cfg, t0_us)

    def p(a, fill=0):
        return np.pad(a, (0, pad), constant_values=fill)
    cols = {k: p(v, fill=cfg.sw if k == "sid" else 0)
            for k, v in raw.items()}
    n_chunks = (n + pad) // cfg.chunk_size
    return {k: v.reshape(n_chunks, cfg.chunk_size) for k, v in cols.items()}, n


def dead_chunk(cfg: ReplayConfig, device: DeviceLike = None,
               width: Optional[int] = None) -> dict:
    """An all-dead staged chunk on ``device`` (sid = the dead pad lane,
    valid = 0) — numerically a no-op on any replay state; the warm-up
    input that builds the kernels before a timed push."""
    device = resolve_device(device)
    w = int(width or cfg.chunk_size)

    def z(dtype):
        return torch.zeros((w,), dtype=dtype, device=device)
    return {"sid": torch.full((w,), cfg.sw, dtype=torch.int32,
                              device=device),
            "dur": z(torch.float32), "dur_raw": z(torch.float32),
            "err": z(torch.float32), "s5": z(torch.float32),
            "valid": z(torch.float32), "tid": z(torch.int32)}


def zero_state(cfg: ReplayConfig, device: DeviceLike = None) -> ReplayState:
    device = resolve_device(device)
    return ReplayState(
        agg=torch.zeros((cfg.sw, N_FEATS), dtype=torch.float32,
                        device=device),
        hist=torch.zeros((cfg.sw, cfg.n_hist_buckets), dtype=torch.float32,
                         device=device))


def stage_planes(chunks, xp=np):
    """Flatten staged chunk columns into the kernels' layout: ``sid [N]``
    plus the feature-major ``[6, N]`` plane stack (valid, err, 5xx,
    dur_raw, dur, dur²).  ``xp`` is numpy for host arrays, torch for
    tensors (the counterpart of ``stage_pallas_planes``)."""
    sid = chunks["sid"].reshape(-1)
    dur = chunks["dur"].reshape(-1)
    planes = xp.stack([
        chunks["valid"].reshape(-1),
        chunks["err"].reshape(-1),
        chunks["s5"].reshape(-1),
        chunks["dur_raw"].reshape(-1),
        dur,
        dur * dur,
    ])
    return sid, planes


def kernel_block(chunk_size: int) -> int:
    """Block size of the sorted-window kernel for a staged corpus (the
    counterpart of ``pallas_block``): must divide the span count (a
    chunk_size multiple) — chunk_size's largest power-of-2 factor, capped
    at 4096."""
    block = min(4096, chunk_size & -chunk_size)
    if block < 128:
        raise ValueError(
            "the sorted replay kernel needs chunk_size with a power-of-2 "
            f"factor >= 128; got chunk_size={chunk_size}")
    return block


def _split(acc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return acc[:, :N_FEATS], acc[:, N_FEATS:]


def make_chunk_step(cfg: ReplayConfig):
    """The per-chunk fold shared by the stream: ``step(state, chunk) ->
    state`` through :func:`replay_dense` (the CUDA kernel for tensors on
    the card, its plain version on the CPU)."""
    SW, H = cfg.sw, cfg.n_hist_buckets

    def step(state: ReplayState, chunk) -> ReplayState:
        sid, planes = stage_planes(chunk, xp=torch)
        dagg, dhist = _split(replay_dense(sid, planes, SW, H))
        return state._replace(agg=state.agg + dagg, hist=state.hist + dhist)

    return step


def _as_tensors(chunks, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in chunks.items()}


def make_replay_fn(cfg: ReplayConfig, inner_repeats: int = 1,
                   device: DeviceLike = None):
    """``replay(chunks) -> ReplayState`` over staged ``[n_chunks, C]``
    chunk columns: the whole corpus in ONE dense-kernel launch, which folds
    it ``inner_repeats`` times (device-side replication for throughput
    measurement; the counterpart of the JAX scan + fori_loop)."""
    device = resolve_device(device)
    SW, H = cfg.sw, cfg.n_hist_buckets

    def replay(chunks) -> ReplayState:
        sid, planes = stage_planes(_as_tensors(chunks, device), xp=torch)
        agg, hist = _split(replay_dense(sid.contiguous(), planes, SW, H,
                                        inner_repeats=inner_repeats))
        return ReplayState(agg=agg, hist=hist)

    return replay


def make_matmul_replay_fn(cfg: ReplayConfig, inner_repeats: int = 1,
                          device: DeviceLike = None):
    """The one-hot formulation (counterpart of the JAX ``matmul`` chunk
    step): per chunk, a ``[C, SW+1]`` one-hot contracted with the kernels'
    ``[C, 6+H]`` rounded payload (``replay_payload``).  With TF32 off
    (PyTorch's default) every product is exact and the sums accumulate in
    f32, as the MXU's do."""
    device = resolve_device(device)
    SW, H = cfg.sw, cfg.n_hist_buckets

    def replay(chunks) -> ReplayState:
        chunks = _as_tensors(chunks, device)
        n_chunks, C = chunks["sid"].shape
        rows = torch.arange(C, device=device)
        acc = torch.zeros((SW + 1, N_FEATS + H), dtype=torch.float32,
                          device=device)
        for _ in range(inner_repeats):
            for i in range(n_chunks):
                sid, planes = stage_planes({k: v[i] for k, v in
                                            chunks.items()}, xp=torch)
                onehot = torch.zeros((C, SW + 1), dtype=torch.float32,
                                     device=device)
                onehot[rows, sid.long()] = 1.0
                acc += torch.matmul(onehot.T, replay_payload(planes, H))
        return ReplayState(*_split(acc[:SW]))

    return replay


def replay_numpy(chunks, cfg: ReplayConfig) -> ReplayState:
    """Host oracle (and the host engine) for the replay aggregation."""
    SW, H = cfg.sw, cfg.n_hist_buckets
    agg = np.zeros((SW, N_FEATS), np.float32)
    hist = np.zeros((SW, H), np.float32)
    sid = chunks["sid"].reshape(-1)
    valid = chunks["valid"].reshape(-1) > 0
    sid = sid[valid]
    feats = np.stack([
        chunks["valid"].reshape(-1)[valid],
        chunks["err"].reshape(-1)[valid],
        chunks["s5"].reshape(-1)[valid],
        chunks["dur_raw"].reshape(-1)[valid],
        chunks["dur"].reshape(-1)[valid],
        (chunks["dur"] ** 2).reshape(-1)[valid],
    ], axis=1)
    np.add.at(agg, sid, feats.astype(np.float32))
    bucket = np.clip(chunks["dur"].reshape(-1)[valid].astype(np.int32), 0, H - 1)
    np.add.at(hist, (sid, bucket), 1.0)
    return ReplayState(agg=agg, hist=hist)


def percentile_from_hist(hist: np.ndarray, q: float,
                         as_us: bool = False) -> np.ndarray:
    """Per-row percentile from the log-latency histogram, linearly
    interpolated within the winning bucket (``as_us`` converts the
    log1p-µs value back to µs)."""
    cum = np.cumsum(hist, axis=-1)
    total = cum[..., -1:]
    target = q * np.maximum(total, 1e-30)
    idx = np.minimum((cum < target).sum(axis=-1), hist.shape[-1] - 1)
    in_bucket = np.take_along_axis(hist, idx[..., None], axis=-1)[..., 0]
    below = np.take_along_axis(np.concatenate(
        [np.zeros_like(cum[..., :1]), cum], axis=-1),
        idx[..., None], axis=-1)[..., 0]
    frac = np.where(in_bucket > 0,
                    (target[..., 0] - below) / np.maximum(in_bucket, 1e-30),
                    0.5)
    p = idx.astype(np.float32) + np.clip(frac, 0.0, 1.0).astype(np.float32)
    p = np.where(total[..., 0] > 0, p, 0.0).astype(np.float32)  # empty row = 0
    return np.expm1(p).astype(np.float32) if as_us else p


@dataclasses.dataclass
class ThroughputResult:
    n_spans: int
    wall_s: float
    spans_per_sec: float
    compile_s: float                    # first run: kernel build + warm-up
    kernel: str
    device: str
    raw_wall_s: Tuple[float, ...] = ()  # per-repeat walls (median -> wall_s)
    #: the last run's planes on the host, summed over all ``replicate``
    #: passes
    state: Optional[ReplayState] = None


def _host_state(st: ReplayState) -> ReplayState:
    return ReplayState(agg=st.agg.cpu().numpy(), hist=st.hist.cpu().numpy())


def measure_throughput(batch: SpanBatch, cfg: Optional[ReplayConfig] = None,
                       repeats: int = 3, replicate: int = 1,
                       kernel: str = "cuda",
                       device: DeviceLike = None) -> ThroughputResult:
    """Warm up, then time the replay over the staged corpus.

    Each run reads the planes back to the host, the barrier that makes the
    wall honest.  ``replicate`` folds the staged corpus that many times on
    the device in one launch.  ``kernel``: "cuda" (the dense CUDA kernel),
    "cuda-sorted" (the sorted-window CUDA kernel over a one-time host
    pre-sort into aligned 128-segment windows), "matmul" (the one-hot
    product through ``torch.matmul``) or "numpy" (the host engine, which
    needs no device).  On ``device="cpu"`` the kernels take their plain
    PyTorch versions."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown replay kernel {kernel!r} "
                         f"(expected one of {KERNELS})")
    if replicate < 1 or repeats < 1:
        raise ValueError("replicate and repeats must be >= 1")
    cfg = cfg or ReplayConfig(n_services=len(batch.services))
    chunks_np, n = stage_columns(batch, cfg)
    n *= replicate
    SW, H = cfg.sw, cfg.n_hist_buckets

    if kernel == "numpy":
        dev_name = "host"

        def run_once():
            agg = np.zeros((SW, N_FEATS), np.float32)
            hist = np.zeros((SW, H), np.float32)
            for _r in range(replicate):
                out = replay_numpy(chunks_np, cfg)
                agg += out.agg
                hist += out.hist
            return ReplayState(agg=agg, hist=hist)
    else:
        from anomod_torch.io.prefetch import device_put_columns
        dev = resolve_device(device)
        dev_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu")
        if kernel == "cuda":
            chunks = device_put_columns(chunks_np, dev)
            rfn = make_replay_fn(cfg, inner_repeats=replicate, device=dev)

            def run_once():
                return _host_state(rfn(chunks))
        elif kernel == "cuda-sorted":
            block = kernel_block(cfg.chunk_size)
            sid_np, planes_np = stage_planes(chunks_np)
            sid_l, planes_s, wids = stage_sorted_planes(sid_np, planes_np, SW,
                                                        block=block)
            staged = device_put_columns(
                {"sid": sid_l, "planes": planes_s, "wids": wids}, dev)

            def run_once():
                return _host_state(ReplayState(*_split(replay_sorted(
                    staged["sid"], staged["planes"], staged["wids"], SW, H,
                    block=block, inner_repeats=replicate))))
        else:
            chunks = device_put_columns(chunks_np, dev)
            mfn = make_matmul_replay_fn(cfg, inner_repeats=replicate,
                                        device=dev)

            def run_once():
                return _host_state(mfn(chunks))

    t0 = time.perf_counter()
    run_once()                                  # kernel build / warm-up
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        state = run_once()
        times.append(time.perf_counter() - t0)
    total = float(state.agg[:, F_COUNT].astype(np.float64).sum())
    # f32 per-segment counts are exact only up to 2^24 spans per segment,
    # hence the small relative slack
    if abs(total - n) > max(8.0, 1e-6 * n):
        raise RuntimeError(f"span count mismatch: {total} != {n}")
    wall = sorted(times)[len(times) // 2]
    return ThroughputResult(n_spans=n, wall_s=wall, spans_per_sec=n / wall,
                            compile_s=compile_s, kernel=kernel,
                            device=dev_name, raw_wall_s=tuple(times),
                            state=state)

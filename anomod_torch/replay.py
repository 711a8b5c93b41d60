"""Span-stream replay on the card (counterpart of ``anomod/replay.py``).

An experiment corpus is replayed *as data*: span columns are staged on the
host (``stage_columns``), copied to the card, and folded into the
per-(service, window) planes — a ``[S*W, 6]`` moment plane (count, errors,
5xx, latency, log-latency, log-latency²) and a ``[S*W, H]`` log-latency
histogram, plus, with ``with_hll``, per-service distinct-trace HLL
registers.  The fold is the hand-written dense CUDA kernel
(``ops.replay_kernels.replay_dense``); the sorted-window kernel and the
one-hot matmul are the other engines ``measure_throughput`` can time.
Spans per second of that fold is the replay's headline metric.

The sketch featurization path (``replay_digests`` / ``replay_percentiles``
over (service, window) segments, ``replay_edge_features`` over
(caller->callee edge, window) segments) builds t-digest planes through
the ``tdigest_reduce`` kernel and per-edge distinct-trace counts through
the ``hll_update`` kernel (``ops.sketch_kernels``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from anomod_torch import obs
from anomod_torch.config import get_config, refuse_on_card
from anomod_torch.device import DeviceLike, device_name, resolve_device
from anomod_torch.ops.hll import hll_add, hll_estimate, hll_init
from anomod_torch.ops.replay_kernels import (PLANES, recombine_moments,
                                             replay_dense, replay_payload,
                                             replay_sorted,
                                             stage_sorted_planes)
from anomod_torch.ops.serve_kernels import lane_delta, window_gather
from anomod_torch.ops.tdigest import (TDigest, tdigest_by_segment,
                                      tdigest_quantile)
from anomod_torch.schemas import SpanBatch

# Feature plane order: the three exact 0/1 columns, then the three latency
# moments.
F_COUNT, F_ERR, F_STATUS5XX, F_LAT, F_LOGLAT, F_LOGLAT2 = range(6)
N_FEATS = 6

KERNELS = ("cuda", "cuda-sorted", "matmul", "numpy")


class ReplayState(NamedTuple):
    agg: "object"          # [S*W, F] float32
    hist: "object"         # [S*W, H] float32 — log-latency histogram
    hll: "object" = None   # [S, 2^p] int32 — distinct-trace registers (opt.)


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    n_services: int
    n_windows: int = 32
    n_hist_buckets: int = 16
    chunk_size: int = 1 << 15
    window_us: int = 60_000_000  # 60 s windows
    hll_p: int = 8               # per-service distinct-trace HLL precision

    @property
    def sw(self) -> int:
        return self.n_services * self.n_windows

    @property
    def hll_m(self) -> int:
        return 1 << self.hll_p


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


def zero_state(cfg: ReplayConfig, device: DeviceLike = None,
               with_hll: bool = False) -> ReplayState:
    device = resolve_device(device)
    return ReplayState(
        agg=torch.zeros((cfg.sw, N_FEATS), dtype=torch.float32,
                        device=device),
        hist=torch.zeros((cfg.sw, cfg.n_hist_buckets), dtype=torch.float32,
                         device=device),
        hll=(hll_init(cfg.hll_p, lanes=cfg.n_services, device=device)
             if with_hll else None))


def hll_scatter_update(regs: torch.Tensor, sid: torch.Tensor,
                       tid: torch.Tensor, cfg: ReplayConfig) -> torch.Tensor:
    """New per-service HLL registers with the staged rows' trace ids
    added (``regs`` is not modified): the one definition of the
    distinct-trace plane.  A row's lane is its service ``clip(sid // W, 0,
    S-1)``; rows with ``sid >= SW`` are padding and go to lane S, which
    the ``hll_update`` kernel drops."""
    sid = sid.reshape(-1)
    svc = torch.clamp(torch.div(sid, cfg.n_windows, rounding_mode="floor"),
                      0, cfg.n_services - 1)
    lane = torch.where(sid < cfg.sw, svc, cfg.n_services)
    return hll_add(regs, tid.reshape(-1), p=cfg.hll_p, lane=lane)


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


def make_chunk_step(cfg: ReplayConfig, with_hll: bool = False):
    """The per-chunk fold shared by the stream: ``step(state, chunk) ->
    state`` through :func:`replay_dense` (the CUDA kernel for tensors on
    the card, its plain version on the CPU); ``with_hll`` also folds the
    chunk's trace ids into ``state.hll`` through :func:`hll_scatter_update`
    (the ``hll_update`` kernel)."""
    SW, H = cfg.sw, cfg.n_hist_buckets

    def step(state: ReplayState, chunk) -> ReplayState:
        sid, planes = stage_planes(chunk, xp=torch)
        dagg, dhist = _split(replay_dense(sid, planes, SW, H))
        hll = (hll_scatter_update(state.hll, chunk["sid"], chunk["tid"], cfg)
               if with_hll else None)
        return ReplayState(agg=state.agg + dagg, hist=state.hist + dhist,
                           hll=hll)

    return step


def stage_lane_planes(chunks):
    """Lane-stacked chunk columns (each ``[L, W]``) -> the lane kernel's
    layout: ``sid int32[L, W]`` and the lane-major ``planes f32[L, 6, W]``
    (valid, err, 5xx, dur_raw, dur, dur²)."""
    dur = chunks["dur"]
    planes = torch.stack([chunks[k] for k in PLANES[:5]] + [dur * dur],
                         dim=1)
    return chunks["sid"].contiguous(), planes


def make_lane_delta(cfg: ReplayConfig):
    """The fused (lane-stacked) dispatch surface of the chunk step.

    Returns ``delta(chunks) -> (dagg, dhist)``: every column in ``chunks``
    is ``[lanes, width]`` (one staged chunk per lane; dead-padded lanes
    carry all-pad rows) and the outputs are ``[lanes, SW, F]`` /
    ``[lanes, SW, H]`` per-lane deltas, through the lane kernel
    (``ops.serve_kernels.lane_delta``; its plain version on the CPU).  A
    lane's delta sums its rows in row order, so ``state + delta[i]`` is
    bit-identical to the JAX scatter engine's step on that lane's chunk,
    whatever the lane count or position."""
    SW, H = cfg.sw, cfg.n_hist_buckets

    def delta(chunks):
        out = lane_delta(*stage_lane_planes(chunks), SW, H)
        return out[..., :N_FEATS], out[..., N_FEATS:]

    return delta


def fold_delta(state: ReplayState, dagg, dhist) -> ReplayState:
    """THE host-seam fold: one lane's delta added to a tenant state with
    one elementwise f32 add per cell (``state + delta``).  The device
    pool's :meth:`TenantStatePool.scatter_fold` performs the same add."""
    return ReplayState(agg=state.agg + dagg, hist=state.hist + dhist)


class TenantStatePool:
    """Per-tenant replay states of the serving plane, resident on one
    device: ``[P+1, SW, F]`` agg and ``[P+1, SW, H]`` hist planes.

    Tenants map to slots at first service (:meth:`acquire`); row 0 is the
    DEAD slot and is never read.  A retired dispatch's fold is
    :meth:`scatter_fold`, ``state + delta`` per live slot in dispatch
    order, never a float atomic; :meth:`gather` and :meth:`put` are pure
    copies, so the ``get_state``/``set_state`` round trip is byte-exact;
    :meth:`roll` is :func:`anomod_torch.stream.roll_ring_state`'s shift
    and zero on one row; :meth:`gather_window` feeds batched window
    scoring through the window-gather kernel.  Every operation does the
    same f32 arithmetic as the per-tenant host seam, so serving with the
    pool and with host states is byte-identical."""

    def __init__(self, cfg: ReplayConfig, capacity: int = 32,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        cap = max(int(capacity), 1)
        # +1: row 0 is the dead slot
        self.agg = torch.zeros((cap + 1, cfg.sw, N_FEATS),
                               dtype=torch.float32, device=self.device)
        self.hist = torch.zeros((cap + 1, cfg.sw, cfg.n_hist_buckets),
                                dtype=torch.float32, device=self.device)
        self._free: list = []
        self._next = 1

    @property
    def capacity(self) -> int:
        return int(self.agg.shape[0]) - 1

    @property
    def live_slots(self) -> int:
        """Slots held by a tenant now."""
        return self._next - 1 - len(self._free)

    def acquire(self) -> int:
        """Map a new tenant to a zeroed slot (>= 1); the pool doubles when
        full (existing rows keep their bits)."""
        if self._free:
            return self._free.pop()
        if self._next > self.capacity:
            grow = max(self.capacity, 1)
            self.agg = torch.cat([self.agg, torch.zeros(
                (grow,) + tuple(self.agg.shape[1:]), dtype=torch.float32,
                device=self.device)])
            self.hist = torch.cat([self.hist, torch.zeros(
                (grow,) + tuple(self.hist.shape[1:]), dtype=torch.float32,
                device=self.device)])
        slot = self._next
        self._next += 1
        return slot

    def release(self, slot: int) -> None:
        """Return a churned tenant's slot to the free list, zeroed."""
        self.put(slot, zero_state(self.cfg, "cpu"))
        self._free.append(int(slot))

    def gather(self, slot: int) -> ReplayState:
        """Host copy of one tenant's state (the get_state seam)."""
        slot = int(slot)   # a None slot must raise, not broadcast
        return ReplayState(agg=self.agg[slot].cpu().clone(),
                           hist=self.hist[slot].cpu().clone())

    def put(self, slot: int, state: ReplayState) -> None:
        """Install a state (numpy or tensors) into a slot (the set_state
        seam); ``put(gather())`` is byte-identical."""
        slot = int(slot)

        def f32(x):
            return (x.to(torch.float32) if torch.is_tensor(x)
                    else torch.as_tensor(np.asarray(x, np.float32)))
        self.agg[slot] = f32(state.agg)
        self.hist[slot] = f32(state.hist)

    def roll(self, slot: int, k: int) -> None:
        """Evict the oldest ``k`` ring windows of one tenant's row: values
        pass through verbatim, the tail is exact 0.0."""
        slot = int(slot)
        cfg = self.cfg
        S, W = cfg.n_services, cfg.n_windows
        shift = min(int(k), W)
        for plane, width in ((self.agg, N_FEATS),
                             (self.hist, cfg.n_hist_buckets)):
            x = plane[slot].view(S, W, width)
            if shift < W:
                x[:, :W - shift] = x[:, shift:].clone()
                x[:, W - shift:] = 0.0
            else:
                x.zero_()

    def scatter_fold(self, slots, dagg: torch.Tensor,
                     dhist: torch.Tensor) -> None:
        """Fold one retired dispatch's deltas: ``pool[slots[i]] +=
        delta[i]`` for the live lanes ``i < len(slots)`` (dead pad lanes
        are skipped).  The lanes split into WAVES (the k-th occurrence of
        a slot in wave k), each an index_put of ``row + delta`` over
        distinct slots, so a duplicated slot folds in lane order,
        ``(state + d_i) + d_j``."""
        waves: list = []
        seen: dict = {}
        for i, s in enumerate(int(s) for s in slots):
            k = seen.get(s, 0)
            seen[s] = k + 1
            if k == len(waves):
                waves.append(([], []))
            waves[k][0].append(i)
            waves[k][1].append(s)
        for lanes, wslots in waves:
            li = torch.as_tensor(lanes, device=self.device)
            si = torch.as_tensor(wslots, device=self.device)
            self.agg.index_put_((si,), self.agg[si] + dagg[li])
            self.hist.index_put_((si,), self.hist[si] + dhist[li])

    def gather_window(self, slots, cols) -> np.ndarray:
        """``[T, S, F]`` host copy of one window column per tenant (the
        batched scorer's gather): only the scored columns leave the
        device, through the window-gather kernel, which takes the host
        indices by value (nothing is copied to the card for them)."""
        slots = np.asarray(slots, np.int32)
        cols = np.asarray(cols, np.int32)
        cfg = self.cfg
        if slots.size and (slots.min() < 0 or slots.max() > self.capacity
                           or cols.min() < 0
                           or cols.max() >= cfg.n_windows):
            raise IndexError("gather_window: slot or column out of range")
        out = window_gather(self.agg, slots, cols, cfg.n_services,
                            cfg.n_windows)
        return out.cpu().numpy()

    def gather_rows(self, slots) -> np.ndarray:
        """``[T, SW, F]`` host copy of whole agg rows."""
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        return self.agg[idx].cpu().numpy()

    def warm(self) -> float:
        """One gather of the dead slot: builds and first-launches the
        gather kernel outside the measured serve wall.  Returns the
        wall."""
        t0 = time.perf_counter()
        self.gather_window([0], [0])
        return time.perf_counter() - t0


def _as_tensors(chunks, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in chunks.items()}


def make_replay_fn(cfg: ReplayConfig, inner_repeats: int = 1,
                   device: DeviceLike = None, with_hll: bool = False):
    """``replay(chunks) -> ReplayState`` over staged ``[n_chunks, C]``
    chunk columns: the whole corpus in ONE dense-kernel launch, which folds
    it ``inner_repeats`` times (device-side replication for throughput
    measurement; the counterpart of the JAX scan + fori_loop).
    ``with_hll`` adds the per-service distinct-trace registers ``[S,
    2^p]`` in ONE ``hll_update`` launch (a register max: replicating the
    corpus leaves it unchanged)."""
    device = resolve_device(device)
    SW, H = cfg.sw, cfg.n_hist_buckets

    def replay(chunks) -> ReplayState:
        staged = _as_tensors(chunks, device)
        sid, planes = stage_planes(staged, xp=torch)
        agg, hist = _split(replay_dense(sid.contiguous(), planes, SW, H,
                                        inner_repeats=inner_repeats))
        hll = None
        if with_hll:
            hll = hll_scatter_update(
                hll_init(cfg.hll_p, lanes=cfg.n_services, device=device),
                staged["sid"], staged["tid"], cfg)
        return ReplayState(agg=agg, hist=hist, hll=hll)

    return replay


def make_matmul_replay_fn(cfg: ReplayConfig, inner_repeats: int = 1,
                          device: DeviceLike = None):
    """The one-hot formulation (counterpart of the JAX ``matmul`` chunk
    step): per chunk, a ``[C, SW+1]`` one-hot contracted with the dense
    fold's ``[C, 9+H]`` rounded payload (``replay_payload``), each
    moment's hi and lo sums added after the product and the chunk's sums
    then added to the state, as the JAX step does.  With TF32 off
    (PyTorch's default) every product is exact and the sums accumulate in
    f32, as the MXU's do."""
    device = resolve_device(device)
    SW, H = cfg.sw, cfg.n_hist_buckets

    def replay(chunks) -> ReplayState:
        chunks = _as_tensors(chunks, device)
        n_chunks, C = chunks["sid"].shape
        rows = torch.arange(C, device=device)
        acc = torch.zeros((SW, N_FEATS + H), dtype=torch.float32,
                          device=device)
        for _ in range(inner_repeats):
            for i in range(n_chunks):
                sid, planes = stage_planes({k: v[i] for k, v in
                                            chunks.items()}, xp=torch)
                onehot = torch.zeros((C, SW + 1), dtype=torch.float32,
                                     device=device)
                onehot[rows, sid.long()] = 1.0
                acc += recombine_moments(torch.matmul(
                    onehot.T, replay_payload(planes, H))[:SW])
        return ReplayState(*_split(acc))

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


def _digests_from_staged(chunks, cfg: ReplayConfig, k: int,
                         device: DeviceLike) -> TDigest:
    """Per-segment t-digest plane from already-staged host chunk columns:
    the log1p-µs durations of the real rows, staged per segment on the
    host, built on ``device`` through the ``tdigest_reduce`` kernel, read
    back as host numpy ``[SW, K]``.  On the card an
    ``ANOMOD_TDIGEST_ENGINE`` that names a JAX formulation (``host``,
    ``xla``) is refused first."""
    dev = resolve_device(device)
    refuse_on_card("ANOMOD_TDIGEST_ENGINE", get_config().tdigest_engine, dev)
    sid = chunks["sid"].reshape(-1)
    dur = chunks["dur"].reshape(-1)       # log1p(duration_us), staged
    real = sid < cfg.sw
    d = tdigest_by_segment(dur[real], sid[real], cfg.sw, k=k, device=dev)
    return TDigest(mean=d.mean.cpu().numpy(), weight=d.weight.cpu().numpy())


def _quantiles_us(digests: TDigest, qs) -> np.ndarray:
    out = np.stack([np.expm1(tdigest_quantile(digests, q)) for q in qs],
                   axis=-1)
    return out.astype(np.float32)


def replay_digests(batch: SpanBatch, cfg: Optional[ReplayConfig] = None,
                   k: int = 64, device: DeviceLike = None) -> TDigest:
    """The per-(service, window) t-digest plane over the exact segments the
    replay aggregates: ``[S*W, K]`` log1p-µs digests, host numpy (one
    device transfer however many quantiles are queried afterwards)."""
    cfg = cfg or ReplayConfig(n_services=len(batch.services))
    chunks, _ = stage_columns(batch, cfg)
    return _digests_from_staged(chunks, cfg, k, device)


def replay_percentiles(batch: SpanBatch, cfg: Optional[ReplayConfig] = None,
                       qs: Tuple[float, ...] = (0.5, 0.95, 0.99),
                       k: int = 64, device: DeviceLike = None) -> np.ndarray:
    """Per-(service, window) latency percentiles in µs from the
    :func:`replay_digests` plane: ``[S*W, len(qs)]`` float32."""
    return _quantiles_us(replay_digests(batch, cfg, k=k, device=device), qs)


def edge_keyed_batch(batch: SpanBatch):
    """Re-key spans to observed call-graph edges: each span maps to the
    (parent-service, own-service) edge (roots and own-parented spans to
    the (svc, svc) self-edge).  Returns ``(batch', edge_table)`` where
    ``batch'.service`` holds dense edge ids and ``edge_table[i]`` is the
    (caller, callee) service-id pair of edge ``i``.  ``parent`` holds
    batch-global row indices, so this runs on a FULL corpus."""
    psvc = batch.service.copy()            # default: self-edge
    has = batch.parent >= 0
    psvc[has] = batch.service[batch.parent[has]]
    pairs = psvc.astype(np.int64) * len(batch.services) + batch.service
    uniq, inv = np.unique(pairs, return_inverse=True)
    table = tuple((int(p // len(batch.services)),
                   int(p % len(batch.services))) for p in uniq.tolist())
    return batch._replace(service=inv.astype(np.int32)), table


def _edge_staged(batch: SpanBatch, cfg: Optional[ReplayConfig]):
    """One edge re-key + staging pass shared by every per-edge plane."""
    eb, table = edge_keyed_batch(batch)
    base = cfg or ReplayConfig(n_services=len(batch.services))
    cfg_e = dataclasses.replace(base, n_services=len(table))
    chunks, _ = stage_columns(eb, cfg_e)
    return chunks, cfg_e, table


def _edge_distinct_from_staged(chunks, cfg_e: ReplayConfig,
                               device: DeviceLike) -> np.ndarray:
    """Per-edge HLL estimates: the ``with_hll`` plane of the edge-keyed
    replay (only its ``sid`` and ``tid`` columns go to the device)."""
    device = resolve_device(device)
    regs = hll_scatter_update(
        hll_init(cfg_e.hll_p, lanes=cfg_e.n_services, device=device),
        torch.as_tensor(chunks["sid"], device=device),
        torch.as_tensor(chunks["tid"], device=device), cfg_e)
    return hll_estimate(regs)


def replay_edge_distinct(batch: SpanBatch,
                         cfg: Optional[ReplayConfig] = None,
                         device: DeviceLike = None):
    """Per-edge distinct-trace counts from the HLL register plane of the
    edge-keyed replay.  Returns ``(counts, edge_table)``: float64 ``[E]``
    estimates and the edge id -> (caller, callee) service-id table."""
    chunks, cfg_e, table = _edge_staged(batch, cfg)
    return _edge_distinct_from_staged(chunks, cfg_e, device), table


def replay_edge_percentiles(batch: SpanBatch,
                            cfg: Optional[ReplayConfig] = None,
                            qs: Tuple[float, ...] = (0.5, 0.95, 0.99),
                            k: int = 64, device: DeviceLike = None):
    """Per-edge latency percentiles: the t-digest plane over (call-graph
    edge, window) segments.  Returns ``(percentiles, edge_table)``:
    ``[E*W, len(qs)]`` float32 µs and the edge table."""
    chunks, cfg_e, table = _edge_staged(batch, cfg)
    return _quantiles_us(_digests_from_staged(chunks, cfg_e, k, device),
                         qs), table


def replay_edge_features(batch: SpanBatch,
                         cfg: Optional[ReplayConfig] = None,
                         qs: Tuple[float, ...] = (0.5, 0.95, 0.99),
                         k: int = 64, device: DeviceLike = None):
    """Both per-edge planes, t-digest percentiles and HLL distinct-trace
    counts, from ONE edge re-key + staging pass.  Returns
    ``(percentiles, counts, edge_table)`` as the two single-plane
    entries."""
    chunks, cfg_e, table = _edge_staged(batch, cfg)
    pct = _quantiles_us(_digests_from_staged(chunks, cfg_e, k, device), qs)
    return pct, _edge_distinct_from_staged(chunks, cfg_e, device), table


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
        dev_name = device_name(dev)
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
    compile_s = 0.0 if kernel == "numpy" else time.perf_counter() - t0
    if compile_s:
        obs.counter("anomod_replay_compile_total", kernel=kernel).inc()
        obs.counter("anomod_replay_compile_seconds_total",
                    kernel=kernel).inc(compile_s)
    dispatch_s = obs.histogram("anomod_replay_dispatch_seconds",
                               kernel=kernel)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        state = run_once()
        times.append(time.perf_counter() - t0)
        dispatch_s.observe(times[-1])
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

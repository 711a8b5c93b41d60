"""The columnar span IR (the span half of ``anomod/schemas.py``).

``SpanBatch`` unifies the two reference trace schemas (Jaeger spans for SN,
SkyWalking segments for TT) behind fixed-dtype numpy columns plus interned
string side tables.  The port keeps the batch on the host: only the staged
replay columns (``anomod_torch.replay.stage_columns``) go to the card.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np

# Span kinds (TT "type" field; SN spans are all RPC ~ Entry/Exit mix).
KIND_ENTRY = 0
KIND_EXIT = 1
KIND_LOCAL = 2
KIND_NAMES = ("Entry", "Exit", "Local")

LOG_INFO, LOG_WARN, LOG_ERROR, LOG_OTHER = 0, 1, 2, 3

_ROW_FIELDS = ("trace", "parent", "service", "endpoint", "start_us",
               "duration_us", "is_error", "status", "kind")


class SpanBatch(NamedTuple):
    """Columnar batch of spans — the unified span IR.

    All arrays share length ``n_spans``.  ``parent`` holds the *global row
    index* of the parent span within the same batch (-1 for roots).
    """

    trace: np.ndarray      # int32  — index into `trace_ids` table
    parent: np.ndarray     # int32  — global row index of parent, -1 = root
    service: np.ndarray    # int32  — index into `services`
    endpoint: np.ndarray   # int32  — index into `endpoints`
    start_us: np.ndarray   # int64  — epoch microseconds
    duration_us: np.ndarray  # int64
    is_error: np.ndarray   # bool_
    status: np.ndarray     # int16  — HTTP status code, 0 if absent
    kind: np.ndarray       # int8   — KIND_ENTRY/EXIT/LOCAL

    services: Tuple[str, ...]
    endpoints: Tuple[str, ...]
    trace_ids: Tuple[str, ...]

    @property
    def n_spans(self) -> int:
        return int(self.trace.shape[0])

    @property
    def n_traces(self) -> int:
        return len(self.trace_ids)

    @property
    def n_services(self) -> int:
        return len(self.services)

    def validate(self) -> "SpanBatch":
        n = self.n_spans
        for name in _ROW_FIELDS:
            arr = getattr(self, name)
            if arr.shape != (n,):
                raise ValueError(f"SpanBatch.{name}: shape {arr.shape} != ({n},)")
        if n:
            if self.parent.max(initial=-1) >= n:
                raise ValueError("SpanBatch.parent out of range")
            if self.service.max(initial=0) >= len(self.services):
                raise ValueError("SpanBatch.service id out of range")
            if self.trace.max(initial=0) >= len(self.trace_ids):
                raise ValueError("SpanBatch.trace id out of range")
        return self


def empty_span_batch() -> SpanBatch:
    z = lambda dt: np.zeros((0,), dtype=dt)  # noqa: E731
    return SpanBatch(
        trace=z(np.int32), parent=z(np.int32), service=z(np.int32),
        endpoint=z(np.int32), start_us=z(np.int64), duration_us=z(np.int64),
        is_error=z(np.bool_), status=z(np.int16), kind=z(np.int8),
        services=(), endpoints=(), trace_ids=(),
    )


def concat_span_batches(batches: Sequence[SpanBatch]) -> SpanBatch:
    """Concatenate batches, re-interning the string tables."""
    batches = [b for b in batches if b.n_spans]
    if not batches:
        return empty_span_batch()
    services: Dict[str, int] = {}
    endpoints: Dict[str, int] = {}
    trace_ids: Dict[str, int] = {}
    cols = {k: [] for k in _ROW_FIELDS}
    offset = 0
    for b in batches:
        svc_map = np.array([services.setdefault(s, len(services)) for s in b.services]
                           or [0], dtype=np.int32)
        ep_map = np.array([endpoints.setdefault(e, len(endpoints)) for e in b.endpoints]
                          or [0], dtype=np.int32)
        tr_map = np.array([trace_ids.setdefault(t, len(trace_ids)) for t in b.trace_ids]
                          or [0], dtype=np.int32)
        cols["service"].append(svc_map[b.service])
        cols["endpoint"].append(ep_map[b.endpoint])
        cols["trace"].append(tr_map[b.trace])
        par = b.parent.copy()
        par[par >= 0] += offset
        cols["parent"].append(par)
        for k in ("start_us", "duration_us", "is_error", "status", "kind"):
            cols[k].append(getattr(b, k))
        offset += b.n_spans
    return SpanBatch(
        **{k: np.concatenate(v) for k, v in cols.items()},
        services=tuple(services), endpoints=tuple(endpoints),
        trace_ids=tuple(trace_ids),
    ).validate()


def take_spans(batch: SpanBatch, idx) -> SpanBatch:
    """Row-subset of a SpanBatch (boolean mask, index array or slice).

    Side tables are kept whole so service/endpoint/trace ids stay valid;
    ``parent`` is NOT remapped — callers that need parent edges resolve
    them on the full batch first (``stream.resolve_parent_services``).
    """
    return batch._replace(**{k: getattr(batch, k)[idx] for k in _ROW_FIELDS})

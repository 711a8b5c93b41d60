"""Admission control: per-tenant weighted-fair queues, bounded backlog,
priority-aware load shedding (counterpart of ``anomod/serve/queues.py``).

Every tenant owns a FIFO of pending span micro-batches; service order
across tenants is start-time fair queuing (SFQ: each batch gets the
virtual finish tag ``start + cost / weight`` and the drain always serves
the smallest tag).  Two backlog bounds give backpressure:

- a per-tenant bound, so one runaway feed cannot take the queue memory
  (its own overflow is shed, nobody else's);
- a global bound: when offered load exceeds capacity the controller sheds
  in PRIORITY order.  An arriving batch may evict queued work of strictly
  lower priority (latest finish tag first, the work fair queuing would
  reach last), and is itself shed when not enough lower-priority work is
  queued.

Three drain/shed engines keep the same contract (``drain_engine``): the
per-batch heap pair (``"heap"``, the parity oracle), and the columnar book
(:class:`_ColumnarSFQ`) whose candidate scans run over parallel numpy
columns, in C++ (``"native"``, the default: ``atn_sfq_drain`` /
``atn_sfq_victim`` of ``anomod_torch/csrc/native.cpp``) or as a numpy
``lexsort`` (``"numpy"``).  All three give the same served order, the same
shed and eviction victims and the same SFQ floats, as the JAX package's
engines do.  The registered fleet lives in a columnar spec table and the
per-tenant counters are created on a tenant's first offer.  Everything is
host bookkeeping over integers and floats, with no clock and no
randomness, so a seeded overload replay is bit-reproducible.
"""

from __future__ import annotations

import ctypes
import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from anomod_torch import obs
from anomod_torch.io import native
from anomod_torch.obs.registry import NULL
from anomod_torch.schemas import SpanBatch

#: the drain engines ``AdmissionController`` takes
DRAIN_ENGINES = ("native", "numpy", "heap")

#: default scheduler weight per priority class (0 = most important).
PRIORITY_WEIGHTS = {0: 4.0, 1: 2.0, 2: 1.0}


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's static admission contract."""
    tenant_id: int
    name: str
    priority: int = 1          # 0 = gold, 1 = silver, 2 = bronze
    weight: float = 0.0        # 0 -> PRIORITY_WEIGHTS[priority]
    rate_spans_per_s: float = 0.0   # offered-load hint (traffic generator)

    def effective_weight(self) -> float:
        if self.weight > 0:
            return self.weight
        return PRIORITY_WEIGHTS.get(self.priority, 1.0)


@dataclasses.dataclass
class QueuedBatch:
    """One admitted micro-batch waiting for the batcher."""
    tenant_id: int
    seq: int                   # global admission sequence number
    spans: SpanBatch
    n_spans: int
    priority: int
    enqueued_s: float          # virtual admission time
    finish_tag: float          # SFQ virtual finish time


@dataclasses.dataclass
class TenantCounters:
    offered_spans: int = 0
    admitted_spans: int = 0
    served_spans: int = 0
    shed_spans: int = 0
    offered_batches: int = 0
    served_batches: int = 0
    shed_batches: int = 0
    # evictions are the shed batches destroyed AFTER admission (displaced
    # by a higher-priority arrival)
    evicted_batches: int = 0


class _LazyCounters(dict):
    """Per-tenant counters created on first touch: a registered tenant
    that never offers has no row, and reads as zeros."""

    def __missing__(self, tid: int) -> TenantCounters:
        c = self[tid] = TenantCounters()
        return c


class _SpecTable:
    """The registered fleet as columns: tenant id, priority, resolved SFQ
    weight and the rate hint as parallel arrays, names as a tuple of
    references.  Dense ids (0..n-1, every generated fleet) index the
    arrays directly; others go through a side index."""

    __slots__ = ("ids", "pri", "wt", "rate", "names", "_index")

    def __init__(self, tenants: Sequence[TenantSpec]):
        self.ids = np.asarray([t.tenant_id for t in tenants], np.int64)
        if len(np.unique(self.ids)) != len(self.ids):
            raise ValueError("duplicate tenant_id in tenant specs")
        self.pri = np.asarray([t.priority for t in tenants], np.int16)
        self.wt = np.asarray([t.effective_weight() for t in tenants],
                             np.float64)
        self.rate = np.asarray([t.rate_spans_per_s for t in tenants],
                               np.float64)
        self.names = tuple(t.name for t in tenants)
        n = len(self.ids)
        dense = n > 0 and bool((self.ids == np.arange(n)).all())
        self._index: Optional[Dict[int, int]] = None if dense \
            else {int(t): i for i, t in enumerate(self.ids)}

    def _row(self, tid: int) -> int:
        if self._index is None:
            if 0 <= tid < len(self.ids):
                return tid
            raise KeyError(tid)
        return self._index[tid]

    def priority_of(self, tid: int) -> int:
        return int(self.pri[self._row(tid)])

    def weight_of(self, tid: int) -> float:
        return float(self.wt[self._row(tid)])

    def __len__(self) -> int:
        return len(self.ids)

    def nbytes(self) -> int:
        """Exact column bytes + 8 nominal a name reference (the strings
        are the caller's) + the side index's entries where ids are not
        dense: the census admission plane's per-registered price, 34 B a
        tenant on a dense fleet."""
        b = int(self.ids.nbytes + self.pri.nbytes + self.wt.nbytes
                + self.rate.nbytes) + 8 * len(self.names)
        if self._index is not None:
            b += 64 * len(self._index)
        return b


class _ColumnarSFQ:
    """The drain and evict heaps' book as parallel columns: finish tag,
    admission seq, span count, priority and an alive mask, one slot a
    queued batch (freed slots are reused).

    - drain: the alive slots sorted by ``(finish_tag, seq)`` (the drain
      heap's pop order; seqs are unique), then the budget walked down by
      the heap loop's own float64 subtraction (serve while ``remaining >
      0``, the one-batch overdraw included);
    - victim: the lexicographic max of ``(priority, finish_tag, seq)``
      over the alive slots (the evict heap's top).

    ``engine="native"`` runs both scans in C++ over the columns'
    pointers, marshalled once per allocation; ``"numpy"`` runs them as a
    ``lexsort``.  The per-batch bookkeeping stays in the controller."""

    __slots__ = ("fin", "seq", "nsp", "pri", "alive", "engine", "_lib",
                 "_slot_of", "_free", "_n", "_out", "_ptrs")

    def __init__(self, engine: str, cap: int = 256):
        self.engine = engine
        self._lib = native.library() if engine == "native" else None
        cap = max(int(cap), 16)
        self.fin = np.zeros(cap, np.float64)
        self.seq = np.zeros(cap, np.int64)
        self.nsp = np.zeros(cap, np.int64)
        self.pri = np.zeros(cap, np.int64)
        self.alive = np.zeros(cap, np.uint8)
        self._slot_of: Dict[int, int] = {}
        self._free: List[int] = []
        self._n = 0                       # slot high-water mark
        self._out = np.empty(cap, np.int64)
        self._rebind()

    def _rebind(self) -> None:
        types = (ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
                 ctypes.c_int64, ctypes.c_uint8, ctypes.c_int64)
        self._ptrs = tuple(
            a.ctypes.data_as(ctypes.POINTER(t)) for a, t in zip(
                (self.fin, self.seq, self.nsp, self.pri, self.alive,
                 self._out), types))

    def _grow(self) -> None:
        cap = len(self.fin) * 2
        for name in ("fin", "seq", "nsp", "pri", "alive"):
            old = getattr(self, name)
            new = np.zeros(cap, old.dtype)
            new[:len(old)] = old
            setattr(self, name, new)
        self._out = np.empty(cap, np.int64)
        self._rebind()

    def add(self, qb: QueuedBatch) -> None:
        if self._free:
            slot = self._free.pop()
        else:
            if self._n >= len(self.fin):
                self._grow()
            slot = self._n
            self._n += 1
        self.fin[slot] = qb.finish_tag
        self.seq[slot] = qb.seq
        self.nsp[slot] = qb.n_spans
        self.pri[slot] = qb.priority
        self.alive[slot] = 1
        self._slot_of[qb.seq] = slot

    def remove(self, seq: int) -> None:
        slot = self._slot_of.pop(seq)
        self.alive[slot] = 0
        self._free.append(slot)

    def select(self, budget: float) -> List[int]:
        """Admission seqs a drain of ``budget`` spans serves, in order."""
        n = self._n
        if not self._slot_of:
            return []
        if self._lib is not None:
            fin, seq, nsp, _, alive, out = self._ptrs
            count = self._lib.atn_sfq_drain(fin, seq, nsp, alive, n,
                                            budget, out)
            if count < 0:
                raise ValueError("atn_sfq_drain refused its arguments")
            return self.seq[self._out[:count]].tolist()
        idx = np.flatnonzero(self.alive[:n])
        order = np.lexsort((self.seq[idx], self.fin[idx]))
        out: List[int] = []
        remaining = float(budget)
        for slot in idx[order]:
            if not remaining > 0:
                break
            remaining -= int(self.nsp[slot])
            out.append(int(self.seq[slot]))
        return out

    def victim(self) -> Optional[int]:
        """Admission seq of the evict heap's top; None when empty."""
        n = self._n
        if not self._slot_of:
            return None
        if self._lib is not None:
            fin, seq, _, pri, alive, _ = self._ptrs
            got = self._lib.atn_sfq_victim(fin, seq, pri, alive, n)
            if got < 0:
                raise ValueError("atn_sfq_victim found no alive slot")
            return int(self.seq[got])
        idx = np.flatnonzero(self.alive[:n])
        k = np.lexsort((self.seq[idx], self.fin[idx], self.pri[idx]))[-1]
        return int(self.seq[idx[k]])


class AdmissionController:
    """Weighted-fair admission over a bounded multi-tenant backlog.

    ``drain_engine``: ``"native"`` (the default), ``"numpy"`` or
    ``"heap"``; ``.drain_engine`` names the engine in use."""

    def __init__(self, tenants: Sequence[TenantSpec],
                 max_backlog: int = 200_000,
                 max_tenant_backlog: Optional[int] = None,
                 drain_engine: str = "native"):
        if max_backlog < 1:
            raise ValueError("max_backlog must be >= 1 span")
        if drain_engine not in DRAIN_ENGINES:
            raise ValueError(f"drain_engine must be one of {DRAIN_ENGINES}, "
                             f"got {drain_engine!r}")
        self.drain_engine = drain_engine
        self._col = (None if drain_engine == "heap"
                     else _ColumnarSFQ(drain_engine))
        self.specs = _SpecTable(tenants)
        self.max_backlog = int(max_backlog)
        self.max_tenant_backlog = int(max_tenant_backlog
                                      if max_tenant_backlog is not None
                                      else max(max_backlog // 8, 1))
        #: per-tenant counters, created on a tenant's first offer
        self.counters: Dict[int, TenantCounters] = _LazyCounters()
        #: running totals, bumped at every counter mutation
        self._tot = TenantCounters()
        self.backlog_spans = 0
        self.peak_backlog_spans = 0
        self._tenant_backlog: Dict[int, int] = {}
        # per-priority backlog: the eviction feasibility check must know
        # how much strictly-lower-priority work is queued BEFORE
        # destroying any of it
        self._priority_backlog: Dict[int, int] = {}
        # SFQ state: system virtual time + per-tenant last finish tag
        self._vtime = 0.0
        self._last_finish: Dict[int, float] = {}
        self._seq = 0
        self._alive: Dict[int, QueuedBatch] = {}      # seq -> batch
        # drain heap: smallest finish tag first (seq breaks ties); evict
        # heap: lowest priority (largest number) first, then latest
        # finish tag.  Both delete lazily against _alive.
        self._drain_heap: List[Tuple[float, int]] = []
        self._evict_heap: List[Tuple[int, float, int]] = []
        self._evict_stale = 0
        # registry mirrors (the JAX package's names), handles cached:
        # offer and drain run per micro-batch
        self._obs_offered = obs.counter("anomod_serve_offered_spans_total")
        self._obs_admitted = obs.counter("anomod_serve_admitted_spans_total")
        self._obs_served = obs.counter("anomod_serve_served_spans_total")
        self._obs_shed = obs.counter("anomod_serve_shed_spans_total")
        self._obs_evicted = obs.counter("anomod_serve_evicted_batches_total")
        self._obs_backlog = obs.gauge("anomod_serve_backlog_spans")
        self._obs_tenant_backlog = obs.gauge(
            "anomod_serve_max_tenant_backlog_spans")

    def _obs_depths(self) -> None:
        # the tenant gauge scans every tenant's backlog, once an admitted
        # batch: skipped when the registry is off
        if self._obs_tenant_backlog is NULL:
            return
        self._obs_backlog.set(self.backlog_spans)
        self._obs_tenant_backlog.set(
            max(self._tenant_backlog.values(), default=0))

    def _shed(self, c: TenantCounters, n: int) -> bool:
        c.shed_spans += n
        c.shed_batches += 1
        self._tot.shed_spans += n
        self._tot.shed_batches += 1
        self._obs_shed.inc(n)
        return False

    # -- admission --------------------------------------------------------

    def offer(self, tenant_id: int, spans: SpanBatch,
              now_s: float) -> bool:
        """Admit (enqueue) or shed one tenant micro-batch; True iff
        admitted.  Per-tenant overflow sheds the arrival; global overflow
        evicts strictly-lower-priority queued work first and sheds the
        arrival only when not enough of it exists."""
        priority = self.specs.priority_of(tenant_id)
        n = spans.n_spans
        c = self.counters[tenant_id]
        c.offered_spans += n
        c.offered_batches += 1
        self._tot.offered_spans += n
        self._tot.offered_batches += 1
        self._obs_offered.inc(n)
        if n == 0:
            return False
        # both bounds refuse a batch only when queued work already exists:
        # a batch wider than a bound still admits against an empty queue
        backlog = self._tenant_backlog.get(tenant_id, 0)
        if backlog and backlog + n > self.max_tenant_backlog:
            return self._shed(c, n)
        if self.backlog_spans and self.backlog_spans + n > self.max_backlog:
            # transactional eviction: destroy lower-priority work only if
            # enough of it exists to admit the arrival (emptying the whole
            # queue also admits, so the need caps at the backlog)
            needed = min(self.backlog_spans + n - self.max_backlog,
                         self.backlog_spans)
            evictable = sum(v for p, v in self._priority_backlog.items()
                            if p > priority)
            if evictable < needed:
                return self._shed(c, n)
        while self.backlog_spans and self.backlog_spans + n > self.max_backlog:
            victim = self._pop_eviction_candidate(priority)
            if victim is None:           # unreachable given the check above
                return self._shed(c, n)
            vc = self.counters[victim.tenant_id]
            vc.shed_spans += victim.n_spans
            vc.shed_batches += 1
            vc.evicted_batches += 1
            vc.admitted_spans -= victim.n_spans
            self._tot.shed_spans += victim.n_spans
            self._tot.shed_batches += 1
            self._tot.evicted_batches += 1
            self._tot.admitted_spans -= victim.n_spans
            self._obs_shed.inc(victim.n_spans)
            self._obs_evicted.inc()
            self._remove(victim)
        start = max(self._vtime, self._last_finish.get(tenant_id, 0.0))
        finish = start + n / self.specs.weight_of(tenant_id)
        self._last_finish[tenant_id] = finish
        qb = QueuedBatch(tenant_id=tenant_id, seq=self._seq, spans=spans,
                         n_spans=n, priority=priority,
                         enqueued_s=now_s, finish_tag=finish)
        self._seq += 1
        self._alive[qb.seq] = qb
        if self._col is not None:
            self._col.add(qb)
        else:
            heapq.heappush(self._drain_heap, (qb.finish_tag, qb.seq))
            heapq.heappush(self._evict_heap,
                           (-qb.priority, -qb.finish_tag, -qb.seq))
        self.backlog_spans += n
        self._tenant_backlog[tenant_id] = backlog + n
        self._priority_backlog[priority] = \
            self._priority_backlog.get(priority, 0) + n
        self.peak_backlog_spans = max(self.peak_backlog_spans,
                                      self.backlog_spans)
        c.admitted_spans += n
        self._tot.admitted_spans += n
        self._obs_admitted.inc(n)
        self._obs_depths()
        return True

    def _pop_eviction_candidate(self, incoming_priority: int):
        """The queued batch a higher-priority arrival may displace:
        strictly lower priority than the arrival, lowest class first,
        latest finish tag first.  None when nothing qualifies."""
        if self._col is not None:
            seq = self._col.victim()
            if seq is None:
                return None
            qb = self._alive[seq]
            # the columnar argmax is the highest priority number queued:
            # if even it is not strictly lower than the arrival, nothing is
            return qb if qb.priority > incoming_priority else None
        while self._evict_heap:
            neg_pri, neg_fin, neg_seq = self._evict_heap[0]
            qb = self._alive.get(-neg_seq)
            if qb is None:                      # already drained/evicted
                heapq.heappop(self._evict_heap)
                continue
            if -neg_pri <= incoming_priority:
                return None                     # nothing strictly lower
            heapq.heappop(self._evict_heap)
            return qb
        return None

    def _remove(self, qb: QueuedBatch) -> None:
        del self._alive[qb.seq]
        self.backlog_spans -= qb.n_spans
        self._tenant_backlog[qb.tenant_id] -= qb.n_spans
        self._priority_backlog[qb.priority] -= qb.n_spans
        if self._col is not None:
            self._col.remove(qb.seq)
            return
        # the evict heap prunes lazily only when overflow consults its
        # top: compact it when stale entries dominate (amortized O(1))
        self._evict_stale += 1
        if self._evict_stale > max(64, len(self._alive)):
            self._evict_heap = [(-q.priority, -q.finish_tag, -q.seq)
                                for q in self._alive.values()]
            heapq.heapify(self._evict_heap)
            self._evict_stale = 0

    # -- drain ------------------------------------------------------------

    def drain(self, budget_spans: float) -> List[QueuedBatch]:
        """Serve up to ``budget_spans`` in weighted-fair order.  The
        budget may overdraw by at most one batch (batches are never
        split), so a batch wider than a tick's budget still drains."""
        if self._col is not None:
            out = []
            for seq in self._col.select(float(budget_spans)):
                qb = self._alive[seq]
                self._remove(qb)
                self._vtime = max(self._vtime, qb.finish_tag - qb.n_spans
                                  / self.specs.weight_of(qb.tenant_id))
                self._serve(qb)
                out.append(qb)
            if out:
                self._obs_depths()
            return out
        out: List[QueuedBatch] = []
        remaining = float(budget_spans)
        while remaining > 0 and self._drain_heap:
            fin, seq = self._drain_heap[0]
            qb = self._alive.get(seq)
            heapq.heappop(self._drain_heap)
            if qb is None:                      # evicted under overload
                continue
            self._remove(qb)
            self._vtime = max(self._vtime, fin - qb.n_spans
                              / self.specs.weight_of(qb.tenant_id))
            remaining -= qb.n_spans
            self._serve(qb)
            out.append(qb)
        if out:
            self._obs_depths()
        return out

    def _serve(self, qb: QueuedBatch) -> None:
        c = self.counters[qb.tenant_id]
        c.served_spans += qb.n_spans
        c.served_batches += 1
        self._tot.served_spans += qb.n_spans
        self._tot.served_batches += 1
        self._obs_served.inc(qb.n_spans)

    # -- report helpers ---------------------------------------------------

    def totals(self) -> TenantCounters:
        return dataclasses.replace(self._tot)

    def per_priority(self) -> Dict[int, TenantCounters]:
        out: Dict[int, TenantCounters] = {}
        for tid, c in self.counters.items():
            acc = out.setdefault(self.specs.priority_of(tid),
                                 TenantCounters())
            for f in dataclasses.fields(TenantCounters):
                setattr(acc, f.name,
                        getattr(acc, f.name) + getattr(c, f.name))
        return out

    def priority_of(self, tenant_id: int) -> int:
        return self.specs.priority_of(tenant_id)

    def spec_table_nbytes(self) -> int:
        """Exact resident bytes of the registered fleet's spec table."""
        return self.specs.nbytes()

    def tenant_backlog(self, tenant_id: int) -> int:
        """Queued spans of one tenant (0 when it never offered): state
        tiering skips a queued tenant at demotion."""
        return self._tenant_backlog.get(tenant_id, 0)

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

The drain and the eviction order are the JAX package's heap engine, the
oracle its columnar and native engines are pinned byte-identical to.
Everything is host bookkeeping over integers and floats, with no clock and
no randomness, so a seeded overload replay is bit-reproducible.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from anomod_torch.schemas import SpanBatch

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


class AdmissionController:
    """Weighted-fair admission over a bounded multi-tenant backlog."""

    def __init__(self, tenants: Sequence[TenantSpec],
                 max_backlog: int = 200_000,
                 max_tenant_backlog: Optional[int] = None):
        if max_backlog < 1:
            raise ValueError("max_backlog must be >= 1 span")
        self.specs: Dict[int, TenantSpec] = {}
        for t in tenants:
            if t.tenant_id in self.specs:
                raise ValueError("duplicate tenant_id in tenant specs")
            self.specs[t.tenant_id] = t
        self._weight = {tid: s.effective_weight()
                        for tid, s in self.specs.items()}
        self.max_backlog = int(max_backlog)
        self.max_tenant_backlog = int(max_tenant_backlog
                                      if max_tenant_backlog is not None
                                      else max(max_backlog // 8, 1))
        #: per-tenant counters, created on a tenant's first offer
        self.counters: Dict[int, TenantCounters] = {}
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

    def _counter(self, tid: int) -> TenantCounters:
        c = self.counters.get(tid)
        if c is None:
            c = self.counters[tid] = TenantCounters()
        return c

    def _shed(self, c: TenantCounters, n: int) -> bool:
        c.shed_spans += n
        c.shed_batches += 1
        self._tot.shed_spans += n
        self._tot.shed_batches += 1
        return False

    # -- admission --------------------------------------------------------

    def offer(self, tenant_id: int, spans: SpanBatch,
              now_s: float) -> bool:
        """Admit (enqueue) or shed one tenant micro-batch; True iff
        admitted.  Per-tenant overflow sheds the arrival; global overflow
        evicts strictly-lower-priority queued work first and sheds the
        arrival only when not enough of it exists."""
        priority = self.specs[tenant_id].priority
        n = spans.n_spans
        c = self._counter(tenant_id)
        c.offered_spans += n
        c.offered_batches += 1
        self._tot.offered_spans += n
        self._tot.offered_batches += 1
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
            vc = self._counter(victim.tenant_id)
            vc.shed_spans += victim.n_spans
            vc.shed_batches += 1
            vc.evicted_batches += 1
            vc.admitted_spans -= victim.n_spans
            self._tot.shed_spans += victim.n_spans
            self._tot.shed_batches += 1
            self._tot.evicted_batches += 1
            self._tot.admitted_spans -= victim.n_spans
            self._remove(victim)
        start = max(self._vtime, self._last_finish.get(tenant_id, 0.0))
        finish = start + n / self._weight[tenant_id]
        self._last_finish[tenant_id] = finish
        qb = QueuedBatch(tenant_id=tenant_id, seq=self._seq, spans=spans,
                         n_spans=n, priority=priority,
                         enqueued_s=now_s, finish_tag=finish)
        self._seq += 1
        self._alive[qb.seq] = qb
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
        return True

    def _pop_eviction_candidate(self, incoming_priority: int):
        """The queued batch a higher-priority arrival may displace:
        strictly lower priority than the arrival, lowest class first,
        latest finish tag first.  None when nothing qualifies."""
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
        out: List[QueuedBatch] = []
        remaining = float(budget_spans)
        while remaining > 0 and self._drain_heap:
            fin, seq = self._drain_heap[0]
            qb = self._alive.get(seq)
            heapq.heappop(self._drain_heap)
            if qb is None:                      # evicted under overload
                continue
            self._remove(qb)
            self._vtime = max(self._vtime,
                              fin - qb.n_spans / self._weight[qb.tenant_id])
            remaining -= qb.n_spans
            c = self._counter(qb.tenant_id)
            c.served_spans += qb.n_spans
            c.served_batches += 1
            self._tot.served_spans += qb.n_spans
            self._tot.served_batches += 1
            out.append(qb)
        return out

    # -- report helpers ---------------------------------------------------

    def totals(self) -> TenantCounters:
        return dataclasses.replace(self._tot)

    def per_priority(self) -> Dict[int, TenantCounters]:
        out: Dict[int, TenantCounters] = {}
        for tid, c in self.counters.items():
            acc = out.setdefault(self.specs[tid].priority, TenantCounters())
            for f in dataclasses.fields(TenantCounters):
                setattr(acc, f.name,
                        getattr(acc, f.name) + getattr(c, f.name))
        return out

    def priority_of(self, tenant_id: int) -> int:
        return self.specs[tenant_id].priority

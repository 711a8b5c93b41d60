"""Tenant sharding for the serving plane: the deterministic partition
and the engine's worker threads (counterpart of
``anomod/serve/shard.py``).

The tick's control plane (admission, weighted-fair drain, shedding, SLO
samples) stays on the coordinator thread, so every decision equals the
1-shard engine's by construction.  The score plane (staging, the lane
kernel, window scoring, per-tenant detector state) partitions by tenant:
each shard worker owns its tenants' replays and detectors, its own
:class:`~anomod_torch.serve.batcher.BucketRunner` (its own scratch, its
own device pool, its own CUDA stream on the card) and its own metrics
registry, so the score path takes no cross-shard lock.  The tick fans
its served batches out by ownership and joins at a barrier before SLO
accounting.

Placement is rendezvous hashing (tenant t goes to ``argmax_s
fmix32(crc32(f"{t}/{s}"))``), then a load-balance pass over the tenants'
seeded rates that moves the heaviest movable tenant from the most to the
least loaded shard while that strictly shrinks the spread.  Everything
derives from ``(tenant_id, rate, weight)``: the same specs always give
the same plan, equal to the JAX package's.
"""

from __future__ import annotations

import queue
import threading
import zlib
from typing import Dict, List, Optional, Sequence

from anomod_torch.serve.queues import TenantSpec


def _fmix32(h: int) -> int:
    """MurmurHash3's 32-bit avalanche finalizer.  crc32 alone is
    XOR-LINEAR: two keys differing only in the shard suffix differ by a
    near-constant XOR, so comparing raw crc32 scores across shards
    clumps — runs of ~80 CONSECUTIVE tenant ids all prefer the same
    shard (measured: the 1→2 delta set over tenants 0..79 was empty,
    which would make a small fleet's first scale-up a placement
    no-op).  The multiply/shift mix destroys that linear structure
    while staying process- and hash-seed-stable."""
    h &= 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def rendezvous_shard(tenant_id: int, n_shards: int,
                     candidates: Optional[Sequence[int]] = None) -> int:
    """Highest-random-weight shard for one tenant (crc32 + the
    :func:`_fmix32` avalanche — stable across processes and Python hash
    seeds).  ``candidates`` restricts the draw to a subset of shard ids
    (the dead-shard migration and elastic scale-down cases: the ONE key
    definition must serve initial placement, recovery migration and
    policy-time scaling alike, or they could silently disagree)."""
    pool = range(n_shards) if candidates is None else candidates
    best, best_score = -1, -1
    for s in pool:
        score = _fmix32(zlib.crc32(f"{tenant_id}/{s}".encode()))
        if score > best_score:
            best, best_score = s, score
    if best < 0:
        raise ValueError("rendezvous needs at least one candidate shard")
    return best


def served_rate_model(specs: Sequence[TenantSpec],
                      capacity_spans_per_s: float) -> Dict[int, float]:
    """Expected SERVED spans/s per tenant under weighted-fair overload.

    Offered rate is the wrong balance weight once the fleet overloads:
    shedding is priority-ordered, so a bronze head tenant's spans mostly
    shed while a gold tenant's mostly serve — and the shard barrier
    waits on *scored* work, not offered work.  Under SFQ saturation each
    backlogged tenant's served rate is proportional to its weight, so
    the fleet splits as ``served_t = min(rate_t, w_t * K)`` with K set
    by capacity: ``sum_t min(rate_t, w_t * K) = C`` (demand-limited
    tenants serve their whole offer, the rest split the remainder by
    weight).  K solves by bisection; with capacity >= offered load the
    model degrades to the offered rates exactly.
    """
    rates = {s.tenant_id: max(float(s.rate_spans_per_s), 0.0)
             for s in specs}
    total = sum(rates.values())
    if total <= 0 or capacity_spans_per_s >= total:
        return rates
    ws = {s.tenant_id: s.effective_weight() for s in specs}
    lo, hi = 0.0, max(r / w for r, w in
                      ((rates[t], ws[t]) for t in rates) if w > 0)
    for _ in range(60):
        k = 0.5 * (lo + hi)
        if sum(min(rates[t], ws[t] * k) for t in rates) \
                < capacity_spans_per_s:
            lo = k
        else:
            hi = k
    k = 0.5 * (lo + hi)
    return {t: min(rates[t], ws[t] * k) for t in rates}


def plan_shards(specs: Sequence[TenantSpec], n_shards: int,
                capacity_spans_per_s: float = 0.0) -> Dict[int, int]:
    """tenant_id -> shard for the whole fleet: rendezvous base + the
    greedy rate-balance pass described in the module docstring.

    ``capacity_spans_per_s`` (when positive and below the offered load)
    switches the balance weights from offered to expected-served rates
    (:func:`served_rate_model`) — the barrier waits on scored spans, so
    that is the load to equalize.  Deterministic in the arguments alone;
    every tenant is assigned; with ``n_shards == 1`` everything maps to
    shard 0.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    assign = {s.tenant_id: rendezvous_shard(s.tenant_id, n_shards)
              for s in specs}
    if n_shards == 1 or len(specs) <= 1:
        return assign
    # expected-served weights (offered rates when capacity is ample or
    # unknown); an all-zero fleet (scripted traffic with no rate hints)
    # balances by tenant count instead
    w = served_rate_model(specs, capacity_spans_per_s) \
        if capacity_spans_per_s > 0 else \
        {s.tenant_id: max(float(s.rate_spans_per_s), 0.0) for s in specs}
    if sum(w.values()) <= 0:
        w = {t: 1.0 for t in w}
    loads = [0.0] * n_shards
    members: List[List[int]] = [[] for _ in range(n_shards)]
    for s in specs:
        loads[assign[s.tenant_id]] += w[s.tenant_id]
        members[assign[s.tenant_id]].append(s.tenant_id)
    # every accepted move strictly decreases the load variance
    # (condition below implies wt < loads[hi] - loads[lo]), so the loop
    # terminates; the iteration cap is a belt for float dust.  Donors
    # are tried in descending load order — a shard whose whole load is
    # one indivisible head tenant is optimal already and must not stop
    # the rest of the fleet from leveling.
    for _ in range(8 * len(specs)):
        lo = min(range(n_shards), key=lambda i: (loads[i], i))
        moved = False
        for hi in sorted(range(n_shards), key=lambda i: (-loads[i], i)):
            if hi == lo or loads[hi] <= loads[lo]:
                break
            # heaviest first (ties broken by tenant id for
            # determinism): moving a head tenant off the hot shard is
            # the whole point
            for tid in sorted(members[hi], key=lambda t: (-w[t], t)):
                wt = w[tid]
                if max(loads[hi] - wt, loads[lo] + wt) \
                        < loads[hi] - 1e-12:
                    members[hi].remove(tid)
                    members[lo].append(tid)
                    loads[hi] -= wt
                    loads[lo] += wt
                    assign[tid] = lo
                    moved = True
                    break
            if moved:
                break
        if not moved:
            break
    return assign


def fold_verdicts(parts: Sequence[Sequence[tuple]]) -> List[tuple]:
    """Barrier fold of per-shard RCA results: each shard worker appends
    ``(seq, verdict, wall_s)`` tuples for the tenants it owns; merging
    on ``seq`` (the coordinator's enqueue order) makes the folded stream
    IDENTICAL to the 1-shard engine's — the RCA half of the shard
    determinism contract (wall_s legitimately varies; the verdicts carry
    no wall fields, so byte-comparison holds)."""
    out = [item for part in parts for item in part]
    out.sort(key=lambda item: item[0])
    return out


def fold_leg_records(legs: Sequence[dict]) -> List[dict]:
    """Barrier fold of per-shard flight-journal leg records: each
    shard's runner contributes one ``{"shard": s, ...}`` wall/dispatch
    delta for the tick; merging on the shard id makes the journaled
    order deterministic regardless of which worker finished first — the
    :func:`fold_verdicts` idiom, flight-recorder half (the leg contents
    are wall-clock/topology and ride the journal's VARIANT tier; only
    their ORDER is part of the record's determinism)."""
    out = [dict(leg) for leg in legs]
    out.sort(key=lambda leg: leg["shard"])
    return out


def fold_tree(parts: Sequence, combine) -> object:
    """Deterministic binary fold tree over per-shard barrier payloads.

    ``parts`` arrive in fixed shard order (the caller's contract) and
    pair off bottom-up — ``((s0, s1), (s2, s3))`` — so the combine
    schedule is a function of the part COUNT alone, never of which
    worker finished first: the reduction is reproducible at any shard
    count and any completion order, the fold_verdicts/fold_from idiom
    lifted to an O(log n)-depth tree (the Sparse Allreduce shape).  ``combine`` must be associative over adjacent parts;
    an empty sequence folds to None."""
    items = list(parts)
    if not items:
        return None
    while len(items) > 1:
        paired = [combine(items[i], items[i + 1])
                  for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            paired.append(items[-1])
        items = paired
    return items[0]


def join_all(workers) -> None:
    """Barrier over submitted workers that COMPLETES before any error
    propagates: raising at the first failed join would leave sibling
    tasks running, and the next submit would desynchronize their
    done-events (a later join could observe the old task's completion).
    Re-raises the first collected error after every join returned."""
    errs = []
    for w in workers:
        try:
            w.join()
        except BaseException as e:           # noqa: BLE001 — re-raised
            errs.append(e)
    if errs:
        raise errs[0]


class ShardWorker:
    """One persistent engine worker thread.

    The coordinator submits ONE closure per tick (the shard's slice of
    the served batches) and joins at the barrier; the worker executes it
    against state only this shard ever touches.  Exceptions propagate to
    the coordinator at join() — a failed shard must fail the tick, not
    silently drop its tenants' scoring.

    This submit/join/close/``alive`` surface is the worker seam the
    engine drives; the JAX package's process worker presents the same
    four members over a worker process.
    """

    def __init__(self, shard_id: int, name: str = "anomod-serve-shard"):
        self.shard_id = shard_id
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._exc: BaseException | None = None
        self._dying = False
        self._thread = threading.Thread(
            target=self._loop, name=f"{name}-{shard_id}", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            die = False
            try:
                fn()
            except BaseException as e:       # noqa: BLE001 — re-raised at join
                self._exc = e
                # an error that kills the worker (``kills_worker``, the
                # JAX package's injected crash, duck-typed) reports at
                # the barrier like any failure, then the thread ends.
                # ``_dying`` flips BEFORE the done event: the joiner
                # wakes strictly after ``alive`` reads False, so a
                # respawn check cannot submit to a queue nobody drains.
                die = bool(getattr(e, "kills_worker", False))
                if die:
                    self._dying = True
            finally:
                self._done.set()
            if die:
                return

    def submit(self, fn) -> None:
        """Queue one task; pair every submit with a :meth:`join`."""
        self._done.clear()
        self._q.put(fn)

    def join(self) -> None:
        """Barrier: wait for the submitted task; re-raise its error."""
        self._done.wait()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def close(self) -> None:
        """Stop the worker thread and settle its books.

        A worker still parked mid-task past the join timeout cannot be
        force-killed in-process — but abandoning it SILENTLY hid two
        failure modes: the hang itself (now counted,
        ``anomod_serve_shard_close_timeout_total``, and warned) and any
        task error nobody joined (now re-raised here instead of dying
        with the thread)."""
        self._q.put(None)
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            import warnings

            from anomod_torch import obs
            obs.counter("anomod_serve_shard_close_timeout_total").inc()
            warnings.warn(
                f"shard worker {self.shard_id} still running 5 s after "
                "close(); abandoning the daemon thread (its task error, "
                "if any, will be lost)", RuntimeWarning, stacklevel=2)
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._dying

"""The fleet census's tracker (counterpart of part of
``anomod/obs/census.py``).

:class:`CensusTracker` keeps the coordinator's hot-set bookkeeping: each
tenant's last-served tick and a lazily decayed served-span EWMA, fed
only by admission's served decisions, so
every number is canonical (equal across shard counts, residencies and
elastic episodes).  Its :meth:`~CensusTracker.coldest_candidates` is the
one eviction ordering: state tiering (:mod:`anomod_torch.serve.tiering`)
demotes in that order.

The census observatory itself (the hot-set document and its knobs
``ANOMOD_CENSUS_DECAY_TICKS`` / ``ANOMOD_CENSUS_COLDEST_K``, the
resident-bytes drain with its nominal entry sizes,
``collect_resident_bytes``, ``fleet_probe``, ``diff_census`` and the
``census`` command) is still to be ported.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

#: per-tick decay of the served-span EWMA (applied lazily per idle tick,
#: so updates stay O(served) and reads O(reported))
CENSUS_EWMA_DECAY = 0.9


class CensusTracker:
    """Coordinator-side hot-set bookkeeping: per-tenant last-served tick
    and a lazily decayed served-span EWMA.  ``observe`` is O(served
    batches) a tick."""

    def __init__(self):
        self.last_served: Dict[int, int] = {}
        self._ewma: Dict[int, float] = {}

    def observe(self, tick: int, served) -> None:
        """Fold one tick's served batches."""
        per_tenant: Dict[int, int] = {}
        for qb in served:
            per_tenant[qb.tenant_id] = \
                per_tenant.get(qb.tenant_id, 0) + qb.n_spans
        for tid, n in per_tenant.items():
            self._ewma[tid] = self.ewma_at(tid, tick) + float(n)
            self.last_served[tid] = tick

    def ewma_at(self, tid: int, tick: int) -> float:
        """The tenant's served-span EWMA decayed to ``tick`` (the stored
        value is anchored at the tenant's last-served tick)."""
        got = self._ewma.get(tid)
        if got is None:
            return 0.0
        gap = max(tick - self.last_served.get(tid, tick), 0)
        return got * CENSUS_EWMA_DECAY ** gap

    def coldest_candidates(self, tick: int,
                           resident: Sequence[int]) -> List[int]:
        """Ever-served resident tenants, coldest first: oldest last-served
        tick, then the weaker EWMA, then the tenant id."""
        return sorted(
            (tid for tid in resident if tid in self.last_served),
            key=lambda tid: (self.last_served[tid],
                             self.ewma_at(tid, tick), tid))

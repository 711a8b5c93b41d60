"""The elastic policy: signal-fed autoscaling for the serve plane
(counterpart of ``anomod/serve/policy.py``).

An :class:`ElasticPolicy` the coordinator evaluates at every tick
boundary (``ANOMOD_SERVE_POLICY=auto|script``) emits scale-up,
scale-down, rebalance and brownout decisions; the engine executes them
through the live-migration seams (``snapshot_replay`` /
``restore_replay``).

**Determinism.**  Every input is canonical, a function of seed and
config alone: the per-tenant served spans (admission's drain decisions),
the per-shard staged-chunk counts (``BucketRunner.n_dispatches``, never
a wall), the backlog and the shed delta.  The EWMAs update once a
virtual tick, so the decision stream is a pure function of the seed: a
rerun, an ``audit replay`` and the original run produce the same
scaling schedule, on the card, on the CPU and in the JAX engine.
Admission, drain and shed stay on the coordinator and tenant bits do
not depend on placement, so an elastic run's states, alerts, SLO and
shed equal a static run's byte for byte.

**Hysteresis and cooldown.**  Scale-up needs the pressure EWMA above
:data:`UP_BACKLOG_RATIO` for :data:`SUSTAIN_TICKS` consecutive ticks,
scale-down below :data:`DOWN_BACKLOG_RATIO` as long; the thresholds are
far apart.  ``ANOMOD_SERVE_POLICY_COOLDOWN_TICKS`` spaces executed
decisions.

**Brownout ladder.**  Sustained pressure at the
``ANOMOD_SERVE_POLICY_MAX_SHARDS`` ceiling degrades auxiliary planes
before tenants shed, one rung a cooldown: level 1 tightens the online
RCA budget to one run a tick, level 2 also coarsens the flight
recorder's state-digest cadence 4x.  Pressure below
:data:`BROWNOUT_LO_RATIO` relaxes the ladder in reverse order.  The
ladder never touches admission.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from anomod_torch import obs
from anomod_torch.config import validate_policy_script
from anomod_torch.serve.queues import TenantSpec
from anomod_torch.serve.shard import served_rate_model

__all__ = ["ElasticPolicy", "TickSignals", "plan_rebalance",
           "ALPHA", "SUSTAIN_TICKS", "UP_BACKLOG_RATIO",
           "DOWN_BACKLOG_RATIO", "BROWNOUT_HI_RATIO",
           "BROWNOUT_LO_RATIO", "MAX_BROWNOUT_LEVEL"]

#: EWMA smoothing for every policy signal (per virtual tick): heavy
#: enough that one spiky tick cannot trigger an episode, light enough
#: that a real surge registers within SUSTAIN_TICKS
ALPHA = 0.5
#: consecutive ticks a threshold must hold before a decision fires —
#: the time half of the hysteresis contract (the level half is the
#: UP/DOWN threshold gap)
SUSTAIN_TICKS = 2
#: pressure EWMA (max of backlog-fill ratio and budget-normalized shed
#: rate, see TickSignals.pressure) above which the fleet is overloaded:
#: scale up (or climb the brownout ladder at the shard ceiling)
UP_BACKLOG_RATIO = 0.5
#: pressure EWMA below which the fleet is idle enough to scale down
#: (far from UP_BACKLOG_RATIO on purpose — no flapping band)
DOWN_BACKLOG_RATIO = 0.05
#: pressure past this at the shard ceiling climbs the brownout ladder
BROWNOUT_HI_RATIO = 0.85
#: pressure below this relaxes the brownout ladder one rung
BROWNOUT_LO_RATIO = 0.3
#: the ladder's top rung (1 = RCA budget, 2 = + flight digest cadence)
MAX_BROWNOUT_LEVEL = 2


@dataclasses.dataclass
class TickSignals:
    """One tick's canonical policy inputs, assembled by the coordinator
    at the tick boundary.  Everything here is seed-determined — the
    audit-replay contract's precondition."""
    tick: int                        #: 0-based virtual tick index
    served_by_tenant: Dict[int, int]  #: spans drained per tenant
    per_shard_chunks: Sequence[int]  #: staged-chunk deltas per shard
    #: (leg_walls' canonical dispatch book — never its wall fields)
    backlog_spans: int
    max_backlog: int
    shed_delta: int                  #: spans shed this tick
    budget_spans: float              #: capacity * tick_s (the drain
    #: budget — what shed/backlog normalize against)

    def pressure(self) -> float:
        """The tick's overload pressure in [0, ~1+]: the max of the
        backlog-fill ratio and the shed rate normalized by the drain
        budget (clamped to 1).  Backlog alone oscillates with drain
        quantization — a whole retained backlog can drain in one tick
        while shedding continues — so the shed term is what keeps the
        signal steady through a sustained surge."""
        ratio = (self.backlog_spans / self.max_backlog
                 if self.max_backlog else 0.0)
        shed = (min(1.0, self.shed_delta / self.budget_spans)
                if self.budget_spans > 0 else 0.0)
        return max(ratio, shed)


def plan_rebalance(shard_of: Dict[int, int], n_shards: int,
                   specs: Sequence[TenantSpec],
                   live_rates: Dict[int, float],
                   capacity_spans_per_s: float,
                   k: int, dead: Sequence[int] = ()) -> List[tuple]:
    """The rebalance pass: up to ``k`` ``(tenant_id, dst_shard)`` moves
    of the hottest tenants off the most-loaded shard.

    The weights are :func:`anomod_torch.serve.shard.served_rate_model` over
    the LIVE served-rate EWMAs (not the static spec rates — the skew
    being fixed is the one the traffic actually produced), solved
    against capacity exactly like initial placement.  Greedy and
    strictly improving: each move goes from the currently most- to the
    currently least-loaded shard and must shrink the load spread, so a
    balanced fleet yields an empty plan.  ``dead`` shards (past their
    respawn budget) are never chosen as a destination — an idle
    shard that is idle because it is DEAD is not spare capacity.
    Deterministic in the arguments alone (ties break on tenant/shard
    id)."""
    if n_shards < 2 or k < 1:
        return []
    pool = [i for i in range(n_shards) if i not in set(dead)]
    if len(pool) < 2:
        return []
    live_specs = [dataclasses.replace(
        s, rate_spans_per_s=float(live_rates.get(s.tenant_id, 0.0)))
        for s in specs]
    w = served_rate_model(live_specs, capacity_spans_per_s)
    loads = [0.0] * n_shards
    members: List[List[int]] = [[] for _ in range(n_shards)]
    for s in specs:
        sh = shard_of.get(s.tenant_id, 0)
        loads[sh] += w.get(s.tenant_id, 0.0)
        members[sh].append(s.tenant_id)
    moves: List[tuple] = []
    for _ in range(k):
        hi = max(pool, key=lambda i: (loads[i], -i))
        lo = min(pool, key=lambda i: (loads[i], i))
        if hi == lo or loads[hi] <= loads[lo]:
            break
        moved = False
        for tid in sorted(members[hi],
                          key=lambda t: (-w.get(t, 0.0), t)):
            wt = w.get(tid, 0.0)
            if wt <= 0:
                break
            if max(loads[hi] - wt, loads[lo] + wt) < loads[hi] - 1e-12:
                members[hi].remove(tid)
                members[lo].append(tid)
                loads[hi] -= wt
                loads[lo] += wt
                moves.append((tid, lo))
                moved = True
                break
        if not moved:
            break
    return moves


class ElasticPolicy:
    """The coordinator's tick-boundary scaling brain.

    ``mode`` is the validated ``ANOMOD_SERVE_POLICY`` value: ``auto``
    decides from the signal EWMAs (hysteresis + cooldown), ``script``
    replays a fixed ``ANOMOD_SERVE_POLICY_SCRIPT`` schedule (the
    episode-determinism probe; min/max clamps still apply at
    execution).  The engine owns EXECUTION — this class only observes
    canonical signals and emits decision dicts."""

    def __init__(self, mode: str, min_shards: int, max_shards: int,
                 target_imbalance: float, cooldown_ticks: int,
                 script: str = ""):
        if mode not in ("auto", "script"):
            raise ValueError(f"unknown policy mode {mode!r} "
                             "(auto|script; off = no policy object)")
        self.mode = mode
        self.min_shards = int(min_shards)
        self.max_shards = int(max_shards)
        if not 1 <= self.min_shards <= self.max_shards:
            raise ValueError(
                f"policy shard envelope must satisfy 1 <= min <= max, "
                f"got [{self.min_shards}, {self.max_shards}]")
        self.target_imbalance = float(target_imbalance)
        if self.target_imbalance < 1.0:
            raise ValueError("target imbalance must be >= 1.0")
        self.cooldown_ticks = int(cooldown_ticks)
        if self.cooldown_ticks < 1:
            raise ValueError("cooldown must be >= 1 tick")
        self.script = str(script).strip()
        self._script_actions = validate_policy_script(self.script)
        if mode == "script" and not self._script_actions:
            raise ValueError(
                "ANOMOD_SERVE_POLICY=script needs a non-empty "
                "ANOMOD_SERVE_POLICY_SCRIPT (an empty scripted policy "
                "is a misconfiguration, not a quiet static run)")
        #: per-tenant served-rate EWMA (spans per tick) — the live-rate
        #: input of the rebalance plan
        self.rate_ewma: Dict[int, float] = {}
        #: per-shard staged-chunk EWMA (the leg_walls dispatch book) —
        #: the imbalance signal's numerator
        self.chunk_ewma: List[float] = []
        self.pressure_ewma = 0.0
        self.brownout_level = 0
        self._up_streak = 0
        self._down_streak = 0
        self._hot_streak = 0
        self._cool_streak = 0
        self._last_scale_tick: Optional[int] = None
        self._last_brownout_tick: Optional[int] = None
        #: pacing stamp for rebalance ATTEMPTS that turned out to be
        #: no-ops — separate from the executed-decision cooldown, so a
        #: fleet whose imbalance cannot improve (one unsplittable hot
        #: tenant) never delays a genuinely needed scale-up
        self._last_rebalance_try: Optional[int] = None
        self.n_scale_ups = 0
        self.n_scale_downs = 0
        self.n_rebalances = 0
        self.n_migrated = 0
        self.brownout_ticks = 0
        self._obs_ups = obs.counter("anomod_serve_policy_scale_ups_total")
        self._obs_downs = obs.counter(
            "anomod_serve_policy_scale_downs_total")
        self._obs_rebal = obs.counter(
            "anomod_serve_policy_rebalances_total")
        self._obs_migrated = obs.counter(
            "anomod_serve_policy_migrated_tenants_total")
        self._obs_level = obs.gauge("anomod_serve_policy_brownout_level")
        self._obs_ratio = obs.gauge(
            "anomod_serve_policy_pressure_ewma")
        self._obs_shards = obs.gauge("anomod_serve_policy_shards")

    # -- signal fold (once per virtual tick — the quantization rule) ----

    def observe(self, sig: TickSignals) -> None:
        self.pressure_ewma += ALPHA * (sig.pressure()
                                       - self.pressure_ewma)
        self._obs_ratio.set(self.pressure_ewma)
        # decay every known tenant, then fold this tick's served spans:
        # an idle tenant's rate must decay toward zero or one historic
        # burst would pin it "hot" forever
        for tid in self.rate_ewma:
            self.rate_ewma[tid] *= (1.0 - ALPHA)
        for tid in sorted(sig.served_by_tenant):
            self.rate_ewma[tid] = self.rate_ewma.get(tid, 0.0) \
                + ALPHA * sig.served_by_tenant[tid]
        chunks = list(sig.per_shard_chunks)
        if len(self.chunk_ewma) != len(chunks):
            # topology changed since last tick: new shards start cold,
            # retired shards drop off the end (the engine always grows/
            # shrinks at the tail, so indexes stay aligned)
            self.chunk_ewma = (self.chunk_ewma + [0.0] * len(chunks)
                               )[:len(chunks)]
        for i, c in enumerate(chunks):
            self.chunk_ewma[i] += ALPHA * (c - self.chunk_ewma[i])
        # streak bookkeeping (the SUSTAIN half of the hysteresis)
        self._up_streak = self._up_streak + 1 \
            if self.pressure_ewma > UP_BACKLOG_RATIO else 0
        self._down_streak = self._down_streak + 1 \
            if self.pressure_ewma < DOWN_BACKLOG_RATIO else 0
        self._hot_streak = self._hot_streak + 1 \
            if self.pressure_ewma > BROWNOUT_HI_RATIO else 0
        self._cool_streak = self._cool_streak + 1 \
            if self.pressure_ewma < BROWNOUT_LO_RATIO else 0
        if self.brownout_level:
            self.brownout_ticks += 1

    def imbalance(self) -> float:
        """max/mean of the per-shard chunk EWMAs (1.0 when unloaded or
        single-shard) — the rebalance trigger."""
        if len(self.chunk_ewma) < 2:
            return 1.0
        mean = sum(self.chunk_ewma) / len(self.chunk_ewma)
        return max(self.chunk_ewma) / mean if mean > 0 else 1.0

    # -- decisions ------------------------------------------------------

    def _cooldown_ok(self, tick: int) -> bool:
        return (self._last_scale_tick is None
                or tick - self._last_scale_tick >= self.cooldown_ticks)

    def _brownout_ok(self, tick: int) -> bool:
        return (self._last_brownout_tick is None
                or tick - self._last_brownout_tick >= self.cooldown_ticks)

    def _rebalance_ok(self, tick: int) -> bool:
        return (self._last_rebalance_try is None
                or tick - self._last_rebalance_try >= self.cooldown_ticks)

    def decide(self, tick: int, shards: int) -> List[dict]:
        """The tick's decision list (usually empty; at most one scaling
        action plus at most one brownout step).  ``observe`` must have
        folded this tick's signals first.  Decisions carry only intent —
        the engine clamps against the live envelope and journals what
        actually executed."""
        if self.mode == "script":
            return [dict(a) for a in self._script_actions
                    if a["tick"] == tick]
        out: List[dict] = []
        if self._up_streak >= SUSTAIN_TICKS and self._cooldown_ok(tick):
            if shards < self.max_shards:
                out.append({"action": "up", "tick": tick})
            elif self._hot_streak >= SUSTAIN_TICKS \
                    and self.brownout_level < MAX_BROWNOUT_LEVEL \
                    and self._brownout_ok(tick):
                out.append({"action": "brownout", "tick": tick,
                            "level": self.brownout_level + 1})
        elif self._down_streak >= SUSTAIN_TICKS:
            # relax the ladder BEFORE shrinking the fleet (reverse
            # degradation order: restore observability first)
            if self.brownout_level > 0 and self._brownout_ok(tick):
                out.append({"action": "brownout", "tick": tick,
                            "level": self.brownout_level - 1})
            elif shards > self.min_shards and self._cooldown_ok(tick):
                out.append({"action": "down", "tick": tick})
        elif self.brownout_level > 0 \
                and self._cool_streak >= SUSTAIN_TICKS \
                and self._brownout_ok(tick):
            out.append({"action": "brownout", "tick": tick,
                        "level": self.brownout_level - 1})
        if not out and shards > 1 \
                and self.imbalance() > self.target_imbalance \
                and self._cooldown_ok(tick) and self._rebalance_ok(tick):
            out.append({"action": "rebalance", "tick": tick, "k": 1})
        return out

    # -- execution bookkeeping (the engine reports back) ---------------

    def note_executed(self, action: str, tick: int,
                      migrated: int = 0, level: int = 0,
                      shards: int = 0) -> None:
        """Record an action the engine actually EXECUTED (clamped or
        skipped decisions never reach here): counters, cooldown stamps
        and the brownout level all key off execution, so a decision the
        envelope refused cannot burn the cooldown."""
        self.n_migrated += migrated
        self._obs_migrated.inc(migrated)
        if action == "up":
            self.n_scale_ups += 1
            self._obs_ups.inc()
            self._last_scale_tick = tick
        elif action == "down":
            self.n_scale_downs += 1
            self._obs_downs.inc()
            self._last_scale_tick = tick
        elif action == "rebalance":
            self.n_rebalances += 1
            self._obs_rebal.inc()
            self._last_scale_tick = tick
            self._last_rebalance_try = tick
        elif action == "brownout":
            self.brownout_level = level
            self._obs_level.set(level)
            self._last_brownout_tick = tick
        if shards:
            self._obs_shards.set(shards)

    def note_noop(self, tick: int) -> None:
        """Stamp the REBALANCE-attempt pacing for a decision the engine
        evaluated but had nothing to do (an already-balanced or
        unimprovable rebalance): without the stamp the auto policy
        would re-emit the same no-op every tick until the signal moved.
        Deliberately NOT the executed-decision cooldown — a no-op must
        never delay a genuinely needed scale-up/down (the cooldown
        spaces EXECUTED decisions, the documented contract)."""
        self._last_rebalance_try = tick

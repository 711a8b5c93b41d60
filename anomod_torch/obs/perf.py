"""The performance observatory: the dispatch-lifecycle timeline, the
overlap-bubble analyzer and noise-aware capture diffing (counterpart of
``anomod/obs/perf.py``).  Numpy and host code only: it reads no tensor.

- **The timeline** (:class:`PerfRecorder`, one a shard runner): every
  fused lane dispatch of :class:`~anomod_torch.serve.batcher.BucketRunner`
  records ``staged_t0``/``staged`` (the scratch fill), ``submitted_t0``/
  ``submitted`` (the host-to-device copies and the lane kernel's launch
  enqueued), ``retire_t0`` (the retire began), ``materialized``,
  ``folded``, ``refill`` (the scratch slot was next refilled) and, under
  the deferred commit, ``deferred_t0``/``deferred`` (issued, then read
  at the barrier), keyed by (tick, shard, scratch slot, shape).  The
  stamps are the ``time.perf_counter()`` reads the runner's wall legs
  already take, so the timeline reconciles with ``stage_wall_s`` /
  ``dispatch_wall_s`` / ``fold_wall_s`` to float rounding; the recorder
  adds no synchronization.  On the card the runner's retire issues the
  pool fold on the stream first and then waits on the dispatch's CUDA
  event: ``retire_t0`` is the retire's first read, ``materialized`` the
  read after the event's ``synchronize()`` returned and ``folded`` the
  same read (the fold was enqueued before the wait, so its host span is
  empty), and the wait ``materialized - retire_t0`` is host time blocked
  on the device plus the fold's enqueue.  On the CPU the fold is host
  work and the wait is its wall.  Events drain at the tick barrier onto
  the flight journal's ``perf`` variant key and export as a Chrome /
  Perfetto trace (:func:`perf_tracer`), one lane a (shard, scratch slot).
- **The analyzer** (:func:`analyze_events`): per tick and shard, how much
  of the retire wait the next dispatches' staging could hide.  A wait may
  claim the stage walls of up to ``pipeline`` later dispatches on other
  scratch slots (staging into the waited-on slot is what the wait
  protects), each stage wall once, earliest wait first: an upper bound,
  ``overlap_headroom_s``.
- **Capture diffing** (:func:`diff_captures`, ``perf diff``): decision
  metrics compare byte-exact, wall sample lists (``raw_wall_s``) by a
  seeded bootstrap CI of the mean ratio against the noise floor
  (``ANOMOD_PERF_NOISE_FLOOR``); :func:`capture_history` indexes a runs
  directory (``perf history``).

Recording on or off leaves every serve decision byte-identical.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: perf-timeline document format (the ``perf record`` dump)
PERF_FORMAT = 1

#: the per-dispatch event fields, in lifecycle order (``refill`` is None
#: until the slot's next reuse, which may never come for the run's last
#: dispatch per slot)
EVENT_FIELDS = ("seq", "tick", "shard", "width", "lanes", "slot",
                "staged_t0", "staged", "submitted_t0", "submitted",
                "retire_t0", "materialized", "folded", "refill",
                # the deferred-commit leg (ANOMOD_SERVE_ASYNC_COMMIT):
                # issued-at / barrier-read-at stamps, None on a
                # synchronous engine's events — appended, never
                # reordered, so PERF_FORMAT 1 readers keep working
                "deferred_t0", "deferred")


class PerfRecorder:
    """Per-shard dispatch-lifecycle event recorder.

    One recorder per shard runner (the shard-private registry
    discipline): the BucketRunner's dispatch path calls the ``note_*``
    hooks — keyed by the scratch-slot key ``(width, lanes, slot)``,
    which holds at most ONE in-flight dispatch at a time (a slot refills
    strictly after its dispatch retired), so
    the open-record map can never collide.  ``drain()`` hands the
    completed records to the coordinator at the tick barrier (the
    ``fold_verdicts`` idiom — see :func:`fold_perf_records`).

    Timestamps are ``time.perf_counter()`` seconds handed in by the
    caller — the recorder never reads a clock itself, which is what
    lets the dispatch path reuse the wall-leg reads it already takes.
    """

    def __init__(self, shard: int = 0):
        self.shard = int(shard)
        #: the engine sets this at each tick boundary (the workers are
        #: quiescent there, so no cross-thread write races a dispatch)
        self.tick = 0
        self.seq = 0
        self.n_aborted = 0
        self._open: Dict[tuple, dict] = {}
        self._last_by_key: Dict[tuple, dict] = {}
        self._done: List[dict] = []

    def note_refill(self, key: tuple, t: float) -> None:
        """The scratch slot ``key`` is being refilled at ``t`` — stamp
        the previous dispatch that used it (the slot-refilled event)."""
        last = self._last_by_key.get(key)
        if last is not None and last.get("refill") is None:
            last["refill"] = t

    def note_staged(self, key: tuple, t0: float, t1: float) -> None:
        width, lanes, slot = key
        self._open[key] = {
            "seq": self.seq, "tick": self.tick, "shard": self.shard,
            "width": int(width), "lanes": int(lanes), "slot": int(slot),
            "staged_t0": t0, "staged": t1,
            "submitted_t0": None, "submitted": None, "retire_t0": None,
            "materialized": None, "folded": None, "refill": None,
            "deferred_t0": None, "deferred": None}
        self.seq += 1

    def _rec(self, key: tuple) -> Optional[dict]:
        return self._open.get(key)

    def note_submitted(self, key: tuple, t0: float, t1: float) -> None:
        rec = self._rec(key)
        if rec is not None:
            rec["submitted_t0"] = t0
            rec["submitted"] = t1

    def note_retire(self, key: tuple, t0: float) -> None:
        rec = self._rec(key)
        if rec is not None:
            rec["retire_t0"] = t0

    def note_materialized(self, key: tuple, t: float) -> None:
        rec = self._rec(key)
        if rec is not None:
            rec["materialized"] = t

    def note_deferred(self, key: tuple, t0: float, t1: float) -> None:
        """The dispatch was left in flight under next-tick coordinator
        work from ``t0`` (issue) until the commit barrier read it at
        ``t1`` — the deferred-commit engine stamps every in-flight
        record at the barrier (once: a record re-marked by a forced
        synchronous commit keeps its first stamp)."""
        rec = self._rec(key)
        if rec is not None and rec.get("deferred_t0") is None:
            rec["deferred_t0"] = t0
            rec["deferred"] = t1

    def note_folded(self, key: tuple, t: float) -> None:
        rec = self._open.pop(key, None)
        if rec is not None:
            rec["folded"] = t
            self._last_by_key[key] = rec
            self._done.append(rec)

    def note_aborted(self, key: tuple) -> None:
        """An aborted tick discards its in-flight dispatches without
        folding (``abort_lanes``) — the open record is dropped and
        COUNTED, never silently completed as if it folded."""
        if self._open.pop(key, None) is not None:
            self.n_aborted += 1

    def drain(self) -> List[dict]:
        """Completed records since the last drain, in dispatch order
        (tick-barrier read: the runner is quiescent)."""
        done, self._done = self._done, []
        return done


def fold_perf_records(parts: Sequence[Sequence[dict]]) -> List[dict]:
    """Barrier fold of per-shard perf drains: merge on (shard, seq) so
    the folded timeline order is deterministic regardless of which
    worker drained first — the ``fold_verdicts``/``fold_leg_records``
    idiom (contents are wall clock and ride the journal's VARIANT
    tier; only the ORDER is part of the record's determinism)."""
    out = [rec for part in parts for rec in part]
    out.sort(key=lambda r: (r["shard"], r["seq"]))
    return out


# ---------------------------------------------------------------------------
# the bubble / critical-path analyzer
# ---------------------------------------------------------------------------

def _durations(ev: dict) -> Tuple[float, float, float, float, float]:
    """(stage_s, dispatch_s, wait_s, fold_s, commit_defer_s) of one
    event record — tolerant of partially-filled records (an event that
    never materialized contributes zero to the legs it never reached;
    ``commit_defer_s`` is zero on a synchronous engine's events)."""

    def span(a, b):
        if ev.get(a) is None or ev.get(b) is None:
            return 0.0
        return max(0.0, ev[b] - ev[a])

    return (span("staged_t0", "staged"),
            span("submitted_t0", "submitted"),
            span("retire_t0", "materialized"),
            span("retire_t0", "folded"),
            span("deferred_t0", "deferred"))


def analyze_events(events: Sequence[dict], pipeline: int = 1) -> dict:
    """Aggregate one batch of timeline events into leg sums and the
    overlap-headroom upper bound (model in the module docstring).

    Events are grouped by (tick, shard); within a group they are in
    dispatch order (the ``fold_perf_records`` contract).  Per group,
    each wait ``w_i`` may claim the stage walls of up to ``pipeline``
    LATER dispatches whose slot key differs from ``w_i``'s; a stage
    wall is claimable once (greedy, earliest wait first).  Returns the
    sums plus per-leg totals the reconciliation test pins against the
    five-leg ServeReport walls."""
    groups: Dict[tuple, List[dict]] = {}
    for ev in events:
        groups.setdefault((ev["tick"], ev["shard"]), []).append(ev)
    stage_s = dispatch_s = wait_s = fold_s = headroom_s = 0.0
    commit_defer_s = 0.0
    for key in sorted(groups):
        evs = groups[key]
        stages = []
        for ev in evs:
            st, dp, wt, fd, cd = _durations(ev)
            stage_s += st
            dispatch_s += dp
            wait_s += wt
            fold_s += fd
            commit_defer_s += cd
            stages.append(st)
        claimed = [False] * len(evs)
        for i, ev in enumerate(evs):
            wt = _durations(ev)[2]
            if wt <= 0.0:
                continue
            slot_key = (ev["width"], ev["lanes"], ev["slot"])
            avail = 0.0
            legal = 0
            for j in range(i + 1, len(evs)):
                if legal >= max(int(pipeline), 1):
                    break
                other = evs[j]
                if (other["width"], other["lanes"],
                        other["slot"]) == slot_key:
                    # the scratch-reuse constraint: staging into the
                    # waited-on slot IS what this barrier protects
                    break
                legal += 1
                if claimed[j]:
                    continue
                take = min(stages[j], wt - avail)
                if take > 0.0:
                    avail += take
                    if take >= stages[j]:
                        claimed[j] = True
                    else:
                        stages[j] -= take
                if avail >= wt:
                    break
            headroom_s += min(wt, avail)
    return {"n_events": len(events),
            "stage_s": stage_s, "dispatch_s": dispatch_s,
            "wait_s": wait_s, "fold_s": fold_s,
            "headroom_s": headroom_s,
            # the deferred-commit leg: time dispatches spent executing
            # under next-tick coordinator work before their barrier —
            # the HIDDEN share of the wait (0.0 on a synchronous run)
            "commit_defer_s": commit_defer_s}


def bubble_fractions(wait_s: float, headroom_s: float,
                     fold_wall_s: float, serve_wall_s: float) -> dict:
    """The per-leg bubble fractions the ServeReport carries: what share
    of the fold leg (and of the whole serve wall) is measured execute
    WAIT, and what share of each the analyzer's headroom bound says
    overlap could reclaim.  The fold leg is the only leg with an
    instrumented barrier today (stage/dispatch are host work, score is
    vectorized host math) — their bubble is 0.0 by measurement, kept in
    the dict so the schema names every leg explicitly."""
    fold = max(float(fold_wall_s), 0.0)
    serve = max(float(serve_wall_s), 0.0)

    def frac(num, den):
        return round(min(max(num, 0.0) / den, 1.0), 6) if den > 0 else 0.0

    return {"stage": 0.0, "dispatch": 0.0, "score": 0.0,
            "fold_wait_of_fold": frac(wait_s, fold),
            "fold_wait_of_serve": frac(wait_s, serve),
            "headroom_of_fold": frac(headroom_s, fold),
            "headroom_of_serve": frac(headroom_s, serve)}


def round_events(events: Sequence[dict], ndigits: int = 6) -> List[dict]:
    """Journal-compact copies (timestamps rounded to ``ndigits``) — the
    shape the flight journal's ``perf`` variant key carries."""
    out = []
    for ev in events:
        out.append({k: (round(v, ndigits) if isinstance(v, float) else v)
                    for k, v in ev.items()})
    return out


# ---------------------------------------------------------------------------
# Chrome/Perfetto export (through the existing Tracer.to_chrome)
# ---------------------------------------------------------------------------

def perf_tracer(events: Sequence[dict], service: str = "anomod-perf"):
    """A Tracer whose span list is the dispatch-lifecycle timeline —
    export with ``.to_chrome()`` / ``.dump_chrome()`` (the one chrome
    exporter, so ``spans_from_chrome`` round-trips these spans like any
    other trace).  One Perfetto lane (tid) per (shard, scratch slot);
    shard / pipeline-slot / shape tags ride each span's ``args`` so
    lanes group by shard in the UI.  Spans per dispatch:

    - ``lane.stage``     staged_t0 → staged       (host scratch pack)
    - ``lane.dispatch``  submitted_t0 → submitted (copies + launch
      enqueued)
    - ``lane.inflight``  submitted → materialized (device work in
      flight)
    - ``lane.wait``      retire_t0 → materialized (host BLOCKED — the
      bubble the overlap analyzer prices; nested inside lane.inflight)
    - ``lane.fold``      materialized → folded    (state folds)
    - ``lane.defer``     deferred_t0 → deferred   (deferred-commit mode
      only: in flight under next-tick coordinator work — the hidden
      wait)
    """
    from anomod_torch.utils.tracing import Tracer
    tr = Tracer(service)
    lanes: Dict[tuple, int] = {}
    for ev in sorted(events, key=lambda r: (r["shard"], r["seq"])):
        lane_key = (ev["shard"], ev["width"], ev["lanes"], ev["slot"])
        tid = lanes.setdefault(lane_key, ev["shard"] * 1000 + len(
            [k for k in lanes if k[0] == ev["shard"]]))
        tags = {"shard": ev["shard"], "slot": ev["slot"],
                "width": ev["width"], "lanes": ev["lanes"],
                "tick": ev["tick"]}
        for name, a, b in (("lane.stage", "staged_t0", "staged"),
                           ("lane.dispatch", "submitted_t0", "submitted"),
                           ("lane.inflight", "submitted", "materialized"),
                           ("lane.wait", "retire_t0", "materialized"),
                           ("lane.fold", "materialized", "folded"),
                           ("lane.defer", "deferred_t0", "deferred")):
            if ev.get(a) is None or ev.get(b) is None:
                continue
            tr.add_span(name, ev[a], max(0.0, ev[b] - ev[a]),
                        tid=tid, **tags)
    return tr


# ---------------------------------------------------------------------------
# noise-aware capture diffing (``perf diff``)
# ---------------------------------------------------------------------------

#: keys whose values are seed-determined DECISIONS — byte-exact across
#: same-seed captures at any shard count / pipeline depth / residency,
#: so a mismatch is drift, not noise.  Parity sub-dicts are compared
#: wholesale (every recorded parity bit is a decision about decisions).
_DECISION_KEYS = {
    "shed_fraction", "offered_spans", "served_spans", "n_alerts",
    "fault_detection", "p99_admission_to_scored_latency_s",
    "p50_admission_to_scored_latency_s", "p99_latency_s",
    "p50_latency_s", "shed_fraction_unfused", "p99_latency_s_unfused",
    "topk_hits", "topk_hit_rate", "eligible_fault_tenants",
    "n_fault_tenants", "recorded_ticks", "dropped_ticks",
}

#: scalar wall/throughput keys reported informationally (single
#: samples — the noise model forbids flagging them)
_SCALAR_WALL_PAT = re.compile(
    r"(^|_)(spans_per_sec|wall_s|value|compile_s|overhead_fraction|"
    r"speedup)($|_)")


def _walk(doc, path=""):
    if isinstance(doc, dict):
        for k, v in doc.items():
            yield from _walk(v, f"{path}.{k}" if path else str(k))
    else:
        yield path, doc


def collect_decisions(doc: dict) -> Dict[str, object]:
    """Every decision-metric leaf of a capture, keyed by dotted path:
    the byte-exact comparison surface of :func:`diff_captures`."""
    out: Dict[str, object] = {}
    for path, val in _walk(doc):
        parts = path.split(".")
        leaf = parts[-1]
        if leaf in _DECISION_KEYS or "parity" in parts[:-1] \
                or leaf == "parity":
            out[path] = val
    return out


def collect_wall_samples(doc: dict) -> Dict[str, List[float]]:
    """Every ``raw_wall_s`` sample list, keyed by dotted path — the
    matched-leg pairing surface the bootstrap runs over."""
    out: Dict[str, List[float]] = {}
    for path, val in _walk(doc):
        if path.split(".")[-1] == "raw_wall_s" and isinstance(val, list) \
                and val and all(isinstance(x, (int, float)) for x in val):
            out[path] = [float(x) for x in val]
    return out


def collect_scalar_walls(doc: dict) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for path, val in _walk(doc):
        leaf = path.split(".")[-1]
        if isinstance(val, (int, float)) and not isinstance(val, bool) \
                and _SCALAR_WALL_PAT.search(leaf):
            out[path] = float(val)
    return out


def bootstrap_ratio_ci(a: Sequence[float], b: Sequence[float],
                       n_boot: int = 2000, seed: int = 0,
                       ) -> Tuple[float, float, float]:
    """(ratio, lo, hi): the B/A mean-wall ratio and its 95% bootstrap
    CI (seeded — two diffs of the same captures always agree)."""
    rng = np.random.default_rng(seed)
    av = np.asarray(a, np.float64)
    bv = np.asarray(b, np.float64)
    ma = av[rng.integers(0, av.size, (n_boot, av.size))].mean(axis=1)
    mb = bv[rng.integers(0, bv.size, (n_boot, bv.size))].mean(axis=1)
    ratios = mb / np.maximum(ma, 1e-12)
    lo, hi = np.quantile(ratios, [0.025, 0.975])
    return (float(bv.mean() / max(av.mean(), 1e-12)),
            float(lo), float(hi))


def default_noise_floor() -> float:
    from anomod_torch.config import get_config
    return get_config().perf_noise_floor


def diff_captures(a: dict, b: dict,
                  noise_floor: Optional[float] = None) -> dict:
    """Compare two bench captures: decisions byte-exact, walls by
    bootstrap CI against the explicit noise model.  Returns the
    verdict document ```perf diff``` prints; ``regressions`` is
    the ordered list of statistically significant wall regressions
    (first entry = the first one, in capture order) and
    ``decision_mismatches`` the drifted decision paths."""
    floor = default_noise_floor() if noise_floor is None \
        else float(noise_floor)
    da, db = collect_decisions(a), collect_decisions(b)
    shared = sorted(set(da) & set(db))
    mismatches = [{"path": p, "a": da[p], "b": db[p]}
                  for p in shared if da[p] != db[p]]
    # a comparison that never actually compared the decision surface
    # must not report "ok": when one capture carries decision metrics
    # and the other shares NONE of them (truncated/foreign capture),
    # identical is UNKNOWN, not vacuously true.  Partial overlap stays
    # legitimate — block schemas grow across PRs, and the one-sided
    # keys are listed either way.
    coverage_gap = not shared and bool(da or db)
    wa, wb = collect_wall_samples(a), collect_wall_samples(b)
    walls = []
    regressions = []
    for path in sorted(set(wa) & set(wb)):
        ratio, lo, hi = bootstrap_ratio_ci(wa[path], wb[path])
        if lo > 1.0 + floor:
            verdict = "regression"
        elif hi < 1.0 - floor:
            verdict = "improvement"
        else:
            verdict = "within-noise"
        row = {"path": path, "ratio": round(ratio, 4),
               "ci95": [round(lo, 4), round(hi, 4)],
               "n_a": len(wa[path]), "n_b": len(wb[path]),
               "verdict": verdict}
        walls.append(row)
        if verdict == "regression":
            regressions.append(row)
    sa, sb = collect_scalar_walls(a), collect_scalar_walls(b)
    scalars = []
    for path in sorted(set(sa) & set(sb)):
        if sa[path] <= 0:
            continue
        r = sb[path] / sa[path]
        scalars.append({"path": path, "ratio": round(r, 4),
                        "outside_noise": bool(abs(r - 1.0) > floor)})
    return {
        "check": "anomod_perf_diff",
        "noise_model": {
            "floor_fraction": floor,
            "note": "walls flagged only when the whole 95% bootstrap "
                    "CI of the B/A mean ratio clears 1 + floor; "
                    "single-sample scalars are informational "
                    "(ANOMOD_PERF_NOISE_FLOOR; docs/BENCHMARKS.md "
                    "box noise model)"},
        "decisions": {"compared": len(shared),
                      "identical": (None if coverage_gap
                                    else not mismatches),
                      "only_in_a": sorted(set(da) - set(db)),
                      "only_in_b": sorted(set(db) - set(da))},
        "decision_mismatches": mismatches,
        "walls": walls,
        "scalars": scalars,
        "regressions": regressions,
        "status": ("decision-drift" if mismatches
                   else "decision-coverage-gap" if coverage_gap
                   else "wall-regression" if regressions else "ok"),
    }


# ---------------------------------------------------------------------------
# history (``perf history``)
# ---------------------------------------------------------------------------

def capture_history(runs_dir) -> List[dict]:
    """Index a runs directory of capture JSONs into a trajectory table:
    one row per capture (timestamp order), carrying the headline value and
    the decision anchors, plus the ``perf`` block's overlap headroom
    when the capture has one — "is this PR faster" read off a table
    instead of a prose hedge."""
    rows: List[dict] = []
    root = Path(runs_dir)
    for p in sorted(root.glob("*.json")):
        try:
            doc = json.loads(p.read_text())
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict) or "metric" not in doc:
            continue
        perf = doc.get("perf") if isinstance(doc.get("perf"), dict) \
            else {}
        rows.append({
            "file": p.name,
            "timestamp_utc": doc.get("timestamp_utc"),
            "git_sha": doc.get("git_sha"),
            "metric": doc.get("metric"),
            "value": doc.get("value"),
            "unit": doc.get("unit"),
            "p99_latency_s":
                doc.get("p99_admission_to_scored_latency_s"),
            "shed_fraction": doc.get("shed_fraction"),
            "n_wall_sample_legs": len(collect_wall_samples(doc)),
            "overlap_headroom_s": perf.get("overlap_headroom_s"),
        })
    rows.sort(key=lambda r: (r["timestamp_utc"] or "", r["file"]))
    return rows

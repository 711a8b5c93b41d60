"""Scripted fault injection aimed at the serve plane itself (counterpart
of ``anomod/serve/chaos.py``).

A validated fault script (``ANOMOD_SERVE_CHAOS``, off by default; the
grammar is :func:`anomod_torch.config.validate_chaos_script`) injects the
serve plane's own faults (shard-worker crashes mid-tick, score-path
exceptions, slow-shard stalls, state-pool fold failures, arrival surges)
at deterministic (tick, shard, phase) points of the score path, so the
supervised engine's checkpoint / restore recovery
(:mod:`anomod_torch.serve.supervise`) can be driven and checked.

Faults key on the ORIGIN tick of the slice being scored (the tick its
batches were drained on), never the wall clock: a recovery re-execution
of an older slice never re-trips a fault scripted for a newer tick, and
a fault's ``repeat`` budget counts attempts at its own tick's slice.
With ``repeat=1`` (the default) the first recovery retry runs clean;
``repeat=-1`` fails every attempt.
"""

from __future__ import annotations

import threading
import time
from typing import List

from anomod_torch import obs
from anomod_torch.config import (CHAOS_KINDS, CHAOS_PHASES,
                                 validate_chaos_script)

__all__ = ["CHAOS_KINDS", "CHAOS_PHASES", "ChaosFault",
           "ChaosWorkerCrash", "ServeChaos"]


class ChaosFault(RuntimeError):
    """An injected serve-plane fault: a score-path exception; the shard
    worker survives, the tick fails at the barrier."""
    #: read by ``ShardWorker._loop`` and the process child: a true value
    #: ends the worker after it reports the error
    kills_worker = False


class ChaosWorkerCrash(ChaosFault):
    """An injected shard-worker crash: the error reaches the barrier AND
    the worker ends (respawning it is the supervisor's job)."""
    kills_worker = True


class _Fault:
    __slots__ = ("kind", "tick", "shard", "phase", "ms", "repeat",
                 "factor", "ticks", "fired")

    def __init__(self, spec: dict):
        self.kind = spec["kind"]
        self.tick = spec["tick"]
        self.shard = spec["shard"]
        self.phase = spec["phase"]
        self.ms = spec["ms"]
        self.repeat = spec["repeat"]
        self.factor = spec["factor"]
        self.ticks = spec["ticks"]
        self.fired = 0


class ServeChaos:
    """The injector the engine consults at every score-path phase
    boundary (:meth:`hit`).  Shard workers hit it concurrently, so the
    fired counts are kept under a lock: a fault's ``repeat`` budget is
    exact under any interleaving."""

    def __init__(self, script: str):
        self.script = str(script).strip()
        self.faults: List[_Fault] = [
            _Fault(spec) for spec in validate_chaos_script(self.script)]
        self._lock = threading.Lock()
        self.n_injected = 0
        self.n_stalls = 0
        self._obs_injected = obs.counter(
            "anomod_serve_chaos_injected_total")
        self._obs_stalls = obs.counter("anomod_serve_chaos_stalls_total")

    def surge_factor(self, tick: int) -> int:
        """The fleet-wide arrival multiplier at virtual ``tick``: the
        product of every active ``surge``'s factor (a function of the
        tick alone, so a replay amplifies the same arrivals).  A surge's
        first tick counts as one injection."""
        factor = 1
        for f in self.faults:
            if f.kind != "surge" or not f.tick <= tick < f.tick + f.ticks:
                continue
            factor *= f.factor
            if tick == f.tick:
                with self._lock:
                    if f.fired == 0:
                        f.fired = 1
                        self.n_injected += 1
                        self._obs_injected.inc()
        return factor

    def hit(self, phase: str, tick: int, shard: int) -> None:
        """One score-path phase boundary on one shard's slice of one
        ORIGIN tick: raises (or stalls) as the script says, else does
        nothing."""
        for f in self.faults:
            if f.kind == "surge" or f.tick != tick or f.shard != shard \
                    or f.phase != phase:
                continue
            with self._lock:
                if 0 <= f.repeat <= f.fired:
                    continue
                f.fired += 1
                self.n_injected += 1
                self._obs_injected.inc()
                if f.kind == "stall":
                    self.n_stalls += 1
                    self._obs_stalls.inc()
            where = (f"@tick {tick} shard {shard} phase {phase} "
                     f"(attempt {f.fired})")
            if f.kind == "stall":
                # anomod-lint: disable=D101 — the stall FAULT is a scripted wall delay by definition; it perturbs walls (variant tier), never decisions
                time.sleep(f.ms / 1000.0)
            elif f.kind == "crash":
                raise ChaosWorkerCrash(f"chaos: shard-worker crash "
                                       f"{where}")
            elif f.kind == "poolput":
                raise ChaosFault(f"chaos: state-pool put failure {where}")
            else:
                raise ChaosFault(f"chaos: injected exception {where}")

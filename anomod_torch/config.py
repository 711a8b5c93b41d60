"""The port's settings, read from the environment (the ingest, telemetry
and online-RCA halves of ``anomod/config.py``).

The same variables as the JAX package's ``Config``, with its defaults,
validation and error messages; reference-style ``{PLACEHOLDER}`` values
count as unset.  The data layer:

- ``ANOMOD_DATA_ROOT``: the archive root holding ``SN_data/`` and
  ``TT_data/``.  Unset: no archive, every modality comes from the
  synthetic generator.
- ``ANOMOD_SYNTH_ON_LFS``: synth-fill modalities that are missing or
  git-LFS pointer stubs (default on; ``0`` / ``false`` turn it off).
- ``ANOMOD_CACHE_DIR``: the ingest cache root; ``0`` / ``off`` / ``none``
  / ``disabled`` / ``false`` disable the cache.  Unset: ``build/
  anomod_torch_cache`` inside the checkout, so the port writes nothing
  outside it.
- ``ANOMOD_INGEST_WORKERS``: the corpus loader's process-pool size (0 or
  1: serial); anything but a non-negative integer raises ``ValueError``.

Telemetry (``anomod_torch.obs``):

- ``ANOMOD_OBS_ENABLED``: the process registry's switch (default on;
  ``0`` / ``false`` / ``off`` / ``no`` make every handle a no-op).
- ``ANOMOD_OBS_MAX_SAMPLES``: the scrape journal's bound (default
  500,000).
- ``ANOMOD_OBS_HTTP`` / ``ANOMOD_OBS_HTTP_PORT``: the localhost
  ``/metrics`` endpoint (default off, port 9464; 0 asks the OS).

Online RCA in the serve tick (``anomod_torch.serve.rca``):
``ANOMOD_SERVE_RCA`` (default off), ``ANOMOD_SERVE_RCA_BUCKETS``
(``NODESxNEIGHBORS`` pairs, default ``16x8,64x16``),
``ANOMOD_SERVE_RCA_TOPK`` (5), ``ANOMOD_SERVE_RCA_BUDGET`` (4 runs a
tick) and ``ANOMOD_SERVE_RCA_WINDOWS`` (8).

Shards (``anomod_torch.serve.shard``, ``anomod_torch.serve.procshard``):
``ANOMOD_SERVE_SHARDS`` (engine workers, 1-256, default 1),
``ANOMOD_SERVE_FOLD`` (the tick barrier's registry merge, ``sparse`` or
``dense``), ``ANOMOD_SERVE_WORKER`` (``thread``, the default, or
``process``: one spawned worker process a shard) and
``ANOMOD_SERVE_WORKER_START_TIMEOUT_S`` (a process worker's start-up
bound, 1-3600 s, default 120).

Chaos and supervision (``anomod_torch.serve.chaos``,
``anomod_torch.serve.supervise``): ``ANOMOD_SERVE_CHAOS`` (a fault
script, :func:`validate_chaos_script`; empty, the default, is off),
``ANOMOD_SERVE_CKPT_EVERY`` (checkpoint cadence in ticks, default 32;
``0`` turns supervision off), ``ANOMOD_SERVE_RETRIES`` (consecutive
failures of one slice before it is quarantined, default 3),
``ANOMOD_SERVE_RETRY_BACKOFF_S`` (default 0) and
``ANOMOD_SERVE_MAX_RESPAWNS`` (a shard's worker respawns before its
tenants migrate, default 8).

The elastic policy (``anomod_torch.serve.policy``): ``ANOMOD_SERVE_POLICY``
(``off``, the default, ``auto`` or ``script``),
``ANOMOD_SERVE_POLICY_SCRIPT`` (a scaling script,
:func:`validate_policy_script`), ``ANOMOD_SERVE_POLICY_MIN_SHARDS`` (1)
and ``_MAX_SHARDS`` (8), ``ANOMOD_SERVE_POLICY_TARGET_IMBALANCE`` (1.5)
and ``ANOMOD_SERVE_POLICY_COOLDOWN_TICKS`` (8).  The deferred-commit
tick: ``ANOMOD_SERVE_ASYNC_COMMIT`` (default off).  State tiering
(``anomod_torch.serve.tiering``): ``ANOMOD_SERVE_TIER_HOT`` (pool-resident
tenants before demotion, 0 = off, the default),
``ANOMOD_SERVE_TIER_DEMOTE_AFTER`` (idle ticks, 8),
``ANOMOD_SERVE_TIER_WARM_BYTES`` (64 MiB), ``ANOMOD_SERVE_TIER_COLD_DIR``
(unset: no cold tier) and ``ANOMOD_SERVE_TIER_PREFETCH`` (1-256, 4).

The flight recorder (``anomod_torch.obs.flight``): ``ANOMOD_FLIGHT``
(default on), ``ANOMOD_FLIGHT_DIGEST_EVERY`` (tenant-state digest
cadence in ticks, default 16), ``ANOMOD_FLIGHT_MAX_TICKS`` (the ring,
default 65536) and ``ANOMOD_FLIGHT_DUMP_DIR`` (the alert-triggered
forensic bundle's directory, default none).

The live feed (``anomod_torch.serve.feed``): ``ANOMOD_SERVE_FEED_LAG_S``
(the wall-to-virtual lag budget in seconds, [0, 3600], default 2.0) and
``ANOMOD_FEED_JOURNAL`` (the wire journal's path; unset or ``off``: no
recording).

The serve plane's shape (``anomod_torch.serve``): ``ANOMOD_SERVE_BUCKETS``
and ``ANOMOD_SERVE_LANE_BUCKETS`` (comma-separated, strictly ascending),
``ANOMOD_SERVE_FUSE`` (default on), ``ANOMOD_SERVE_PIPELINE`` (1-64,
default 2), ``ANOMOD_SERVE_STATE`` (``auto`` = ``device``, or ``host``),
``ANOMOD_SERVE_LANE_ENGINE`` (``auto``, the default, ``matmul``,
``scatter`` or ``pallas``, as the JAX package parses it),
``ANOMOD_SERVE_MAX_BACKLOG`` (spans, default 200,000),
``ANOMOD_SERVE_NATIVE_DRAIN`` and ``ANOMOD_NATIVE`` (``auto``, ``on`` or
``off``: the admission drain's and the scratch fill's C++ routes; ``off``
picks the Python oracle, and ``auto`` and ``on`` both build the C++
library, a failed build raising) and ``ANOMOD_SEED`` (default 1).

The observatories: ``ANOMOD_PERF`` (the dispatch-lifecycle timeline,
:mod:`anomod_torch.obs.perf`, default off), ``ANOMOD_PERF_MAX_EVENTS``
(retained events, default 262,144) and ``ANOMOD_PERF_NOISE_FLOOR`` (the
noise fraction ``perf diff`` tests wall ratios against, default 0.35);
``ANOMOD_CENSUS`` (the resident-bytes census,
:mod:`anomod_torch.obs.census`, default off), ``ANOMOD_CENSUS_EVERY``
(cadence in ticks, default 8), ``ANOMOD_CENSUS_DECAY_TICKS`` (hot-set
thresholds, default ``4,16,64,256``), ``ANOMOD_CENSUS_SWEEP`` (the probe's
registered-fleet sizes, at least two, default ``1000,10000,100000``) and
``ANOMOD_CENSUS_COLDEST_K`` (the coldest-candidate preview, default 8).

The t-digest plane (``anomod_torch.replay``): ``ANOMOD_TDIGEST_ENGINE``
(``auto``, the default, ``host``, ``xla`` or ``pallas``, case-folded as
the JAX package does, an unknown value raising ``unknown t-digest
engine``).  Both engine knobs keep the JAX values; on the card only the
port's kernels run, so a card path takes ``auto`` or ``pallas`` and
refuses the values that name JAX formulations before anything launches
(:func:`refuse_on_card`).  On the CPU every value runs the plain
versions.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

#: the cache root when ``ANOMOD_CACHE_DIR`` is unset
DEFAULT_CACHE_DIR = (Path(__file__).resolve().parent.parent / "build"
                     / "anomod_torch_cache")

_CACHE_OFF = ("0", "off", "none", "disabled", "false")


def _env(name: str, default: str) -> str:
    val = os.environ.get(name, "").strip()
    if not val or (val.startswith("{") and val.endswith("}")):
        return default
    return val


def _data_root_env() -> Optional[Path]:
    raw = _env("ANOMOD_DATA_ROOT", "")
    return Path(raw) if raw else None


def _cache_dir_env() -> Optional[Path]:
    raw = _env("ANOMOD_CACHE_DIR", "")
    if raw.lower() in _CACHE_OFF:
        return None
    if raw:
        return Path(raw).expanduser()
    return DEFAULT_CACHE_DIR


def _ingest_workers_env() -> int:
    raw = _env("ANOMOD_INGEST_WORKERS", "0")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_INGEST_WORKERS must be a non-negative integer "
            f"(0/1 = serial), got {raw!r}")
    if n < 0:
        raise ValueError(
            f"ANOMOD_INGEST_WORKERS must be >= 0, got {n}")
    return n


def _obs_enabled_env() -> bool:
    return _env("ANOMOD_OBS_ENABLED", "1").strip().lower() \
        not in ("0", "false", "off", "no")


def _obs_max_samples_env() -> int:
    raw = _env("ANOMOD_OBS_MAX_SAMPLES", "500000")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_OBS_MAX_SAMPLES must be a positive integer, "
            f"got {raw!r}")
    if n < 1:
        raise ValueError(
            f"ANOMOD_OBS_MAX_SAMPLES must be >= 1, got {n}")
    return n


def _obs_http_env() -> bool:
    raw = _env("ANOMOD_OBS_HTTP", "0").strip().lower()
    if raw in ("1", "on", "true", "yes"):
        return True
    if raw in ("0", "off", "false", "no", ""):
        return False
    raise ValueError(
        f"ANOMOD_OBS_HTTP must be 0/off/false/no or "
        f"1/on/true/yes, got {raw!r}")


def _obs_http_port_env() -> int:
    raw = _env("ANOMOD_OBS_HTTP_PORT", "9464")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_OBS_HTTP_PORT must be an integer port, got {raw!r}")
    if not 0 <= n <= 65535:
        raise ValueError(
            f"ANOMOD_OBS_HTTP_PORT must be in [0, 65535], got {n}")
    return n


def _serve_rca_env() -> bool:
    return _env("ANOMOD_SERVE_RCA", "0").strip().lower() \
        not in ("0", "false", "off", "no", "")


#: the online-RCA scorer's (nodes, sampled neighbors) bucket grid: a
#: tenant's graph pads into the smallest bucket holding its service table
DEFAULT_SERVE_RCA_BUCKETS = ((16, 8), (64, 16))


def validate_rca_buckets(buckets) -> tuple:
    """The RCA bucket-grid contract: (nodes, neighbors) int pairs with
    strictly ascending node counts, every dimension >= 1."""
    try:
        out = tuple((int(n), int(k)) for n, k in buckets)
    except (TypeError, ValueError):
        raise ValueError(
            f"RCA bucket grid must be (nodes, neighbors) integer pairs, "
            f"got {buckets!r}")
    if not out:
        raise ValueError("RCA bucket grid must not be empty")
    if any(n < 1 or k < 1 for n, k in out):
        raise ValueError(f"RCA bucket dims must be >= 1, got {out}")
    if any(a[0] >= b[0] for a, b in zip(out, out[1:])):
        raise ValueError(
            f"RCA bucket node counts must be strictly ascending: {out}")
    return out


def _serve_rca_buckets_env() -> tuple:
    raw = _env("ANOMOD_SERVE_RCA_BUCKETS", "")
    if not raw:
        return DEFAULT_SERVE_RCA_BUCKETS
    pairs = []
    for part in (p.strip() for p in raw.split(",") if p.strip()):
        dims = part.lower().split("x")
        if len(dims) != 2:
            raise ValueError(
                f"ANOMOD_SERVE_RCA_BUCKETS entries must be NODESxNEIGHBORS "
                f"pairs, got {part!r}")
        pairs.append(dims)
    try:
        return validate_rca_buckets(pairs)
    except ValueError as e:
        raise ValueError(f"ANOMOD_SERVE_RCA_BUCKETS: {e}") from e


def _serve_rca_int_env(name: str, default: str, lo: int, hi: int) -> int:
    raw = _env(name, default)
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}")
    if not lo <= n <= hi:
        raise ValueError(f"{name} must be in [{lo}, {hi}], got {n}")
    return n


def _serve_buckets_env() -> tuple:
    from anomod_torch.serve.config import (DEFAULT_SERVE_BUCKETS,
                                           validate_serve_buckets)
    raw = _env("ANOMOD_SERVE_BUCKETS", "")
    if not raw:
        return DEFAULT_SERVE_BUCKETS
    parts = [p.strip() for p in raw.split(",") if p.strip()]
    try:
        return validate_serve_buckets(parts)
    except ValueError as e:
        raise ValueError(f"ANOMOD_SERVE_BUCKETS: {e}") from e


def _serve_lane_buckets_env() -> tuple:
    from anomod_torch.serve.config import (DEFAULT_SERVE_LANE_BUCKETS,
                                           validate_lane_buckets)
    raw = _env("ANOMOD_SERVE_LANE_BUCKETS", "")
    if not raw:
        return DEFAULT_SERVE_LANE_BUCKETS
    parts = [p.strip() for p in raw.split(",") if p.strip()]
    try:
        return validate_lane_buckets(parts)
    except ValueError as e:
        raise ValueError(f"ANOMOD_SERVE_LANE_BUCKETS: {e}") from e


def _serve_fuse_env() -> bool:
    return _env("ANOMOD_SERVE_FUSE", "1").strip().lower() \
        not in ("0", "false", "off", "no")


def _serve_pipeline_env() -> int:
    raw = _env("ANOMOD_SERVE_PIPELINE", "2")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_PIPELINE must be a positive integer, got {raw!r}")
    if not 1 <= n <= 64:
        raise ValueError(
            f"ANOMOD_SERVE_PIPELINE must be in [1, 64], got {n}")
    return n


def _serve_state_env() -> str:
    raw = _env("ANOMOD_SERVE_STATE", "auto").strip().lower()
    if raw in ("auto", ""):
        return "auto"
    if raw in ("host", "device"):
        return raw
    raise ValueError(
        f"ANOMOD_SERVE_STATE must be auto, host or device, got {raw!r}")


def validate_serve_lane_engine(raw: Optional[str]) -> str:
    """An ``ANOMOD_SERVE_LANE_ENGINE`` value, normalized as the JAX
    package does (``auto`` when empty)."""
    raw = (raw or "auto").strip().lower()
    if raw in ("auto", ""):
        return "auto"
    if raw in ("matmul", "scatter", "pallas"):
        return raw
    raise ValueError(
        "ANOMOD_SERVE_LANE_ENGINE must be auto, matmul, scatter or "
        f"pallas, got {raw!r}")


def validate_tdigest_engine(raw: Optional[str]) -> str:
    """An ``ANOMOD_TDIGEST_ENGINE`` value, normalized as the JAX package
    does (``auto`` when empty)."""
    raw = (raw or "auto").strip().lower()
    if raw in ("auto", ""):
        return "auto"
    if raw in ("host", "xla", "pallas"):
        return raw
    raise ValueError(f"unknown t-digest engine {raw!r}")


#: the engine knobs' values a card path takes: both name the port's
#: kernels (``pallas`` is the counterpart of the JAX package's Mosaic
#: kernel); the other values name JAX formulations the port does not carry
CARD_ENGINES = ("auto", "pallas")


def refuse_on_card(knob: str, value: str, device) -> None:
    """Raise ``ValueError`` when ``device`` is a card and ``value`` (of the
    engine knob ``knob``) names a JAX formulation: no knob value routes
    the card to a plain version.  ``device`` (a device, its name, or None
    for the card) is only looked at."""
    kind = ("cuda" if device is None
            else getattr(device, "type", str(device).split(":")[0]))
    if kind == "cuda" and value not in CARD_ENGINES:
        raise ValueError(
            f"{knob}={value!r} names a JAX formulation; on the card it "
            "takes auto or pallas (the port's kernels)")


def _auto_on_off_env(name: str) -> str:
    """``auto`` (the default), ``on`` (``1``/``true``/``yes``) or ``off``
    (``0``/``false``/``no``)."""
    raw = _env(name, "auto").strip().lower()
    if raw in ("auto", ""):
        return "auto"
    if raw in ("1", "on", "true", "yes"):
        return "on"
    if raw in ("0", "off", "false", "no"):
        return "off"
    raise ValueError(f"{name} must be auto, on/1 or off/0, got {raw!r}")


def _serve_max_backlog_env() -> int:
    raw = _env("ANOMOD_SERVE_MAX_BACKLOG", "200000")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_MAX_BACKLOG must be a positive integer, "
            f"got {raw!r}")
    if n < 1:
        raise ValueError(
            f"ANOMOD_SERVE_MAX_BACKLOG must be >= 1, got {n}")
    return n


def _serve_shards_env() -> int:
    raw = _env("ANOMOD_SERVE_SHARDS", "1")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_SHARDS must be a positive integer, got {raw!r}")
    if not 1 <= n <= 256:
        raise ValueError(
            f"ANOMOD_SERVE_SHARDS must be in [1, 256], got {n}")
    return n


def _serve_fold_env() -> str:
    raw = _env("ANOMOD_SERVE_FOLD", "sparse").strip().lower()
    if raw in ("sparse", ""):
        return "sparse"
    if raw == "dense":
        return "dense"
    raise ValueError(
        f"ANOMOD_SERVE_FOLD must be dense or sparse, got {raw!r}")


def validate_serve_worker(raw: str) -> str:
    """The shard-worker kind: ``thread`` (in-process worker threads, the
    byte-parity oracle) or ``process`` (one spawned worker process a
    shard, :mod:`anomod_torch.serve.procshard`)."""
    mode = str(raw).strip().lower() or "thread"
    if mode in ("thread", "process"):
        return mode
    raise ValueError(
        f"ANOMOD_SERVE_WORKER must be thread or process, got {raw!r}")


def _serve_worker_start_timeout_s_env() -> float:
    raw = _env("ANOMOD_SERVE_WORKER_START_TIMEOUT_S", "120")
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_WORKER_START_TIMEOUT_S must be a number, "
            f"got {raw!r}")
    if not 1 <= v <= 3600:
        raise ValueError(
            f"ANOMOD_SERVE_WORKER_START_TIMEOUT_S must be in [1, 3600], "
            f"got {v}")
    return v


#: the serve-chaos fault kinds (:mod:`anomod_torch.serve.chaos`):
#: ``crash`` kills the shard worker mid-tick, ``except`` raises at a
#: score-path phase, ``stall`` sleeps, ``poolput`` fails the state-pool
#: fold, ``surge`` multiplies every tenant's offered arrivals for a
#: window of ticks.  The phases are the score path's five injection
#: points; a surge has none (it acts on admission input).
CHAOS_KINDS = ("crash", "except", "stall", "poolput", "surge")
CHAOS_PHASES = ("stage", "dispatch", "fold", "score", "commit")
_CHAOS_DEFAULT_PHASE = {"crash": "dispatch", "except": "dispatch",
                        "stall": "stage", "poolput": "fold",
                        "surge": "stage"}


def validate_chaos_script(script: str) -> list:
    """Parse and validate an ``ANOMOD_SERVE_CHAOS`` fault script.

    Grammar: semicolon-separated ``KIND@TICK[:key=value]*`` items, e.g.
    ``crash@5:shard=1;stall@8:ms=20;except@12:phase=score:repeat=2``.
    Keys: ``shard`` (default 0), ``phase`` (one of :data:`CHAOS_PHASES`,
    a default per kind), ``ms`` (stall milliseconds, default 10, at most
    10,000), ``repeat`` (how many attempts of that tick's slice the
    fault fires on, default 1; ``-1`` fires on every attempt).  A
    ``surge`` takes ``factor`` (2-64, default 4) and ``ticks`` (default
    10) instead; a key of the other family is refused.  Returns the
    parsed fault dicts; raises ``ValueError`` naming the offending
    item, with the JAX package's messages."""
    faults = []
    for item in (p.strip() for p in str(script).split(";") if p.strip()):
        head, _, tail = item.partition(":")
        kind, at, tick = head.partition("@")
        kind = kind.strip().lower()
        if kind not in CHAOS_KINDS or not at:
            raise ValueError(
                f"chaos item {item!r}: expected KIND@TICK with KIND in "
                f"{'/'.join(CHAOS_KINDS)}")
        try:
            tick_i = int(tick)
        except ValueError:
            raise ValueError(f"chaos item {item!r}: tick must be an "
                             f"integer, got {tick!r}")
        if tick_i < 0:
            raise ValueError(f"chaos item {item!r}: tick must be >= 0")
        fault = {"kind": kind, "tick": tick_i, "shard": 0,
                 "phase": _CHAOS_DEFAULT_PHASE[kind], "ms": 10.0,
                 "repeat": 1, "factor": 4, "ticks": 10}
        allowed = (("factor", "ticks") if kind == "surge"
                   else ("shard", "phase", "ms", "repeat"))
        for kv in (p.strip() for p in tail.split(":") if p.strip()):
            key, eq, val = kv.partition("=")
            key = key.strip().lower()
            if not eq or key not in allowed:
                raise ValueError(
                    f"chaos item {item!r}: unknown key {kv!r} (want "
                    + "/".join(f"{k}=" for k in allowed) + ")")
            try:
                if key == "phase":
                    val = val.strip().lower()
                    if val not in CHAOS_PHASES:
                        raise ValueError
                    fault["phase"] = val
                elif key == "ms":
                    fault["ms"] = float(val)
                    if not 0 <= fault["ms"] <= 10_000:
                        raise ValueError
                else:
                    fault[key] = int(val)
            except ValueError:
                raise ValueError(
                    f"chaos item {item!r}: bad value for {key!r}: {val!r}")
        if fault["shard"] < 0:
            raise ValueError(f"chaos item {item!r}: shard must be >= 0")
        if fault["repeat"] < -1 or fault["repeat"] == 0:
            raise ValueError(f"chaos item {item!r}: repeat must be a "
                             "positive count or -1 (forever)")
        if not 2 <= fault["factor"] <= 64:
            raise ValueError(f"chaos item {item!r}: surge factor must "
                             f"be in [2, 64], got {fault['factor']}")
        if not 1 <= fault["ticks"] <= 1_000_000:
            raise ValueError(f"chaos item {item!r}: surge ticks must "
                             f"be in [1, 1000000], got {fault['ticks']}")
        faults.append(fault)
    return faults


def _serve_chaos_env() -> str:
    raw = _env("ANOMOD_SERVE_CHAOS", "").strip()
    if raw:
        validate_chaos_script(raw)
    return raw


def _serve_ckpt_every_env() -> int:
    raw = _env("ANOMOD_SERVE_CKPT_EVERY", "32")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_CKPT_EVERY must be a non-negative integer "
            f"(0 = supervision off), got {raw!r}")
    if not 0 <= n <= 1_000_000:
        raise ValueError(
            f"ANOMOD_SERVE_CKPT_EVERY must be in [0, 1000000], got {n}")
    return n


def _serve_retries_env() -> int:
    raw = _env("ANOMOD_SERVE_RETRIES", "3")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_RETRIES must be a positive integer, got {raw!r}")
    if not 1 <= n <= 64:
        raise ValueError(
            f"ANOMOD_SERVE_RETRIES must be in [1, 64], got {n}")
    return n


def _serve_retry_backoff_s_env() -> float:
    raw = _env("ANOMOD_SERVE_RETRY_BACKOFF_S", "0")
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_RETRY_BACKOFF_S must be a number, got {raw!r}")
    if not 0 <= v <= 60:
        raise ValueError(
            f"ANOMOD_SERVE_RETRY_BACKOFF_S must be in [0, 60], got {v}")
    return v


def _serve_max_respawns_env() -> int:
    raw = _env("ANOMOD_SERVE_MAX_RESPAWNS", "8")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_MAX_RESPAWNS must be a non-negative integer, "
            f"got {raw!r}")
    if not 0 <= n <= 4096:
        raise ValueError(
            f"ANOMOD_SERVE_MAX_RESPAWNS must be in [0, 4096], got {n}")
    return n


#: the elastic policy's decision kinds (:mod:`anomod_torch.serve.policy`):
#: ``up`` grows the shard set by one worker, ``down`` drains and retires
#: the highest shard, ``rebalance`` moves the top-K hottest tenants off the
#: most-loaded shard, ``brownout`` forces a degradation-ladder level
POLICY_ACTIONS = ("up", "down", "rebalance", "brownout")


def validate_policy_script(script: str) -> list:
    """Parse and validate an ``ANOMOD_SERVE_POLICY_SCRIPT`` scaling script.

    Grammar: semicolon-separated ``ACTION@TICK[:key=value]`` items with
    ACTION in :data:`POLICY_ACTIONS`, e.g.
    ``up@10;rebalance@25:k=2;down@40;brownout@50:level=1``.  Keys: ``k``
    (rebalance move count, default 1) and ``level`` (brownout level 0..2,
    default 1); a key on the wrong action is refused.  Returns the action
    dicts; the JAX package's grammar and messages."""
    actions = []
    for item in (p.strip() for p in str(script).split(";") if p.strip()):
        head, _, tail = item.partition(":")
        act, at, tick = head.partition("@")
        act = act.strip().lower()
        if act not in POLICY_ACTIONS or not at:
            raise ValueError(
                f"policy item {item!r}: expected ACTION@TICK with "
                f"ACTION in {'/'.join(POLICY_ACTIONS)}")
        try:
            tick_i = int(tick)
        except ValueError:
            raise ValueError(f"policy item {item!r}: tick must be an "
                             f"integer, got {tick!r}")
        if tick_i < 0:
            raise ValueError(f"policy item {item!r}: tick must be >= 0")
        entry = {"action": act, "tick": tick_i, "k": 1, "level": 1}
        allowed = {"rebalance": ("k",), "brownout": ("level",)} \
            .get(act, ())
        for kv in (p.strip() for p in tail.split(":") if p.strip()):
            key, eq, val = kv.partition("=")
            key = key.strip().lower()
            if not eq or key not in allowed:
                raise ValueError(
                    f"policy item {item!r}: unknown key {kv!r}"
                    + (f" (want {'/'.join(f'{k}=' for k in allowed)})"
                       if allowed else f" ({act} takes no keys)"))
            try:
                entry[key] = int(val)
            except ValueError:
                raise ValueError(
                    f"policy item {item!r}: bad value for {key!r}: "
                    f"{val!r}")
        if not 1 <= entry["k"] <= 1024:
            raise ValueError(f"policy item {item!r}: k must be in "
                             f"[1, 1024], got {entry['k']}")
        if not 0 <= entry["level"] <= 2:
            raise ValueError(f"policy item {item!r}: level must be in "
                             f"[0, 2], got {entry['level']}")
        actions.append(entry)
    return actions


def _serve_policy_env() -> str:
    raw = _env("ANOMOD_SERVE_POLICY", "off").strip().lower()
    if raw in ("off", ""):
        return "off"
    if raw in ("auto", "script"):
        return raw
    raise ValueError(
        f"ANOMOD_SERVE_POLICY must be off, auto or script, got {raw!r}")


def _serve_policy_script_env() -> str:
    raw = _env("ANOMOD_SERVE_POLICY_SCRIPT", "").strip()
    if raw:
        validate_policy_script(raw)
    return raw


def _serve_policy_int_env(name: str, default: str, lo: int,
                          hi: int) -> int:
    raw = _env(name, default)
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}")
    if not lo <= n <= hi:
        raise ValueError(f"{name} must be in [{lo}, {hi}], got {n}")
    return n


def _serve_policy_target_imbalance_env() -> float:
    raw = _env("ANOMOD_SERVE_POLICY_TARGET_IMBALANCE", "1.5")
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_POLICY_TARGET_IMBALANCE must be a number, "
            f"got {raw!r}")
    if not 1.0 <= v <= 100.0:
        raise ValueError(
            f"ANOMOD_SERVE_POLICY_TARGET_IMBALANCE must be in "
            f"[1.0, 100.0], got {v}")
    return v


def _serve_async_commit_env() -> bool:
    # explicit token sets: the knob flips the whole tick structure, so a
    # typo fails here instead of serving synchronously
    raw = _env("ANOMOD_SERVE_ASYNC_COMMIT", "0").strip().lower()
    if raw in ("1", "on", "true", "yes"):
        return True
    if raw in ("0", "off", "false", "no", ""):
        return False
    raise ValueError(
        f"ANOMOD_SERVE_ASYNC_COMMIT must be 0/off/false/no or "
        f"1/on/true/yes, got {raw!r}")


def _serve_tier_hot_env() -> int:
    raw = _env("ANOMOD_SERVE_TIER_HOT", "0")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_TIER_HOT must be a non-negative integer "
            f"(0 = tiering off), got {raw!r}")
    if n < 0:
        raise ValueError(
            f"ANOMOD_SERVE_TIER_HOT must be >= 0, got {n}")
    return n


def _serve_tier_demote_after_env() -> int:
    raw = _env("ANOMOD_SERVE_TIER_DEMOTE_AFTER", "8")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_TIER_DEMOTE_AFTER must be a positive "
            f"integer (idle ticks), got {raw!r}")
    if n < 1:
        raise ValueError(
            f"ANOMOD_SERVE_TIER_DEMOTE_AFTER must be >= 1, got {n}")
    return n


def _serve_tier_warm_bytes_env() -> int:
    raw = _env("ANOMOD_SERVE_TIER_WARM_BYTES", str(64 * 1024 * 1024))
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_TIER_WARM_BYTES must be a non-negative "
            f"integer (bytes), got {raw!r}")
    if n < 0:
        raise ValueError(
            f"ANOMOD_SERVE_TIER_WARM_BYTES must be >= 0, got {n}")
    return n


def _serve_tier_cold_dir_env() -> Optional[Path]:
    raw = _env("ANOMOD_SERVE_TIER_COLD_DIR", "")
    if not raw or raw.lower() in _CACHE_OFF:
        return None
    return Path(raw).expanduser()


def _serve_tier_prefetch_env() -> int:
    raw = _env("ANOMOD_SERVE_TIER_PREFETCH", "4")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_TIER_PREFETCH must be a positive integer, "
            f"got {raw!r}")
    if not 1 <= n <= 256:
        raise ValueError(
            f"ANOMOD_SERVE_TIER_PREFETCH must be in [1, 256], got {n}")
    return n


def _flight_env() -> bool:
    return _env("ANOMOD_FLIGHT", "1").strip().lower() \
        not in ("0", "false", "off", "no")


def _flight_int_env(name: str, default: str, hi: int) -> int:
    raw = _env(name, default)
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be a positive integer, got {raw!r}")
    if not 1 <= n <= hi:
        raise ValueError(f"{name} must be in [1, {hi}], got {n}")
    return n


def _flight_dump_dir_env() -> Optional[Path]:
    raw = _env("ANOMOD_FLIGHT_DUMP_DIR", "")
    if not raw or raw.lower() in _CACHE_OFF:
        return None
    return Path(raw).expanduser()


def _serve_feed_lag_s_env() -> float:
    """The live feed's lag budget: a sample collected at wall time ``w``
    maps to virtual time ``w - t0_wall + lag``, so a tick never asks for
    data the polls have not fetched yet."""
    raw = _env("ANOMOD_SERVE_FEED_LAG_S", "2.0")
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_SERVE_FEED_LAG_S must be a number, got {raw!r}")
    if not 0 <= v <= 3600:
        raise ValueError(
            f"ANOMOD_SERVE_FEED_LAG_S must be in [0, 3600], got {v}")
    return v


def _feed_journal_env() -> Optional[Path]:
    raw = _env("ANOMOD_FEED_JOURNAL", "")
    if not raw or raw.lower() in _CACHE_OFF:
        return None
    return Path(raw).expanduser()


def _switch_off_env(name: str) -> bool:
    """An observatory switch, off by default: anything but ``0`` /
    ``false`` / ``off`` / ``no`` / empty turns it on."""
    return _env(name, "0").strip().lower() \
        not in ("0", "false", "off", "no", "")


def _bounded_int_env(name: str, default: str, lo: int, hi: int) -> int:
    raw = _env(name, default)
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be a positive integer, got {raw!r}")
    if not lo <= n <= hi:
        raise ValueError(f"{name} must be in [{lo}, {hi}], got {n}")
    return n


def _perf_noise_floor_env() -> float:
    raw = _env("ANOMOD_PERF_NOISE_FLOOR", "0.35")
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_PERF_NOISE_FLOOR must be a number, got {raw!r}")
    if not 0 <= v <= 10:
        raise ValueError(
            f"ANOMOD_PERF_NOISE_FLOOR must be in [0, 10], got {v}")
    return v


#: hot-set decay thresholds in ticks: the census reports how many tenants
#: were served within the last N ticks, for each
DEFAULT_CENSUS_DECAY_TICKS = (4, 16, 64, 256)

#: registered-fleet sizes of the census probe's sweep
DEFAULT_CENSUS_SWEEP = (1_000, 10_000, 100_000)


def _census_int_tuple_env(name: str, default: tuple, lo: int,
                          hi: int) -> tuple:
    """Comma-separated integers in ``[lo, hi]``, strictly ascending."""
    raw = _env(name, "")
    if not raw:
        return default
    parts = [p.strip() for p in raw.split(",") if p.strip()]
    try:
        out = tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(f"{name} must be comma-separated integers, "
                         f"got {raw!r}")
    if not out:
        raise ValueError(f"{name} must not be empty")
    if any(not lo <= v <= hi for v in out):
        raise ValueError(f"{name} entries must be in [{lo}, {hi}], "
                         f"got {out}")
    if any(a >= b for a, b in zip(out, out[1:])):
        raise ValueError(f"{name} must be strictly ascending: {out}")
    return out


def _census_sweep_env() -> tuple:
    out = _census_int_tuple_env("ANOMOD_CENSUS_SWEEP",
                                DEFAULT_CENSUS_SWEEP, 1, 10_000_000)
    if len(out) < 2:
        raise ValueError(
            f"ANOMOD_CENSUS_SWEEP needs >= 2 sizes (a slope fit needs "
            f"two points), got {out}")
    return out


@dataclasses.dataclass
class Config:
    """Where experiments come from and how they are loaded; the telemetry,
    online-RCA, shard, supervision, elastic-policy, deferred-commit,
    tiering, flight-recorder, live-feed, serve-plane and observatory
    knobs."""

    data_root: Optional[Path] = dataclasses.field(
        default_factory=_data_root_env)
    synth_on_lfs: bool = dataclasses.field(
        default_factory=lambda: _env("ANOMOD_SYNTH_ON_LFS", "1")
        not in ("0", "false"))
    cache_dir: Optional[Path] = dataclasses.field(
        default_factory=_cache_dir_env)
    ingest_workers: int = dataclasses.field(
        default_factory=_ingest_workers_env)
    obs_enabled: bool = dataclasses.field(default_factory=_obs_enabled_env)
    obs_max_samples: int = dataclasses.field(
        default_factory=_obs_max_samples_env)
    obs_http: bool = dataclasses.field(default_factory=_obs_http_env)
    obs_http_port: int = dataclasses.field(
        default_factory=_obs_http_port_env)
    serve_rca: bool = dataclasses.field(default_factory=_serve_rca_env)
    serve_rca_buckets: tuple = dataclasses.field(
        default_factory=_serve_rca_buckets_env)
    serve_rca_topk: int = dataclasses.field(
        default_factory=lambda: _serve_rca_int_env(
            "ANOMOD_SERVE_RCA_TOPK", "5", 1, 64))
    serve_rca_budget: int = dataclasses.field(
        default_factory=lambda: _serve_rca_int_env(
            "ANOMOD_SERVE_RCA_BUDGET", "4", 1, 4096))
    serve_rca_windows: int = dataclasses.field(
        default_factory=lambda: _serve_rca_int_env(
            "ANOMOD_SERVE_RCA_WINDOWS", "8", 2, 128))
    serve_shards: int = dataclasses.field(default_factory=_serve_shards_env)
    serve_fold: str = dataclasses.field(default_factory=_serve_fold_env)
    serve_worker: str = dataclasses.field(
        default_factory=lambda: validate_serve_worker(
            _env("ANOMOD_SERVE_WORKER", "thread")))
    serve_worker_start_timeout_s: float = dataclasses.field(
        default_factory=_serve_worker_start_timeout_s_env)
    serve_chaos: str = dataclasses.field(default_factory=_serve_chaos_env)
    serve_ckpt_every: int = dataclasses.field(
        default_factory=_serve_ckpt_every_env)
    serve_retries: int = dataclasses.field(default_factory=_serve_retries_env)
    serve_retry_backoff_s: float = dataclasses.field(
        default_factory=_serve_retry_backoff_s_env)
    serve_max_respawns: int = dataclasses.field(
        default_factory=_serve_max_respawns_env)
    serve_policy: str = dataclasses.field(default_factory=_serve_policy_env)
    serve_policy_script: str = dataclasses.field(
        default_factory=_serve_policy_script_env)
    serve_policy_min_shards: int = dataclasses.field(
        default_factory=lambda: _serve_policy_int_env(
            "ANOMOD_SERVE_POLICY_MIN_SHARDS", "1", 1, 256))
    serve_policy_max_shards: int = dataclasses.field(
        default_factory=lambda: _serve_policy_int_env(
            "ANOMOD_SERVE_POLICY_MAX_SHARDS", "8", 1, 256))
    serve_policy_target_imbalance: float = dataclasses.field(
        default_factory=_serve_policy_target_imbalance_env)
    serve_policy_cooldown_ticks: int = dataclasses.field(
        default_factory=lambda: _serve_policy_int_env(
            "ANOMOD_SERVE_POLICY_COOLDOWN_TICKS", "8", 1, 100_000))
    serve_async_commit: bool = dataclasses.field(
        default_factory=_serve_async_commit_env)
    serve_tier_hot: int = dataclasses.field(
        default_factory=_serve_tier_hot_env)
    serve_tier_demote_after: int = dataclasses.field(
        default_factory=_serve_tier_demote_after_env)
    serve_tier_warm_bytes: int = dataclasses.field(
        default_factory=_serve_tier_warm_bytes_env)
    serve_tier_cold_dir: Optional[Path] = dataclasses.field(
        default_factory=_serve_tier_cold_dir_env)
    serve_tier_prefetch: int = dataclasses.field(
        default_factory=_serve_tier_prefetch_env)
    flight: bool = dataclasses.field(default_factory=_flight_env)
    flight_digest_every: int = dataclasses.field(
        default_factory=lambda: _flight_int_env(
            "ANOMOD_FLIGHT_DIGEST_EVERY", "16", 1_000_000))
    flight_max_ticks: int = dataclasses.field(
        default_factory=lambda: _flight_int_env(
            "ANOMOD_FLIGHT_MAX_TICKS", "65536", 10_000_000))
    flight_dump_dir: Optional[Path] = dataclasses.field(
        default_factory=_flight_dump_dir_env)
    serve_feed_lag_s: float = dataclasses.field(
        default_factory=_serve_feed_lag_s_env)
    feed_journal: Optional[Path] = dataclasses.field(
        default_factory=_feed_journal_env)
    seed: int = dataclasses.field(
        default_factory=lambda: int(_env("ANOMOD_SEED", "1")))
    serve_buckets: tuple = dataclasses.field(
        default_factory=_serve_buckets_env)
    serve_lane_buckets: tuple = dataclasses.field(
        default_factory=_serve_lane_buckets_env)
    serve_fuse: bool = dataclasses.field(default_factory=_serve_fuse_env)
    serve_pipeline: int = dataclasses.field(
        default_factory=_serve_pipeline_env)
    serve_state: str = dataclasses.field(default_factory=_serve_state_env)
    serve_lane_engine: str = dataclasses.field(
        default_factory=lambda: validate_serve_lane_engine(
            _env("ANOMOD_SERVE_LANE_ENGINE", "auto")))
    tdigest_engine: str = dataclasses.field(
        default_factory=lambda: validate_tdigest_engine(
            _env("ANOMOD_TDIGEST_ENGINE", "auto")))
    serve_native_drain: str = dataclasses.field(
        default_factory=lambda: _auto_on_off_env("ANOMOD_SERVE_NATIVE_DRAIN"))
    serve_max_backlog: int = dataclasses.field(
        default_factory=_serve_max_backlog_env)
    native: str = dataclasses.field(
        default_factory=lambda: _auto_on_off_env("ANOMOD_NATIVE"))
    perf: bool = dataclasses.field(
        default_factory=lambda: _switch_off_env("ANOMOD_PERF"))
    perf_max_events: int = dataclasses.field(
        default_factory=lambda: _bounded_int_env(
            "ANOMOD_PERF_MAX_EVENTS", "262144", 1, 100_000_000))
    perf_noise_floor: float = dataclasses.field(
        default_factory=_perf_noise_floor_env)
    census: bool = dataclasses.field(
        default_factory=lambda: _switch_off_env("ANOMOD_CENSUS"))
    census_every: int = dataclasses.field(
        default_factory=lambda: _bounded_int_env(
            "ANOMOD_CENSUS_EVERY", "8", 1, 1_000_000))
    census_decay_ticks: tuple = dataclasses.field(
        default_factory=lambda: _census_int_tuple_env(
            "ANOMOD_CENSUS_DECAY_TICKS", DEFAULT_CENSUS_DECAY_TICKS,
            1, 10_000_000))
    census_sweep: tuple = dataclasses.field(
        default_factory=_census_sweep_env)
    census_coldest_k: int = dataclasses.field(
        default_factory=lambda: _bounded_int_env(
            "ANOMOD_CENSUS_COLDEST_K", "8", 1, 4096))

    @property
    def sn_data(self) -> Optional[Path]:
        return None if self.data_root is None else \
            Path(self.data_root) / "SN_data"

    @property
    def tt_data(self) -> Optional[Path]:
        return None if self.data_root is None else \
            Path(self.data_root) / "TT_data"


_DEFAULT: Optional[Config] = None


def get_config() -> Config:
    """The process's settings, read from the environment once."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Config()
    return _DEFAULT


def set_config(cfg: Optional[Config]) -> Optional[Config]:
    """Install ``cfg`` as the process's settings (None: re-read the
    environment at the next :func:`get_config`); returns the previous."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, cfg
    return prev

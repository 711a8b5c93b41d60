"""Process shard workers: each shard's score plane in a process of its
own (counterpart of ``anomod/serve/procshard.py``).

``worker="process"`` (``ANOMOD_SERVE_WORKER=process``) replaces each
shard's worker thread (:class:`anomod_torch.serve.shard.ShardWorker`) by
a spawned worker process that owns the shard's whole score plane:
detectors, replay states, its :class:`~anomod_torch.serve.batcher.
BucketRunner` (device pool, scratch, on the card a CUDA context of its
own) and its obs :class:`~anomod_torch.obs.registry.Registry`.  N shards
then score in N interpreters instead of taking turns on one.

The coordinator drives each child by a picklable command a tick over a
duplex pipe: the drained batches go out (``{"op": "score", "served":
[...], "origin_tick": t}``), the results come back (new alerts, the
runner's cumulative book and walls, a registry delta, chaos fired
counts, the child's kernel launches).  The child scores through the same
``ServeEngine._score_shard`` as a thread worker, in a 1-shard sub-engine
over the tenants it owns (flight, RCA and supervision off: they live on
the coordinator), so its bytes equal the thread engine's by
construction.

Only host data crosses the pipe: numpy arrays and plain Python.  A
child syncs the device before each reply, so nothing it hands back is in
flight.

- **Alerts** ship as ``(tenant_id, base, alerts[base:])`` suffixes; the
  coordinator's mirror truncates to ``base`` and extends, so a restore's
  rewind heals to the child's exact list.
- **Registry deltas** are ``Registry.delta_snapshot`` payloads; the
  child keeps its own fold high-waters, so a respawned child folds from
  zero without counting twice.
- **State digests** ship as per-tenant ``(tid, crc, len)`` fragments
  (``obs.flight.state_digest_parts``), folded on the coordinator with
  ``crc32_combine``: equal to the sequential walk.
- **Chaos fired counts** ride every reply: a respawned child resumes
  its faults' ``repeat`` budgets, or a one-shot crash would trip again
  on every re-execution.
- **Kernel launches** ride every reply as the child's counts since its
  last reply, so a caller that counts launches sees the children's.

A child's error crosses the pipe as a summary (type, message,
``kills_worker``, traceback) and is rebuilt on the coordinator: the chaos
types by name from :mod:`anomod_torch.serve.chaos`, builtins as
themselves, anything else as ``RuntimeError``.  A ``kills_worker`` fault
sends its reply, then the child exits.

The device: the child takes the coordinator's resolved device from the
init payload and never resolves it again; a child that finds no CUDA
where the coordinator asked for it fails its start, loudly.  Children
are spawned (``multiprocessing`` ``spawn``; a forked child of a process
that initialised CUDA cannot use it).
"""

from __future__ import annotations

import multiprocessing as mp
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple

from anomod_torch.config import get_config, refuse_on_card
from anomod_torch.serve.config import (validate_lane_buckets,
                                       validate_serve_buckets)

__all__ = ["DetMirror", "ProcShardWorker", "RunnerMirror", "rebuild_exc",
           "ship_exc", "start_workers"]

#: exception modules a shipped child error is rebuilt from by name;
#: anything else becomes RuntimeError
_TRUSTED_EXC_MODULES = ("builtins", "anomod_torch.serve.chaos")


def ship_exc(e: BaseException) -> dict:
    """One child-side exception as a picklable summary."""
    return {"type": type(e).__name__,
            "module": type(e).__module__,
            "msg": str(e),
            "kills_worker": bool(getattr(e, "kills_worker", False)),
            "traceback": traceback.format_exc()}


def rebuild_exc(doc: dict) -> BaseException:
    """The coordinator's rebuild of :func:`ship_exc`: chaos types and
    builtins as themselves (so the supervisor's ``kills_worker`` reading
    and a caller's ``except`` see what a thread worker raises), anything
    else as ``RuntimeError`` carrying the child's traceback."""
    exc: Optional[BaseException] = None
    mod = doc.get("module", "")
    name = doc.get("type", "RuntimeError")
    if mod in _TRUSTED_EXC_MODULES:
        try:
            import importlib
            cls = getattr(importlib.import_module(mod), name, None)
            if isinstance(cls, type) and issubclass(cls, BaseException):
                exc = cls(doc.get("msg", ""))
        except Exception:       # noqa: BLE001 - falls back below
            exc = None
    if exc is None:
        exc = RuntimeError(f"shard worker {name}: {doc.get('msg', '')}")
    if doc.get("kills_worker") and not getattr(exc, "kills_worker", False):
        exc.kills_worker = True        # type: ignore[attr-defined]
    exc.remote_traceback = doc.get("traceback")  # type: ignore[attr-defined]
    return exc


class RunnerMirror:
    """The coordinator's stand-in for a child's BucketRunner: every
    runner fact the coordinator reads (the flight header's buckets, the
    per-tick ``leg_walls``, the supervisor's ``book_snapshot`` /
    ``book_restore``, the report's books and walls) comes from the
    child's last reply.  The static facts are validated as the
    BucketRunner validates them: the flight header is written before any
    child exists."""

    def __init__(self, cfg, buckets=None, lane_buckets=None,
                 pipeline: int = 1, state: str = "device", device=None,
                 native_stage: bool = True):
        if pipeline < 1:
            raise ValueError("pipeline depth must be >= 1")
        if state not in ("host", "device"):
            raise ValueError(f"unknown serve state mode {state!r} "
                             "(host|device)")
        self.cfg = cfg
        self.device = device
        self.pipeline = int(pipeline)
        self.state_mode = state
        self.native_stage = bool(native_stage)
        app_cfg = get_config()
        # the children read ANOMOD_SERVE_LANE_ENGINE from the environment
        # they inherit: a value the card refuses fails here, first
        refuse_on_card("ANOMOD_SERVE_LANE_ENGINE", app_cfg.serve_lane_engine,
                       device)
        self.buckets = validate_serve_buckets(
            app_cfg.serve_buckets if buckets is None else buckets)
        self.lane_buckets = validate_lane_buckets(
            app_cfg.serve_lane_buckets if lane_buckets is None
            else lane_buckets)
        self.pool = None               # the pool lives in the child
        self.n_dispatches = 0
        self.dispatches_by_width: Dict[int, int] = {}
        self.fused_dispatches = 0
        self.native_staged = 0
        self.staged_lanes = 0
        self.live_lanes = 0
        self.lanes_by_bucket: Dict[int, int] = {}
        self.compile_s = 0.0
        self.lane_compile_s = 0.0
        self.stage_wall_s = 0.0
        self.dispatch_wall_s = 0.0
        self.fold_wall_s = 0.0
        self.score_wall_s = 0.0

    def apply(self, doc: dict) -> None:
        """Install one reply's cumulative runner book and walls."""
        self.book_restore(doc["book"])
        self.compile_s = doc["compile_s"]
        self.lane_compile_s = doc["lane_compile_s"]
        walls = doc["walls"]
        self.stage_wall_s = walls["stage_s"]
        self.dispatch_wall_s = walls["dispatch_s"]
        self.fold_wall_s = walls["fold_s"]
        self.score_wall_s = walls["score_s"]

    def leg_walls(self) -> dict:
        return {"stage_s": self.stage_wall_s,
                "dispatch_s": self.dispatch_wall_s,
                "fold_s": self.fold_wall_s,
                "score_s": self.score_wall_s,
                "chunks": self.n_dispatches,
                "fused": self.fused_dispatches,
                "native_staged": self.native_staged,
                "by_width": dict(self.dispatches_by_width)}

    def book_snapshot(self) -> dict:
        return {"n_dispatches": self.n_dispatches,
                "dispatches_by_width": dict(self.dispatches_by_width),
                "fused_dispatches": self.fused_dispatches,
                "native_staged": self.native_staged,
                "staged_lanes": self.staged_lanes,
                "live_lanes": self.live_lanes,
                "lanes_by_bucket": dict(self.lanes_by_bucket)}

    def book_restore(self, book: dict) -> None:
        self.n_dispatches = book["n_dispatches"]
        self.dispatches_by_width = dict(book["dispatches_by_width"])
        self.fused_dispatches = book["fused_dispatches"]
        self.native_staged = book["native_staged"]
        self.staged_lanes = book["staged_lanes"]
        self.live_lanes = book["live_lanes"]
        self.lanes_by_bucket = dict(book["lanes_by_bucket"])



class DetMirror:
    """The coordinator's stand-in for a child's OnlineDetector: its alert
    list (the one detector surface the coordinator reads: the flight
    alert digest, RCA, the report), kept by the replies' suffixes."""

    __slots__ = ("alerts",)

    def __init__(self):
        self.alerts: list = []


class ProcShardWorker:
    """One shard's worker process.  ``close`` and ``alive`` are the
    ShardWorker seam's; in place of its closures the engine drives the
    data protocol: ``send`` (fan-out), ``recv`` (barrier, the raw reply)
    and ``call`` (both, raising the rebuilt child error), with command
    dicts: a process shares no memory with the engine.  With
    ``wait=False`` the constructor returns once the child is spawned;
    :meth:`wait_ready` then waits for its start-up handshake (so several
    children start together)."""

    def __init__(self, shard_id: int, init: dict,
                 start_timeout_s: float = 120.0,
                 name: str = "anomod-torch-procshard", wait: bool = True):
        ctx = mp.get_context("spawn")
        self.shard_id = shard_id
        self.start_timeout_s = float(start_timeout_s)
        parent_conn, child_conn = ctx.Pipe()
        self._conn = parent_conn
        self._proc = ctx.Process(target=_shard_main, args=(child_conn,),
                                 name=f"{name}-{shard_id}", daemon=True)
        self._closed = False
        self._dying = False
        self.hello: Optional[dict] = None
        self._proc.start()
        child_conn.close()
        try:
            # anomod-lint: disable=D101 — a wall stamp across processes (perf_counter does not compare between them) for the child's boot wall, a variant figure of the hello, never a decision
            self._conn.send({**init, "sent_at": time.time()})
        except BaseException:
            self.close(force=True)
            raise
        if wait:
            self.wait_ready()

    def wait_ready(self) -> dict:
        """Wait for the child's start-up handshake, bounded by the start
        timeout; a child that fails to start (or is too slow) is reaped
        and its error raised."""
        try:
            ready = self._conn.poll(self.start_timeout_s)
            hello = self._conn.recv() if ready else None
        except (EOFError, OSError) as e:
            self.close(force=True)
            raise RuntimeError(f"shard {self.shard_id} worker process "
                               "died during startup") from e
        except BaseException:
            self.close(force=True)
            raise
        if hello is None:
            self.close(force=True)
            raise TimeoutError(
                f"shard {self.shard_id} worker process did not finish "
                f"startup within {self.start_timeout_s:.0f}s "
                "(ANOMOD_SERVE_WORKER_START_TIMEOUT_S)")
        if hello.get("error") is not None:
            err = rebuild_exc(hello["error"])
            self.close(force=True)
            raise err
        #: the child's resolved facts (device, buckets, state mode) and
        #: its start-up split (``boot_s``: interpreter and imports;
        #: ``init_s``: the shard plane, its CUDA context included)
        self.hello = hello
        return hello

    # -- the data protocol -------------------------------------------------

    def send(self, msg: dict) -> None:
        try:
            self._conn.send(msg)
        except (BrokenPipeError, OSError) as e:
            self._dying = True
            raise RuntimeError(
                f"shard {self.shard_id} worker process is gone "
                f"(command {msg.get('op')!r} not delivered)") from e

    def recv(self) -> dict:
        """One raw reply.  A shipped error stays in the reply (the engine
        folds its partial results first); only a dead pipe raises."""
        try:
            rep = self._conn.recv()
        except (EOFError, OSError) as e:
            self._dying = True
            raise RuntimeError(
                f"shard {self.shard_id} worker process died "
                "mid-command") from e
        err = rep.get("error")
        if err is not None and err.get("kills_worker"):
            # the child exits right after this reply: ``alive`` reads
            # False from now, so a respawn check cannot race the exit
            self._dying = True
        return rep

    def call(self, msg: dict) -> dict:
        self.send(msg)
        rep = self.recv()
        if rep.get("error") is not None:
            raise rebuild_exc(rep["error"])
        return rep

    def close(self, force: bool = False) -> None:
        """Ask the child to exit and reap it (terminated if it does not
        exit within 10 s, or at once with ``force``); idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            if not force and self._proc.is_alive():
                self._conn.send({"op": "close"})
        except (BrokenPipeError, OSError):
            pass
        if not force:
            self._proc.join(timeout=10.0)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5.0)
        try:
            self._conn.close()
        except OSError:
            pass

    @property
    def alive(self) -> bool:
        return (not self._closed and not self._dying
                and self._proc.is_alive())


def start_workers(inits: List[Tuple[int, dict]],
                  start_timeout_s: float) -> List[ProcShardWorker]:
    """Spawn one worker a ``(shard_id, init)``, all at once, then wait
    for every handshake.  If any child fails to start, every child is
    reaped and the first error raised."""
    workers: List[ProcShardWorker] = []
    try:
        for s, init in inits:
            workers.append(ProcShardWorker(s, init, start_timeout_s,
                                           wait=False))
        for w in workers:
            w.wait_ready()
    except BaseException:
        for w in workers:
            w.close(force=True)
        raise
    return workers


# -- the child ---------------------------------------------------------------

def _shard_main(conn) -> None:
    """The worker process's entry: take the init payload, build the shard
    plane, then serve commands until ``close`` or EOF (or until a
    ``kills_worker`` fault ends it after its error reply)."""
    try:
        init = conn.recv()
    except (EOFError, OSError):
        return
    # the start-up split the handshake reports: interpreter, imports
    # and the pipe (from the parent's send), then the shard plane
    # anomod-lint: disable=D101 — the boot wall against the parent's send stamp: a variant figure of the hello, never a decision
    boot_s = time.time() - init["sent_at"]
    t0 = time.perf_counter()
    try:
        plane = _ShardPlane(init)
        conn.send({"ok": True, "boot_s": boot_s,
                   "init_s": time.perf_counter() - t0,
                   **plane.static_facts()})
    except BaseException as e:          # noqa: BLE001 - shipped
        try:
            conn.send({"error": ship_exc(e)})
        except (BrokenPipeError, OSError):
            pass
        return
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg.get("op") == "close":
            return
        reply, die = plane.handle(msg)
        try:
            conn.send(reply)
        except (BrokenPipeError, OSError):
            return
        if die:
            return


class _ShardPlane:
    """The child's side: a real 1-shard sub-ServeEngine over the shard's
    tenants, and the books that turn its changes into replies.  Every
    knob comes from the init payload (the parent's resolved values), the
    device included: the child never reads its environment for them."""

    def __init__(self, init: dict):
        import torch

        from anomod_torch import obs
        from anomod_torch.device import resolve_device
        from anomod_torch.ops import serve_kernels
        from anomod_torch.serve.engine import ServeEngine
        torch.set_num_threads(max(int(init["torch_threads"]), 1))
        # the coordinator asked for this device: no CUDA here raises
        device = resolve_device(init["device"])
        reg = obs.get_registry()
        # the child's process registry is the shard registry
        reg.enabled = bool(init["registry_enabled"])
        self.shard_id = int(init["shard_id"])
        self.chaos = None
        if init.get("chaos_script"):
            from anomod_torch.serve.chaos import ServeChaos
            self.chaos = ServeChaos(init["chaos_script"])
            # this shard's faults only, as the sub-engine's shard 0 (a
            # surge amplifies the coordinator's arrivals, never here)
            self.chaos.faults = [f for f in self.chaos.faults
                                 if f.kind != "surge"
                                 and f.shard == self.shard_id]
            for f in self.chaos.faults:
                f.shard = 0
            for f, n in zip(self.chaos.faults, init.get("chaos_fired") or ()):
                f.fired = int(n)
        self.eng = ServeEngine(
            init["specs"], init["services"], cfg=init["cfg"],
            t0_us=init["t0_us"],
            capacity_spans_per_s=init["capacity_spans_per_s"],
            tick_s=init["tick_s"], buckets=init["buckets"],
            max_backlog=init["max_backlog"], score=init["score"],
            fuse=init["fuse"], lane_buckets=init["lane_buckets"],
            pipeline=init["pipeline"], state=init["state"], device=device,
            native_stage=init["native"], drain_engine=init["drain_engine"],
            rca=False, shards=1, fold="sparse", flight=False,
            chaos=self.chaos if self.chaos is not None else "",
            ckpt_every=0, worker="thread", policy="off",
            async_commit=False, tier_hot=0, **init["det_kw"])
        self._kernels = serve_kernels
        self._launch_mark = dict(serve_kernels.launches)
        self._fold_state: Dict[tuple, float] = {}
        self._reg = reg
        #: alert high-water a tenant: how much of each detector's list
        #: the coordinator's mirror holds
        self._sent: Dict[int, int] = {}
        self._shipped_replay: Set[int] = set()
        self._shipped_det: Set[int] = set()

    def static_facts(self) -> dict:
        r = self.eng.runner
        return {"buckets": tuple(r.buckets),
                "lane_buckets": tuple(r.lane_buckets),
                "native_stage": bool(r.native_stage),
                "state_mode": r.state_mode, "device": str(self.eng.device)}

    # -- reply assembly ------------------------------------------------------

    def _mirror_doc(self) -> dict:
        r = self.eng.runner
        return {"book": r.book_snapshot(),
                "compile_s": float(r.compile_s),
                "lane_compile_s": float(r.lane_compile_s),
                "walls": {"stage_s": r.stage_wall_s,
                          "dispatch_s": r.dispatch_wall_s,
                          "fold_s": r.fold_wall_s,
                          "score_s": r.score_wall_s}}

    def _alert_updates(self) -> list:
        ups = []
        for tid in sorted(self.eng._tenant_det):
            alerts = self.eng._tenant_det[tid].alerts
            prev = self._sent.get(tid, 0)
            if len(alerts) != prev:
                base = min(prev, len(alerts))
                ups.append((tid, base, list(alerts[base:])))
                self._sent[tid] = len(alerts)
        return ups

    def _residency_updates(self) -> dict:
        new_rep = [t for t in self.eng._tenant_replay
                   if t not in self._shipped_replay]
        new_det = [t for t in self.eng._tenant_det
                   if t not in self._shipped_det]
        self._shipped_replay.update(new_rep)
        self._shipped_det.update(new_det)
        return {"resident_new": sorted(new_rep), "det_new": sorted(new_det)}

    def _launch_delta(self) -> dict:
        cur = dict(self._kernels.launches)
        out = {k: n - self._launch_mark.get(k, 0) for k, n in cur.items()
               if n != self._launch_mark.get(k, 0)}
        self._launch_mark = cur
        return out

    def handle(self, msg: dict):
        op = msg["op"]
        reply: dict = {}
        die = False
        try:
            out = getattr(self, "_op_" + op, self._op_unknown)(msg)
            if out:
                reply.update(out)
        except BaseException as e:      # noqa: BLE001 - shipped
            reply["error"] = ship_exc(e)
            die = bool(getattr(e, "kills_worker", False))
        try:
            # nothing handed back may still be in flight on the device
            self.eng.runner.sync()
            if op in ("score", "warm", "finish", "install_tenant",
                      "put_tenant"):
                reply.update(self._mirror_doc())
                reply["alerts"] = self._alert_updates()
                reply.update(self._residency_updates())
                if op in ("score", "finish"):
                    reply["reg_delta"] = self._reg.delta_snapshot(
                        self._fold_state, mode=msg.get("fold", "sparse"),
                        final=False)
        except BaseException as e:      # noqa: BLE001 - shipped
            reply.setdefault("error", ship_exc(e))
        reply["launches"] = self._launch_delta()
        if self.chaos is not None:
            reply["chaos_fired"] = [f.fired for f in self.chaos.faults]
        return reply, die

    def _op_unknown(self, msg: dict):
        raise ValueError(f"unknown procshard command {msg.get('op')!r}")

    # -- the commands --------------------------------------------------------

    def _op_score(self, msg: dict):
        self.eng._score_shard(0, msg["served"], msg["origin_tick"])

    def _op_warm(self, msg: dict):
        self.eng._warm_shard(0)

    def _op_finish(self, msg: dict):
        for det in self.eng._tenant_det.values():
            det.finish()

    def _op_digest(self, msg: dict):
        from anomod_torch.obs.flight import state_digest_parts
        return {"parts": state_digest_parts(self.eng._tenant_replay)}

    def _op_reg_delta(self, msg: dict):
        return {"delta": self._reg.delta_snapshot(
            self._fold_state, mode=msg.get("fold", "sparse"),
            final=bool(msg.get("final", False)))}

    def _op_snapshot(self, msg: dict):
        from anomod_torch.serve.supervise import (snapshot_detector,
                                                  snapshot_replays)
        reps = snapshot_replays(self.eng._tenant_replay)
        tenants = {}
        for tid, snap in reps.items():
            det = self.eng._tenant_det.get(tid)
            tenants[tid] = (snap, snapshot_detector(det)
                            if det is not None else None)
        return {"tenants": tenants,
                "book": self.eng.runner.book_snapshot()}

    def _op_book_restore(self, msg: dict):
        self.eng.runner.book_restore(msg["book"])

    def _op_drop(self, msg: dict):
        eng = self.eng
        for tid in list(eng._tenant_replay):
            rep = eng._tenant_replay.pop(tid)
            if hasattr(rep, "release"):
                rep.release()
        eng._tenant_det.clear()
        eng.runner.abort_lanes()
        self._sent.clear()
        self._shipped_replay.clear()
        self._shipped_det.clear()

    def _op_install_tenant(self, msg: dict):
        from anomod_torch.serve.supervise import (restore_detector,
                                                  restore_replay)
        tid = msg["tid"]
        restore_replay(self.eng._replay_for(tid), msg["replay"])
        det_snap = msg.get("det")
        if det_snap is not None:
            det = self.eng._detector_for(tid)
            restore_detector(det, det_snap)
            # the coordinator rewinds its mirror from the same snapshot
            self._sent[tid] = len(det.alerts)

    def _op_put_tenant(self, msg: dict):
        self._op_install_tenant(msg)

    def _op_take_tenant(self, msg: dict):
        from anomod_torch.serve.supervise import (snapshot_detector,
                                                  snapshot_replay)
        tid = msg["tid"]
        eng = self.eng
        rep = eng._tenant_replay.pop(tid, None)
        if rep is None:
            return {"snap": None}
        rep_snap = snapshot_replay(rep)
        if hasattr(rep, "release"):
            rep.release()
        det = eng._tenant_det.pop(tid, None)
        det_snap = snapshot_detector(det) if det is not None else None
        self._sent.pop(tid, None)
        self._shipped_replay.discard(tid)
        self._shipped_det.discard(tid)
        return {"snap": (rep_snap, det_snap)}

"""Tracing and profiling: the port's own observability (counterpart of
``anomod/utils/tracing.py``).

(a) Wall-clock span timing of pipeline stages, exported in the Jaeger API
JSON shape (loadable back through ``anomod_torch.io.sn_traces``) and as
Chrome trace events; (b) device profiling through ``torch.profiler``
(:func:`profile_to`), writing a Chrome trace of the card's kernels.

Thread-safety contract: spans may open from any thread (the prefetch
pipeline's staging worker, ingest pool callbacks).  Each thread keeps its
OWN span stack (thread-local), so parent links never cross threads; the
span list itself is lock-protected.  A span opened on a fresh thread is
a root of the same trace.

Durability contract: :meth:`Tracer.dump` and :meth:`Tracer.dump_chrome`
publish atomically (same-directory tmp + ``os.replace``), so a run
killed mid-write never leaves a truncated JSON behind a valid path.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from pathlib import Path
from typing import List, Optional


class Span:
    """Handle yielded by :meth:`Tracer.span` — tag/event mutation only."""

    __slots__ = ("_rec",)

    def __init__(self, rec: dict):
        self._rec = rec

    def set_tag(self, key: str, value) -> None:
        self._rec["tags"][str(key)] = value

    def event(self, message: str, **fields) -> None:
        """Append a timestamped span log (Jaeger ``logs`` entry)."""
        self._rec["events"].append(
            {"t": time.time(), "message": str(message), **fields})


class Tracer:
    """Lightweight span tracer; dumps Jaeger-API-shaped JSON."""

    def __init__(self, service: str = "anomod"):
        self.service = service
        self._spans: List[dict] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._trace_id = f"anomod-{int(time.time() * 1e6):x}"
        # thread ident -> small stable lane id, in first-span order: the
        # chrome exporter's ``tid``, so a worker thread's spans (the
        # prefetch pipeline's) land on their own Perfetto lane
        self._tids: dict = {}

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            got = self._tids.get(ident)
            if got is None:
                got = self._tids[ident] = len(self._tids)
            return got

    def _stack(self) -> List[int]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    @property
    def n_spans(self) -> int:
        with self._lock:
            return len(self._spans)

    @contextlib.contextmanager
    def span(self, name: str, **tags):
        stack = self._stack()
        parent = stack[-1] if stack else None
        start = time.time()
        rec = {"name": name, "start": start, "dur": 0.0, "parent": parent,
               "tid": self._tid(),
               "tags": {str(k): v for k, v in tags.items()}, "events": []}
        with self._lock:
            idx = len(self._spans)
            self._spans.append(rec)
        stack.append(idx)
        try:
            yield Span(rec)
        finally:
            stack.pop()
            rec["dur"] = time.time() - start

    def event(self, message: str, **fields) -> None:
        """Attach an event to the CURRENT thread's innermost open span
        (no-op outside any span — callers never need to guard)."""
        stack = self._stack()
        if not stack:
            return
        with self._lock:
            rec = self._spans[stack[-1]]
        Span(rec).event(message, **fields)

    def to_jaeger(self) -> dict:
        """Jaeger API JSON (loadable by anomod_torch.io.sn_traces)."""
        with self._lock:
            # copy the mutable containers too: a worker thread may still
            # be set_tag()/event()-ing an open span while we serialize
            # (each event dict is write-once at append, so list() is
            # deep enough)
            recs = [{**s, "tags": dict(s["tags"]),
                     "events": list(s["events"])} for s in self._spans]
        spans = []
        for i, s in enumerate(recs):
            refs = ([{"refType": "CHILD_OF", "traceID": self._trace_id,
                      "spanID": f"s{s['parent']:08x}"}]
                    if s["parent"] is not None else [])
            tags = [{"key": "span.kind", "value": "internal"}]
            tags.extend({"key": k, "value": str(v)}
                        for k, v in sorted(s["tags"].items()))
            logs = [{"timestamp": int(e["t"] * 1e6),
                     "fields": [{"key": k, "value": str(v)}
                                for k, v in e.items() if k != "t"]}
                    for e in s["events"]]
            spans.append({
                "traceID": self._trace_id, "spanID": f"s{i:08x}",
                "processID": "p0", "operationName": s["name"],
                "startTime": int(s["start"] * 1e6),
                "duration": int(s["dur"] * 1e6),
                "references": refs,
                "tags": tags,
                "logs": logs,
            })
        return {"data": [{"traceID": self._trace_id,
                          "processes": {"p0": {"serviceName": self.service}},
                          "spans": spans}]}

    def to_chrome(self) -> List[dict]:
        """The span list as Chrome trace-event JSON (the array form
        ``chrome://tracing`` / Perfetto load directly): one complete
        event (``"ph": "X"``) per span on the microsecond clock domain.

        The trace-event format has no parent references — nesting is
        inferred from timestamp containment per ``(pid, tid)`` lane — so
        the EXPLICIT parent index and span id ride in ``args`` alongside
        the span's tags, which is what lets :func:`spans_from_chrome`
        round-trip the exact parent links instead of re-guessing them
        from timestamps (guessing breaks on zero-duration spans)."""
        with self._lock:
            recs = [{**s, "tags": dict(s["tags"])} for s in self._spans]
        events = []
        for i, s in enumerate(recs):
            events.append({
                "name": s["name"], "ph": "X", "cat": self.service,
                "ts": int(s["start"] * 1e6),
                "dur": int(s["dur"] * 1e6),
                # one lane per recording thread, so Perfetto groups
                # worker-thread spans instead of collapsing them onto
                # lane 0; the tags ride in args and survive the round
                # trip
                "pid": 0, "tid": s.get("tid", 0),
                "args": {**{str(k): str(v)
                            for k, v in sorted(s["tags"].items())},
                         "span_id": i,
                         "parent": -1 if s["parent"] is None
                         else s["parent"]},
            })
        return events

    def _dump_json(self, path: Path, doc) -> None:
        """The one atomic-publish body behind both dump shapes (tmp +
        ``os.replace``)."""
        path = Path(path)
        if path.parent and not path.parent.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            tmp.write_text(json.dumps(doc))
            os.replace(tmp, path)
        finally:
            if tmp.exists():
                try:
                    tmp.unlink()
                except OSError:
                    pass

    def dump_chrome(self, path: Path) -> None:
        """Atomic publish of :meth:`to_chrome` (same contract as
        :meth:`dump`)."""
        self._dump_json(path, self.to_chrome())

    def dump(self, path: Path) -> None:
        """Atomic publish (tmp + ``os.replace``): a killed run never
        leaves a truncated trace behind a valid path."""
        self._dump_json(path, self.to_jaeger())


def spans_from_chrome(events: List[dict]) -> List[dict]:
    """Parse a Chrome trace-event array back into span records
    (``{"name", "start", "dur", "parent", "tags"}`` — seconds, parent
    by span index, ``None`` for roots): the round-trip contract of
    :meth:`Tracer.to_chrome`, the chrome twin of
    ``anomod_torch.io.sn_traces.spans_from_jaeger``.  Only complete events
    (``"ph": "X"``) are spans; anything else (metadata, counters some
    other producer appended) is skipped.  Events are keyed back into
    index order by the ``args.span_id`` the exporter planted, so a
    reordered (e.g. Perfetto-sorted) file still parses losslessly."""
    spans = [e for e in events if e.get("ph") == "X"]
    spans.sort(key=lambda e: e.get("args", {}).get("span_id", 0))
    out = []
    for e in spans:
        args = dict(e.get("args", {}))
        parent = args.pop("parent", -1)
        args.pop("span_id", None)
        out.append({"name": e.get("name", ""),
                    "start": e.get("ts", 0) / 1e6,
                    "dur": e.get("dur", 0) / 1e6,
                    "parent": None if parent in (-1, None) else int(parent),
                    "tid": int(e.get("tid", 0)),
                    "tags": args})
    return out


@contextlib.contextmanager
def profile_to(log_dir: Optional[str]):
    """Device profiling of the block through ``torch.profiler`` when a
    directory is given: CPU and, with a card, CUDA activity, written on
    exit as one Chrome trace (``trace.json``) into ``log_dir``.  Without
    a directory the block runs unprofiled."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))

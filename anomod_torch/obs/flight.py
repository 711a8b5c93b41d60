"""The serve plane's black-box flight recorder: a tick-level journal,
deterministic audit replay and divergence bisection (counterpart of
``anomod/obs/flight.py``).

Every serve tick journals what the engine decided: admission deltas and
a crc32 over the served decision set, the staged-chunk counts per width,
a cadenced crc32 over every tenant's replay state, and running digests
of the alert and RCA-verdict streams.  The journal is a bounded ring
with a self-describing header (engine shape, the resolved
:class:`~anomod_torch.config.Config`, versions and the ``run`` arguments
``audit replay`` re-executes from), published atomically.

Two tiers a record, as in the JAX package:

- the **canonical planes** (:data:`PLANES`) hold only seed-determined
  decisions, so one seed gives byte-identical canonical journals across
  reruns, shard counts, pipeline depths, state residencies and devices
  (the card's journal equals the CPU's, and both equal the JAX
  engine's on the CPU);
- the **variant keys** (:data:`FLIGHT_VARIANT_KEYS`) hold walls and
  lane / shard topology; they ride the dump for forensics and stay out
  of the canonical bytes and of :func:`diff_journals`.  ``recovery``
  carries the supervisor's events (a crash recovered, a quarantine, a
  migration); the keys of planes the port has not ported (``scaling``,
  ``perf``, ``census``, ``tiering``) are present and empty, as the JAX
  record makes them when those planes are off.

The ring is bounded (``ANOMOD_FLIGHT_MAX_TICKS``) and every eviction is
counted (``anomod_flight_dropped_ticks_total`` and ``n_dropped``).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import os
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from anomod_torch import obs

#: journal format version (the JAX package's: one canonical shape)
FLIGHT_FORMAT = 1

#: the canonical decision planes in causal order: when several diverge
#: in one tick, :func:`diff_journals` names the earliest
PLANES: Tuple[str, ...] = ("admission", "dispatch", "fold", "score", "rca")

#: per-tick keys excluded from the canonical bytes and from ``diff``:
#: walls, lane / shard topology, the supervisor's recovery events, and
#: the JAX package's scaling, perf, census and tiering planes (empty in
#: the port)
FLIGHT_VARIANT_KEYS: Tuple[str, ...] = ("walls", "topology", "recovery",
                                        "scaling", "perf", "census",
                                        "tiering")


def crc_text(text: str, prev: int = 0) -> int:
    """Running crc32 over a text chunk (stable across processes)."""
    return zlib.crc32(text.encode(), prev) & 0xFFFFFFFF


def crc_bytes(data: bytes, prev: int = 0) -> int:
    return zlib.crc32(data, prev) & 0xFFFFFFFF


def _prefix(tid: int, rep) -> bytes:
    """The per-tenant prefix of the digest: tenant id, ring anchor and
    span count, so equal bytes at different anchors still differ."""
    return (f"{tid}:{getattr(rep, 'window_offset', 0)}"
            f":{getattr(rep, 'n_spans', 0)}:").encode()


def _state_chunks(replays: Dict[int, object]):
    """``(tid, prefix, agg bytes, hist bytes)`` of every tenant in sorted
    order.  A replay whose state lives in a runner's device pool is read
    with its pool's other residents: ONE device-to-host copy of the
    resident rows a plane and runner (``BucketRunner.gather_rows``), not
    two copies a tenant; host-seam replays read their state."""
    pooled: Dict[int, Tuple[object, List[int]]] = {}
    for tid, rep in replays.items():
        runner = getattr(rep, "_runner", None)
        if getattr(rep, "_slot", None) is not None \
                and getattr(runner, "pool", None) is not None:
            pooled.setdefault(id(runner), (runner, []))[1].append(tid)
    rows: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for runner, tids in pooled.values():
        agg, hist = runner.gather_rows([replays[t]._slot for t in tids])
        for i, t in enumerate(tids):
            rows[t] = (agg[i], hist[i])
    for tid in sorted(replays):
        rep = replays[tid]
        got = rows.get(tid)
        if got is None:
            st = rep.get_state() if hasattr(rep, "get_state") else rep.state
            got = (np.asarray(st.agg), np.asarray(st.hist))
        yield (tid, _prefix(tid, rep),
               np.ascontiguousarray(got[0]).tobytes(),
               np.ascontiguousarray(got[1]).tobytes())


def state_digest(replays: Dict[int, object], prev: int = 0) -> int:
    """crc32 over every tenant replay state, in sorted-tenant order: the
    prefix, then the agg bytes, then the hist bytes of each tenant.  The
    bytes are the ``get_state`` seam's, so a pool-backed and a host-seam
    run of one seed give one digest."""
    crc = prev
    for _, prefix, agg, hist in _state_chunks(replays):
        crc = crc_bytes(prefix, crc)
        crc = crc_bytes(agg, crc)
        crc = crc_bytes(hist, crc)
    return crc


def _gf2_matrix_times(mat: List[int], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(mat: List[int]) -> List[int]:
    return [_gf2_matrix_times(mat, mat[n]) for n in range(32)]


@functools.lru_cache(maxsize=1)
def _zero_byte_ops() -> Tuple[Tuple[int, ...], ...]:
    """The crc32 operators that append 2^k zero bytes, k = 0..63: the
    one-bit shift of the reflected polynomial squared three times, then
    squared once a power.  Built once; each combine then costs one
    matrix-vector product a set bit of the length."""
    op = [0xEDB88320]           # CRC-32 polynomial, reflected: one bit
    row = 1
    for _ in range(31):
        op.append(row)
        row <<= 1
    for _ in range(3):
        op = _gf2_matrix_square(op)
    ops = []
    for _ in range(64):
        ops.append(tuple(op))
        op = _gf2_matrix_square(op)
    return tuple(ops)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib's crc32_combine: the crc of ``A + B`` from ``crc32(A)``,
    ``crc32(B)`` and ``len(B)`` alone (a GF(2) matrix shift), so shards
    can digest their tenants apart and the fold stays equal to
    :func:`state_digest`'s sequential walk."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    ops = _zero_byte_ops()
    k = 0
    while len2:
        if len2 & 1:
            crc1 = _gf2_matrix_times(ops[k], crc1)
        len2 >>= 1
        k += 1
    return (crc1 ^ crc2) & 0xFFFFFFFF


def state_digest_parts(replays: Dict[int, object]
                       ) -> List[Tuple[int, int, int]]:
    """Per-tenant ``(tenant_id, chunk_crc, chunk_len)`` fragments over
    exactly the bytes :func:`state_digest` walks (prefix + agg + hist);
    :func:`fold_digest_parts` folds any shards' fragments back into the
    sequential digest."""
    parts = []
    for tid, prefix, agg, hist in _state_chunks(replays):
        crc = crc_bytes(hist, crc_bytes(agg, crc_bytes(prefix)))
        parts.append((int(tid), crc, len(prefix) + len(agg) + len(hist)))
    return parts


def fold_digest_parts(parts: List[Tuple[int, int, int]],
                      prev: int = 0) -> int:
    """Fold :func:`state_digest_parts` fragments (from any number of
    shards) in global sorted-tenant order: equal to :func:`state_digest`
    over the union of the shards' replays."""
    crc = prev
    for _tid, chunk_crc, chunk_len in sorted(parts):
        crc = crc32_combine(crc, chunk_crc, chunk_len)
    return crc


def config_snapshot() -> dict:
    """The resolved port :class:`~anomod_torch.config.Config` as a
    JSON-able dict (paths as strings, tuples as lists)."""
    from anomod_torch.config import get_config
    cfg = get_config()
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, Path):
            v = str(v)
        elif isinstance(v, tuple):
            v = [list(x) if isinstance(x, tuple) else x for x in v]
        out[f.name] = v
    return out


def versions(device=None) -> dict:
    """Python, torch, its CUDA, numpy and the device the run served on
    (``device_name``: the card's name, or ``cpu``)."""
    import platform as _platform

    import torch

    from anomod_torch.device import device_name
    dev = torch.device("cpu" if device is None else device)
    return {"python": _platform.python_version(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "numpy": np.__version__,
            "device": device_name(dev)}


def canonical_ticks(ticks: List[dict]) -> List[dict]:
    """The byte-parity view of a tick list: every record with the
    variant keys (:data:`FLIGHT_VARIANT_KEYS`) stripped."""
    return [{k: v for k, v in rec.items()
             if k not in FLIGHT_VARIANT_KEYS} for rec in ticks]


def _atomic_write_json(path, doc: dict) -> Path:
    """Publish ``doc`` through a temporary file and ``os.replace``: a
    killed run never leaves a truncated document behind a valid path."""
    path = Path(path)
    if path.parent and not path.parent.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        tmp.write_text(json.dumps(doc, sort_keys=True))
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
    return path


class FlightRecorder:
    """Bounded ring journal of serve-tick records.

    The engine builds each record; the recorder owns the bound, the
    counts, the canonical surface and publication.  ``header`` is the
    self-describing preamble; ``max_ticks`` / ``digest_every`` default
    from ``ANOMOD_FLIGHT_MAX_TICKS`` / ``ANOMOD_FLIGHT_DIGEST_EVERY``."""

    def __init__(self, header: dict, max_ticks: Optional[int] = None,
                 digest_every: Optional[int] = None):
        from anomod_torch.config import get_config
        cfg = get_config()
        self.max_ticks = int(cfg.flight_max_ticks if max_ticks is None
                             else max_ticks)
        self.digest_every = int(cfg.flight_digest_every
                                if digest_every is None else digest_every)
        if self.max_ticks < 1:
            raise ValueError("flight ring needs >= 1 tick")
        if self.digest_every < 1:
            raise ValueError("digest cadence must be >= 1 tick")
        self.header = dict(header)
        self.header.setdefault("flight_format", FLIGHT_FORMAT)
        self.header["digest_every"] = self.digest_every
        self.header["max_ticks"] = self.max_ticks
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=self.max_ticks)
        self.n_recorded = 0
        self.n_dropped = 0
        self.dump_error: Optional[str] = None
        self._obs_ticks = obs.counter("anomod_flight_ticks_total")
        self._obs_dropped = obs.counter("anomod_flight_dropped_ticks_total")
        self._obs_dumps = obs.counter("anomod_flight_dumps_total")
        self._obs_dump_errors = obs.counter(
            "anomod_flight_dump_errors_total")

    def digest_tick(self, tick_idx: int) -> bool:
        """Whether ``tick_idx`` (0-based) is a state-digest tick."""
        return (tick_idx + 1) % self.digest_every == 0

    def record(self, rec: dict) -> None:
        if len(self._ring) == self.max_ticks:
            self.n_dropped += 1
            self._obs_dropped.inc()
        self._ring.append(rec)
        self.n_recorded += 1
        self._obs_ticks.inc()

    def records(self) -> List[dict]:
        return list(self._ring)

    def canonical_bytes(self) -> bytes:
        """The journal's byte-parity surface: the canonical tick records,
        serialized deterministically."""
        return json.dumps({"flight_format": FLIGHT_FORMAT,
                           "ticks": canonical_ticks(self.records())},
                          sort_keys=True, separators=(",", ":")).encode()

    def journal(self) -> dict:
        """The whole journal: header, counts and every record, variant
        keys included."""
        return {"flight_format": FLIGHT_FORMAT, "header": dict(self.header),
                "n_recorded": self.n_recorded, "n_dropped": self.n_dropped,
                "ticks": self.records()}

    def dump(self, path) -> dict:
        """Atomic publish of :meth:`journal`; returns what it wrote."""
        doc = self.journal()
        _atomic_write_json(path, doc)
        return doc

    def forensic(self, path, registry=None, tracer=None,
                 reason: str = "") -> Optional[str]:
        """Publish a :func:`forensic_bundle`.  An ``OSError`` (disk full,
        unwritable directory) does not fail the tick that asked: it is
        counted (``anomod_flight_dump_errors_total``) and kept in
        ``dump_error``; any other failure propagates."""
        try:
            out = forensic_bundle(path, self, registry=registry,
                                  tracer=tracer, reason=reason)
            self._obs_dumps.inc()
            return str(out)
        except OSError as e:
            self.dump_error = f"{type(e).__name__}: {e}"
            self._obs_dump_errors.inc()
            return None


def forensic_bundle(path, recorder: FlightRecorder, registry=None,
                    tracer=None, reason: str = "") -> Path:
    """One forensic document, published atomically: the flight journal,
    the registry's snapshot and scrape journal, the tracer's Jaeger
    spans."""
    doc = {"bundle": "anomod-flight-forensic", "reason": str(reason),
           "flight": recorder.journal()}
    if registry is not None and getattr(registry, "enabled", False):
        doc["registry"] = {"snapshot": registry.snapshot(),
                           "journal": [list(s) for s
                                       in registry.journal()]}
    if tracer is not None:
        doc["trace"] = tracer.to_jaeger()
    return _atomic_write_json(path, doc)


def load_journal(path) -> dict:
    """Load a dumped journal; a document that is not one raises
    ``ValueError`` (a diff against it would report nonsense ticks)."""
    doc = json.loads(Path(path).read_text())
    if not isinstance(doc, dict) or not isinstance(doc.get("ticks"), list) \
            or doc.get("flight_format") != FLIGHT_FORMAT:
        raise ValueError(f"not a flight journal (format "
                         f"{FLIGHT_FORMAT}): {path}")
    return doc


def diff_journals(a: dict, b: dict) -> Optional[dict]:
    """Tick-aligned comparison of two journals' canonical planes.

    ``None`` when the canonical surfaces are equal; else the FIRST
    divergent tick and its earliest divergent plane in causal order
    (:data:`PLANES`; ``clock`` when the tick spine itself differs,
    ``length`` when one journal ran more ticks), with both sides'
    records of that plane and any notes on why the journals may not be
    comparable (digest cadence, ring drops)."""
    ta = canonical_ticks(a.get("ticks", ()))
    tb = canonical_ticks(b.get("ticks", ()))
    notes: List[str] = []
    ha, hb = a.get("header", {}), b.get("header", {})
    if ha.get("digest_every") != hb.get("digest_every"):
        notes.append(
            f"digest cadence differs (a={ha.get('digest_every')}, "
            f"b={hb.get('digest_every')}): fold digests land on "
            "different ticks and will read as fold divergence")
    if a.get("n_dropped") or b.get("n_dropped"):
        notes.append(f"ring drops (a={a.get('n_dropped', 0)}, "
                     f"b={b.get('n_dropped', 0)}): journals may start "
                     "at different ticks")

    def verdict(i, plane, va, vb):
        out = {"tick": (ta[i].get("tick", i) if i < len(ta)
                        else tb[i].get("tick", i)),
               "index": i, "plane": plane, "a": va, "b": vb}
        if notes:
            out["notes"] = notes
        return out

    for i in range(min(len(ta), len(tb))):
        ra, rb = ta[i], tb[i]
        spine_a = (ra.get("tick"), ra.get("now_s"), ra.get("final"))
        spine_b = (rb.get("tick"), rb.get("now_s"), rb.get("final"))
        if spine_a != spine_b:
            return verdict(i, "clock", list(spine_a), list(spine_b))
        for plane in PLANES:
            if ra.get(plane) != rb.get(plane):
                return verdict(i, plane, ra.get(plane), rb.get(plane))
    if len(ta) != len(tb):
        i = min(len(ta), len(tb))
        return verdict(i, "length", len(ta), len(tb))
    return None

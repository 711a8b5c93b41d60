"""The port's host entries in C++ (``csrc/native.cpp``), bound with
``ctypes``: the ingest scanners and their thread pool, the serve tick's
scratch fill and the admission plane's SFQ scans (counterpart of
``anomod/io/native.py``).

The source builds at first use with ``g++ -O3 -shared -fPIC -pthread``
into ``build/anomod_torch_native/`` beside the package, keyed by a hash
of the source, the compiler and the flags, and published atomically (a
per-process temporary renamed into place), so concurrent first uses in
several processes race safely.  ``ctypes`` releases the GIL for every
call.

``ANOMOD_NATIVE`` picks the route (:func:`enabled`): ``off`` takes the
Python routes of the parsers (``io/logs.py``, ``io/metrics.py``) and the
serve tick; ``auto`` (the default) and ``on`` take the library.  There
is no quiet fallback, unlike the JAX package (whose ``auto`` drops to
Python when its library does not load): a failed build or load raises
with the compiler's output, and a chunk that breaks the staging contract
raises ``ValueError``.

Scanners: :func:`scan_log` (level and timestamp a line, threaded from 1
MiB), :class:`Runtime` (a pool of C++ threads; ``summarize_logs`` reads
and summarizes one file a task), :func:`default_runtime`,
:func:`summarize_log_files`, :func:`scan_csv_columns` and
:func:`scan_api_jsonl`; each returns the JAX library's arrays, byte for
byte.

Staging: :class:`StagedChunk` carries one chunk as a slice of the staged
``[7, n]`` matrix (``replay.stage_columns_fused``, rows in
``replay.STAGE_KEYS`` order), so a live lane marshals as three ints
(pointer, row stride, row count).  :class:`StagePlan` marshals one pinned
scratch slot once (destination pointers, the row map, the ctypes argument
arrays); each fill then writes those three ints per live lane and makes
one native call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from anomod_torch.ops.replay_kernels import PLANES
from anomod_torch.replay import STAGE_KEYS

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "native.cpp"
BUILD_DIR = _PKG.parent / "build" / "anomod_torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_ROW = {k: i for i, k in enumerate(STAGE_KEYS)}
#: matrix row of sid, then of each scratch plane (-1: dur2, the square
#: of the dur plane)
ROW_MAP = (_ROW["sid"],) + tuple(_ROW.get(p, -1) for p in PLANES)
SQ_OF = PLANES.index("dur")
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def cxx() -> str:
    """The C++ compiler (``g++``)."""
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the port's host entries "
                           "(anomod_torch/csrc/native.cpp) need it")
    return path


def artifact(stem: str, sources: Sequence[Path], cmd: Sequence[str],
             build_dir: Optional[Path] = None, suffix: str = "") -> Path:
    """The path of what ``cmd`` (a compiler and its flags) builds from
    ``sources``: ``<build_dir>/<stem>_<hash><suffix>``, the hash over
    the sources' bytes and the command."""
    key = b"".join(p.read_bytes() for p in sources) + "\0".join(cmd).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"{stem}_{digest}{suffix}"


def compile_once(stem: str, sources: Sequence[Path], cmd: Sequence[str],
                 build_dir: Optional[Path] = None, suffix: str = "",
                 timeout: Optional[float] = None) -> Path:
    """Run ``cmd`` over ``sources`` into :func:`artifact`'s path unless it
    is there already, publishing by an atomic rename (a per-process
    temporary), so concurrent first uses race safely.  Raises
    ``RuntimeError`` with the compiler's output, ``TimeoutExpired`` past
    ``timeout``."""
    out = artifact(stem, sources, cmd, build_dir, suffix)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    full = [*cmd, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(full, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(full)} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)                  # atomic publish
    return out


def target(build_dir: Optional[Path] = None) -> Path:
    """The library path for this source, compiler and flags."""
    return artifact("libanomod_torch_native", (SOURCE,),
                    (cxx(), *CXX_FLAGS), build_dir, ".so")


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile ``csrc/native.cpp`` unless built already; returns the
    library path.  Raises ``RuntimeError`` with the compiler's output."""
    return compile_once("libanomod_torch_native", (SOURCE,),
                        (cxx(), *CXX_FLAGS), build_dir, ".so")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.atn_stage_lanes.restype = ctypes.c_int64
    lib.atn_stage_lanes.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
    lib.atn_sfq_drain.restype = ctypes.c_int64
    lib.atn_sfq_drain.argtypes = [_F64P, _I64P, _I64P, _U8P, ctypes.c_int64,
                                  ctypes.c_double, _I64P]
    lib.atn_sfq_victim.restype = ctypes.c_int64
    lib.atn_sfq_victim.argtypes = [_F64P, _I64P, _I64P, _U8P,
                                   ctypes.c_int64]
    lib.atn_scan_log_mt.restype = ctypes.c_int64
    lib.atn_scan_log_mt.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int32]
    lib.atn_scan_api_jsonl.restype = ctypes.c_int64
    lib.atn_scan_api_jsonl.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64]
    lib.atn_scan_csv_cols.restype = ctypes.c_int64
    lib.atn_scan_csv_cols.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64]
    lib.atn_rt_create.restype = ctypes.c_void_p
    lib.atn_rt_create.argtypes = [ctypes.c_int32]
    lib.atn_rt_destroy.restype = None
    lib.atn_rt_destroy.argtypes = [ctypes.c_void_p]
    lib.atn_rt_n_threads.restype = ctypes.c_int32
    lib.atn_rt_n_threads.argtypes = [ctypes.c_void_p]
    lib.atn_rt_summarize_logs.restype = ctypes.c_int64
    lib.atn_rt_summarize_logs.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    return lib


def library() -> ctypes.CDLL:
    """The loaded host library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def status() -> dict:
    """The host library's health document, with the keys of the JAX
    ``anomod.io.native.status()``: ``mode`` (the ``ANOMOD_NATIVE`` value
    of the port's ``Config``), ``available``, ``so_path`` (None until
    built), ``build_error`` (why the library is unusable, the compiler's
    or the loader's words; None while it is fine) and ``staging`` (the
    library serves the serve tick's staging and the scanners: true when
    it loads and ``mode`` is not ``off``); ``mode`` ``on`` with no
    library adds ``error``.  It builds the library if it must, and
    reports a failed build rather than raising: it is a health document
    (``validate`` carries it).  The staging and scanning paths raise."""
    from anomod_torch.config import get_config
    m = get_config().native
    so_path, build_error = None, None
    try:
        library()
    except (RuntimeError, OSError) as e:
        build_error = f"{type(e).__name__}: {e}"
    try:
        built = target()
        so_path = str(built) if built.exists() else None
    except RuntimeError:                # no compiler: nothing was built
        pass
    ok = build_error is None
    out = {"mode": m, "available": ok, "so_path": so_path,
           "build_error": build_error, "staging": bool(ok and m != "off")}
    if m == "on" and not ok:
        out["error"] = ("ANOMOD_NATIVE=on but the native runtime is "
                        "unusable — see build_error")
    return out


def enabled() -> bool:
    """Whether the parsers take the library: False under
    ``ANOMOD_NATIVE=off``; else the library, built and loaded now (a
    failed build raises), and True."""
    from anomod_torch.config import get_config
    if get_config().native == "off":
        return False
    library()
    return True


# -- scanners ---------------------------------------------------------------

def scan_log(text: bytes, n_threads: int = 4) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """(level codes int8, timestamps float64) a ``\\n``-separated line:
    0 info, 1 warn, 2 error or exception, 3 other (case-insensitive
    substrings); the first ``YYYY-MM-DD[T ]HH:MM:SS`` starting in a
    line's first 64 bytes as epoch seconds, 0 where none.  From 1 MiB
    the scan runs on ``n_threads`` threads."""
    lib = library()
    max_lines = text.count(b"\n") + 1
    levels = np.empty(max_lines, np.int8)
    ts = np.empty(max_lines, np.float64)
    n = lib.atn_scan_log_mt(text, len(text), levels.ctypes.data,
                            ts.ctypes.data, max_lines, n_threads)
    return levels[:n], ts[:n]


class Runtime:
    """A pool of ``n_threads`` C++ worker threads (``atn_rt_*``), each
    with a read buffer it reuses across files; one pool serves many
    calls.  A context manager; :func:`default_runtime` is the process's
    shared one."""

    def __init__(self, n_threads: int = 4):
        self._lib = library()
        self._ptr = self._lib.atn_rt_create(n_threads)

    @property
    def n_threads(self) -> int:
        return int(self._lib.atn_rt_n_threads(self._ptr))

    def close(self) -> None:
        if self._ptr:
            self._lib.atn_rt_destroy(self._ptr)
            self._ptr = None

    def __enter__(self) -> "Runtime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def summarize_logs(self, paths) -> Tuple[np.ndarray, np.ndarray, int]:
        """``(counts [N, 5] int64, ts [N, 2] float64, n_readable)``, a
        file a task on the pool: counts rows {n_lines, n_info, n_warn,
        n_error, size_bytes}, ts rows {min_ts, max_ts} (0 when absent);
        an unreadable file's rows are zeros."""
        enc = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        counts = np.zeros((len(enc), 5), np.int64)
        ts = np.zeros((len(enc), 2), np.float64)
        n = self._lib.atn_rt_summarize_logs(
            self._ptr, arr, len(enc), counts.ctypes.data, ts.ctypes.data)
        return counts, ts, int(n)


_DEFAULT_RT: Optional[Runtime] = None
_rt_lock = threading.Lock()


def default_runtime() -> Runtime:
    """The process's shared pool (4 workers), made at first use and
    closed at exit."""
    global _DEFAULT_RT
    with _rt_lock:
        if _DEFAULT_RT is None:
            import atexit
            _DEFAULT_RT = Runtime(4)
            atexit.register(_DEFAULT_RT.close)
        return _DEFAULT_RT


def summarize_log_files(paths) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``(counts [N, 5], ts [N, 2])`` of :meth:`Runtime.summarize_logs`
    on the shared pool; None for no paths, as the JAX function."""
    if not paths:
        return None
    counts, ts, _ = default_runtime().summarize_logs(paths)
    return counts, ts


def scan_csv_columns(text: bytes, cols,
                     skip_header: bool = True) -> np.ndarray:
    """Numeric CSV columns, ``[len(cols), n_rows]`` float64 by
    ``strtod``, NaN where a field does not parse or is missing; an
    empty line is no row, and quoted fields may hold commas but not
    newlines (a caller that needs full CSV checks the row count, as
    ``io/metrics.py`` does)."""
    lib = library()
    max_rows = text.count(b"\n") + 1
    cols_arr = np.asarray(list(cols), np.int32)
    out = np.empty((len(cols_arr), max_rows), np.float64)
    n = lib.atn_scan_csv_cols(text, len(text), cols_arr.ctypes.data,
                              len(cols_arr), int(skip_header),
                              out.ctypes.data, max_rows)
    return out[:, :n]


def scan_api_jsonl(text: bytes) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]:
    """``(status int16, latency_ms float32, content_length int32)`` a
    JSONL record (a line longer than 2 bytes), each the number after its
    quoted key by ``strtod``, 0 where the key is absent."""
    lib = library()
    max_recs = text.count(b"\n") + 1
    status = np.empty(max_recs, np.int16)
    lat = np.empty(max_recs, np.float32)
    clen = np.empty(max_recs, np.int32)
    n = lib.atn_scan_api_jsonl(text, len(text), status.ctypes.data,
                               lat.ctypes.data, clen.ctypes.data, max_recs)
    return status[:n], lat[:n], clen[:n]


# -- staging ----------------------------------------------------------------

class StagedChunk:
    """One staged chunk: columns ``[lo, lo + m)`` of a C-contiguous
    ``[len(STAGE_KEYS), stride]`` float32 staging matrix.  ``ptr`` is the
    chunk's first element; ``chunk[key]`` is the column's row view
    (``sid`` and ``tid`` as int32), for the interpreter fill and readers.
    The matrix and the bounds are checked here: the native fill reads
    ``m`` elements of each row from ``ptr`` on."""

    __slots__ = ("mat", "lo", "m", "ptr", "stride")

    def __init__(self, mat: np.ndarray, lo: int, hi: int,
                 mat_ptr: Optional[int] = None):
        if mat_ptr is None:
            self.check_matrix(mat)
        if not 0 <= lo <= hi <= mat.shape[1]:
            raise ValueError(f"chunk [{lo}, {hi}) outside a "
                             f"{mat.shape[1]}-column staging matrix")
        self.mat = mat
        self.lo = int(lo)
        self.m = int(hi) - self.lo
        self.stride = mat.shape[1]
        self.ptr = (mat.ctypes.data if mat_ptr is None else mat_ptr) \
            + 4 * self.lo

    @staticmethod
    def check_matrix(mat: np.ndarray) -> None:
        if (mat.ndim != 2 or mat.shape[0] != len(STAGE_KEYS)
                or mat.dtype != np.float32 or not mat.flags.c_contiguous):
            raise ValueError(
                f"a staging matrix is C-contiguous float32 "
                f"[{len(STAGE_KEYS)}, n]; got {mat.dtype} {mat.shape}")

    def __getitem__(self, key: str) -> np.ndarray:
        row = self.mat[_ROW[key], self.lo:self.lo + self.m]
        return row.view(np.int32) if key in ("sid", "tid") else row


def staged_chunks(mat: np.ndarray, bounds) -> list:
    """Carriers for the ``(lo, hi)`` slices of one staging matrix (the
    matrix is checked once, its pointer read once)."""
    StagedChunk.check_matrix(mat)
    ptr = mat.ctypes.data
    return [StagedChunk(mat, lo, hi, ptr) for lo, hi in bounds]


class StagePlan:
    """The native fill of one pinned scratch slot (``sid [L, W]`` int32,
    ``planes [L, len(PLANES), W]`` float32, both C-contiguous), marshalled
    once."""

    __slots__ = ("_fn", "_sid", "_planes", "_lanes", "_width", "_dead",
                 "_expect", "_rows", "_bases", "_strides", "_row_map",
                 "_keep")

    def __init__(self, sid: np.ndarray, planes: np.ndarray, dead_sid: int):
        lanes, width = sid.shape
        if (sid.dtype != np.int32 or planes.dtype != np.float32
                or planes.shape != (lanes, len(PLANES), width)
                or not sid.flags.c_contiguous
                or not planes.flags.c_contiguous):
            raise ValueError("scratch must be C-contiguous int32 sid [L, W] "
                             f"and float32 planes [L, {len(PLANES)}, W]")
        self._fn = library().atn_stage_lanes
        self._keep = (sid, planes)
        self._sid = sid.ctypes.data
        self._planes = planes.ctypes.data
        self._lanes, self._width = int(lanes), int(width)
        self._dead = int(dead_sid)
        self._expect = self._lanes * (1 + len(PLANES)) * self._width
        self._rows = (ctypes.c_int64 * self._lanes)()
        self._bases = (ctypes.c_void_p * self._lanes)()
        self._strides = (ctypes.c_int64 * self._lanes)()
        self._row_map = (ctypes.c_int32 * len(ROW_MAP))(*ROW_MAP)

    def stage(self, group: Sequence[StagedChunk]) -> None:
        """Pack ``group`` (one chunk per live lane) into the slot,
        dead-filling row tails and dead lanes."""
        n_live = len(group)
        if n_live > self._lanes:
            raise ValueError(f"{n_live} chunks for a {self._lanes}-lane slot")
        rows, bases, strides = self._rows, self._bases, self._strides
        width = self._width
        for i, c in enumerate(group):
            if type(c) is not StagedChunk:
                raise ValueError("native staging takes StagedChunk matrix "
                                 f"carriers, got {type(c).__name__}")
            if c.m > width:
                raise ValueError(f"a {c.m}-row chunk in a {width}-wide slot")
            rows[i] = c.m
            bases[i] = c.ptr
            strides[i] = c.stride
        n = self._fn(self._sid, self._planes, bases, strides, rows,
                     self._row_map, len(PLANES), SQ_OF, n_live,
                     self._lanes, width, self._dead)
        if n != self._expect:
            raise ValueError(f"atn_stage_lanes refused the fill ({n})")

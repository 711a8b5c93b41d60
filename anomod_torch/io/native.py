"""The serve tick's host entries in C++ (``csrc/native.cpp``), bound with
``ctypes`` (counterpart of the staging and SFQ half of
``anomod/io/native.py``).

The source builds at first use with ``g++ -O3 -shared -fPIC -pthread``
into ``build/anomod_torch_native/`` beside the package, keyed by a hash
of the source, the compiler and the flags, and published atomically (a
per-process temporary renamed into place), so concurrent first uses in
several processes race safely.  There is no quiet fallback: a failed
build or load raises with the compiler's output, and a chunk that breaks
the staging contract raises ``ValueError``.  ``ctypes`` releases the GIL
for every call.

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
from typing import Optional, Sequence

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


def target(build_dir: Optional[Path] = None) -> Path:
    """The library path for this source, compiler and flags."""
    exe = cxx()
    key = SOURCE.read_bytes() + "\0".join((exe,) + CXX_FLAGS).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"libanomod_torch_native_{digest}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile ``csrc/native.cpp`` unless built already; returns the
    library path.  Raises ``RuntimeError`` with the compiler's output."""
    out = target(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    cmd = [cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)                  # atomic publish
    return out


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
    serve tick stages through it); ``mode`` ``on`` with no library adds
    ``error``.  It builds the library if it must, and reports a failed
    build rather than raising: it is a health document (``validate``
    carries it).  The staging path itself still raises."""
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

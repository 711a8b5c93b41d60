"""Build and load the port's CUDA kernels.

Each source under ``anomod_torch/csrc/`` compiles with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes``.  The build happens at first use, into
``build/anomod_torch_kernels/`` beside the package, keyed by a hash of the
source and the flags so an edited source rebuilds.  Nothing is built when
the package is imported: the CPU tests import every module, and the host
has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "anomod_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output per source from this process's builds (``-Xptxas -v``:
#: registers, shared memory and spills of every kernel)
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build anomod_torch's kernels")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, one ``nvcc``
    process per source, all started together.  Returns name -> library."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        exe = nvcc()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".tmp{os.getpid()}")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        failed = []
        for n, (p, tmp) in procs.items():
            log, _ = p.communicate()
            build_logs[n] = log
            if p.returncode != 0:
                failed.append(f"{n}.cu (exit {p.returncode}):\n{log}")
                continue
            os.replace(tmp, todo[n])      # atomic publish
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib

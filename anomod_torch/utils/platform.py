"""Device decisions (counterpart of ``anomod/utils/platform.py``): the
bounded out-of-process probe of the card, the numeric env knob parser and
the opt-in CPU failover.

The port's rule: no run moves off the card unless its caller asked for
it, and a run that moved says so.

- :func:`ensure_live_backend` probes the card in a subprocess with a hard
  deadline (a wedged card can hang ``torch.cuda.init()`` forever, so the
  probe never touches CUDA in this process).  A live card returns a note;
  a dead or missing card raises, naming how to ask for the host
  (``--device cpu`` or ``ANOMOD_PLATFORM=cpu``).  It never pins the host.
  :func:`start_probe` runs it in a thread beside the caller's host work,
  and ``device.resolve_device`` joins it (:func:`await_probe`) before the
  card is first touched.
- :func:`with_cpu_failover` reruns one unit of work on the CPU after the
  card was lost mid-run, once, and only when the caller passed
  ``allow=True``.  Deterministic device errors (out of memory, an illegal
  address, a device-side assert, a bad launch, a kernel build error)
  always propagate: retrying a bug on the host buries it.

The JAX package's ``pin_cpu``, ``is_pinned`` and ``enable_jit_cache`` have
no counterpart: the port has no process-wide platform to repoint (every
entry point takes its ``device``), and its kernels are built once into
``ops/_build.py``'s directory rather than through XLA's compile cache.
The JAX package's verdict cache (``read_probe_verdict`` /
``write_probe_verdict``) serves its bench entry, which the port has not
yet.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Optional

import torch

#: the probe subprocess's program: ``cuda`` when a card initializes,
#: ``cpu`` when this install sees none
_PROBE_PROGRAM = (
    "import torch\n"
    "if torch.cuda.is_available():\n"
    "    torch.cuda.init()\n"
    "    print('cuda')\n"
    "else:\n"
    "    print('cpu')\n")


def probe_device_platform(attempts=None):
    """Out-of-process device probe with a hard deadline.

    Returns ``(platform, diagnostic)``: ``platform`` is ``"cuda"`` when a
    card initialized in the subprocess, ``"cpu"`` when the install sees
    no card, and ``""`` when nothing answered within the deadline (or the
    subprocess failed; the diagnostic holds its stderr's tail).
    ``attempts`` are the deadlines in seconds, tried in turn (default
    75 s then 30 s: sized for a slow but live cold init)."""
    import subprocess

    attempts = attempts or (75.0, 30.0)
    last = ""
    for t in attempts:
        try:
            r = subprocess.run([sys.executable, "-c", _PROBE_PROGRAM],
                               timeout=t, capture_output=True)
            if r.returncode == 0:
                return r.stdout.decode(errors="replace").strip(), "probe ok"
            last = (r.stderr or b"").decode(errors="replace").strip()[-300:]
        except subprocess.TimeoutExpired:
            last = f"backend init probe timed out after {t:.0f}s"
    return "", last or "unknown"


def ensure_live_backend(attempts=None) -> str:
    """Probe the card out of process; raise when it is dead or missing.

    Returns ``"probe ok: cuda"``, or ``"probe skipped via
    ANOMOD_SKIP_PROBE"`` under ``ANOMOD_SKIP_PROBE=1``.  ``attempts=None``
    keeps :func:`probe_device_platform`'s default deadlines;
    ``ANOMOD_PROBE_DEADLINE=<secs>`` overrides them.  A dead or missing
    card raises ``RuntimeError`` with the diagnostic: the host is used
    only when the caller asks for it."""
    if os.environ.get("ANOMOD_SKIP_PROBE", "").strip() == "1":
        return "probe skipped via ANOMOD_SKIP_PROBE"
    if attempts is None:
        deadline = env_number("ANOMOD_PROBE_DEADLINE", None, cast=float)
        if deadline is not None:
            attempts = (deadline,)
    plat, diag = probe_device_platform(attempts)
    if plat == "cuda":
        return "probe ok: cuda"
    why = diag if not plat else f"the probe answered {plat!r}"
    raise RuntimeError(
        f"no CUDA device is available: device backend unavailable ({why}); "
        "to run on the host, ask for it with --device cpu or "
        "ANOMOD_PLATFORM=cpu")


#: the probe a caller started beside its host work (:func:`start_probe`):
#: ``(thread, outcome)``, joined by :func:`await_probe` under ``_JOIN``
_PENDING = None
_JOIN = threading.Lock()


def start_probe(attempts=None) -> None:
    """Start :func:`ensure_live_backend` in a thread, so that the probe's
    subprocess (its own ``import torch`` and ``torch.cuda.init()``) runs
    beside the caller's host work.  ``device.resolve_device`` joins it
    before the card is first touched; a second start while one is pending
    does nothing."""
    global _PENDING
    if _PENDING is not None:
        return
    outcome = {}

    def run():
        try:
            outcome["note"] = ensure_live_backend(attempts)
        except BaseException as e:      # handed to the joining thread
            outcome["error"] = e
    thread = threading.Thread(target=run, name="anomod-probe", daemon=True)
    thread.start()
    _PENDING = (thread, outcome)


def await_probe(quiet: bool = False) -> Optional[str]:
    """Join the probe :func:`start_probe` started: its note, or None when
    none is pending.  A dead or missing card raises its ``RuntimeError``
    here, unless ``quiet`` (a caller that is already failing only waits
    for the subprocess to end)."""
    global _PENDING
    with _JOIN:
        if _PENDING is None:
            return None
        (thread, outcome), _PENDING = _PENDING, None
        thread.join()
    if "error" in outcome and not quiet:
        raise outcome["error"]
    return outcome.get("note")


def env_number(name: str, default, cast=int):
    """Parse a numeric env var, warning and falling back on garbage:
    empty or unset -> ``default``, non-numeric -> a stderr warning and
    ``default`` (``ANOMOD_CPU_DEVICES``, ``ANOMOD_PROBE_DEADLINE``)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return cast(raw)
    except ValueError:
        print(f"[anomod] ignoring non-numeric {name}={raw!r}",
              file=sys.stderr)
        return default


#: Substrings that read as loss of the card or of a peer: CUDA's own
#: words for an unusable device, NVML's for a card off the bus, NCCL's
#: for a peer that went away.
_DEVICE_LOSS_MARKERS = (
    "busy or unavailable",                  # cudaErrorDevicesUnavailable
    "no CUDA-capable device is detected",   # cudaErrorNoDevice
    "uncorrectable ECC error",              # cudaErrorECCUncorrectable
    "context is destroyed",                 # cudaErrorContextIsDestroyed
    "system not yet initialized",           # cudaErrorSystemNotReady
    "GPU is lost", "fallen off the bus",    # NVML, Xid 79
    "remote process exited",                # ncclRemoteError
    "NCCL communicator was aborted",
)

#: Substrings of deterministic errors: a bug or a limit of the work
#: itself, which fails the same way on a retry and never reads as loss.
_NOT_LOSS_MARKERS = (
    "out of memory",                        # cudaErrorMemoryAllocation
    "illegal memory access",                # cudaErrorIllegalAddress
    "illegal address",
    "device-side assert",                   # cudaErrorAssert
    "misaligned address",                   # cudaErrorMisalignedAddress
    "invalid configuration argument",       # cudaErrorInvalidConfiguration
    "too many resources requested for launch",
    "illegal instruction",
    "nvcc failed", "nvcc not found",        # ops/_build.py
)


def is_backend_loss(exc: BaseException) -> bool:
    """True when the exception reads as loss of the card (or of an NCCL
    peer) rather than as a deterministic error of the work."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    msg = str(exc)
    if any(m in msg for m in _NOT_LOSS_MARKERS):
        return False
    return any(m in msg for m in _DEVICE_LOSS_MARKERS)


def with_cpu_failover(fn, device, *, allow: bool = False,
                      on_failover=None):
    """Run ``fn(device)``; when the caller allowed it and the card was
    lost while it ran, run ``fn(torch.device("cpu"))`` once more.

    The retry happens only when all four hold: ``allow`` is true, the
    error reads as loss (:func:`is_backend_loss`, checked first: it
    touches no device), ``device`` is a CUDA device, and this is the
    first failure.  Otherwise the original exception propagates
    unchanged; a failure of the retry propagates too.  ``on_failover``
    is called with the original exception before the retry, so the
    caller can say that the run moved."""
    dev = torch.device("cuda" if device is None else device)
    try:
        return fn(dev)
    except RuntimeError as e:
        if not allow or not is_backend_loss(e) or dev.type != "cuda":
            raise
        if on_failover is not None:
            on_failover(e)
    return fn(torch.device("cpu"))

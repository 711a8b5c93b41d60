"""Double-buffered host-to-device staging (counterpart of ``anomod/io/prefetch.py``).

While the replay step consumes chunk ``i`` on the card, a background
thread copies chunk ``i+1`` from pinned host memory with a ``non_blocking``
copy on a side CUDA stream.  Each staged item carries an event recorded on
that stream; the consumer makes its own stream wait on the event (and
marks the tensors as used there) before the step reads them, so the copy
of the next chunk overlaps the kernel on the current one.  On the CPU the
same pipeline only wraps the arrays as tensors.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from anomod_torch import obs

_SENTINEL = object()


class Pipeline:
    """Bounded background-staging iterator (the double buffer).

    A worker thread pulls items from ``iterable``, applies ``fn`` and parks
    at most ``depth`` staged results in a queue; the consumer receives
    ``finish(staged)`` in order.  Worker exceptions are re-raised in the
    consumer.  A consumer that stops early MUST call :meth:`close` (a
    ``finally`` block at every call site), or the worker stays parked on
    the bounded queue holding staged buffers.
    """

    def __init__(self, iterable: Iterable[Any], fn: Callable[[Any], Any],
                 depth: int = 2,
                 finish: Optional[Callable[[Any], Any]] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._err: Optional[BaseException] = None
        self._finish = finish or (lambda x: x)
        # staging telemetry: each item's staging wall, and the queue
        # occupancy both sides see (full: the consumer is the bottleneck,
        # empty: the staging is); one cached gauge handle for both sides
        stage_s = obs.histogram("anomod_prefetch_stage_seconds")
        self._occupancy = obs.gauge("anomod_prefetch_queue_depth")
        occupancy = self._occupancy

        def work():
            try:
                for item in iterable:
                    if self._stop.is_set():
                        return
                    t0 = time.perf_counter()
                    staged = fn(item)
                    stage_s.observe(time.perf_counter() - t0)
                    self._q.put(staged)
                    occupancy.set(self._q.qsize())
            except BaseException as e:       # re-raised on the consumer side
                self._err = e
            finally:
                self._q.put(_SENTINEL)

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="anomod-torch-prefetch")
        self._thread.start()

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        self._occupancy.set(self._q.qsize())
        if item is _SENTINEL:
            self._done = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return self._finish(item)

    def close(self) -> None:
        """Stop the worker and drain; safe to call more than once."""
        if self._done:
            return
        self._stop.set()
        while True:
            try:
                if self._q.get(timeout=0.05) is _SENTINEL:
                    break
            except queue.Empty:
                if not self._thread.is_alive():
                    break
        self._done = True
        self._thread.join(timeout=5.0)


def _host_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _stager(device: torch.device):
    """``(stage, finish)`` for :class:`Pipeline` on ``device``: dicts of
    numpy arrays in, dicts of tensors on ``device`` out."""
    if device.type != "cuda":
        return (lambda item: {k: _host_tensor(v) for k, v in item.items()},
                None)
    side = torch.cuda.Stream(device=device)

    def stage(item):
        with torch.cuda.stream(side):
            out = {k: _host_tensor(v).pin_memory().to(device,
                                                      non_blocking=True)
                   for k, v in item.items()}
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def finish(staged):
        out, done = staged
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        for t in out.values():
            # the tensors were allocated on the side stream: keep the
            # caching allocator from reusing them while `cur` reads them
            t.record_stream(cur)
        return out

    return stage, finish


def prefetch_to_device(iterable: Iterable[Dict[str, np.ndarray]],
                       device: torch.device, depth: int = 2) -> Pipeline:
    """Stage each dict of arrays to ``device`` in a background thread,
    ``depth`` ahead."""
    stage, finish = _stager(torch.device(device))
    return Pipeline(iterable, stage, depth=depth, finish=finish)


def iter_chunk_dicts(chunks: Dict[str, np.ndarray]) -> Iterator[Dict[str, Any]]:
    """Per-chunk row dicts from stage_columns' stacked [n_chunks, C] arrays."""
    n_chunks = next(iter(chunks.values())).shape[0]
    for i in range(n_chunks):
        yield {k: v[i] for k, v in chunks.items()}


def device_put_columns(columns: Dict[str, np.ndarray], device: torch.device,
                       depth: int = 2) -> Dict[str, torch.Tensor]:
    """Stage a column dict to ``device``, one column per pipeline item so
    the copy of column ``j`` overlaps the host packing of ``j+1``."""
    staged = prefetch_to_device(({k: v} for k, v in columns.items()),
                                device, depth=depth)
    try:
        out: Dict[str, torch.Tensor] = {}
        for part in staged:
            out.update(part)
        return out
    finally:
        staged.close()

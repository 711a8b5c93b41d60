"""Serving-plane defaults and their validators (the serve half of
``anomod/config.py``).

The port reads no environment knobs for the serve plane: every setting is
a constructor argument whose default is the JAX package's default.
"""

from __future__ import annotations

#: micro-batch bucket widths (spans) of the dynamic batcher; widths above
#: the replay chunk size are never staged
DEFAULT_SERVE_BUCKETS = (64, 256, 1024, 4096, 16384)

#: lane counts of the fused (lane-stacked) dispatch
DEFAULT_SERVE_LANE_BUCKETS = (1, 2, 4, 8, 16, 32)

#: global admission backlog bound (spans): the backpressure/shed budget
DEFAULT_SERVE_MAX_BACKLOG = 200_000

#: in-flight fused dispatches per runner plus one (depth 1 = synchronous)
DEFAULT_SERVE_PIPELINE = 2


def validate_serve_buckets(buckets) -> tuple:
    """The one bucket-set contract: positive, strictly ascending ints."""
    try:
        out = tuple(int(b) for b in buckets)
    except (TypeError, ValueError):
        raise ValueError(f"bucket set must be integers, got {buckets!r}")
    if not out:
        raise ValueError("bucket set must not be empty")
    if any(b < 1 for b in out):
        raise ValueError(f"bucket widths must be >= 1, got {out}")
    if any(b >= c for b, c in zip(out, out[1:])):
        raise ValueError(f"bucket widths must be strictly ascending: {out}")
    return out


def validate_lane_buckets(lanes) -> tuple:
    """The lane-bucket contract: positive, strictly ascending ints (every
    (width, lane-bucket) pair is one kernel shape, so the set is small
    and fixed)."""
    try:
        out = tuple(int(b) for b in lanes)
    except (TypeError, ValueError):
        raise ValueError(f"lane-bucket set must be integers, got {lanes!r}")
    if not out:
        raise ValueError("lane-bucket set must not be empty")
    if any(b < 1 for b in out):
        raise ValueError(f"lane buckets must be >= 1, got {out}")
    if any(b >= c for b, c in zip(out, out[1:])):
        raise ValueError(f"lane buckets must be strictly ascending: {out}")
    return out

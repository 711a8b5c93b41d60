"""SN social-graph seeder — deterministic graph synthesis + seeding program.

Counterpart of ``anomod/seeder.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_workload.py``.

The reference seeds the SocialNetwork testbed from the ``socfb-Reed98``
Facebook edge list (962 users, ~18.8k undirected edges): register every user,
upload both follow directions per edge, optionally compose up to 20 posts per
user (average 10), all batched through an asyncio gate of 200 in-flight
requests with ``random.seed(1)`` determinism
(DeathStarBench/socialNetwork/scripts/init_social_graph.py:76-160).

The checkout does not materialize the dataset, so this module *synthesizes* a
graph with the same shape — a heavy-tailed Chung-Lu construction pinned to
the Reed98 scale — and compiles the same seeding program: batched
register/follow/compose request waves against the wrk2-api endpoints
(enhanced_openapi_monitor.py:36-49 vocabulary).  The resulting follower
counts also feed timeline-read weighting for SN traffic synthesis: hot users
dominate home-timeline reads the way the wrk2 Lua workload's zipfian user
draws do (mixed-workload.lua:33-83).
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np

# socfb-Reed98 scale (init_social_graph.py:143-147 loads nodes+edges files)
REED98_USERS = 962
REED98_EDGES = 18_812

REGISTER = ("POST", "/wrk2-api/user/register")
FOLLOW = ("POST", "/wrk2-api/user/follow")
COMPOSE = ("POST", "/wrk2-api/post/compose")


class SocialGraph(NamedTuple):
    n_users: int
    edges: np.ndarray          # [E, 2] int32, undirected, deduped, u < v
    posts_per_user: np.ndarray  # [n_users] int32

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    def follower_counts(self) -> np.ndarray:
        """In-degree under both-direction follows (== undirected degree)."""
        deg = np.zeros(self.n_users, np.int64)
        np.add.at(deg, self.edges[:, 0], 1)
        np.add.at(deg, self.edges[:, 1], 1)
        return deg


def generate_graph(n_users: int = REED98_USERS,
                   n_edges: int = REED98_EDGES,
                   seed: int = 1,
                   tail: float = 1.8) -> SocialGraph:
    """Chung-Lu style heavy-tailed graph at the Reed98 scale.

    Vectorized: draw per-user weights from a Pareto tail, sample edge
    endpoints proportional to weight, drop self-loops/duplicates, and top up
    until the edge budget is met.  Deterministic in ``seed`` (the reference
    pins random.seed(1), init_social_graph.py:149).
    """
    feasible = n_users * (n_users - 1) // 2
    if n_edges > feasible:
        raise ValueError(
            f"n_edges={n_edges} exceeds the {feasible} unique pairs "
            f"available among {n_users} users")
    rng = np.random.default_rng(seed)
    w = rng.pareto(tail, n_users) + 1.0
    p = w / w.sum()
    seen = set()
    rows: List[Tuple[int, int]] = []
    # oversample in waves; heavy tail makes duplicates common
    stalled = 0
    while len(rows) < n_edges and stalled < 8:
        need = max(1024, int((n_edges - len(rows)) * 1.6))
        u = rng.choice(n_users, size=need, p=p)
        v = rng.choice(n_users, size=need, p=p)
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        before = len(rows)
        for a, b in zip(lo.tolist(), hi.tolist()):
            if a == b or (a, b) in seen:
                continue
            seen.add((a, b))
            rows.append((a, b))
            if len(rows) == n_edges:
                break
        stalled = stalled + 1 if len(rows) == before else 0
    if len(rows) < n_edges:
        # near the feasibility ceiling weighted sampling stops landing on
        # unseen pairs — top up deterministically
        for a in range(n_users):
            for b in range(a + 1, n_users):
                if (a, b) not in seen:
                    seen.add((a, b))
                    rows.append((a, b))
                    if len(rows) == n_edges:
                        break
            if len(rows) == n_edges:
                break
    edges = np.array(rows, np.int32).reshape(-1, 2)
    # up to 20 posts per user, average 10 (init_social_graph.py:119)
    posts = rng.integers(0, 21, size=n_users).astype(np.int32)
    return SocialGraph(n_users, edges, posts)


class SeedOp(NamedTuple):
    method: str
    path: str
    params: Tuple[Tuple[str, str], ...]


def seeding_program(graph: SocialGraph, compose: bool = False) -> List[SeedOp]:
    """The full seeding request sequence: register every user, follow both
    directions per edge (init_social_graph.py:99-104 uploads edge[0]→edge[1]
    AND edge[1]→edge[0]), optionally compose posts."""
    ops: List[SeedOp] = []
    for i in range(graph.n_users):
        ops.append(SeedOp(*REGISTER, (
            ("first_name", f"first_name_{i}"), ("last_name", f"last_name_{i}"),
            ("username", f"username_{i}"), ("password", f"password_{i}"),
            ("user_id", str(i)))))
    for a, b in graph.edges.tolist():
        ops.append(SeedOp(*FOLLOW, (("user_name", f"username_{a}"),
                                    ("followee_name", f"username_{b}"))))
        ops.append(SeedOp(*FOLLOW, (("user_name", f"username_{b}"),
                                    ("followee_name", f"username_{a}"))))
    if compose:
        for i in range(graph.n_users):
            for _ in range(int(graph.posts_per_user[i])):
                ops.append(SeedOp(*COMPOSE, (("username", f"username_{i}"),
                                             ("user_id", str(i)))))
    return ops


def waves(ops: Sequence[SeedOp], limit: int = 200) -> Iterator[Sequence[SeedOp]]:
    """Batch the program into concurrent waves of ``limit`` in-flight requests
    (the asyncio connector gate, init_social_graph.py:78,156)."""
    for i in range(0, len(ops), limit):
        yield ops[i:i + limit]


def timeline_weights(graph: SocialGraph) -> np.ndarray:
    """Per-user home-timeline read propensity ∝ follower count (hot users are
    read more) — feeds SN traffic synthesis."""
    deg = graph.follower_counts().astype(np.float64)
    total = deg.sum()
    if total == 0:  # edgeless graph: uniform reads
        return np.full(graph.n_users, 1.0 / max(graph.n_users, 1))
    return deg / total

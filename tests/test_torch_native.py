"""The port's C++ host entries (``anomod_torch/csrc/native.cpp`` through
``anomod_torch.io.native``), built with the host's ``g++`` on the CPU.

- The native scratch fill is byte-identical to the interpreter fill
  (``BucketRunner._fill_slot_py``) and to the JAX runner's fill of the same
  chunks, over (seed, lanes, width) with lanes 1-32 and widths 64-16384,
  empty groups, tails of 0 and of ``width`` and all-dead slots.
- The columnar SFQ scans (native and numpy) equal each other and the heap
  engine on seeded offer / drain / evict sequences.
- A chunk that breaks the staging contract raises ``ValueError``.
- Two processes building into one empty directory publish one library.
"""

import dataclasses
import multiprocessing
import os

import numpy as np
import pytest

from anomod.replay import ReplayConfig as JReplayConfig
from anomod.serve.batcher import BucketRunner as JBucketRunner
from anomod_torch.io import native
from anomod_torch.ops.replay_kernels import PLANES
from anomod_torch.replay import STAGE_KEYS, ReplayConfig
from anomod_torch.schemas import SpanBatch
from anomod_torch.serve.batcher import BucketRunner
from anomod_torch.serve.queues import (AdmissionController, TenantSpec,
                                       _ColumnarSFQ)

N_SERVICES = 5


def _cfg():
    return ReplayConfig(n_services=N_SERVICES, n_windows=8,
                        window_us=1_000_000, chunk_size=16384)


def _staging_matrix(rng, n, sw):
    """A ``[7, n]`` staging matrix in ``STAGE_KEYS`` row order: sid and
    tid as int32 bits, the rest f32 (dur with negative zeros, NaNs and
    denormals beside plain values, so dur2's rounding is exercised)."""
    mat = np.empty((len(STAGE_KEYS), n), np.float32)
    mat[0].view(np.int32)[:] = rng.integers(0, sw, n)
    mat[-1].view(np.int32)[:] = rng.integers(0, 1 << 30, n)
    mat[1:-1] = rng.normal(0, 3, (len(STAGE_KEYS) - 2, n))
    dur = mat[STAGE_KEYS.index("dur")]
    special = np.array([-0.0, np.nan, 1e-40, 3.4e38, 1.0000001], np.float32)
    k = min(n, 5 * (n // 50))
    dur[rng.choice(n, k, replace=False)] = np.resize(special, k)
    return mat


def _group(rng, lanes, width, sw):
    """Chunks for a random number of live lanes (0 to ``lanes``) of one
    staging matrix, tails of 0 and of ``width`` among them."""
    n_live = int(rng.integers(0, lanes + 1))
    sizes = [int(rng.integers(0, width + 1)) for _ in range(n_live)]
    if n_live >= 2:
        sizes[0], sizes[1] = 0, width
    mat = _staging_matrix(rng, max(sum(sizes), 1), sw)
    bounds, lo = [], 0
    for m in sizes:
        bounds.append((lo, lo + m))
        lo += m
    return native.staged_chunks(mat, bounds)


def _fills(lanes, width, group):
    cfg = _cfg()
    out = []
    for flag in (True, False):
        runner = BucketRunner(cfg, buckets=(64,), lane_buckets=(lanes,),
                              device="cpu", native_stage=flag)
        (sid, planes), _ = runner._fill_slot(width, lanes, group)
        out.append((sid.numpy().copy(), planes.numpy().copy()))
    return out


@pytest.mark.parametrize("seed,lanes,width", [
    (0, 1, 64), (1, 2, 256), (2, 3, 1024), (3, 8, 4096), (4, 17, 64),
    (5, 32, 16384), (6, 32, 64), (7, 5, 16384)])
def test_native_fill_equals_interpreter_and_jax(seed, lanes, width):
    rng = np.random.default_rng(seed)
    cfg = _cfg()
    with np.errstate(over="ignore"):          # 3.4e38 squared is inf
        _check_fills(rng, cfg, lanes, width)


def _check_fills(rng, cfg, lanes, width):
    for _ in range(3):
        group = _group(rng, lanes, width, cfg.sw)
        (ns, npl), (ps, ppl) = _fills(lanes, width, group)
        assert ns.tobytes() == ps.tobytes()
        assert npl.tobytes() == ppl.tobytes()
        # the JAX runner's interpreter fill of the same chunks
        jrun = JBucketRunner(JReplayConfig(
            n_services=N_SERVICES, n_windows=8, window_us=1_000_000,
            chunk_size=16384), buckets=(64,))
        scratch = {k: np.empty((lanes, width), np.int32 if k in
                               ("sid", "tid") else np.float32)
                   for k in STAGE_KEYS}
        jrun._fill_slot_py(scratch, [{k: c[k] for k in STAGE_KEYS}
                                     for c in group], width, lanes)
        assert ns.tobytes() == scratch["sid"].tobytes()
        for p, k in enumerate(PLANES[:5]):
            assert npl[:, p].tobytes() == scratch[k].tobytes(), k
        dur2 = np.multiply(scratch["dur"], scratch["dur"])
        assert npl[:, 5].tobytes() == dur2.tobytes()


@pytest.mark.parametrize("lanes,width", [(1, 64), (4, 1024), (32, 256)])
def test_all_dead_slot(lanes, width):
    (ns, npl), (ps, ppl) = _fills(lanes, width, [])
    assert (ns == _cfg().sw).all() and not npl.any()
    assert ns.tobytes() == ps.tobytes() and npl.tobytes() == ppl.tobytes()


def test_serve_chunks_fill_identically():
    """The serve path's own chunks (``stage_plan`` of traffic batches)."""
    from anomod_torch.schemas import concat_span_batches
    from anomod_torch.serve.traffic import PowerLawTraffic
    tt = PowerLawTraffic(n_tenants=9, total_rate_spans_per_s=3000,
                         alpha=1.1, seed=3, n_services=N_SERVICES,
                         batch_cap=128)
    batch = concat_span_batches([b for _, b in tt.arrivals(0.0, 2.0)])
    cfg = ReplayConfig(n_services=N_SERVICES, n_windows=8,
                       window_us=1_000_000, chunk_size=256)
    runs = [BucketRunner(cfg, buckets=(64, 256), lane_buckets=(4,),
                         device="cpu", native_stage=f) for f in (True, False)]
    plan = runs[0].stage_plan(batch, 0)
    assert len(plan) > 2 and all(type(c) is native.StagedChunk
                                 for _, c in plan)
    group = [c for w, c in plan if w == 256][:3]
    got = [r._fill_slot(256, 4, group)[0] for r in runs]
    for a, b in zip(*got):
        assert a.numpy().tobytes() == b.numpy().tobytes()


# -- the contract -----------------------------------------------------------

def test_fill_contract_breaks_raise():
    cfg = _cfg()
    runner = BucketRunner(cfg, buckets=(64,), lane_buckets=(2,),
                          device="cpu")
    rng = np.random.default_rng(0)
    mat = _staging_matrix(rng, 200, cfg.sw)
    ok = native.staged_chunks(mat, [(0, 64), (64, 128)])
    with pytest.raises(ValueError, match="StagedChunk"):
        runner._fill_slot(64, 2, [{k: ok[0][k] for k in STAGE_KEYS}])
    with pytest.raises(ValueError, match="wide slot"):
        runner._fill_slot(64, 2, native.staged_chunks(mat, [(0, 100)]))
    with pytest.raises(ValueError, match="2-lane slot"):
        runner._fill_slot(64, 2, ok + ok[:1])
    with pytest.raises(ValueError, match="staging matrix"):
        native.staged_chunks(mat[:6].copy(), [(0, 10)])
    with pytest.raises(ValueError, match="staging matrix"):
        native.staged_chunks(mat.astype(np.float64), [(0, 10)])
    with pytest.raises(ValueError, match="staging matrix"):
        native.staged_chunks(np.asfortranarray(mat), [(0, 10)])
    with pytest.raises(ValueError, match="staging matrix"):
        native.StagedChunk(mat[:, ::2], 0, 10)
    with pytest.raises(ValueError, match="outside"):
        native.staged_chunks(mat, [(150, 201)])
    with pytest.raises(ValueError, match="outside"):
        native.StagedChunk(mat, 20, 10)
    with pytest.raises(ValueError, match="scratch"):
        native.StagePlan(np.zeros((2, 64), np.int64),
                         np.zeros((2, 6, 64), np.float32), cfg.sw)
    # a refused fill leaves the slot usable: the good group still stages
    runner._fill_slot(64, 2, ok)


# -- the columnar SFQ scans -------------------------------------------------

def _book(rng, n, engine, ties):
    book = _ColumnarSFQ(engine, cap=16)
    fins = rng.integers(0, 8, n).astype(float) if ties \
        else rng.uniform(0, 100, n)
    from anomod_torch.serve.queues import QueuedBatch
    for seq in range(n):
        book.add(QueuedBatch(tenant_id=0, seq=seq, spans=None,
                             n_spans=int(rng.integers(1, 50)),
                             priority=int(rng.integers(0, 3)),
                             enqueued_s=0.0, finish_tag=float(fins[seq])))
    for seq in rng.choice(n, n // 3, replace=False):
        book.remove(int(seq))
    return book


@pytest.mark.parametrize("seed,n,ties", [(0, 1, False), (1, 40, False),
                                         (2, 300, True), (3, 1000, False)])
def test_sfq_scans_native_equal_numpy(seed, n, ties):
    books = [_book(np.random.default_rng(seed), n, e, ties)
             for e in ("native", "numpy")]
    for budget in (0.0, 1.0, 37.5, 500.0, 1e9, -3.0):
        assert books[0].select(budget) == books[1].select(budget)
    assert books[0].victim() == books[1].victim()


def _batch(n):
    z = np.zeros(n, np.int64)
    return SpanBatch(trace=z.astype(np.int32), parent=z.astype(np.int32),
                     service=z.astype(np.int32), endpoint=z.astype(np.int32),
                     start_us=z, duration_us=z, is_error=z.astype(bool),
                     status=z.astype(np.int16), kind=z.astype(np.int8),
                     services=("s",), endpoints=("e",), trace_ids=("t",))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drain_engines_equal_on_offer_drain_evict(seed):
    """heap == numpy == native over a seeded overload sequence with
    evictions: served order, finish tags, the virtual time and every
    counter."""
    rng = np.random.default_rng(seed)
    specs = [TenantSpec(t, f"t{t}", priority=int(rng.integers(0, 3)),
                        weight=float(rng.choice([0.0, 0.5, 3.0])))
             for t in range(12)]
    ctrls = [AdmissionController(specs, max_backlog=900,
                                 max_tenant_backlog=400, drain_engine=e)
             for e in ("heap", "numpy", "native")]
    assert [c.drain_engine for c in ctrls] == ["heap", "numpy", "native"]
    evicted = 0
    for k in range(60):
        offers = [(int(rng.integers(0, 12)), int(rng.integers(0, 160)))
                  for _ in range(int(rng.integers(0, 9)))]
        budget = float(rng.choice([0.0, 50.5, 300.0, 1200.0]))
        outs = []
        for c in ctrls:
            adm = [c.offer(t, _batch(n), float(k)) for t, n in offers]
            served = [(q.tenant_id, q.seq, q.n_spans, q.finish_tag)
                      for q in c.drain(budget)]
            outs.append((adm, served, c._vtime, c.backlog_spans,
                         dataclasses.astuple(c.totals())))
        assert outs[0] == outs[1] == outs[2]
        evicted = outs[0][-1][-1]
    assert evicted > 0
    assert {t: dataclasses.astuple(c) for t, c in ctrls[0].counters.items()} \
        == {t: dataclasses.astuple(c) for t, c in ctrls[2].counters.items()}


# -- the build ----------------------------------------------------------------

def _build_in(path, q):
    try:
        lib = native.build(path)
        import ctypes
        q.put(str(lib) if ctypes.CDLL(str(lib)).atn_sfq_victim else "")
    except BaseException as e:           # report, never hang the parent
        q.put(f"error: {e!r}")


def test_build_publishes_atomically_under_a_race(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_build_in, args=(tmp_path, q))
             for _ in range(2)]
    for p in procs:
        p.start()
    got = [q.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs)
    assert got[0] == got[1] == str(native.target(tmp_path)), got
    assert sorted(os.listdir(tmp_path)) == [native.target(tmp_path).name]

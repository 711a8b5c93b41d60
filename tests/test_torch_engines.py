"""The two engine-choice knobs, ``ANOMOD_SERVE_LANE_ENGINE`` and
``ANOMOD_TDIGEST_ENGINE``, against the JAX package's, on the CPU.

The values, their normalization and the error for an invalid one are
the JAX package's.  What a value does is the port's: on the card only
the port's kernels run (``auto`` and ``pallas``), and the values that
name JAX formulations (``matmul`` / ``scatter``, ``host`` / ``xla``) are
refused before anything launches; on the CPU every valid value runs the
plain versions.  The card check is a pure function of (knob, value,
device), so it is handed ``torch.device("cuda")`` here without a card.

Tolerance: the percentiles against the JAX host build, rtol 2e-3 and
atol 1e-2 (``tests/test_replay.py``'s for its engines); the serve runs
under each lane value equal the unset run's states and alerts byte for
byte.
"""

import dataclasses

import numpy as np
import pytest
import torch

import anomod.config as jconfig
import anomod_torch.config as tconfig
from anomod import labels as jlabels
from anomod import synth as jsynth
from anomod.replay import ReplayConfig as JReplayConfig
from anomod.replay import _resolve_tdigest_engine as j_resolve
from anomod.replay import replay_percentiles as j_percentiles
from anomod.schemas import concat_span_batches as jconcat
from anomod_torch import labels, replay, synth
from anomod_torch.schemas import concat_span_batches
from anomod_torch.serve.engine import run_power_law

CUDA = torch.device("cuda")
CPU = torch.device("cpu")
LANE_VALUES = ("auto", "matmul", "scatter", "pallas")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain lane fold's ``index_add_``
    contends under torch's thread pool on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_config(monkeypatch):
    """Both packages re-read the environment; their settings are put
    back afterwards."""
    jprev, tprev = jconfig.get_config(), tconfig.get_config()
    yield monkeypatch
    jconfig.set_config(jprev)
    tconfig.set_config(tprev)


def _parse(module, monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("ANOMOD_SERVE_LANE_ENGINE", raising=False)
    else:
        monkeypatch.setenv("ANOMOD_SERVE_LANE_ENGINE", raw)
    try:
        return module.Config().serve_lane_engine
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("raw", [None, "", "auto", "AUTO", " Pallas ",
                                 "matmul", "scatter", "banana"])
def test_lane_knob_parses_as_jax(raw, fresh_config):
    got = _parse(tconfig, fresh_config, raw)
    assert got == _parse(jconfig, fresh_config, raw)
    if raw == "banana":
        assert got == ("ValueError: ANOMOD_SERVE_LANE_ENGINE must be auto, "
                       "matmul, scatter or pallas, got 'banana'")


def _resolve(fn, *a, **k):
    try:
        return fn(*a, **k)
    except ValueError as e:
        return f"ValueError: {e}"


def _same_engine(got, want):
    """The port's value equals the JAX one, but for ``auto``: the JAX
    package resolves it by its backend (``host`` on the CPU), the port
    keeps it (its plain version on the CPU, the kernel on the card)."""
    return got == want or (got, want) == ("auto", "host")


@pytest.mark.parametrize("engine", ["auto", "AUTO", "HOST", " pallas ",
                                    "xla", "exact"])
@pytest.mark.parametrize("env", [None, "pallas", "HOST", "xla", "exact"])
def test_tdigest_engine_resolves_as_jax(engine, env, fresh_config):
    """The JAX selector reads ``ANOMOD_TDIGEST_ENGINE`` under ``auto`` and
    normalizes an explicit engine: the port reads the variable into
    ``Config`` and normalizes a value by the same rule (case-folded,
    stripped, an unknown value raising the same error)."""
    if env is None:
        fresh_config.delenv("ANOMOD_TDIGEST_ENGINE", raising=False)
    else:
        fresh_config.setenv("ANOMOD_TDIGEST_ENGINE", env)
    if engine.strip().lower() == "auto":
        got = _resolve(lambda: tconfig.Config().tdigest_engine)
    else:
        got = _resolve(tconfig.validate_tdigest_engine, engine)
    assert _same_engine(got, _resolve(j_resolve, engine))
    if engine == "exact" or (engine == "auto" and env == "exact"):
        assert got == "ValueError: unknown t-digest engine 'exact'"


def test_knobs_refuse_jax_formulations_on_the_card():
    """On a card only the kernels' values pass; on the CPU every value
    runs the plain version.  The check touches no device."""
    for device in (CUDA, "cuda", "cuda:0", None):
        for knob in ("ANOMOD_SERVE_LANE_ENGINE", "ANOMOD_TDIGEST_ENGINE"):
            for v in ("auto", "pallas"):
                tconfig.refuse_on_card(knob, v, device)
    for knob, values in (("ANOMOD_SERVE_LANE_ENGINE", ("matmul", "scatter")),
                         ("ANOMOD_TDIGEST_ENGINE", ("host", "xla"))):
        for v in values:
            with pytest.raises(ValueError, match=f"{knob}='{v}' names a "
                               "JAX formulation"):
                tconfig.refuse_on_card(knob, v, CUDA)
            for device in (CPU, "cpu"):
                tconfig.refuse_on_card(knob, v, device)


def test_card_refusals_come_before_any_launch(fresh_config, monkeypatch):
    """A card runner under ``scatter`` refuses at construction, and the
    digest plane under ``xla`` before staging: neither reaches the
    device check (no card here) nor a kernel."""
    from anomod_torch import device as device_mod
    from anomod_torch.serve import batcher
    monkeypatch.setattr(batcher, "resolve_device", lambda d=None: CUDA)
    fresh_config.setenv("ANOMOD_SERVE_LANE_ENGINE", "scatter")
    tconfig.set_config(None)
    with pytest.raises(ValueError, match="'scatter' names a JAX"):
        batcher.BucketRunner(replay.ReplayConfig(n_services=2))
    fresh_config.setenv("ANOMOD_TDIGEST_ENGINE", "XLA")
    tconfig.set_config(None)
    monkeypatch.setattr(replay, "resolve_device", lambda d=None: CUDA)
    monkeypatch.setattr(replay, "tdigest_by_segment",
                        lambda *a, **k: pytest.fail("launched"))
    with pytest.raises(ValueError, match="'xla' names a JAX"):
        replay._digests_from_staged({}, None, 64, "cuda")
    assert device_mod.resolve_device("cpu") == CPU


@pytest.fixture(scope="module")
def tt_batches():
    """The JAX replay tests' corpus, 13 TT labels x 40 traces, from both
    packages' generators."""
    tl = labels.labels_for_testbed("TT")
    jl = jlabels.labels_for_testbed("TT")
    return (concat_span_batches([synth.generate_spans(l, n_traces=40)
                                 for l in tl]),
            jconcat([jsynth.generate_spans(l, n_traces=40) for l in jl]))


@pytest.fixture(scope="module")
def jax_host_percentiles(tt_batches):
    _, jbatch = tt_batches
    cfg = JReplayConfig(n_services=jbatch.n_services)
    return j_percentiles(jbatch, cfg, qs=(0.5, 0.99), engine="host")


@pytest.mark.parametrize("engine", ["auto", "AUTO", "host", "xla",
                                    "pallas"])
def test_percentiles_under_each_engine_equal_jax_host(
        engine, tt_batches, jax_host_percentiles, fresh_config):
    batch, _ = tt_batches
    cfg = replay.ReplayConfig(n_services=batch.n_services)
    fresh_config.setenv("ANOMOD_TDIGEST_ENGINE", engine)
    tconfig.set_config(None)
    got = replay.replay_percentiles(batch, cfg, qs=(0.5, 0.99),
                                    device="cpu")
    np.testing.assert_allclose(got, jax_host_percentiles, rtol=2e-3,
                               atol=1e-2)


def test_percentiles_env_knob_on_the_cpu(tt_batches, fresh_config):
    batch, _ = tt_batches
    cfg = replay.ReplayConfig(n_services=batch.n_services)
    fresh_config.delenv("ANOMOD_TDIGEST_ENGINE", raising=False)
    tconfig.set_config(None)
    unset = replay.replay_percentiles(batch, cfg, device="cpu")
    for val in ("AUTO", "HOST", "pallas", "xla"):
        fresh_config.setenv("ANOMOD_TDIGEST_ENGINE", val)
        tconfig.set_config(None)
        np.testing.assert_array_equal(
            replay.replay_percentiles(batch, cfg, device="cpu"), unset)
    fresh_config.setenv("ANOMOD_TDIGEST_ENGINE", "exact")
    tconfig.set_config(None)
    with pytest.raises(ValueError, match="unknown t-digest engine 'exact'"):
        replay.replay_percentiles(batch, cfg, device="cpu")


SERVE_KW = dict(n_tenants=4, n_services=4, capacity_spans_per_s=800,
                overload=2.0, duration_s=16, tick_s=1.0, seed=5,
                window_s=2.0, baseline_windows=2, fault_tenants=1,
                buckets=(64, 256), lane_buckets=(1, 2, 4), max_backlog=800,
                n_windows=8, flight=False, device="cpu")


def _fingerprint(eng):
    """Per tenant: its alert stream and its replay state's bytes."""
    return {tid: ([dataclasses.asdict(a) for a in eng.alerts_for(tid)],
                  np.asarray(eng._tenant_replay[tid].state.agg).tobytes(),
                  np.asarray(eng._tenant_replay[tid].state.hist).tobytes())
            for tid in sorted(eng._tenant_replay)}


def test_serve_run_under_each_lane_value_equals_the_unset_run(
        fresh_config):
    fresh_config.delenv("ANOMOD_SERVE_LANE_ENGINE", raising=False)
    tconfig.set_config(None)
    eng, _ = run_power_law(**SERVE_KW)
    want = _fingerprint(eng)
    assert any(alerts for alerts, _, _ in want.values())
    for v in LANE_VALUES + ("PALLAS",):
        fresh_config.setenv("ANOMOD_SERVE_LANE_ENGINE", v)
        tconfig.set_config(None)
        eng, _ = run_power_law(**SERVE_KW)
        assert _fingerprint(eng) == want, v

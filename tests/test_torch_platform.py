"""The port's device decisions (``anomod_torch.utils.platform``, the
failover of ``rca`` and ``quality``, the CLI's probe and
``ANOMOD_PLATFORM``) against ``anomod/utils/platform.py``,
``anomod/rca.py`` and ``anomod/quality.py``, on the CPU.

Each of ``tests/test_platform.py``'s cases is restated in the port's
terms: the JAX package repoints the process to the CPU on its own, the
port retries on the CPU only when the caller passed ``allow`` (the
``--cpu-failover`` flag), on a CUDA device, for an error that reads as
loss of the card, once.  The stubs are handed ``torch.device("cuda")``
and never touch CUDA.  The probe's subprocess runs a stub program, so no
process here imports torch.
"""

import json
import os
import time

import pytest
import torch

from anomod.utils import platform as jplatform
from anomod_torch.utils import platform

CUDA = torch.device("cuda")
CPU = torch.device("cpu")

#: the CUDA runtime's words for errors that read as loss of the card, and
#: NCCL's for a peer that went away
LOSS = ("CUDA error: CUDA-capable device(s) is/are busy or unavailable",
        "CUDA error: no CUDA-capable device is detected",
        "CUDA error: uncorrectable ECC error encountered",
        "NCCL error: remote process exited or there was a network error")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flaky(msg=LOSS[2], fail_on=("cuda",)):
    """A unit of work that dies with ``msg`` on its first call when it is
    handed a device of a type in ``fail_on``; records every device."""
    seen = []

    def fn(dev):
        seen.append(dev)
        if len(seen) == 1 and dev.type in fail_on:
            raise RuntimeError(msg)
        return ("ok", dev.type)
    return fn, seen


# -- env_number ----------------------------------------------------------------

@pytest.mark.parametrize("raw", ["abc", "", " 7 ", "2.5"])
def test_env_number_equals_jax(raw, monkeypatch, capsys):
    monkeypatch.setenv("ANOMOD_CPU_DEVICES", raw)
    got = platform.env_number("ANOMOD_CPU_DEVICES", 1)
    got_err = capsys.readouterr().err
    want = jplatform.env_number("ANOMOD_CPU_DEVICES", 1)
    assert (got, got_err) == (want, capsys.readouterr().err)
    if raw in ("abc", "2.5"):
        assert "ignoring non-numeric ANOMOD_CPU_DEVICES" in got_err


# -- with_cpu_failover ---------------------------------------------------------

def test_with_cpu_failover_passthrough():
    assert platform.with_cpu_failover(lambda d: (42, d), CUDA) == (42, CUDA)
    assert platform.with_cpu_failover(lambda d: d, None) == CUDA


@pytest.mark.parametrize("msg", LOSS)
def test_with_cpu_failover_retries_on_cuda_only_when_allowed(msg):
    assert platform.is_backend_loss(RuntimeError(msg))
    fn, seen = _flaky(msg)
    notes = []
    out = platform.with_cpu_failover(fn, CUDA, allow=True,
                                     on_failover=notes.append)
    assert out == ("ok", "cpu") and seen == [CUDA, CPU]
    assert len(notes) == 1 and str(notes[0]) == msg


def test_with_cpu_failover_reraises_on_cpu():
    fn, seen = _flaky(fail_on=("cpu",))
    with pytest.raises(RuntimeError, match="ECC"):
        platform.with_cpu_failover(fn, CPU, allow=True,
                                   on_failover=lambda e: pytest.fail(
                                       "no failover from the CPU"))
    assert seen == [CPU]


def _build_error():
    """The kernel build's own error when no toolkit is there (or a stub
    of its ``nvcc failed`` when one is)."""
    from anomod_torch.ops import _build
    try:
        _build.nvcc()
    except RuntimeError as e:
        return e
    return RuntimeError("nvcc failed for replay: ptxas error")


DETERMINISTIC = [
    lambda: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 1.00 TiB"),
    lambda: RuntimeError("CUDA error: an illegal memory access was "
                         "encountered"),
    lambda: RuntimeError("anomod_replay_dense: CUDA error 700 (an illegal "
                         "memory access was encountered)"),
    lambda: RuntimeError("CUDA error: device-side assert triggered"),
    lambda: RuntimeError("CUDA error: misaligned address"),
    lambda: RuntimeError("CUDA error: invalid configuration argument"),
    _build_error,
    lambda: RuntimeError("a real bug, not a lost card"),
]


@pytest.mark.parametrize("make", DETERMINISTIC)
def test_with_cpu_failover_ignores_deterministic_device_errors(make):
    """Out of memory, an illegal address, a device-side assert, a bad
    launch and a kernel build error propagate, even with the failover
    asked for: retrying a bug on the host buries it."""
    err = make()
    assert not platform.is_backend_loss(err)
    calls = []

    def fn(dev):
        calls.append(dev)
        raise err
    with pytest.raises(RuntimeError) as e:
        platform.with_cpu_failover(fn, CUDA, allow=True)
    assert e.value is err and calls == [CUDA]


def test_with_cpu_failover_single_shot():
    calls = []

    def always(dev):
        calls.append(dev)
        raise RuntimeError(LOSS[0] + f" (attempt {len(calls)})")
    with pytest.raises(RuntimeError, match="attempt 2"):
        platform.with_cpu_failover(always, CUDA, allow=True)
    assert calls == [CUDA, CPU]


def test_with_cpu_failover_without_allow_reraises_the_original():
    err = RuntimeError(LOSS[2])
    calls = []

    def fn(dev):
        calls.append(dev)
        raise err
    with pytest.raises(RuntimeError) as e:
        platform.with_cpu_failover(fn, CUDA)
    assert e.value is err and calls == [CUDA]


# -- the probe -----------------------------------------------------------------

def test_ensure_live_backend_skip_env(monkeypatch):
    monkeypatch.setenv("ANOMOD_SKIP_PROBE", "1")
    monkeypatch.setattr(platform, "probe_device_platform",
                        lambda *a, **k: pytest.fail("probe must be skipped"))
    assert "skipped" in platform.ensure_live_backend()


@pytest.mark.parametrize("verdict, words", [
    (("", "backend init probe timed out after 45s"), "timed out after 45s"),
    (("cpu", "probe ok"), "the probe answered 'cpu'"),
])
def test_ensure_live_backend_raises_on_dead_probe(verdict, words,
                                                  monkeypatch):
    """A dead or missing card raises with the diagnostic and the way to
    ask for the host; nothing is pinned (the port has no pin)."""
    monkeypatch.delenv("ANOMOD_SKIP_PROBE", raising=False)
    monkeypatch.setenv("ANOMOD_PROBE_DEADLINE", "3")
    asked = []

    def probe(attempts=None):
        asked.append(attempts)
        return verdict
    monkeypatch.setattr(platform, "probe_device_platform", probe)
    with pytest.raises(RuntimeError) as e:
        platform.ensure_live_backend()
    msg = str(e.value)
    assert words in msg and "--device cpu" in msg \
        and "ANOMOD_PLATFORM=cpu" in msg and "no CUDA device" in msg
    assert asked == [(3.0,)]
    assert not hasattr(platform, "pin_cpu")
    monkeypatch.setattr(platform, "probe_device_platform",
                        lambda *a, **k: ("cuda", "probe ok"))
    assert platform.ensure_live_backend() == "probe ok: cuda"


def test_probe_deadline_and_answer(monkeypatch):
    """The probe's subprocess under its deadline: an answer is the
    platform, a hang is "" with the timeout named (stub programs)."""
    monkeypatch.setattr(platform, "_PROBE_PROGRAM", "print('cpu')")
    assert platform.probe_device_platform((30.0,)) == ("cpu", "probe ok")
    monkeypatch.setattr(platform, "_PROBE_PROGRAM",
                        "import time; time.sleep(30)")
    t0 = time.perf_counter()
    plat, diag = platform.probe_device_platform((0.5,))
    assert (plat, diag) == ("", "backend init probe timed out after 0s")
    assert time.perf_counter() - t0 < 20
    monkeypatch.setattr(platform, "_PROBE_PROGRAM",
                        "import sys; sys.exit('the card is gone')")
    assert platform.probe_device_platform((30.0,)) == ("", "the card is gone")


def _pending_probe(monkeypatch, verdict):
    """Start the background probe on a stub that answers ``verdict``."""
    monkeypatch.delenv("ANOMOD_SKIP_PROBE", raising=False)

    def probe(attempts=None):
        return verdict
    monkeypatch.setattr(platform, "probe_device_platform", probe)
    platform.start_probe()


def test_background_probe_joins_with_its_answer(monkeypatch):
    """``start_probe`` runs ``ensure_live_backend`` in a thread;
    ``await_probe`` gives its note once, or raises its error (``quiet``:
    only waits)."""
    assert platform.await_probe() is None
    _pending_probe(monkeypatch, ("cuda", "probe ok"))
    platform.start_probe()          # one pending probe at a time
    assert platform.await_probe() == "probe ok: cuda"
    assert platform.await_probe() is None
    _pending_probe(monkeypatch, ("", "backend init probe timed out after 75s"))
    with pytest.raises(RuntimeError, match="timed out after 75s"):
        platform.await_probe()
    _pending_probe(monkeypatch, ("cpu", "probe ok"))
    assert platform.await_probe(quiet=True) is None
    assert platform._PENDING is None


def test_resolve_device_joins_the_probe_before_the_card(monkeypatch):
    """A pending probe is joined when the card is resolved, so a dead card
    raises its diagnostic; a host device leaves it pending."""
    from anomod_torch.device import resolve_device
    _pending_probe(monkeypatch, ("", "the card is gone"))
    assert resolve_device("cpu") == CPU
    assert platform._PENDING is not None
    with pytest.raises(RuntimeError, match="the card is gone"):
        resolve_device(None)
    assert platform._PENDING is None


# -- rca -------------------------------------------------------------------------

def test_checkpoint_mtime_distinguishes_fresh_from_stale(tmp_path):
    from anomod_torch.utils.checkpoint import (checkpoint_mtime,
                                               save_train_state)
    assert checkpoint_mtime(tmp_path / "nope") is None
    ck = tmp_path / "ck"
    save_train_state(ck, {"w": torch.ones(2)}, {"m": torch.zeros(2)}, step=5)
    m = checkpoint_mtime(ck)
    assert m is not None and m >= time.time() - 60
    past = time.time() - 3600
    os.utime(ck / "meta.json", (past, past))
    m_stale = checkpoint_mtime(ck)
    assert m_stale is not None and m_stale < time.time() - 3000


def _fake_results(name="gcn"):
    from anomod.rca import TrainResult as JResult
    from anomod_torch.rca import TrainResult
    return (JResult(model_name=name, top1=1.0, top3=1.0, detection_auc=1.0,
                    n_eval=4, params={}),
            TrainResult(model_name=name, top1=1.0, top3=1.0,
                        detection_auc=1.0, n_eval=4, params={}))


def _jax_flaky_rca(monkeypatch, ck, save_first):
    """The JAX wrapper over a stub that dies once (after a save of its
    own when ``save_first``); returns (resume flags, note)."""
    import jax.numpy as jnp

    from anomod import rca as jrca
    from anomod.utils.checkpoint import save_train_state
    monkeypatch.setattr(jplatform, "pin_cpu", lambda n=1: None)
    monkeypatch.setattr(jplatform, "_current_platform", lambda: "tpu")
    seen = []

    def flaky(*a, resume=False, checkpoint_dir=None, **k):
        seen.append(resume)
        if len(seen) == 1:
            if save_first:
                save_train_state(ck, {"w": jnp.ones(2)}, {"m": jnp.zeros(2)},
                                 step=50)
            raise RuntimeError("UNAVAILABLE: the device died")
        return _fake_results()[0]
    monkeypatch.setattr(jrca, "train_rca", flaky)
    _, note = jrca.train_rca_resilient("TT", "gcn", resume=False,
                                       checkpoint_dir=ck)
    return seen, note


def _port_flaky_rca(monkeypatch, ck, save_first, failover=True):
    from anomod_torch import rca
    from anomod_torch.utils.checkpoint import save_train_state
    seen = []

    def flaky(*a, resume=False, checkpoint_dir=None, device=None, **k):
        seen.append((resume, device))
        if len(seen) == 1:
            if save_first:
                save_train_state(ck, {"w": torch.ones(2)},
                                 {"m": torch.zeros(2)}, step=50)
            raise RuntimeError(LOSS[2])
        return _fake_results()[1]
    monkeypatch.setattr(rca, "train_rca", flaky)
    result, note = rca.train_rca_resilient(
        "TT", "gcn", resume=False, checkpoint_dir=ck, failover=failover,
        device=CUDA)
    return seen, result, note


def test_rca_resilient_does_not_resume_stale_checkpoint(monkeypatch,
                                                        tmp_path):
    """A checkpoint left by an earlier run is not resumed: the retry on
    the CPU trains from scratch, and the note says so in the JAX
    wrapper's words."""
    import jax.numpy as jnp

    from anomod.utils.checkpoint import save_train_state as jsave
    from anomod_torch.utils.checkpoint import save_train_state
    jck, ck = tmp_path / "jck", tmp_path / "ck"
    jsave(jck, {"w": jnp.ones(2)}, {"m": jnp.zeros(2)}, step=300)
    save_train_state(ck, {"w": torch.ones(2)}, {"m": torch.zeros(2)},
                     step=300)
    past = time.time() - 3600
    for d in (jck, ck):
        os.utime(d / "meta.json", (past, past))
    jseen, jnote = _jax_flaky_rca(monkeypatch, jck, save_first=False)
    seen, result, note = _port_flaky_rca(monkeypatch, ck, save_first=False)
    assert jseen == [False, False]
    assert seen == [(False, CUDA), (False, CPU)]
    assert result.top1 == 1.0 and "from scratch" in note
    assert note == jnote


def test_rca_resilient_resumes_own_checkpoint(monkeypatch, tmp_path):
    jseen, jnote = _jax_flaky_rca(monkeypatch, tmp_path / "jck",
                                  save_first=True)
    seen, _, note = _port_flaky_rca(monkeypatch, tmp_path / "ck",
                                    save_first=True)
    assert jseen == [False, True]
    assert seen == [(False, CUDA), (True, CPU)]
    assert "last checkpoint" in note and note == jnote


def test_rca_resilient_without_failover_raises(monkeypatch, tmp_path):
    with pytest.raises(RuntimeError, match="ECC"):
        _port_flaky_rca(monkeypatch, tmp_path / "ck", save_first=True,
                        failover=False)


def test_rca_resilient_clean_run_has_no_note(monkeypatch):
    from anomod_torch import rca
    monkeypatch.setattr(rca, "train_rca",
                        lambda *a, device=None, **k: _fake_results()[1])
    result, note = rca.train_rca_resilient("SN", "gcn", failover=True,
                                           device="cpu")
    assert note is None and result.top1 == 1.0


# -- quality ---------------------------------------------------------------------

SWEEP = dict(model_names=("gcn", "zscore"), severities=(1.0,),
             train_seeds=range(3), eval_seeds=(100,), n_traces=8, epochs=2)


def _cells(points):
    return [(p.model, p.severity, p.top1, p.top3, p.detection_auc, p.n_eval)
            for p in points]


def _jax_failover_note(monkeypatch):
    """The JAX sweep's LAST_FAILOVER after a backend loss at ``gcn``
    (the retry is stopped once the note is written)."""
    from anomod import quality as jquality

    class Stop(Exception):
        pass
    monkeypatch.setattr(jplatform, "pin_cpu", lambda n=1: None)
    monkeypatch.setattr(jplatform, "_current_platform", lambda: "tpu")
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("UNAVAILABLE: the device died")
        raise Stop
    monkeypatch.setattr(jquality, "_train_model", flaky)
    with pytest.raises(Stop):
        jquality.severity_sweep(testbed="SN", **SWEEP)
    return jquality.LAST_FAILOVER


@pytest.fixture
def sweep_on_lost_card(monkeypatch):
    """The port's sweep told it runs on the card, whose first learned row
    loses it: ``resolve_device`` takes the name as given, and
    ``_train_model`` dies with a loss on ``cuda`` before touching it."""
    from anomod_torch import quality
    monkeypatch.setattr(quality, "resolve_device",
                        lambda d=None: torch.device(d or "cuda"))
    orig = quality._train_model
    devices = []

    def flaky(*a, device=None, **k):
        devices.append(torch.device(device).type)
        if devices[-1] == "cuda":
            raise RuntimeError(LOSS[2])
        return orig(*a, device=device, **k)
    monkeypatch.setattr(quality, "_train_model", flaky)
    return quality, devices


def test_quality_sweep_failover_equals_the_clean_cpu_sweep(
        sweep_on_lost_card, monkeypatch, capsys):
    """The lost row is redone on the CPU and the row after it (zscore)
    runs there too: the cells equal the clean CPU sweep's, and
    LAST_FAILOVER is the JAX package's note."""
    quality, devices = sweep_on_lost_card
    want = _cells(quality.severity_sweep(testbed="SN", device="cpu",
                                         **SWEEP))
    assert quality.LAST_FAILOVER is None
    devices.clear()
    got = quality.severity_sweep(testbed="SN", device="cuda", failover=True,
                                 **SWEEP)
    assert _cells(got) == want and devices == ["cuda", "cpu"]
    assert quality.LAST_FAILOVER == _jax_failover_note(monkeypatch)
    assert "'gcn'" in quality.LAST_FAILOVER
    assert quality.LAST_FAILOVER in capsys.readouterr().err
    # a clean follow-up sweep resets the note
    quality.severity_sweep(testbed="SN", model_names=("zscore",),
                           severities=(1.0,), eval_seeds=(100,), n_traces=8,
                           device="cpu")
    assert quality.LAST_FAILOVER is None


def test_quality_sweep_without_the_flag_propagates(sweep_on_lost_card):
    quality, devices = sweep_on_lost_card
    with pytest.raises(RuntimeError, match="ECC"):
        quality.shift_sweep(testbed="SN", device="cuda",
                            shifts=("in-dist",), **{
                                k: v for k, v in SWEEP.items()
                                if k != "severities"})
    assert devices == ["cuda"] and quality.LAST_FAILOVER is None


# -- the CLI ---------------------------------------------------------------------

@pytest.fixture
def no_probe(monkeypatch):
    """The probe must not run: a call fails the test."""
    monkeypatch.delenv("ANOMOD_SKIP_PROBE", raising=False)
    monkeypatch.delenv("ANOMOD_PLATFORM", raising=False)
    monkeypatch.setattr(platform, "probe_device_platform",
                        lambda *a, **k: pytest.fail("the probe ran"))


def test_cli_platform_cpu_runs_detect_on_the_host(no_probe, monkeypatch,
                                                  capsys):
    from anomod_torch.cli import main
    monkeypatch.setenv("ANOMOD_PLATFORM", "CPU ")
    assert main(["detect", "--testbed", "SN", "--traces", "5"]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out)["backend"] == "cpu"
    assert "ANOMOD_PLATFORM=cpu" in out.err
    # an explicit --device is the caller's: no note
    assert main(["detect", "--testbed", "SN", "--traces", "5",
                 "--device", "cpu"]) == 0
    assert "ANOMOD_PLATFORM" not in capsys.readouterr().err


def test_cli_device_cpu_never_probes(no_probe, capsys):
    from anomod_torch.cli import main
    assert main(["detect", "--testbed", "SN", "--traces", "5",
                 "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["backend"] == "cpu"


def test_cli_dead_probe_exits_with_the_diagnostic(monkeypatch):
    from anomod_torch.cli import main
    monkeypatch.delenv("ANOMOD_SKIP_PROBE", raising=False)
    monkeypatch.delenv("ANOMOD_PLATFORM", raising=False)
    monkeypatch.setattr(platform, "probe_device_platform",
                        lambda *a, **k: ("", "backend init probe timed "
                                             "out after 75s"))
    for argv in (["detect", "--testbed", "SN", "--traces", "5"],
                 ["rca", "--cpu-failover", "--epochs", "1", "--testbed",
                  "SN", "--train-seeds", "1", "--eval-seeds", "1"],
                 ["quality", "--models", "zscore"]):
        with pytest.raises(RuntimeError, match="timed out after 75s"):
            main(argv)
        assert platform._PENDING is None


def test_cli_probe_runs_beside_the_host_work(monkeypatch):
    """The CLI's probe is started before the subcommand's host work and
    joined before the card: the stub probe answers only once the host
    dataset is being built (a probe run first, alone, would time out)."""
    import threading

    from anomod_torch import rca
    from anomod_torch.cli import main
    monkeypatch.delenv("ANOMOD_PLATFORM", raising=False)
    gate = threading.Event()
    real = rca.prepare_data

    def prepare(*a, **k):
        gate.set()
        return real(*a, **k)
    monkeypatch.setattr(rca, "prepare_data", prepare)
    monkeypatch.delenv("ANOMOD_SKIP_PROBE", raising=False)

    def probe(attempts=None):
        assert gate.wait(30), "nothing ran beside the probe"
        return "", "the card is gone"
    monkeypatch.setattr(platform, "probe_device_platform", probe)
    with pytest.raises(RuntimeError, match="the card is gone"):
        main(["rca", "--testbed", "SN", "--train-seeds", "1",
              "--eval-seeds", "1", "--epochs", "1"])
    assert gate.is_set() and platform._PENDING is None


def test_cli_rca_cpu_failover_note(no_probe, monkeypatch, capsys):
    """``rca --cpu-failover`` asks the wrapper for the failover and adds
    ``device_failover`` (and the stderr note) only when it ran."""
    from anomod_torch import rca
    from anomod_torch.cli import main
    asked = []
    for note in (None, "device backend lost mid-train (RuntimeError); "
                       "retried on the CPU failover backend from scratch"):
        def resilient(*a, failover=False, device=None, _note=note, **k):
            asked.append((failover, device))
            return _fake_results()[1], _note
        monkeypatch.setattr(rca, "train_rca_resilient", resilient)
        assert main(["rca", "--testbed", "SN", "--device", "cpu",
                     "--cpu-failover"]) == 0
        out = capsys.readouterr()
        doc = json.loads(out.out)
        assert doc.get("device_failover") == note
        assert ("device_failover" in doc) == (note is not None)
        assert ("device backend lost" in out.err) == (note is not None)
    assert main(["rca", "--testbed", "SN", "--device", "cpu"]) == 0
    assert asked == [(True, "cpu"), (True, "cpu"), (False, "cpu")]


def test_cli_quality_cpu_failover_labels_the_capture(no_probe, monkeypatch,
                                                     tmp_path, capsys):
    from anomod_torch import quality
    from anomod_torch.cli import main
    monkeypatch.setenv("ANOMOD_BENCH_RUNS_DIR", str(tmp_path))
    note = ("device backend lost mid-sweep at model 'gcn' (RuntimeError); "
            "remaining rows completed on the CPU failover backend")
    asked = []

    def sweep(*a, failover=False, **k):
        asked.append(failover)
        quality.LAST_FAILOVER = note if failover else None
        return [quality.QualityPoint("gcn", 1.0, 0.5, 2, 1.0, 1.0, 1.0, 4)]
    monkeypatch.setattr(quality, "severity_sweep", sweep)
    for flag in (["--cpu-failover"], []):
        assert main(["quality", "--device", "cpu", "--models", "gcn",
                     "--json"] + flag) == 0
        path = capsys.readouterr().err.split("capture: ")[-1].strip()
        rec = json.loads(open(path).read())
        assert rec.get("device_failover") == (note if flag else None)
    assert asked == [True, False]
    quality.LAST_FAILOVER = None


def test_cli_cpu_devices_bounds_the_host_mesh_as_jax(no_probe, monkeypatch,
                                                     capsys):
    """Under ``ANOMOD_PLATFORM=cpu``, ``ANOMOD_CPU_DEVICES`` is the count
    of attached devices ``--devices`` may span, on both packages: the
    JAX CLI pins that many virtual CPU devices (its mesh here is the
    suite's 8), the port bounds its gloo ranks by it, in the same
    words."""
    from anomod.cli import main as jmain
    from anomod_torch.cli import main
    pins = []
    monkeypatch.setattr(jplatform, "pin_cpu", lambda n=1: pins.append(n))
    monkeypatch.setenv("ANOMOD_PLATFORM", "cpu")
    monkeypatch.setenv("ANOMOD_CPU_DEVICES", "8")
    with pytest.raises(ValueError) as e:
        jmain(["replay", "--devices", "9", "--traces", "2"])
    assert pins == [8]
    with pytest.raises(SystemExit) as x:
        main(["replay", "--devices", "9", "--traces", "2"])
    assert x.value.code == 2 and str(e.value) in capsys.readouterr().err
    monkeypatch.setenv("ANOMOD_CPU_DEVICES", "lots")
    with pytest.raises(SystemExit):
        main(["stream", "--all", "--devices", "2"])
    err = capsys.readouterr().err
    assert "requested a 2-device mesh but 1 device(s) are attached" in err
    assert "ignoring non-numeric ANOMOD_CPU_DEVICES='lots'" in err

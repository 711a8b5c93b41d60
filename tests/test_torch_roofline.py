"""The roofline probe's ablation kernels, the port's capture provenance and
the ``stream --all`` summary, against the JAX package.

The TPU ablation has no importable function (``make_ablation`` is a
closure inside ``scripts/bench_kernel_roofline.py``'s ``main``, which
refuses to run without a TPU), so :func:`tpu_ablation` restates its lines
73-121 verbatim and runs them with ``interpret=True``.  On the CPU the
port's wrapper takes its plain version (``index_add_`` over the same
bf16-rounded payload).  Tolerance: count and exact rows are small-integer
f32 sums and must be EQUAL; the moment hi and lo rows are f32 sums taken
in another order and agree to ``rtol=1e-5, atol=1e-3``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from anomod.ops.pallas_replay import N_PLANES, make_pallas_replay_sorted_fn
from anomod_torch import provenance
from anomod_torch.ops import replay_kernels as rk
from anomod_torch.roofline import kernel_roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 16
SW, K, BLOCK = 300, 128, 512


def tpu_ablation(rows_mode, t, k, block, replicate):
    """``scripts/bench_kernel_roofline.py:73-121``, verbatim but for
    ``interpret=True``: the ablated sorted kernel, raw ``[ROWS, NWK]``."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    nw = (SW + 1 + k - 1) // k

    def make_ablation(rows_mode: str):
        """Ablated sorted kernels sharing grid/staging with the real one.
        rows_mode: "counts" (1-row rhs) or "no_hist" (9-row rhs)."""
        ROWS = 1 if rows_mode == "counts" else 9
        NWK = nw * k

        def kernel(wids_ref, sid_ref, planes_ref, out_ref):
            @pl.when((pl.program_id(0) == 0) & (pl.program_id(1) == 0))
            def _init():
                out_ref[:] = jnp.zeros_like(out_ref)
            sid = sid_ref[:]
            planes = planes_ref[:]
            if rows_mode == "counts":
                rhs_t = planes[0:1].astype(jnp.bfloat16)
            else:
                moments = planes[3:6]
                hi = moments.astype(jnp.bfloat16)
                lo = (moments - hi.astype(jnp.float32)).astype(jnp.bfloat16)
                rhs_t = jnp.concatenate(
                    [planes[0:3].astype(jnp.bfloat16), hi, lo], axis=0)
            seg_iota = jax.lax.broadcasted_iota(jnp.int32, (block, k), 1)
            onehot = (seg_iota == sid[:, None]).astype(jnp.bfloat16)
            partial = jax.lax.dot_general(
                rhs_t, onehot, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            col = wids_ref[pl.program_id(1)] * k
            out_ref[:, pl.ds(col, k)] += partial

        @jax.jit
        def run(sid_local, planes, wids):
            return pl.pallas_call(
                kernel,
                grid_spec=pltpu.PrefetchScalarGridSpec(
                    num_scalar_prefetch=1,
                    grid=(replicate, t // block),
                    in_specs=[
                        pl.BlockSpec((block,), lambda r, i, w: (i,)),
                        pl.BlockSpec((N_PLANES, block),
                                     lambda r, i, w: (0, i)),
                    ],
                    out_specs=pl.BlockSpec((ROWS, NWK),
                                           lambda r, i, w: (0, 0)),
                ),
                out_shape=jax.ShapeDtypeStruct((ROWS, NWK), jnp.float32),
                compiler_params=pltpu.CompilerParams(
                    dimension_semantics=("arbitrary", "arbitrary")),
                interpret=True,
            )(wids, sid_local, planes)

        return run

    return make_ablation(rows_mode)


def _staged(n=3000, seed=3):
    """Sorted staging of numpy-seeded spans: ids with dead-lane rows
    (sid = SW, all-zero planes) and [6, n] planes."""
    rng = np.random.default_rng(seed)
    sid = rng.integers(0, SW, n).astype(np.int32)
    valid = (rng.random(n) < 0.9).astype(np.float32)
    dur_us = rng.lognormal(8.0, 1.0, n).astype(np.float32) * valid
    dur = np.log1p(dur_us)
    planes = np.stack([
        valid, ((rng.random(n) < 0.2) * valid).astype(np.float32),
        ((rng.random(n) < 0.1) * valid).astype(np.float32),
        dur_us, dur, dur * dur]).astype(np.float32)
    sid[valid == 0] = SW
    return rk.stage_sorted_planes(sid, planes, SW, k=K, block=BLOCK)


def _port(staged, mode, reps):
    return rk.replay_sorted_ablation(
        *[torch.from_numpy(a) for a in staged], SW, mode, k=K, block=BLOCK,
        inner_repeats=reps).numpy()


def _assert_raw(got, want):
    """Count and exact rows equal; the moments' hi and lo rows close."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:3], want[:3])
    np.testing.assert_allclose(got[3:], want[3:], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("reps", [1, 2])
@pytest.mark.parametrize("mode", ["counts", "no_hist"])
def test_ablation_matches_tpu_ablation(mode, reps):
    staged = _staged()
    want = np.asarray(tpu_ablation(mode, staged[0].shape[0], K, BLOCK,
                                   reps)(*staged))
    got = _port(staged, mode, reps)
    nwk = rk.n_window_cols(SW, K)
    assert got.shape == (rk.ABLATION_ROWS[mode], nwk) == (want.shape[0], 384)
    _assert_raw(got, want)


@pytest.mark.parametrize("reps", [1, 2])
def test_ablation_matches_sorted_kernel(reps):
    """On the first SW columns the ablations equal the sorted replay
    kernel's count column, exact planes and recombined moments; the dead
    lane's column SW and the padding after it hold nothing (dead rows
    carry valid = 0)."""
    staged = _staged(seed=4)
    full = np.asarray(make_pallas_replay_sorted_fn(
        SW, H, k=K, block=BLOCK, interpret=True,
        inner_repeats=reps)(*staged))
    counts = _port(staged, "counts", reps)
    no_hist = _port(staged, "no_hist", reps)
    n_live = int((staged[1][0] != 0).sum())
    assert float(counts.astype(np.float64).sum()) == n_live * reps
    np.testing.assert_array_equal(counts[0, :SW], full[:, 0])
    assert (counts[:, SW:] == 0).all() and (no_hist[:, SW:] == 0).all()
    np.testing.assert_array_equal(no_hist[:3, :SW].T, full[:, :3])
    np.testing.assert_allclose(no_hist[3:6, :SW].T + no_hist[6:9, :SW].T,
                               full[:, 3:6], rtol=1e-5, atol=1e-3)


def test_ablation_errors_and_empty_input():
    staged = [torch.from_numpy(a) for a in _staged(n=500, seed=5)]
    with pytest.raises(ValueError, match="unknown ablation"):
        rk.replay_sorted_ablation(*staged, SW, "hist_only", k=K, block=BLOCK)
    with pytest.raises(TypeError):
        rk.replay_sorted_ablation(staged[0].long(), *staged[1:], SW,
                                  "counts", k=K, block=BLOCK)
    with pytest.raises(ValueError, match="multiple"):
        rk.replay_sorted_ablation(*staged, SW, "counts", k=K, block=1000)
    with pytest.raises(ValueError, match="wids must have shape"):
        rk.replay_sorted_ablation(*staged, SW, "counts", k=K, block=256)
    with pytest.raises(ValueError):
        rk.replay_sorted_ablation(staged[0], staged[1][:5], staged[2], SW,
                                  "no_hist", k=K, block=BLOCK)
    with pytest.raises(ValueError):
        rk.replay_sorted_ablation(*staged, SW, "counts", k=K, block=BLOCK,
                                  inner_repeats=0)
    z32 = torch.zeros(0, dtype=torch.int32)
    zp = torch.zeros((6, 0), dtype=torch.float32)
    for mode, rows in rk.ABLATION_ROWS.items():
        out = rk.replay_sorted_ablation(z32, zp, z32, 1440, mode)
        assert out.shape == (rows, 1536) and bool((out == 0).all())


def test_kernel_roofline_on_cpu_writes_its_record(tmp_path):
    v = kernel_roofline(device="cpu", n_traces=8, replicate=2, block=512,
                        outdir=str(tmp_path))
    assert set(v) == {"metric", "value", "unit", "rates",
                      "onehot_ceiling_ratio",
                      "within_2x_of_formulation_ceiling", "params",
                      "capture_file"}
    assert set(v["rates"]) == {"full", "onehot_only", "no_hist"}
    assert all(r > 0 for r in v["rates"].values())
    assert v["value"] == v["rates"]["full"]
    assert v["params"]["device"] == "cpu" and v["params"]["replicate"] == 2
    name = os.path.basename(v["capture_file"])
    assert name.endswith("_replay_kernel_roofline_cpu.json")
    assert name[:8].isdigit() and name[8] == "T"
    rec = json.loads(open(v["capture_file"]).read())
    assert rec["device"] == "cpu" and rec["rates"] == v["rates"]
    assert rec["torch_version"] == torch.__version__
    assert "cuda_version" in rec and "jax_version" not in rec
    assert len(rec["git_sha"].split("-")[0]) == 40


def test_cli_roofline_prints_one_json_line(tmp_path):
    env = dict(os.environ, ANOMOD_BENCH_RUNS_DIR=str(tmp_path))
    r = subprocess.run(
        [sys.executable, "-m", "anomod_torch", "roofline", "--device", "cpu",
         "--traces", "4", "--replicate", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "replay_kernel_roofline"
    assert os.path.dirname(out["capture_file"]) == str(tmp_path)


# -- provenance: the cases of tests/test_provenance.py, against the port --

def test_capture_record_is_self_describing():
    rec = provenance.capture_record("m", 1.5, "u", kernel="cuda",
                                    device="NVIDIA H100 80GB HBM3")
    assert rec["metric"] == "m" and rec["value"] == 1.5 and rec["unit"] == "u"
    assert rec["kernel"] == "cuda"
    assert rec["torch_version"] == torch.__version__
    assert rec["cuda_version"] == torch.version.cuda
    assert rec["timestamp_utc"].endswith("Z")
    assert len(rec["git_sha"].split("-")[0]) == 40


def test_write_capture_filename_and_collisions(tmp_path):
    rec = provenance.capture_record("tt_replay_throughput", 2.0, "u",
                                    device="TPU v5 lite0")
    paths = [provenance.write_capture(rec, outdir=str(tmp_path))
             for _ in range(3)]
    assert all(p is not None for p in paths)
    assert len(set(paths)) == 3
    assert all("_tpu" in p for p in paths)
    cpu = provenance.write_capture(
        provenance.capture_record("x", 1.0, "u", device="cpu"),
        outdir=str(tmp_path))
    assert cpu.endswith("_cpu.json")
    assert json.loads(open(paths[0]).read())["value"] == 2.0


def test_write_capture_gpu_class_and_env_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("ANOMOD_BENCH_RUNS_DIR", str(tmp_path / "runs"))
    for dev in ("NVIDIA H100 80GB HBM3", "cuda:0"):
        path = provenance.write_capture(
            provenance.capture_record("m", 1.0, "u", device=dev))
        assert path.startswith(str(tmp_path / "runs"))
        assert path.endswith("_m_gpu.json") or path.endswith("_m_gpu_1.json")
    assert provenance.device_class("some accelerator") == "dev"


def test_write_capture_never_raises(tmp_path):
    target = tmp_path / "not_a_dir"
    target.write_text("file blocks mkdir")
    rec = provenance.capture_record("m", 1.0, "u")
    assert provenance.write_capture(rec, outdir=str(target / "sub")) is None


def test_git_sha_dirty_only_for_tracked_changes(tmp_path):
    r = tmp_path / "repo"
    r.mkdir()
    subprocess.run(["git", "init", "-q"], cwd=r, check=True)
    (r / "a.txt").write_text("x")
    subprocess.run(["git", "add", "a.txt"], cwd=r, check=True)
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                    "commit", "-qm", "c"], cwd=r, check=True)
    clean = provenance.git_sha(cwd=str(r))
    assert clean and not clean.endswith("-dirty")
    (r / "untracked.json").write_text("{}")
    assert provenance.git_sha(cwd=str(r)) == clean
    (r / "a.txt").write_text("changed")
    assert provenance.git_sha(cwd=str(r)).endswith("-dirty")


def test_stream_all_summary_equals_jax(tmp_path, monkeypatch, capsys):
    """``stream --all --traces 20``: the port's summary line (run on the
    CPU in its own process) equals the JAX CLI's on the same corpus, and
    both write their ``stream_quality`` capture."""
    from anomod import cli as jcli
    env = dict(os.environ, ANOMOD_BENCH_RUNS_DIR=str(tmp_path / "port"))
    r = subprocess.run(
        [sys.executable, "-m", "anomod_torch", "stream", "--all", "--traces",
         "20", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    port = json.loads(r.stdout.strip().splitlines()[-1])["summary"]
    monkeypatch.setenv("ANOMOD_BENCH_RUNS_DIR", str(tmp_path / "jax"))
    assert jcli.main(["stream", "--all", "--traces", "20"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = want["summary"]
    for key in ("testbed", "n_experiments", "top1", "top3",
                "median_detection_latency_windows"):
        assert port[key] == want[key], key
    assert port["top3"] is not None
    caps = os.listdir(tmp_path / "port")
    assert len(caps) == 1 and caps[0].endswith("_stream_quality_cpu.json")
    rec = json.loads((tmp_path / "port" / caps[0]).read_text())
    assert rec["summary"] == port and len(rec["rows"]) == 13
    assert rec["params"] == {"n_traces": 20, "seed": 0, "multimodal": False,
                             "severity": 1.0, "noise": 0.0,
                             "confounders": 0, "shift": "in-dist"}
    assert len(os.listdir(tmp_path / "jax")) == 1

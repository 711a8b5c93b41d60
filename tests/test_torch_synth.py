"""The port's span generator and package boundary.

``anomod_torch.synth`` must produce byte-identical corpora to the JAX
package's generator (the two packages then replay the same spans), and
the port must load neither JAX nor any ``anomod`` module.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from anomod import labels as jlabels
from anomod import synth as jsynth
from anomod.schemas import concat_span_batches as jconcat
from anomod_torch import labels as tlabels
from anomod_torch import synth as tsynth
from anomod_torch.io.dataset import load_bench_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_batch(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f
        else:
            assert x == y, f


@pytest.mark.parametrize("name,seed", [
    ("Normal_case", None), ("Lv_D_TRANSACTION_timeout", 7),
    ("Normal_Baseline", 3), ("Svc_Kill_Media", None)])
def test_generate_spans_byte_identical(name, seed):
    a = jsynth.generate_spans(jlabels.label_for(name), n_traces=60,
                              seed=seed)
    b = tsynth.generate_spans(tlabels.label_for(name), n_traces=60,
                              seed=seed)
    assert b.n_spans > 0
    _assert_same_batch(a, b)


def test_generate_spans_hard_mode_byte_identical():
    kw = dict(severity=0.3, noise=0.5, fault_locus="edge",
              fault_profile="bursty")
    a = jsynth.generate_spans(jlabels.label_for("Lv_P_CPU_preserve"),
                              n_traces=40, hard=jsynth.HardMode(**kw))
    b = tsynth.generate_spans(tlabels.label_for("Lv_P_CPU_preserve"),
                              n_traces=40, hard=tsynth.HardMode(**kw))
    _assert_same_batch(a, b)


def test_label_tables_match():
    assert [tuple(vars(l).values()) for l in tlabels.ALL_LABELS] == \
        [tuple(vars(l).values()) for l in jlabels.ALL_LABELS]


def test_bench_corpus_matches_reference_concat():
    want = jconcat([jsynth.generate_spans(l, n_traces=8)
                    for l in jlabels.labels_for_testbed("TT")])
    _assert_same_batch(want, load_bench_corpus("TT", 8))


def test_port_imports_neither_jax_nor_anomod():
    code = (
        "import sys\n"
        "import anomod_torch, anomod_torch.stream, anomod_torch.cli\n"
        "import anomod_torch.ops.replay_kernels, anomod_torch.state\n"
        "import anomod_torch.io.dataset\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'anomod' "
        "or m.startswith('anomod.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

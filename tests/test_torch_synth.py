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
    """Every module of ``anomod_torch`` (walked with ``pkgutil``; its
    ``__main__`` only calls ``cli.main``) imports in a fresh process
    without loading jax or any ``anomod`` module, and
    no import statement of ``chip_smoke.py`` names either."""
    import ast
    code = (
        "import pkgutil, sys\n"
        "import anomod_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    anomod_torch.__path__, 'anomod_torch.')]\n"
        "for name in names:\n"
        "    if not name.endswith('.__main__'):   # runs the CLI\n"
        "        __import__(name)\n"
        "assert {'anomod_torch.provenance', 'anomod_torch.roofline',\n"
        "        'anomod_torch.serve.engine',\n"
        "        'anomod_torch.ops.sketch_kernels', 'anomod_torch.config',\n"
        "        'anomod_torch.metrics_catalog', 'anomod_torch.io.native',\n"
        "        'anomod_torch.io.cache', 'anomod_torch.io.dataset',\n"
        "        'anomod_torch.io.lfs', 'anomod_torch.io.tt_traces',\n"
        "        'anomod_torch.io.sn_traces', 'anomod_torch.io.metrics',\n"
        "        'anomod_torch.io.logs', 'anomod_torch.io.api',\n"
        "        'anomod_torch.io.coverage', 'anomod_torch.graph',\n"
        "        'anomod_torch.detect', 'anomod_torch.rca',\n"
        "        'anomod_torch.rca_features', 'anomod_torch.models.gnn',\n"
        "        'anomod_torch.utils.checkpoint'} <= set(names), names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'anomod' "
        "or m.startswith('anomod.') or m.split('.')[0] in ('flax', "
        "'optax', 'orbax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "anomod_torch" in roots
    assert not roots & {"jax", "jaxlib", "anomod", "flax", "optax"}, \
        sorted(roots)

    # no module of the port names either in an import statement (deferred
    # imports inside functions included), or loads the JAX package's
    # native library
    pkg = os.path.join(REPO, "anomod_torch")
    for dirpath, _, files in os.walk(pkg):
        for fname in files:
            if not fname.endswith((".py", ".cpp", ".cu")):
                continue
            with open(os.path.join(dirpath, fname)) as f:
                text = f.read()
            assert "libanomod_native" not in text, fname
            if not fname.endswith(".py"):
                continue
            roots = set()
            for node in ast.walk(ast.parse(text)):
                if isinstance(node, ast.Import):
                    roots |= {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.module:
                    roots.add(node.module.split(".")[0])
            assert not roots & {"jax", "jaxlib", "anomod", "flax", "optax",
                                "orbax"}, (fname, roots)

"""The port's RCA harness (``rca_features``, ``models/gnn``, ``rca``,
``utils/checkpoint``) against the JAX package's, on the CPU.

Tolerance: the dataset is host numpy in both packages and must be
byte-identical.  With the JAX package's flax parameters carried across
(``state.params_from_flax``), the forward pass agrees to ``rtol=1e-5,
atol=1e-6`` and the gradients of ``rca_loss`` to ``rtol=1e-4`` (atol
1e-6 of each leaf's largest gradient): both are f32 with the same
operations in another order.  Twenty AdamW steps against ``optax.adamw``
keep every loss within ``rtol=1e-4`` and the final scores within 1e-4 of
their scale (Adam's sign-like first steps carry last-bit differences into
every parameter, so a score near zero has no relative tolerance).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anomod import rca as jrca
from anomod.utils import checkpoint as jcheckpoint
from anomod_torch import rca as trca
from anomod_torch import rca_features as tfeat
from anomod_torch.state import params_from_flax, params_to_flax
from anomod_torch.utils.checkpoint import (checkpoint_mtime, has_checkpoint,
                                           restore_train_state,
                                           save_train_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs its files in parallel workers; one intra-op thread
    a worker keeps torch's CPU thread pools from oversubscribing the
    cores (the models here are small enough to gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sn_data():
    """SN, 2 seeds x 20 traces, from both packages, stacked and
    standardized on the JAX side."""
    js, services = jrca.build_dataset("SN", range(2), 20)
    ts, tservices = trca.build_dataset("SN", range(2), 20)
    train = jrca._stack(js)
    jrca.standardize_features(train, [])
    return js, ts, services, tservices, train


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_build_dataset_byte_identical_sn(sn_data):
    js, ts, services, tservices, _ = sn_data
    assert tservices == services and len(ts) == len(js) == 26
    for a, b in zip(js, ts):
        assert (b.experiment, b.target, b.is_anomaly) == \
            (a.experiment, a.target, a.is_anomaly)
        for f in ("x", "x_t", "adj", "edge_src", "edge_dst", "edge_mask"):
            _same(getattr(b, f), getattr(a, f))
        assert b.edge_x is None and a.edge_x is None
    tstack, jstack = trca._stack(ts), jrca._stack(js)
    assert tstack.keys() == jstack.keys()
    for k in jstack:
        _same(tstack[k], jstack[k])


def test_build_dataset_byte_identical_tt_edge_features():
    """TT with the out-edge block and the per-edge features (the
    line-graph dataset): the rca_features the online extractor shares."""
    js, _ = jrca.build_dataset("TT", [3], 20, edge_features=True)
    ts, _ = trca.build_dataset("TT", [3], 20, edge_features=True)
    assert len(ts) == len(js) == 13
    for a, b in zip(js, ts):
        for f in ("x", "x_t", "adj", "edge_src", "edge_dst", "edge_mask",
                  "edge_x"):
            _same(getattr(b, f), getattr(a, f))
    assert ts[0].x_t.shape[-1] == 8


def test_rca_features_blocks_byte_identical():
    from anomod import graph as jgraph
    from anomod import labels as jlabels
    from anomod import rca_features as jfeat
    from anomod import synth as jsynth
    from anomod.replay import ReplayConfig as JCfg
    from anomod_torch import graph as tgraph
    from anomod_torch import labels as tlabels
    from anomod_torch import synth as tsynth
    from anomod_torch.replay import ReplayConfig as TCfg
    name = "Lv_C_exception_injection"
    jb = jsynth.generate_spans(jlabels.label_for(name), n_traces=30, seed=4)
    tb = tsynth.generate_spans(tlabels.label_for(name), n_traces=30, seed=4)
    services = tuple(tsynth.TT_SERVICES)
    kw = dict(n_services=len(services), n_windows=8, chunk_size=2048,
              window_us=300_000_000)
    jc, tc = JCfg(**kw), TCfg(**kw)
    _same(tfeat.agg_feature_block(tb, services, tc),
          jfeat.agg_feature_block(jb, services, jc))
    g = tgraph.build_service_graph(tb, services=services)
    _same(tfeat.edge_feature_block(tb, services, g, tc),
          jfeat.edge_feature_block(
              jb, services, jgraph.build_service_graph(jb, services=services),
              jc))
    for got, want in zip(tfeat.pad_edge_arrays(g, g.n_edges + 5),
                         jfeat.pad_edge_arrays(g, g.n_edges + 5)):
        _same(got, want)
    with pytest.raises(ValueError):
        tfeat.pad_edge_arrays(g, g.n_edges - 1)


def _flax(name, train):
    model = jrca.make_model(name)
    s0 = {k: v[0] for k, v in train.items()}
    params = jrca.init_params(name, model, s0, jax.random.PRNGKey(0))
    return model, params


def _carried(name, params, train):
    tm = trca.make_model(name, train)
    tm.load_state_dict(params_from_flax(
        name, jax.tree_util.tree_map(np.asarray, params)))
    return tm


@pytest.mark.parametrize("name", ["gcn", "sage", "gat", "temporal",
                                  "transformer"])
def test_forward_and_gradients_match_flax(sn_data, name):
    """The GNNs, and a recurrent and an attention family on the same
    node-feature dataset (every new family, the line graph with its
    per-edge features, is held in ``tests/test_torch_models.py``)."""
    train = sn_data[4]
    model, params = _flax(name, train)
    jb = {k: jnp.asarray(v) for k, v in train.items()}
    tm = _carried(name, params, train)
    tb = trca.to_device(train, CPU)
    want = np.asarray(jax.jit(
        lambda p: jrca._apply_model(name, model, p, jb))(params))
    got = trca.apply_model(name, tm, tb)
    assert got.shape == want.shape == (26, train["x"].shape[1])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)

    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jrca.rca_loss(jrca._apply_model(name, model, p, jb),
                                jb)))(params)
    loss = trca.rca_loss(got, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    tgrad = params_to_flax(name, {k: p.grad
                                  for k, p in tm.named_parameters()})
    jl = jax.tree_util.tree_leaves_with_path(jgrad)
    tl = jax.tree_util.tree_leaves_with_path(tgrad)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (_, g), (_, w) in zip(tl, jl):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max())
    # the carried parameters go back to the same flax tree
    back = params_to_flax(name, tm.state_dict())
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(params)):
        assert pa == pb
        _same(a, np.asarray(b))


@pytest.mark.parametrize("name", ["gcn", "sage", "gat"])
def test_twenty_adamw_steps_match_optax(sn_data, name):
    train = sn_data[4]
    model, params = _flax(name, train)
    jb = {k: jnp.asarray(v) for k, v in train.items()}
    tx = optax.adamw(3e-3, weight_decay=1e-4)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(
            lambda q: jrca.rca_loss(jrca._apply_model(name, model, q, jb),
                                    jb))(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    p, s, jlosses = params, tx.init(params), []
    for _ in range(20):
        p, s, loss = step(p, s)
        jlosses.append(float(loss))
    want = np.asarray(jrca._apply_model(name, model, p, jb))

    tm = _carried(name, params, train)
    tb = trca.to_device(train, CPU)
    losses = trca.train_loop(name, tm, trca.make_optimizer(tm, 3e-3), tb,
                             0, 20)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    with torch.no_grad():
        got = trca.apply_model(name, tm, tb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", ["gcn", "sage", "gat"])
def test_init_draws_as_flax_initializes(sn_data, name):
    """Same parameter names and shapes as the flax tree; dense kernels in
    the truncated-normal range of lecun_normal, biases zero, GAT's
    attention vectors inside glorot_uniform's limit; one generator seed
    gives one draw."""
    train = sn_data[4]
    _, params = _flax(name, train)
    F = train["x"].shape[-1]
    ref = params_from_flax(name, jax.tree_util.tree_map(np.asarray, params))
    a = trca.init_model(name, F, seed=7, device="cpu")
    b = trca.init_model(name, F, seed=7, device="cpu")
    c = trca.init_model(name, F, seed=8, device="cpu")
    sd = a.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    for k, v in sd.items():
        assert torch.equal(v, b.state_dict()[k])
        if k.endswith("bias"):
            assert not v.any()
            continue
        assert not torch.equal(v, c.state_dict()[k])
        if k.endswith(("a_src", "a_dst")):
            limit = np.sqrt(6.0 / sum(v.shape))
            assert float(v.abs().max()) <= limit
            continue
        # lecun_normal: scale / 0.8796 before the cut at two scales, so
        # that the cut normal's variance is 1 / fan_in
        scale = np.sqrt(1.0 / v.shape[1]) / 0.87962566103423978
        assert float(v.abs().max()) <= 2 * scale * (1 + 1e-6)
        if v.numel() >= 1000:
            assert abs(float(v.std()) * np.sqrt(v.shape[1]) - 1.0) < 0.1


def test_segment_ops_match_jax_with_empty_segments():
    """``segment_max`` leaves a segment with no entries at -inf, as
    ``jax.ops.segment_max`` does; ``segment_sum`` / ``segment_mean`` give
    zeros there."""
    from anomod_torch.models import gnn
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(9, 4)).astype(np.float32)
    dst = np.array([0, 0, 2, 2, 2, 5, 5, 0, 2], np.int32)   # 1, 3, 4 empty
    tv, td = torch.from_numpy(vals), torch.from_numpy(dst).long()
    want = np.asarray(jax.ops.segment_max(vals, dst, num_segments=7))
    got = gnn.segment_max(tv, td, 7).numpy()
    assert np.isneginf(got[[1, 3, 4, 6]]).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        gnn.segment_sum(tv, td, 7).numpy(),
        np.asarray(jax.ops.segment_sum(vals, dst, num_segments=7)),
        rtol=1e-6, atol=1e-6)
    mean = gnn.segment_mean(tv, td, 7).numpy()
    assert not mean[[1, 3, 4, 6]].any()


def test_topk_eval_equal_on_equal_scores():
    rng = np.random.default_rng(3)
    scores = rng.normal(size=(30, 12)).astype(np.float32)
    scores[4] = 0.0                                    # all tied
    batch = {"target": rng.integers(-1, 12, 30).astype(np.int32),
             "is_anomaly": (rng.random(30) < 0.7).astype(np.float32)}
    assert trca.topk_eval(scores, batch) == jrca.topk_eval(scores, batch)


def test_train_rca_sn_gcn_meets_the_jax_bar():
    """The bar of the JAX package's own end-to-end test."""
    r = trca.train_rca("SN", "gcn", train_seeds=range(4), eval_seeds=[50],
                       epochs=250, n_traces=40, device="cpu")
    assert r.top1 >= 0.7, (r.top1, r.top3)
    assert r.detection_auc >= 0.8
    assert len(r.losses) == 250 and r.losses[-1] < r.losses[0]


def test_unported_model_and_missing_card_raise():
    with pytest.raises(ValueError, match="not ported"):
        trca.train_rca("SN", "mlp", epochs=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trca.train_rca("SN", "gcn", epochs=1)


def test_checkpoint_roundtrip(tmp_path):
    tm = trca.init_model("gat", 13, seed=0, device="cpu")
    opt = trca.make_optimizer(tm)
    tm(torch.ones(1, 3, 13), torch.tensor([[0, 1]]), torch.tensor([[1, 2]]),
       torch.tensor([[True, True]])).sum().backward()
    opt.step()
    assert save_train_state(tmp_path / "ck", tm.state_dict(),
                            opt.state_dict(), step=42,
                            meta={"model": "gat"}) == "torch"
    assert has_checkpoint(tmp_path / "ck")
    assert checkpoint_mtime(tmp_path / "ck") is not None
    params, opt_state, step, meta = restore_train_state(tmp_path / "ck")
    assert step == 42 and meta == {"model": "gat"}
    for k, v in tm.state_dict().items():
        assert torch.equal(params[k], v)
    # a resumed optimizer steps: the restored state has its structure
    tm2 = trca.make_model("gat", 13)
    tm2.load_state_dict(params)
    opt2 = trca.make_optimizer(tm2)
    opt2.load_state_dict(opt_state)
    assert opt2.state_dict()["state"][0]["step"] == 1
    # a second save publishes v43 and removes v42
    save_train_state(tmp_path / "ck", params, opt_state, step=43)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["meta.json", "v43"]


def test_checkpoint_meta_cannot_clobber_step(tmp_path):
    save_train_state(tmp_path / "ck", {"w": torch.ones(2)}, {}, step=42,
                     meta={"step": 99})
    _, _, step, _ = restore_train_state(tmp_path / "ck")
    assert step == 42


def test_torn_checkpoint_is_not_restorable(tmp_path):
    ck = tmp_path / "ck"
    assert not has_checkpoint(ck) and checkpoint_mtime(ck) is None
    save_train_state(ck, {"w": torch.ones(2)}, {}, step=5)
    (ck / "v5" / "state.pt").unlink()         # killed before the publish
    assert not has_checkpoint(ck)
    (ck / "meta.json").write_text("{not json")
    assert not has_checkpoint(ck)


def test_train_rca_checkpoint_resume(tmp_path):
    """As the JAX package's own resume test: a run resumes from its
    checkpoint, a no-op resume keeps the completed-epoch counter, another
    model's checkpoint is refused; and (the port's own pin) a resumed run
    ends bit-identical to a straight one on the CPU."""
    ck = tmp_path / "ck"
    kwargs = dict(testbed="SN", model_name="gcn", train_seeds=range(2),
                  eval_seeds=range(100, 101), n_traces=12, save_every=10,
                  device="cpu")
    trca.train_rca(epochs=12, checkpoint_dir=ck, **kwargs)
    assert json.loads((ck / "meta.json").read_text())["step"] == 12
    r = trca.train_rca(epochs=16, checkpoint_dir=ck, resume=True, **kwargs)
    assert json.loads((ck / "meta.json").read_text())["step"] == 16
    assert len(r.losses) == 4 and 0.0 <= r.top1 <= 1.0
    trca.train_rca(epochs=12, checkpoint_dir=ck, resume=True, **kwargs)
    assert json.loads((ck / "meta.json").read_text())["step"] == 16
    straight = trca.train_rca(epochs=16, **kwargs)
    assert straight.losses[12:] == r.losses
    for k, v in straight.params.items():
        assert torch.equal(v, r.params[k])
    assert (r.top1, r.top3, r.detection_auc) == \
        (straight.top1, straight.top3, straight.detection_auc)
    with pytest.raises(ValueError, match="model"):
        trca.train_rca(epochs=20, checkpoint_dir=ck, resume=True,
                       **dict(kwargs, model_name="sage"))
    # a JAX checkpoint's layout is not the port's: nothing to restore
    jcheckpoint.save_train_state(tmp_path / "jck", {"w": jnp.ones(2)}, (),
                                 step=3)
    assert not has_checkpoint(tmp_path / "jck")


def test_cli_rca_prints_the_jax_keys(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "anomod_torch", "rca", "--device", "cpu",
         "--testbed", "SN", "--model", "sage", "--epochs", "5",
         "--train-seeds", "1", "--eval-seeds", "1",
         "--checkpoint-dir", str(tmp_path / "ck")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert set(out) == {"testbed", "model", "top1", "top3",
                        "detection_auc", "n_eval"}
    assert out["model"] == "sage" and out["n_eval"] > 0
    assert json.loads((tmp_path / "ck" / "meta.json").read_text()) == \
        {"model": "sage", "testbed": "SN", "step": 5, "version": "v5"}
    bad = subprocess.run(
        [sys.executable, "-m", "anomod_torch", "rca", "--device", "cpu",
         "--model", "mlp"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert bad.returncode == 2 and "invalid choice" in bad.stderr

"""The port's training, pipeline and sequence-parallel planes
(``anomod_torch.parallel``: ``train``, ``pipeline``, ``ring_attention``,
``ulysses``, ``sp_transformer``, ``seqscan``) and its dry run
(``graft_entry.dryrun_multichip``) against the JAX package on 4 of its
virtual CPU devices.

The port runs one process per device: a module fixture launches four
``gloo`` ranks on the CPU once (``tests/torch_planes_worker.py``, which
imports no JAX, one torch thread a rank, a 120 s limit) and every check
runs in that one group; the parent runs the JAX side on
``make_mesh2d(4)``, ``make_pipe_mesh(4)`` and ``make_mesh(4)``.  The
parameters are the JAX package's, carried across (``state.py``).

Tolerances:
- the dp x tp step: losses within ``rtol=1e-5`` and gradients within
  ``rtol=1e-4, atol=1e-6`` of each leaf's largest (f32 sums in another
  order: the shards' partial sums, the ``all_reduce``); parameters after
  the update within ``2 lr + 1e-5``: Adam's first step moves a parameter
  by ``lr * g / (|g| + eps)``, so a gradient within the frameworks' f32
  difference of zero can move it by anything up to ``lr`` either way
  (which is why the gradients are compared too, and why the update is
  held by the second step's loss, within ``rtol=1e-5`` of JAX's: a
  skipped or partial update moves it far more);
- replicas after the update: bit for bit;
- the pipeline: the forward within ``rtol=2e-4, atol=2e-5`` and the
  gradients within ``rtol=5e-3, atol=1e-4`` (the JAX pipeline tests'
  own bounds);
- attention, Ulysses and the sequence-parallel transformer: the JAX
  tests' ``rtol=2e-4, atol=2e-5`` forward and ``rtol=5e-4, atol=5e-5``
  gradients; the recurrence the JAX test's ``rtol=1e-4, atol=1e-5``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_planes_worker as W
from anomod import rca as jrca
from anomod.parallel import make_mesh as jmake_mesh
from anomod.parallel import pipeline as jpipe
from anomod.parallel import train as jtrain
from anomod.parallel.ring_attention import (full_attention as jattention,
                                            make_ring_attention as jring)
from anomod.parallel.seqscan import make_seqpar_recurrence as jseqpar
from anomod.parallel.sp_transformer import make_sp_transformer as jsp
from anomod.parallel.ulysses import make_ulysses_attention as julysses
from anomod_torch.parallel import launch
from anomod_torch.parallel.train import LR, param_spec
from anomod_torch.state import flax_names, params_from_flax

LAUNCH_TIMEOUT_S = 120


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def batches():
    """8 TT experiments (the normal baseline first), so the two dp shards
    of 4 hold 3 and 4 samples with a target."""
    node, _ = jrca.build_dataset("TT", seeds=[0], n_traces=10, n_windows=4)
    edge, _ = jrca.build_dataset("TT", seeds=[0], n_traces=10, n_windows=4,
                                 edge_features=True)
    return {"node": jrca._stack(node[:8]), "edge": jrca._stack(edge[:8])}


@pytest.fixture(scope="module")
def jax_setup(batches):
    """The JAX side's parameters (each family's step on ``make_mesh2d(4)``,
    the pipelines on ``make_pipe_mesh(4)``, the sequence-parallel
    transformer) and inputs, before any step compiles: what the ranks
    need."""
    from anomod.models.transformer import TraceTransformer
    mesh = jtrain.make_mesh2d(4)
    train = {}
    for name in W.TRAIN_MODELS:
        batch = batches["edge" if name == "linegraph" else "node"]
        params, opt, step, put = jtrain.make_distributed_train_step(
            name, batch, mesh)
        train[name] = dict(batch=batch, params=params, opt=opt, step=step,
                           put=put, p0=_np_tree(params))
    pmesh = jpipe.make_pipe_mesh(4)
    pipe = {"mesh": pmesh}
    cfg = jpipe.PipelineConfig(**W.PIPE_FWD)
    S, Wn, F = W.PIPE_FWD_SWF
    params = jpipe.init_pipeline(jax.random.PRNGKey(0), pmesh, cfg, S, Wn, F)
    x, adj = W.pipe_inputs(np.random.default_rng(0), 4, S, Wn, F)
    pipe.update(fwd=params, fwd_params=_np_tree(params), fwd_x=x, fwd_adj=adj)
    cfg = jpipe.PipelineConfig(**W.PIPE_GRAD)
    S, Wn, F = W.PIPE_GRAD_SWF
    params = jpipe.init_pipeline(jax.random.PRNGKey(1), pmesh, cfg, S, Wn, F)
    x, adj = W.pipe_inputs(np.random.default_rng(1), 2, S, Wn, F)
    pipe.update(grad=params, grad_params=_np_tree(params), grad_x=x,
                grad_adj=adj)
    samples, _ = jrca.build_dataset("SN", seeds=[0], n_traces=12, n_windows=4)
    stacked = jrca._stack(samples[:12])        # 6 microbatches of 2
    params, opt, step, put = jpipe.make_pipeline_train_step(
        pmesh, jpipe.PipelineConfig(**W.PIPE_TRAIN), stacked)
    pipe.update(train=(params, opt, step, put), train_params=_np_tree(params),
                train_batch=stacked)
    x, adj = W.sp_inputs()
    model = TraceTransformer(**W.SP_MODEL)
    sp = {"params": _np_tree(model.init(jax.random.PRNGKey(0), x, adj)),
          "x": x, "adj": adj, "model": model}
    return {"train": train, "pipe": pipe, "sp": sp}


@pytest.fixture(scope="module")
def launched(batches, jax_setup):
    """The one 4-rank gloo launch of the library checks, started in a
    thread so that it runs while the JAX side compiles."""
    pipe_keys = ("fwd_params", "fwd_x", "fwd_adj", "grad_params", "grad_x",
                 "grad_adj", "train_params", "train_batch")
    inp = {"batch_node": batches["node"], "batch_edge": batches["edge"],
           "train_params": {
               name: {k: v.numpy() for k, v in params_from_flax(
                   name, jax_setup["train"][name]["p0"]).items()}
               for name in W.TRAIN_MODELS},
           "pipeline": {k: jax_setup["pipe"][k] for k in pipe_keys},
           "attention": W.attention_inputs(),
           "sp": {k: jax_setup["sp"][k] for k in ("params", "x", "adj")}}
    box = {}

    def run():
        try:
            box["ranks"] = launch(W.library_checks, W.N_RANKS, device="cpu",
                                  args=(inp,), timeout=LAUNCH_TIMEOUT_S)
        except BaseException as e:      # handed to the tests below
            box["error"] = e
    thread = threading.Thread(target=run, name="gloo-launch", daemon=True)
    thread.start()
    yield thread, box
    thread.join(timeout=LAUNCH_TIMEOUT_S + 30)


@pytest.fixture(scope="module")
def jax_train(jax_setup, launched):
    """Each family's JAX step: the gradients of the whole batch's loss,
    the loss and the updated parameters."""
    out = {}
    for name in W.TRAIN_MODELS:
        t = jax_setup["train"][name]
        model = jrca.make_model(name)

        def loss_fn(p, b, model=model, name=name):
            return jrca.rca_loss(jrca._apply_model(name, model, p, b), b)
        loss0, grads = jax.jit(jax.value_and_grad(loss_fn))(
            t["p0"], {k: jnp.asarray(v) for k, v in t["batch"].items()})
        batch = t["put"](t["batch"])
        p1, opt1, loss = t["step"](t["params"], t["opt"], batch)
        updated = _np_tree(p1)
        _, _, loss2 = t["step"](p1, opt1, batch)
        out[name] = dict(params=t["p0"], grads=_np_tree(grads),
                         loss0=float(loss0), loss=float(loss),
                         updated=updated, loss2=float(loss2))
    return out


@pytest.fixture(scope="module")
def jax_pipeline(jax_setup, launched):
    p = jax_setup["pipe"]
    mesh, out = p["mesh"], {}
    cfg = jpipe.PipelineConfig(**W.PIPE_FWD)
    forward, _ = jpipe.make_pipeline_forward(mesh, cfg, *W.PIPE_FWD_SWF[:2])
    out["fwd_out"] = np.asarray(jax.jit(forward)(p["fwd"], p["fwd_x"],
                                                 p["fwd_adj"]))
    cfg = jpipe.PipelineConfig(**W.PIPE_GRAD)
    forward, _ = jpipe.make_pipeline_forward(mesh, cfg, *W.PIPE_GRAD_SWF[:2])
    x, adj = jnp.asarray(p["grad_x"]), jnp.asarray(p["grad_adj"])
    out["grads"] = _np_tree(jax.jit(jax.grad(
        lambda q: (forward(q, x, adj) ** 2).sum()))(p["grad"]))
    params, opt, step, put = p["train"]
    batch, losses = put(p["train_batch"]), []
    for _ in range(W.PIPE_TRAIN_STEPS):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    out["losses"] = losses
    return out


@pytest.fixture(scope="module")
def jax_sp(jax_setup, launched):
    sp = jax_setup["sp"]
    return dict(sp, ref=np.asarray(sp["model"].apply(sp["params"], sp["x"],
                                                     sp["adj"])))


@pytest.fixture(scope="module")
def ranks(launched, jax_train, jax_pipeline, jax_sp):
    """The launch's results, once the JAX side has compiled beside it."""
    thread, box = launched
    thread.join(timeout=LAUNCH_TIMEOUT_S + 30)
    if "error" in box:
        raise box["error"]
    assert not thread.is_alive() and "ranks" in box, "the launch did not end"
    return box["ranks"]


def join_state_dicts(parts, specs):
    """The model places' slices (in place order) put back together (the
    inverse of ``state.shard_state_dict``); a replicated key from place
    0."""
    return {key: (parts[0][key] if specs.get(key) is None
                  else torch.cat([p[key] for p in parts], dim=specs[key]))
            for key in parts[0]}


def _specs(name, state):
    return param_spec(name, {k: torch.from_numpy(v) for k, v in
                             state.items()}, 2)


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


# -- the mesh ---------------------------------------------------------------


def test_mesh2d_is_row_major_with_one_group_an_axis_slice(ranks):
    assert [r["coords"] for r in ranks] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    assert [r["model_ranks"] for r in ranks] == [(0, 1), (0, 1), (2, 3),
                                                 (2, 3)]
    assert [r["data_ranks"] for r in ranks] == [(0, 2), (1, 3), (0, 2),
                                                (1, 3)]


# -- param_spec against _param_spec ------------------------------------------


@pytest.mark.parametrize("name", W.TRAIN_MODELS)
def test_param_spec_equals_jax_param_spec(name, jax_train):
    from jax.sharding import PartitionSpec as P
    mesh = jtrain.make_mesh2d(4)
    params = jax_train[name]["params"]
    want = {}
    jax.tree_util.tree_map_with_path(
        lambda path, a: want.__setitem__(
            tuple(str(getattr(k, "key", k)) for k in path)[1:],
            jtrain._param_spec(path, a, mesh)), params)
    state = params_from_flax(name, params)
    specs = param_spec(name, state, 2)
    names = flax_names(name, state)
    assert len(names) == len(want) == len(specs)
    sharded = 0
    for key, path, kernel in names:
        spec = want[path]
        if spec == P():
            assert specs[key] is None, key
        elif spec[0] == "model":                 # an expert axis
            assert specs[key] == 0, key
        else:                                    # flax dim 1: columns
            assert spec == P(None, "model"), key
            assert specs[key] == (0 if kernel else 1), key
        sharded += specs[key] is not None
    assert sharded > 0
    # unsharded on a model axis of 1
    assert set(param_spec(name, state, 1).values()) == {None}


# -- the dp x tp (x ep) step --------------------------------------------------


def test_dp_shards_hold_unequal_target_counts(ranks):
    for name in W.TRAIN_MODELS:
        rows = [r["train"][name]["rows"] for r in ranks]
        targets = [r["train"][name]["targets"] for r in ranks]
        assert rows == [4, 4, 4, 4]
        # data 0 (ranks 0, 1) holds the normal baseline
        assert targets == [3, 3, 4, 4]


def test_tensor_and_expert_parallel_layers_are_swapped_in(ranks):
    layers = ranks[0]["train"]
    assert "ColumnDense" in layers["gcn"]["layers"]
    assert {"ColumnDense", "ColumnTokenEmbed",
            "ExpertParallelMoEBlock"} <= set(layers["moe"]["layers"])
    assert {"ColumnDense", "ColumnTokenEmbed"} <= set(
        layers["linegraph"]["layers"])


@pytest.mark.parametrize("name", W.TRAIN_MODELS)
def test_dp_tp_step_loss_and_grads_equal_jax(name, ranks, jax_train):
    j = jax_train[name]
    losses = [r["train"][name]["loss"] for r in ranks]
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], j["loss0"], rtol=1e-5)
    np.testing.assert_allclose(losses[0], j["loss"], rtol=1e-5)
    want = params_from_flax(name, j["grads"])
    specs = _specs(name, ranks[0]["train"][name]["state"])
    # data row 0: model places 0 and 1
    got = join_state_dicts([_torch(ranks[i]["train"][name]["grads"])
                            for i in (0, 1)], specs)
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{name} grad {k}")


@pytest.mark.parametrize("name", W.TRAIN_MODELS)
def test_dp_tp_step_update_equals_jax_and_replicas_equal(name, ranks,
                                                         jax_train):
    states = [ranks[i]["train"][name]["state"] for i in range(4)]
    specs = _specs(name, states[0])
    # replicas over data (same model place) bit for bit; replicated
    # parameters on every rank
    for a, b in ((0, 2), (1, 3)):
        for k in states[a]:
            np.testing.assert_array_equal(states[a][k], states[b][k],
                                          err_msg=f"{name} {k}")
    for k, dim in specs.items():
        if dim is None:
            for s in states[1:]:
                np.testing.assert_array_equal(s[k], states[0][k])
    got = join_state_dicts([_torch(states[0]), _torch(states[1])], specs)
    want = params_from_flax(name, jax_train[name]["updated"])
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=2 * LR + 1e-5,
                                   err_msg=f"{name} param {k}")
    # the update itself: the loss after it, on every rank, equals JAX's
    losses2 = [r["train"][name]["loss2"] for r in ranks]
    assert len(set(losses2)) == 1
    np.testing.assert_allclose(losses2[0], jax_train[name]["loss2"],
                               rtol=1e-5)


# -- the pipeline -------------------------------------------------------------


def test_pipeline_forward_equals_jax(ranks, jax_pipeline):
    want = jax_pipeline["fwd_out"]
    assert want.shape == (4, W.PIPE_FWD_SWF[0])
    for r in ranks:
        np.testing.assert_allclose(r["pipeline"]["forward"], want,
                                   rtol=2e-4, atol=2e-5)


def test_pipeline_grads_equal_jax(ranks, jax_pipeline):
    from anomod_torch.state import pipeline_params_from_flax
    g = jax_pipeline["grads"]
    for stage, r in enumerate(ranks):
        want = pipeline_params_from_flax(g, stage)
        got = r["pipeline"]["grads"]
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w.numpy(), rtol=5e-3,
                                       atol=1e-4,
                                       err_msg=f"stage {stage} {k}")
    # the embed's gradient reaches every stage (summed over pipe), and
    # is not zero
    emb = ranks[0]["pipeline"]["grads"]["embed.dense.weight"]
    assert np.abs(emb).max() > 0
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["pipeline"]["grads"][
            "embed.dense.weight"], emb)


def test_pipeline_train_steps_lower_the_loss_as_jax(ranks, jax_pipeline):
    losses = ranks[0]["pipeline"]["losses"]
    assert all(r["pipeline"]["losses"] == losses for r in ranks)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses[0], jax_pipeline["losses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(losses, jax_pipeline["losses"], rtol=1e-3)
    # the replicated embed and head stay equal on every stage
    for part in ("embed", "head"):
        for r in ranks[1:]:
            for k, v in r["pipeline"][part].items():
                np.testing.assert_array_equal(v, ranks[0]["pipeline"][part][k])


# -- ring and Ulysses attention, the sp transformer, the scan ---------------


def _qkv(name):
    return W.attention_inputs()[name]


@pytest.mark.parametrize("name,axis", [("ring", "data"), ("odd", "sp")])
def test_ring_attention_equals_jax(name, axis, ranks):
    q, k, v = _qkv(name)
    want = np.asarray(jring(jmake_mesh(4, axis=axis), axis=axis)(q, k, v))
    np.testing.assert_allclose(want, np.asarray(jattention(q, k, v)),
                               rtol=2e-4, atol=2e-5)
    for r in ranks:
        np.testing.assert_allclose(r["attention"][name], want, rtol=2e-4,
                                   atol=2e-5)


def test_ulysses_attention_equals_jax_and_ring(ranks):
    q, k, v = _qkv("ulysses")
    want = np.asarray(julysses(jmake_mesh(4))(q, k, v))
    for r in ranks:
        np.testing.assert_allclose(r["attention"]["ulysses"], want,
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["attention"]["swap_ulysses"],
                                   r["attention"]["swap_ring"], rtol=2e-4,
                                   atol=2e-5)
    q, k, v = _qkv("swap")
    np.testing.assert_allclose(ranks[0]["attention"]["swap_ring"],
                               np.asarray(jattention(q, k, v)), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("plane", ["ring", "ulysses"])
def test_sequence_parallel_gradients_equal_jax(plane, ranks):
    args = tuple(jnp.asarray(a) for a in _qkv("grads"))
    fn = (jring if plane == "ring" else julysses)(jmake_mesh(4))
    want = jax.grad(lambda a: (fn(*a) ** 2).sum())(args)
    full = jax.grad(lambda a: (jattention(*a) ** 2).sum())(args)
    for r in ranks:
        for got, w, f, p in zip(r["attention"][f"grads_{plane}"], want, full,
                                r["attention"]["grads_full"]):
            np.testing.assert_allclose(got, np.asarray(w), rtol=5e-4,
                                       atol=5e-5)
            np.testing.assert_allclose(got, np.asarray(f), rtol=5e-4,
                                       atol=5e-5)
            np.testing.assert_allclose(p, np.asarray(f), rtol=5e-4,
                                       atol=5e-5)


def test_sequence_parallel_refusals_match_jax(ranks):
    q, k, v = W.qkv(64, 6, 16)
    with pytest.raises(ValueError, match="divisible") as e:
        julysses(jmake_mesh(4))(q, k, v)
    for r in ranks:
        assert r["attention"]["ulysses_heads_error"] == str(e.value)
        assert "divisible" in r["attention"]["ring_length_error"]
        assert r["attention"]["ring_length_error"].startswith(
            "sequence-parallel attention needs the sequence length (10)")


def test_sp_transformer_equals_jax_single_chip(ranks, jax_sp):
    ref = jax_sp["ref"]
    for r in ranks:
        sp = r["sp"]
        np.testing.assert_allclose(sp["single"], ref, rtol=2e-4, atol=2e-5)
        for plane in ("ring", "ulysses"):
            np.testing.assert_allclose(sp[plane], ref, rtol=2e-4,
                                       atol=2e-5, err_msg=plane)
            assert sp[f"{plane}_shares_params"]
    with pytest.raises(ValueError, match="plane") as e:
        jsp(jmake_mesh(4), jax_sp["model"], plane="blockwise")
    assert ranks[0]["sp"]["plane_error"] == str(e.value)


def test_seqpar_recurrence_equals_jax_and_sequential(ranks):
    xs, decay = W.scan_inputs()
    h = np.zeros(xs.shape[1:], np.float32)
    seq = np.zeros_like(xs)
    for t in range(xs.shape[0]):
        h = decay * h + xs[t]
        seq[t] = h
    want = np.asarray(jseqpar(jmake_mesh(4))(jnp.asarray(xs),
                                             jnp.asarray(decay)))
    np.testing.assert_allclose(want, seq, rtol=1e-4, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["seqscan"]["full"], want, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["seqscan"]["full"], seq, rtol=1e-4,
                                   atol=1e-5)
    blocks = np.concatenate([r["seqscan"]["local"] for r in ranks])
    np.testing.assert_allclose(blocks, seq, rtol=1e-4, atol=1e-5)


# -- the dry run -------------------------------------------------------------


def test_dryrun_multichip_4_ranks_on_cpu_runs_to_its_end(ranks):
    runs = [r["dryrun"] for r in ranks]
    assert all(run == runs[0] for run in runs)
    run = runs[0]
    assert (run["n_devices"], run["device"]) == (4, "cpu")
    assert run["mesh2d"] == {"data": 2, "model": 2}
    assert run["attention_L"] == 32 and run["n_microbatches"] == 2
    for key in ("gcn_loss", "moe_loss", "linegraph_loss", "pipeline_loss"):
        assert np.isfinite(run[key]) and run[key] > 0, key

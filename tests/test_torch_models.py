"""The five model families the port added to GCN / SAGE / GAT (temporal
GRU, LRU, TraceTransformer, MoE, line graph), and the cores they call
(``parallel.ring_attention.full_attention``,
``parallel.seqscan.linear_recurrence``), against the JAX package on the
CPU, on the ``sn_data`` fixture (SN, 12 services, W 8, two seeds x 20
traces, with the per-edge features).

Tolerance, as for the GNNs (``tests/test_torch_rca.py``): with the flax
parameters carried across (``state.params_from_flax``), the forward pass
agrees to ``rtol=1e-5, atol=1e-6`` and the gradients of ``rca_loss`` to
``rtol=1e-4`` (atol 1e-6 of each leaf's largest gradient): f32, the same
operations in another order (the LRU's recurrence in window order against
``lax.associative_scan``'s tree, LayerNorm and softmax sums in PyTorch's
reduction order).  Twenty AdamW steps against ``optax.adamw`` keep every
loss within ``rtol=1e-4`` and the final scores within 1e-4 of their
scale (one family looser, see :data:`SCORE_TOL`).  The JAX side runs
jitted, each family's loss, gradients and scores compiled once for the
file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anomod import rca as jrca
from anomod.parallel.ring_attention import full_attention as jattention
from anomod.parallel.seqscan import linear_recurrence as jrecurrence
from anomod_torch import rca as trca
from anomod_torch.models.gnn import Dense
from anomod_torch.models.temporal import RecurrentDense
from anomod_torch.parallel.ring_attention import full_attention
from anomod_torch.parallel.seqscan import linear_recurrence
from anomod_torch.state import params_from_flax, params_to_flax

CPU = torch.device("cpu")
FAMILIES = ["temporal", "lru", "transformer", "moe", "linegraph"]
#: the standard deviation of a unit normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978
#: the final scores after 20 steps, within this fraction of their scale;
#: 1e-4 (the GNNs') unless stated.  ``temporal``: Adam's first step moves
#: a parameter by about lr * g / (|g| + 1e-8), and a few gradients of
#: the GRU model's first GCN kernel lie within the two frameworks' f32
#: difference (1e-8) of zero, so that step differs by up to 9.5e-5 in
#: those weights; after 20 steps the scores are 4.6e-4 of their scale
#: apart, while every loss still agrees to rtol 1e-5
SCORE_TOL = {"temporal": 1e-3}


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
    """SN, 2 seeds x 20 traces with the per-edge features, stacked and
    standardized on the JAX side."""
    js, _ = jrca.build_dataset("SN", range(2), 20, edge_features=True)
    train = jrca._stack(js)
    jrca.standardize_features(train, [])
    return train


@pytest.fixture(scope="module")
def flax_runs(sn_data):
    """Per family, built once for the file: the flax model, its
    parameters from ``PRNGKey(0)``, the batch and a jitted ``(loss,
    scores), grads`` of it."""
    runs = {}
    jb = {k: jnp.asarray(v) for k, v in sn_data.items()}
    s0 = {k: v[0] for k, v in sn_data.items()}

    def get(name):
        if name not in runs:
            model = jrca.make_model(name)
            params = jax.jit(lambda key: jrca.init_params(
                name, model, s0, key))(jax.random.PRNGKey(0))

            def loss(p):
                scores = jrca._apply_model(name, model, p, jb)
                return jrca.rca_loss(scores, jb), scores
            runs[name] = (params, jax.jit(jax.value_and_grad(
                loss, has_aux=True)))
        return runs[name]
    return get


def _carried(name, params, train):
    tm = trca.make_model(name, train)
    tm.load_state_dict(params_from_flax(
        name, jax.tree_util.tree_map(np.asarray, params)))
    return tm


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_and_gradients_match_flax(sn_data, flax_runs, name):
    params, vg = flax_runs(name)
    (jloss, want), jgrad = vg(params)
    want = np.asarray(want)
    tm = _carried(name, params, sn_data)
    tb = trca.to_device(sn_data, CPU)
    got = trca.apply_model(name, tm, tb)
    assert got.shape == want.shape == (26, 12)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    loss = trca.rca_loss(got, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    tgrad = params_to_flax(name, {k: p.grad
                                  for k, p in tm.named_parameters()})
    jl = jax.tree_util.tree_leaves_with_path(jgrad)
    tl = jax.tree_util.tree_leaves_with_path(tgrad)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, g), (_, w) in zip(tl, jl):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))
    # the carried parameters go back to the same flax tree
    back = params_to_flax(name, tm.state_dict())
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(params)):
        assert pa == pb
        _same(a, np.asarray(b))


@pytest.mark.parametrize("name", FAMILIES)
def test_twenty_adamw_steps_match_optax(sn_data, flax_runs, name):
    params, vg = flax_runs(name)
    tx = optax.adamw(3e-3, weight_decay=1e-4)

    @jax.jit
    def update(g, s, p):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    p, s, jlosses = params, tx.init(params), []
    for _ in range(20):
        (loss, _), g = vg(p)
        jlosses.append(float(loss))
        p, s = update(g, s, p)
    want = np.asarray(vg(p)[0][1])

    tm = _carried(name, params, sn_data)
    tb = trca.to_device(sn_data, CPU)
    losses = trca.train_loop(name, tm, trca.make_optimizer(tm, 3e-3), tb,
                             0, 20)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    with torch.no_grad():
        got = trca.apply_model(name, tm, tb).numpy()
    tol = SCORE_TOL.get(name, 1e-4)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name", FAMILIES)
def test_init_draws_as_flax_initializes(sn_data, flax_runs, name):
    """Same parameter names and shapes as the flax tree; one generator
    seed gives one draw; each leaf drawn as flax draws it: dense kernels
    ``lecun_normal`` (the MoE experts' fan-in over the expert and input
    axes, E x d and E x h), the GRU's recurrent kernels orthogonal,
    ``svc_emb`` ``normal(0.02)``, ``decay_logit`` ``uniform(2.0)``,
    LayerNorm scales one, biases zero."""
    params, _ = flax_runs(name)
    ref = params_from_flax(name, jax.tree_util.tree_map(np.asarray, params))
    a = trca.init_model(name, sn_data, seed=7, device="cpu")
    b = trca.init_model(name, sn_data, seed=7, device="cpu")
    c = trca.init_model(name, sn_data, seed=8, device="cpu")
    sd = a.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    for k, v in sd.items():
        assert torch.equal(v, b.state_dict()[k])
    mods = dict(a.named_modules())
    for k, v in sd.items():
        owner, leaf = k.rsplit(".", 1) if "." in k else ("", k)
        mod = mods[owner]
        if leaf == "bias" or k.endswith((".b1", ".b2")):
            assert not v.any(), k
            continue
        if leaf == "scale":
            assert bool((v == 1).all()), k
            continue
        assert not torch.equal(v, c.state_dict()[k]), k
        if isinstance(mod, RecurrentDense):
            torch.testing.assert_close(v @ v.T, torch.eye(v.shape[0]),
                                       rtol=0, atol=1e-5)
            continue
        if leaf == "svc_emb":
            assert abs(float(v.std()) - 0.02) < 0.004, k
            continue
        if leaf == "decay_logit":
            assert 0.0 <= float(v.min()) and float(v.max()) < 2.0, k
            continue
        assert isinstance(mod, Dense) or leaf in ("w1", "w2"), k
        # flax reads an [E, d, h] kernel's leading axis as a receptive
        # field: fan-in E x d; a dense weight [out, in]: fan-in in
        fan_in = v.shape[0] * v.shape[1] if v.dim() == 3 else v.shape[1]
        scale = np.sqrt(1.0 / fan_in) / TRUNC_STD
        assert float(v.abs().max()) <= 2 * scale * (1 + 1e-6), k
        if v.numel() >= 1000:
            assert abs(float(v.std()) * np.sqrt(fan_in) - 1.0) < 0.1, k


def test_moe_expert_fan_in_matches_flax(flax_runs):
    """The flax draw itself: the experts' std is 1 / sqrt(E x d), not
    1 / sqrt(d) (0.0510 at E 8, d 48)."""
    params, _ = flax_runs("moe")
    w1 = np.asarray(params["params"]["MoEBlock_0"]["w1"])
    assert abs(w1.std() * np.sqrt(8 * 48) - 1.0) < 0.05


@pytest.mark.parametrize("shape", [(360, 4, 12), (2, 96, 4, 12)],
                         ids=["one_sample", "batched"])
def test_full_attention_matches_jax(shape):
    """The einsum / max-subtract / normalize order of the JAX function;
    a leading batch axis is a vmap of it (no mixing across samples)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    got = full_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    fn = jattention if len(shape) == 3 else jax.vmap(jattention)
    np.testing.assert_allclose(got, np.asarray(fn(q, k, v)), rtol=1e-5,
                               atol=1e-6)


def test_linear_recurrence_matches_associative_scan():
    """A loop in window order against ``lax.associative_scan``'s tree:
    the same states up to f32 reassociation, within rtol 1e-6."""
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(8, 26, 12, 64)).astype(np.float32)
    decay = (1 / (1 + np.exp(-(rng.uniform(0, 2, 64) + 1)))).astype(
        np.float32)
    got = linear_recurrence(torch.from_numpy(xs),
                            torch.from_numpy(decay)).numpy()
    np.testing.assert_allclose(got, np.asarray(jrecurrence(xs, decay)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0], xs[0])


def test_linegraph_pad_rows_and_missing_edge_features(sn_data):
    """Padded edges (mask false) change no score, whatever their
    endpoints and features; without ``edge_x`` the line graph raises the
    JAX package's ``ValueError``."""
    tm = trca.init_model("linegraph", sn_data, seed=0, device="cpu")
    tb = trca.to_device(sn_data, CPU)
    with torch.no_grad():
        base = trca.apply_model("linegraph", tm, tb)
        pad = 5
        grown = dict(tb)
        rng = np.random.default_rng(2)
        B = tb["x"].shape[0]
        for key, fill in (
                ("edge_src", rng.integers(0, 12, (B, pad))),
                ("edge_dst", rng.integers(0, 12, (B, pad))),
                ("edge_mask", np.zeros((B, pad), bool)),
                ("edge_x", rng.normal(size=(B, pad) + tuple(
                    tb["edge_x"].shape[2:])))):
            grown[key] = torch.cat(
                [tb[key], torch.as_tensor(fill).to(tb[key].dtype)], dim=1)
        torch.testing.assert_close(
            trca.apply_model("linegraph", tm, grown), base, rtol=1e-6,
            atol=1e-6)
    jb = {k: jnp.asarray(v) for k, v in sn_data.items() if k != "edge_x"}
    with pytest.raises(ValueError, match="per-edge features") as want:
        jrca._apply_model("linegraph", jrca.make_model("linegraph"), {}, jb)
    without = {k: v for k, v in tb.items() if k != "edge_x"}
    with pytest.raises(ValueError, match="per-edge features") as got:
        trca.apply_model("linegraph", tm, without)
    assert str(got.value) == str(want.value)

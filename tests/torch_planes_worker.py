"""The rank body of ``tests/test_torch_parallel_planes.py``'s one 4-rank
``gloo`` launch.

It imports only ``torch``, ``numpy`` and ``anomod_torch``, so a spawned
rank never imports JAX.  :func:`library_checks` runs every library check
of the training, pipeline and sequence planes in one group and returns
the rank's results as numpy arrays, lists and strings; the parent
compares them with the JAX package on its virtual CPU devices.  The
inputs (the batches, the JAX parameters carried across as numpy, the
attention and scan inputs) come from the parent, made by the recipes
below from seeds.
"""

from __future__ import annotations

import numpy as np
import torch

N_RANKS = 4
#: the families of the dp x tp (x ep) step
TRAIN_MODELS = ("gcn", "moe", "linegraph")
#: the JAX pipeline tests' configurations (``tests/test_pipeline.py``)
PIPE_FWD = dict(n_microbatches=2, layers_per_stage=2, d_model=16, n_heads=2,
                mlp_hidden=32)
PIPE_FWD_SWF = (6, 4, 5)
PIPE_GRAD = dict(n_microbatches=2, layers_per_stage=1, d_model=16,
                 n_heads=2, mlp_hidden=32)
PIPE_GRAD_SWF = (5, 4, 3)
PIPE_TRAIN = dict(n_microbatches=6, layers_per_stage=1, d_model=16,
                  n_heads=2, mlp_hidden=32)
PIPE_TRAIN_STEPS = 8
#: the sequence-parallel transformer (``tests/test_ring_attention.py``)
SP_MODEL = dict(d_model=32, n_heads=8, n_layers=2, mlp_hidden=48)
SP_SWF = (16, 8, 5)


def qkv(L, H, D, seed=0):
    """``tests/conftest.py``'s ``make_qkv``, as numpy."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(L, H, D)).astype(np.float32)
                 for _ in range(3))


#: (name, L, H, D, seed) of the attention inputs on 4 ranks, from the
#: JAX tests' shapes (their 8-device cases at 4)
ATTENTION = (("ring", 64, 4, 16, 0), ("odd", 40, 2, 8, 3),
             ("ulysses", 64, 8, 16, 0), ("swap", 40, 4, 8, 3),
             ("grads", 32, 8, 8, 7))


def attention_inputs() -> dict:
    return {name: qkv(L, H, D, seed) for name, L, H, D, seed in ATTENTION}


def pipe_inputs(rng, B, S, W, F):
    """``tests/test_pipeline.py``'s ``_rand_inputs``."""
    x = rng.normal(size=(B, S, W, F)).astype(np.float32)
    adj = rng.integers(0, 3, size=(B, S, S)).astype(np.float32)
    return x, adj


def scan_inputs():
    """``tests/test_parallel.py``'s recurrence input: 64 windows."""
    rng = np.random.default_rng(3)
    xs = rng.normal(0, 1, (64, 12, 5)).astype(np.float32)
    decay = rng.uniform(0.5, 0.99, (12, 5)).astype(np.float32)
    return xs, decay


def sp_inputs():
    rng = np.random.default_rng(9)
    S, W, F = SP_SWF
    x = rng.normal(size=(S, W, F)).astype(np.float32)
    adj = rng.integers(0, 4, (S, S)).astype(np.float32)
    return x, adj


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


def _sd(params: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _train(name, mesh, batch, params) -> dict:
    from anomod_torch.parallel.train import make_distributed_train_step
    model, _, step, put_batch = make_distributed_train_step(
        name, batch, mesh, params=_sd(params))
    dev_batch = put_batch(batch)
    loss = step(dev_batch)
    grads = {k: _np(p.grad) for k, p in model.named_parameters()}
    state = {k: _np(v) for k, v in model.state_dict().items()}
    # the second step's loss is the first update's outcome
    return {"loss": float(loss), "grads": grads, "state": state,
            "loss2": float(step(dev_batch)),
            "rows": int(dev_batch["target"].shape[0]),
            "targets": int((dev_batch["target"] >= 0).sum()),
            "layers": sorted({type(m).__name__ for m in model.modules()})}


def _pipeline(mesh, inp: dict) -> dict:
    from anomod_torch.parallel.pipeline import (PipelineConfig,
                                                init_pipeline,
                                                make_pipeline_forward,
                                                make_pipeline_train_step,
                                                sum_embed_grads)
    from anomod_torch.state import pipeline_params_from_flax
    r = mesh.axis_index("pipe")
    out = {}
    # the forward of a 2-layer-a-stage pipe
    cfg = PipelineConfig(**PIPE_FWD)
    S, W, F = PIPE_FWD_SWF
    stage = init_pipeline(mesh, cfg, S, W, F,
                          params=pipeline_params_from_flax(inp["fwd_params"],
                                                           r))
    forward, _ = make_pipeline_forward(mesh, cfg, S, W)
    with torch.no_grad():
        out["forward"] = _np(forward(stage, _t(inp["fwd_x"]),
                                     _t(inp["fwd_adj"])))
    # gradients of sum(scores^2) through the schedule
    cfg = PipelineConfig(**PIPE_GRAD)
    S, W, F = PIPE_GRAD_SWF
    stage = init_pipeline(mesh, cfg, S, W, F,
                          params=pipeline_params_from_flax(inp["grad_params"],
                                                           r))
    forward, _ = make_pipeline_forward(mesh, cfg, S, W)
    (forward(stage, _t(inp["grad_x"]), _t(inp["grad_adj"])) ** 2).sum() \
        .backward()
    sum_embed_grads(stage, mesh)
    out["grads"] = {k: _np(p.grad) for k, p in stage.named_parameters()}
    # the train step from the JAX step's parameters
    cfg = PipelineConfig(**PIPE_TRAIN)
    stage, _, step, put_batch = make_pipeline_train_step(
        mesh, cfg, inp["train_batch"],
        params=pipeline_params_from_flax(inp["train_params"], r))
    batch = put_batch(inp["train_batch"])
    out["losses"] = [float(step(batch)) for _ in range(PIPE_TRAIN_STEPS)]
    out["embed"] = {k: _np(v) for k, v in stage.embed.state_dict().items()}
    out["head"] = {k: _np(v) for k, v in stage.head.state_dict().items()}
    return out


def _attention(mesh, mesh_sp, inp: dict) -> dict:
    from anomod_torch.parallel import (make_ring_attention,
                                       make_ulysses_attention)
    from anomod_torch.parallel.ring_attention import full_attention
    out = {}
    with torch.no_grad():
        out["ring"] = _np(make_ring_attention(mesh)(*map(_t, inp["ring"])))
        out["odd"] = _np(make_ring_attention(mesh_sp, "sp")(
            *map(_t, inp["odd"])))
        out["ulysses"] = _np(make_ulysses_attention(mesh)(
            *map(_t, inp["ulysses"])))
        swap = tuple(map(_t, inp["swap"]))
        out["swap_ulysses"] = _np(make_ulysses_attention(mesh_sp, "sp")(
            *swap))
        out["swap_ring"] = _np(make_ring_attention(mesh_sp, "sp")(*swap))
    for plane, make in (("ring", make_ring_attention),
                        ("ulysses", make_ulysses_attention),
                        ("full", None)):
        args = tuple(_t(a, requires_grad=True) for a in inp["grads"])
        fn = full_attention if make is None else make(mesh)
        (fn(*args) ** 2).sum().backward()
        out[f"grads_{plane}"] = [_np(a.grad) for a in args]
    six = tuple(map(_t, qkv(64, 6, 16)))
    out["ulysses_heads_error"] = _error(
        lambda: make_ulysses_attention(mesh)(*six))
    ten = tuple(map(_t, qkv(10, 2, 8)))
    out["ring_length_error"] = _error(lambda: make_ring_attention(mesh)(*ten))
    return out


def _sp(mesh, inp: dict) -> dict:
    from anomod_torch.models.transformer import TraceTransformer
    from anomod_torch.parallel import make_sp_transformer
    from anomod_torch.state import params_from_flax
    S, W, F = SP_SWF
    model = TraceTransformer(in_features=F, n_services=S, **SP_MODEL)
    model.load_state_dict(params_from_flax("transformer", inp["params"]))
    x, adj = _t(inp["x"][None]), _t(inp["adj"][None])
    out = {}
    with torch.no_grad():
        out["single"] = _np(model(x, adj))[0]
        for plane in ("ring", "ulysses"):
            sp = make_sp_transformer(mesh, model, plane=plane)
            out[plane] = _np(sp(x, adj))[0]
            out[f"{plane}_shares_params"] = all(
                a is b for a, b in zip(sp.parameters(), model.parameters()))
    out["plane_error"] = _error(
        lambda: make_sp_transformer(mesh, model, plane="blockwise"))
    return out


def _seqscan(mesh) -> dict:
    from anomod_torch.parallel.seqscan import (make_seqpar_recurrence,
                                               seqpar_recurrence_local)
    xs, decay = scan_inputs()
    full = make_seqpar_recurrence(mesh)(_t(xs), _t(decay))
    mine = xs.reshape(N_RANKS, -1, *xs.shape[1:])[mesh.rank]
    local = seqpar_recurrence_local(_t(mine), _t(decay), mesh)
    return {"full": _np(full), "local": _np(local)}


def library_checks(inp: dict) -> dict:
    """Every library check of the training, pipeline and sequence planes
    on this rank of a 4-rank ``gloo`` group."""
    from anomod_torch.graft_entry import dryrun_multichip
    from anomod_torch.parallel import make_mesh
    from anomod_torch.parallel.pipeline import make_pipe_mesh
    from anomod_torch.parallel.train import make_mesh2d
    torch.set_num_threads(1)
    mesh2d = make_mesh2d(N_RANKS, device="cpu")
    mesh = make_mesh(N_RANKS, device="cpu")
    out = {"rank": mesh.rank, "coords": mesh2d.coords,
           "model_ranks": mesh2d.axis_ranks("model"),
           "data_ranks": mesh2d.axis_ranks("data"),
           "train": {name: _train(name, mesh2d, inp["batch_" + (
               "edge" if name == "linegraph" else "node")],
               inp["train_params"][name]) for name in TRAIN_MODELS},
           "pipeline": _pipeline(make_pipe_mesh(N_RANKS, device="cpu"),
                                 inp["pipeline"]),
           "attention": _attention(mesh, make_mesh(N_RANKS, axis="sp",
                                                   device="cpu"),
                                   inp["attention"]),
           "sp": _sp(mesh, inp["sp"]), "seqscan": _seqscan(mesh)}
    out["dryrun"] = dryrun_multichip(N_RANKS, device="cpu")
    return out

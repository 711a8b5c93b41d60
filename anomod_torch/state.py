"""Replay state carried across packages.

A replay state built by the JAX package (its ``ReplayState`` fields read
back as numpy arrays) moves into the port with :func:`from_numpy_state`,
and back with :func:`to_numpy_state`; a stream can start in one package
and continue in the other.  The serve plane's tenant pool moves across
whole with :func:`load_pool`, or tenant by tenant with
:func:`load_tenant_states`.  A t-digest (``TDigest`` mean and weight
``[..., K]``) moves with :func:`from_numpy_digest` /
:func:`to_numpy_digest`.  An RCA model's flax parameter tree (nested dicts
of numpy arrays, as ``flax.linen.Module.init`` returns them read back to
the host), for any of the eight families, moves into the port's
``state_dict`` with :func:`params_from_flax`, and back with
:func:`params_to_flax`.  The parallel planes' shapes: the JAX pipeline's
stacked tree goes to a stage rank's ``state_dict`` with
:func:`pipeline_params_from_flax`; the column and expert slices of a full
``state_dict`` go to a tensor-parallel rank with :func:`shard_state_dict`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.ops.tdigest import TDigest
from anomod_torch.replay import (N_FEATS, ReplayConfig, ReplayState,
                                 TenantStatePool)


def from_numpy_state(agg, hist, hll=None,
                     device: DeviceLike = None) -> ReplayState:
    """``[S*W, 6]`` agg and ``[S*W, H]`` hist float32 (and optional
    ``[S, 2^p]`` int32 HLL registers) -> the port's state on ``device``.
    The arrays are copied."""
    device = resolve_device(device)

    def put(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)
    return ReplayState(agg=put(agg, np.float32), hist=put(hist, np.float32),
                       hll=None if hll is None else put(hll, np.int32))


def load_pool(cfg: ReplayConfig, agg, hist, device: DeviceLike = None,
              next_slot: Optional[int] = None,
              free: Sequence[int] = ()) -> TenantStatePool:
    """A JAX ``TenantStatePool``'s planes (``pool.agg`` ``[P+1, SW, F]``
    and ``pool.hist`` ``[P+1, SW, H]`` as numpy, row 0 the dead slot) ->
    the port's pool on ``device`` with the same rows in the same slots.
    ``next_slot`` and ``free`` carry the JAX pool's ``_next`` and
    ``_free`` (default: every row in use).  The planes are copied."""
    agg = np.asarray(agg, np.float32)
    hist = np.asarray(hist, np.float32)
    if agg.ndim != 3 or agg.shape[0] < 2 \
            or agg.shape[1:] != (cfg.sw, N_FEATS) \
            or hist.shape != (agg.shape[0], cfg.sw, cfg.n_hist_buckets):
        raise ValueError(f"pool planes {agg.shape} / {hist.shape} do not "
                         f"fit SW={cfg.sw}, H={cfg.n_hist_buckets}")
    pool = TenantStatePool(cfg, capacity=agg.shape[0] - 1, device=device)
    pool.agg.copy_(torch.from_numpy(agg))
    pool.hist.copy_(torch.from_numpy(hist))
    pool._next = int(agg.shape[0] if next_slot is None else next_slot)
    pool._free = [int(s) for s in free]
    return pool


def load_tenant_states(pool: TenantStatePool,
                       states: Sequence[ReplayState]) -> List[int]:
    """Per-tenant replay states (numpy or tensors, e.g. the JAX host
    seam's) -> fresh slots of ``pool``; returns the slots in order."""
    slots = []
    for st in states:
        slot = pool.acquire()
        pool.put(slot, st)
        slots.append(slot)
    return slots


def to_numpy_state(state: ReplayState
                   ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The port's state as host ``(agg, hist, hll)`` numpy copies."""
    def host(t):
        return None if t is None else np.array(t.cpu())
    return host(state.agg), host(state.hist), host(state.hll)


def from_numpy_digest(mean, weight, device: DeviceLike = None) -> TDigest:
    """A digest's ``[..., K]`` float32 mean and weight (e.g. the JAX
    package's ``TDigest`` read back as numpy) -> tensors on ``device``.
    The arrays are copied."""
    device = resolve_device(device)
    mean = np.asarray(mean, np.float32)
    weight = np.asarray(weight, np.float32)
    if mean.shape != weight.shape or mean.ndim < 1:
        raise ValueError(f"digest mean {mean.shape} and weight "
                         f"{weight.shape} must share a [..., K] shape")
    return TDigest(mean=torch.tensor(mean, device=device),
                   weight=torch.tensor(weight, device=device))


def to_numpy_digest(d: TDigest) -> TDigest:
    """A digest of tensors (or arrays) as host numpy copies."""
    def host(t):
        return np.array(t.cpu()) if torch.is_tensor(t) else np.array(t)
    return TDigest(mean=host(d.mean), weight=host(d.weight))


#: a leaf's layout: a flax dense kernel ``[in, out]`` is the port's
#: ``[out, in]`` weight (transposed); every other leaf keeps its layout
KERNEL, AS_IS = True, False

#: the flax module whose count gives each family's layer count
_LAYER_PREFIX = {"gcn": "GCNLayer_", "gat": "GATLayer_",
                 "transformer": "AttentionBlock_", "moe": "MoEBlock_",
                 "linegraph": "AttentionBlock_"}


def _dense(key: str, *path: str, bias: bool = True):
    out = [(f"{key}.weight", path + ("kernel",), KERNEL)]
    if bias:
        out.append((f"{key}.bias", path + ("bias",), AS_IS))
    return out


def _layer_norm(key: str, *path: str):
    return [(f"{key}.{leaf}", path + (leaf,), AS_IS)
            for leaf in ("scale", "bias")]


def _sequence_names(n_layers: int, block: str):
    """The token embedding, ``n_layers`` blocks (``attention`` or
    ``moe``) and the score head shared by the sequence families."""
    names = _dense("embed.dense", "TokenEmbed_0", "Dense_0")
    names.append(("embed.svc_emb", ("TokenEmbed_0", "svc_emb"), AS_IS))
    for i in range(n_layers):
        key = f"blocks.{i}"
        if block == "attention":
            p = f"AttentionBlock_{i}"
            names += _layer_norm(f"{key}.ln0", p, "LayerNorm_0")
            names += _dense(f"{key}.qkv", p, "Dense_0", bias=False)
            names += _dense(f"{key}.proj", p, "Dense_1")
            names += _layer_norm(f"{key}.ln1", p, "LayerNorm_1")
            names += _dense(f"{key}.mlp_in", p, "Dense_2")
            names += _dense(f"{key}.mlp_out", p, "Dense_3")
        else:
            p = f"MoEBlock_{i}"
            names += _layer_norm(f"{key}.ln", p, "LayerNorm_0")
            names += _dense(f"{key}.router", p, "router", bias=False)
            names += [(f"{key}.{w}", (p, w), AS_IS)
                      for w in ("w1", "b1", "w2", "b2")]
    names += _layer_norm("head.ln", "ScoreHead_0", "LayerNorm_0")
    names += _dense("head.dense", "ScoreHead_0", "Dense_0")
    names += _dense("head.out", "ScoreHead_0", "Dense_1")
    return names


def _param_names(model_name: str, n_layers: int
                 ) -> List[Tuple[str, Tuple[str, ...], bool]]:
    """``(state_dict key, flax path, is a dense kernel)`` of every
    parameter of the port's model ``model_name``."""
    names = []
    if model_name == "gcn":
        for i in range(n_layers):
            names += _dense(f"layers.{i}.dense", f"GCNLayer_{i}", "Dense_0")
        names += _dense("out", "Dense_0")
    elif model_name == "sage":
        for i in range(n_layers):
            names += _dense(f"layers.{i}.self_dense", f"Dense_{2 * i}")
            names += _dense(f"layers.{i}.neigh_dense", f"Dense_{2 * i + 1}")
        names += _dense("out", f"Dense_{2 * n_layers}")
    elif model_name == "gat":
        for i in range(n_layers):
            names += _dense(f"layers.{i}.proj", f"GATLayer_{i}", "Dense_0",
                            bias=False)
            names += [(f"layers.{i}.{a}", (f"GATLayer_{i}", a), AS_IS)
                      for a in ("a_src", "a_dst")]
        names += _dense("out", "Dense_0")
    elif model_name in ("temporal", "lru"):
        names += _dense("dense_in", "Dense_0")
        if model_name == "temporal":
            for key, gate in (("ir", "ir"), ("iz", "iz"), ("in_", "in")):
                names += _dense(f"gru.{key}", "ScanGRUCell_0", gate)
            for gate in ("hr", "hz", "hn"):
                names += _dense(f"gru.{gate}", "ScanGRUCell_0", gate,
                                bias=gate == "hn")
        else:
            names.append(("decay_logit", ("decay_logit",), AS_IS))
        for i in range(2):
            names += _dense(f"gcn.{i}.dense", f"GCNLayer_{i}", "Dense_0")
        names += _dense("out", "Dense_1")
    elif model_name in ("transformer", "linegraph"):
        names += _sequence_names(n_layers, "attention")
        if model_name == "linegraph":
            for i, key in enumerate(("edge_in", "edge_hidden", "edge_out",
                                     "mix_hidden", "mix_out")):
                names += _dense(key, f"Dense_{i}")
    elif model_name == "moe":
        names += _sequence_names(n_layers, "moe")
    else:
        raise ValueError(f"no flax mapping for model {model_name!r}")
    return names


def _flax_layers(model_name: str, tree: dict) -> int:
    if model_name == "sage":
        return (sum(k.startswith("Dense_") for k in tree) - 1) // 2
    prefix = _LAYER_PREFIX.get(model_name)
    return sum(k.startswith(prefix) for k in tree) if prefix else 0


def _from_tree(tree: dict, names) -> Dict[str, torch.Tensor]:
    out = {}
    for key, path, kernel in names:
        leaf = tree
        for p in path:
            leaf = leaf[p]
        arr = np.asarray(leaf, np.float32)
        out[key] = torch.from_numpy(np.array(arr.T if kernel else arr,
                                             order="C"))
    return out


def params_from_flax(model_name: str, params) -> Dict[str, torch.Tensor]:
    """A flax parameter tree of the JAX package's model ``model_name``
    (with or without its top ``"params"`` key; leaves numpy) -> a
    ``state_dict`` for the port's model of the same name.  A flax kernel is
    ``[in, out]``; the port's dense weight is ``[out, in]``."""
    tree = params.get("params", params)
    return _from_tree(tree, _param_names(model_name,
                                         _flax_layers(model_name, tree)))


def flax_names(model_name: str, state_dict
               ) -> List[Tuple[str, Tuple[str, ...], bool]]:
    """``(state_dict key, flax path, is a dense kernel)`` of every
    parameter of the port's model ``model_name`` whose ``state_dict`` is
    given (its layer count read from the keys)."""
    layers = {k.split(".")[1] for k in state_dict
              if k.startswith(("layers.", "blocks."))}
    return _param_names(model_name, len(layers))


def pipeline_params_from_flax(params, stage: int) -> Dict[str, torch.Tensor]:
    """The JAX pipeline's tree ``{embed, stages, head}`` (``stages``
    leaves ``[P, layers_per_stage, ...]``, each part with its ``"params"``
    key; leaves numpy) -> the ``state_dict`` of stage ``stage``'s
    ``TraceTransformer`` (``parallel.pipeline.init_pipeline``): the embed
    and the head whole, that stage's blocks as ``blocks.0 ...``."""
    def body(part):
        return part.get("params", part)
    stages = body(params["stages"])
    lps = int(np.asarray(stages["Dense_0"]["kernel"]).shape[1])
    tree = {"TokenEmbed_0": body(params["embed"]),
            "ScoreHead_0": body(params["head"])}

    def pick(node, j):
        if isinstance(node, dict):
            return {k: pick(v, j) for k, v in node.items()}
        return np.asarray(node)[stage, j]
    for j in range(lps):
        tree[f"AttentionBlock_{j}"] = pick(stages, j)
    return _from_tree(tree, _sequence_names(lps, "attention"))


def shard_state_dict(full, specs: Dict[str, Optional[int]], index: int,
                     n: int) -> Dict[str, torch.Tensor]:
    """Place ``index`` of ``n``'s slice of a full ``state_dict``: a key
    whose spec is a dimension keeps its ``index``-th of ``n`` equal
    blocks along it (a column slice, or a block of experts); a key whose
    spec is None (replicated) is copied whole."""
    out = {}
    for key, t in full.items():
        dim = specs.get(key)
        out[key] = (t.clone() if dim is None
                    else t.chunk(n, dim=dim)[index].clone())
    return out


def params_to_flax(model_name: str, state_dict) -> dict:
    """The inverse of :func:`params_from_flax`: ``{"params": ...}`` with
    numpy leaves."""
    tree: dict = {}
    for key, path, kernel in flax_names(model_name, state_dict):
        arr = state_dict[key].detach().cpu().numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr.T if kernel else arr)
    return {"params": tree}

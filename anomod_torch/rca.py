"""RCA training/eval harness: scorers trained on chaos fault labels
(counterpart of ``anomod/rca.py``; flax/optax -> ``nn.Module`` /
``torch.optim``).

Dataset: synthetic experiment corpora (many seeds per fault label; seeds
are the augmentation axis), features relative to the same-seed normal
baseline.  Targets: the culprit service from the chaos metadata
(``labels``).  Eval: top-k hit-rate and detection AUC on held-out seeds.

The dataset is built on the host (``detect.extract_features``,
``rca_features``); the model, the loss and the optimizer run on the card
(``cuda`` unless the caller passes ``device="cpu"``).  A failure on the
card raises; :func:`train_rca_resilient` reruns a run that lost its card
on the CPU, once, when its caller asks for it (``failover=True``).
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
import torch.nn.functional as F

from anomod_torch import detect, labels as labels_mod, synth
from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.graph import build_service_graph
from anomod_torch.models import (GAT, GCN, GraphSAGE, LineGraphRCA,
                                 MoERCA, TemporalGCN, TemporalLRU,
                                 TraceTransformer)
from anomod_torch.models.gnn import init_params
from anomod_torch.rca_features import (edge_feature_block, pad_edge_arrays,
                                       windowed_features)
from anomod_torch.replay import ReplayConfig
from anomod_torch.utils.checkpoint import (has_checkpoint,
                                           restore_train_state,
                                           save_train_state)

#: the model families, at the JAX package's widths (GCN 2 x 64, GraphSAGE
#: 2 x 64, GAT 2 x 32 x 4 heads; GRU and LRU 64 with a 2 x 64 GCN head;
#: transformer, MoE and line graph d 48, 2 layers, 4 heads / 8 experts
#: top-2, MLP 96, head 64)
MODELS = {"gcn": GCN, "gat": GAT, "sage": GraphSAGE,
          "temporal": TemporalGCN, "lru": TemporalLRU,
          "transformer": TraceTransformer, "moe": MoERCA,
          "linegraph": LineGraphRCA}
#: the families that score the fused windowed input ``[B, S, W, Ft + F]``
TEMPORAL = ("temporal", "lru", "transformer", "moe")


@dataclasses.dataclass
class RCASample:
    experiment: str
    x: np.ndarray          # [S, F] baseline-relative features
    x_t: np.ndarray        # [S, W, Ft] windowed temporal features
    adj: np.ndarray        # [S, S] call counts
    edge_src: np.ndarray   # [E_max] int32 (padded)
    edge_dst: np.ndarray   # [E_max] int32
    edge_mask: np.ndarray  # [E_max] bool
    target: int            # culprit service index (-1 if none)
    is_anomaly: bool
    #: [E_max, W, 4] baseline-relative PER-EDGE temporal features aligned
    #: with edge_src/edge_dst (built when edge_features=True); None
    #: otherwise
    edge_x: Optional[np.ndarray] = None


def _edge_x_relative(exp_spans, services, g, cfg,
                     base_edge: Dict[tuple, np.ndarray]) -> np.ndarray:
    """Baseline-relative per-edge features: the normal run's edge set can
    differ, so rows align by (src, dst) pair; edges unseen in the
    baseline keep their raw values (their baseline is zero traffic)."""
    raw = edge_feature_block(exp_spans, services, g, cfg)
    for i, (a, b) in enumerate(zip(g.edge_src, g.edge_dst)):
        base = base_edge.get((int(a), int(b)))
        if base is not None:
            raw[i] = raw[i] - base
    return raw


def _pick_confounders(label, services: Tuple[str, ...], seed: int,
                      n: int) -> Tuple[str, ...]:
    """Deterministic decoy services for one (label, seed): never the
    culprit."""
    cands = [s for s in services if s != label.target_service]
    rng = np.random.default_rng(synth._seed_for(label.experiment, 13) + seed)
    return tuple(rng.choice(cands, size=min(n, len(cands)), replace=False))


def experiment_seed(seed: int, experiment: str) -> int:
    """The per-(seed, experiment) generator seed of the quality corpus."""
    return seed * 1000 + synth._seed_for(experiment) % 997


def experiment_plan(testbed: str, seed: int,
                    hard: Optional[synth.HardMode] = None,
                    n_confounders: int = 0,
                    experiments: Optional[Sequence[str]] = None
                    ) -> Iterator[tuple]:
    """``(label, hard mode, generator seed)`` for every label of one
    seed: what :func:`experiment_stream` generates, for a consumer that
    needs only some of the modalities (the span-only stream generates the
    spans alone).  ``experiments`` filters by name."""
    services = synth.SN_SERVICES if testbed == "SN" else synth.TT_SERVICES
    for label in labels_mod.labels_for_testbed(testbed):
        if experiments is not None and label.experiment not in experiments:
            continue
        mode = hard or synth.HardMode()
        if n_confounders and label.is_anomaly:
            mode = dataclasses.replace(
                mode, confounders=_pick_confounders(
                    label, tuple(services), seed, n_confounders))
        yield label, mode, experiment_seed(seed, label.experiment)


def experiment_stream(testbed: str, seed: int, n_traces: int = 80,
                      hard: Optional[synth.HardMode] = None,
                      n_confounders: int = 0,
                      experiments: Optional[Sequence[str]] = None):
    """Yield ``(label, experiment)`` for every label of one seed — THE
    corpus definition for quality evaluation, shared by the dataset
    builder and the stream's quality table.  Seeds are process-stable per
    (seed, experiment) (``synth._seed_for`` is a stable hash)."""
    for label, mode, gen_seed in experiment_plan(
            testbed, seed, hard, n_confounders, experiments):
        yield label, synth.generate_experiment(
            label, n_traces=n_traces, hard=mode, seed=gen_seed)


def build_dataset(testbed: str, seeds: Sequence[int], n_traces: int = 80,
                  n_windows: int = 8,
                  hard: Optional[synth.HardMode] = None,
                  n_confounders: int = 0,
                  edge_features: bool = False
                  ) -> Tuple[List[RCASample], Tuple[str, ...]]:
    """One sample per (fault label, seed), features relative to the
    same-seed normal baseline.

    ``hard`` applies HardMode difficulty to the FAULT experiments (the
    normal baseline stays easy); ``n_confounders`` plants that many
    per-(label, seed) decoy services into each fault experiment;
    ``edge_features`` doubles the windowed block with per-service OUT-EDGE
    aggregates and builds the per-edge block.
    """
    services = tuple(synth.SN_SERVICES if testbed == "SN"
                     else synth.TT_SERVICES)
    cfg = ReplayConfig(n_services=len(services), n_windows=n_windows,
                       chunk_size=2048, window_us=300_000_000)
    samples: List[RCASample] = []
    e_max = 0
    raw: List[tuple] = []
    normal_label = next(l for l in labels_mod.labels_for_testbed(testbed)
                        if not l.is_anomaly)
    for seed in seeds:
        normal = synth.generate_experiment(normal_label, n_traces=n_traces,
                                           seed=seed * 1000)
        base_x = detect.extract_features(normal, services).x
        base_t = windowed_features(normal.spans, services, cfg,
                                   edge_features=edge_features)
        base_edge: Dict[tuple, np.ndarray] = {}
        if edge_features:
            g_n = build_service_graph(normal.spans, services=services)
            nb = edge_feature_block(normal.spans, services, g_n, cfg)
            base_edge = {(int(a), int(b)): nb[i] for i, (a, b) in
                         enumerate(zip(g_n.edge_src, g_n.edge_dst))}
        for label, exp in experiment_stream(testbed, seed, n_traces=n_traces,
                                            hard=hard,
                                            n_confounders=n_confounders):
            x = detect.extract_features(exp, services).x - base_x
            x_t = windowed_features(exp.spans, services, cfg,
                                    edge_features=edge_features) - base_t
            g = build_service_graph(exp.spans, services=services)
            e_max = max(e_max, g.n_edges)
            target = (services.index(label.target_service)
                      if label.target_service in services else -1)
            ex = (_edge_x_relative(exp.spans, services, g, cfg, base_edge)
                  if edge_features else None)
            raw.append((label.experiment, x, x_t, g, target,
                        label.is_anomaly, ex))
    for name, x, x_t, g, target, is_anom, ex in raw:
        src, dst, mask = pad_edge_arrays(g, e_max)
        if ex is not None:
            ex = np.pad(ex.astype(np.float32),
                        ((0, e_max - ex.shape[0]), (0, 0), (0, 0)))
        samples.append(RCASample(name, x.astype(np.float32), x_t,
                                 g.adj_counts, src, dst, mask, target,
                                 is_anom, edge_x=ex))
    return samples, services


def _stack(samples: List[RCASample]) -> Dict[str, np.ndarray]:
    out = {
        "x": np.stack([s.x for s in samples]),
        "x_t": np.stack([s.x_t for s in samples]),
        "adj": np.stack([s.adj for s in samples]).astype(np.float32),
        "edge_src": np.stack([s.edge_src for s in samples]),
        "edge_dst": np.stack([s.edge_dst for s in samples]),
        "edge_mask": np.stack([s.edge_mask for s in samples]),
        "target": np.array([s.target for s in samples], np.int32),
        "is_anomaly": np.array([s.is_anomaly for s in samples], np.float32),
    }
    if samples and samples[0].edge_x is not None:
        out["edge_x"] = np.stack([s.edge_x for s in samples])
    return out


def repad_edges(samples: List[RCASample], e_max: int) -> None:
    """Pad every sample's edge arrays (and per-edge features) to
    ``e_max``, in place: train and eval sets share one edge width."""
    for s in samples:
        cur = s.edge_src.shape[0]
        if cur < e_max:
            s.edge_src = np.pad(s.edge_src, (0, e_max - cur))
            s.edge_dst = np.pad(s.edge_dst, (0, e_max - cur))
            s.edge_mask = np.pad(s.edge_mask, (0, e_max - cur))
            if s.edge_x is not None:
                s.edge_x = np.pad(s.edge_x,
                                  ((0, e_max - cur), (0, 0), (0, 0)))


def standardize_features(train: Dict[str, np.ndarray],
                         evals: Sequence[Dict[str, np.ndarray]]) -> None:
    """Standardize x/x_t (and edge_x when present) on train statistics,
    in place (shared with eval)."""
    for key in ("x", "x_t", "edge_x"):
        if key not in train:
            continue
        axes = tuple(range(train[key].ndim - 1))  # all but the feature axis
        mu = train[key].mean(axis=axes, keepdims=True)
        sd = train[key].std(axis=axes, keepdims=True) + 1e-6
        train[key] = (train[key] - mu) / sd
        for ev in evals:
            if key in ev:
                ev[key] = (ev[key] - mu) / sd


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """A stacked batch as tensors on ``device`` (copied)."""
    return {k: torch.tensor(v, device=device) for k, v in batch.items()}


def topk_eval(scores: np.ndarray,
              batch: Dict[str, np.ndarray]) -> Tuple[float, float, float, int]:
    """(top1, top3, detection_auc, n_rca) from [B, S] scores vs labels.
    AUC is rank-based (max score as the experiment-level statistic)."""
    tgt = batch["target"]
    rca_mask = tgt >= 0
    order = np.argsort(-scores, axis=-1)
    rank = np.array([np.where(order[i] == tgt[i])[0][0] if rca_mask[i] else -1
                     for i in range(len(tgt))])
    top1 = float((rank[rca_mask] == 0).mean()) if rca_mask.any() else 0.0
    top3 = float((rank[rca_mask] < 3).mean()) if rca_mask.any() else 0.0
    det = scores.max(axis=-1)
    y = batch["is_anomaly"]
    pos, neg = det[y > 0], det[y == 0]
    auc = float((pos[:, None] > neg[None, :]).mean()) \
        if len(neg) and len(pos) else 1.0
    return top1, top3, auc, int(rca_mask.sum())


def rca_loss(scores: torch.Tensor, batch: Dict[str, torch.Tensor],
             totals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> torch.Tensor:
    """Training objective: CE over culprit services (where a chaos label
    names one) + 0.3 x detection BCE on the max score.

    ``totals`` = ``(samples with a target, samples)`` of the whole batch
    when ``batch`` is one data-parallel shard of it: the shard's terms are
    then divided by the whole batch's counts, so the shards' values sum
    to the loss of the whole batch (shards hold different numbers of
    targets, and the mean of their own losses is another function)."""
    target = batch["target"].long()
    has_target = (target >= 0).to(scores.dtype)
    logp = F.log_softmax(scores, dim=-1)
    tgt = target.clamp(0, scores.shape[-1] - 1)
    ce = -logp.gather(1, tgt[:, None])[:, 0]
    n_target, n_samples = ((has_target.sum(), scores.shape[0])
                           if totals is None else totals)
    rca = (ce * has_target).sum() / n_target.clamp(min=1.0)
    # amax, like jnp.max, shares the gradient among tied maxima
    det = F.binary_cross_entropy_with_logits(
        scores.amax(dim=-1), batch["is_anomaly"], reduction="sum") / n_samples
    return rca + 0.3 * det


def _check_model(model_name: str) -> None:
    if model_name not in MODELS:
        raise ValueError(f"model {model_name!r} is not ported (have: "
                         f"{', '.join(MODELS)})")


def _widths(model_name: str,
            shapes: Union[int, Mapping[str, np.ndarray]]) -> dict:
    """The constructor's widths of ``model_name`` from ``shapes``: the
    feature count of ``x`` (enough for the GNNs), or a batch (stacked or
    one sample) whose arrays give every family its widths."""
    if isinstance(shapes, int):
        if model_name in ("gcn", "gat", "sage"):
            return {"in_features": shapes}
        raise ValueError(f"model {model_name!r} takes its widths from a "
                         "batch's arrays, not a feature count")
    n_services, n_static = shapes["x"].shape[-2:]
    n_temporal = shapes["x_t"].shape[-1]
    if model_name in ("gcn", "gat", "sage"):
        return {"in_features": n_static}
    if model_name in ("temporal", "lru"):
        return {"in_features": n_temporal + n_static}
    if model_name in ("transformer", "moe"):
        return {"in_features": n_temporal + n_static,
                "n_services": n_services}
    if "edge_x" not in shapes:
        raise ValueError(_NEEDS_EDGE_X)
    return {"static_features": n_static, "temporal_features": n_temporal,
            "n_services": n_services,
            "edge_features": shapes["edge_x"].shape[-1]}


def make_model(model_name: str,
               shapes: Union[int, Mapping[str, np.ndarray]]
               ) -> torch.nn.Module:
    """The named scorer of :data:`MODELS`, parameters not yet drawn
    (:func:`init_model`), at the widths of ``shapes``: the feature count
    of ``x`` for the GNNs, else a batch's (or one sample's) arrays.
    Raises ``ValueError`` for another name."""
    _check_model(model_name)
    return MODELS[model_name](**_widths(model_name, shapes))


def init_model(model_name: str,
               shapes: Union[int, Mapping[str, np.ndarray]], seed: int = 0,
               device: DeviceLike = None) -> torch.nn.Module:
    """:func:`make_model` with its parameters drawn flax-style from
    ``torch.Generator().manual_seed(seed)`` on the host, then moved to
    ``device``: the same draw on every device."""
    model = init_params(make_model(model_name, shapes),
                        torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device))


_NEEDS_EDGE_X = ("the linegraph model needs per-edge features "
                 "(build_dataset(edge_features=True) / quality sweeps with "
                 "edge_aware)")


def fused_features(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``[B, S, W, Ft + F]``: the windowed features with the static ones
    repeated into every window (the temporal and sequence families'
    input)."""
    x_t = batch["x_t"]
    return torch.cat(
        [x_t, batch["x"][:, :, None, :].expand(-1, -1, x_t.shape[2], -1)],
        dim=-1)


def apply_model(model_name: str, model: torch.nn.Module,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[B, S] culprit logits of a batch.  The temporal and sequence
    families score the windowed features with the static ones repeated
    into every window (``[B, S, W, Ft + F]``); the line graph reads the
    per-edge features too and raises without them."""
    if model_name == "gcn":
        return model(batch["x"], batch["adj"])
    if model_name == "linegraph":
        if "edge_x" not in batch:
            raise ValueError(_NEEDS_EDGE_X)
        return model(batch["x"], batch["x_t"], batch["edge_x"],
                     batch["edge_src"], batch["edge_dst"], batch["edge_mask"])
    if model_name in TEMPORAL:
        return model(fused_features(batch), batch["adj"])
    return model(batch["x"], batch["edge_src"], batch["edge_dst"],
                 batch["edge_mask"])


def make_optimizer(model: torch.nn.Module, lr: float = 3e-3):
    """AdamW as ``optax.adamw(lr, weight_decay=1e-4)`` sets it up."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def train_loop(model_name: str, model: torch.nn.Module, optimizer,
               batch: Dict[str, torch.Tensor], start_ep: int, epochs: int,
               save: Optional[Callable[[int], None]] = None,
               save_every: int = 50, verbose: bool = False) -> List[float]:
    """Epochs ``[start_ep, epochs)`` of full-batch training from the
    model's current parameters and the optimizer's current state; returns
    each epoch's loss (before its update).  ``save(completed)`` is called
    every ``save_every`` epochs and once at the end (unless that state was
    just saved; ``save_every <= 0`` = final save only)."""
    losses = []
    last_saved = start_ep
    for ep in range(start_ep, epochs):
        optimizer.zero_grad()
        loss = rca_loss(apply_model(model_name, model, batch), batch)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
        if verbose and ep % 20 == 0:
            print(f"epoch {ep}: loss {float(loss):.4f}")
        if save is not None and save_every > 0 and (ep + 1) % save_every == 0:
            save(ep + 1)
            last_saved = ep + 1
    if save is not None and start_ep < epochs and last_saved != epochs:
        # a no-op resume must not rewind the counter either
        save(epochs)
    return torch.stack(losses).cpu().tolist() if losses else []


@dataclasses.dataclass
class TrainResult:
    model_name: str
    top1: float
    top3: float
    detection_auc: float
    n_eval: int
    params: object          # the trained model's state_dict
    #: each epoch's loss (before its update), from this call's epochs
    losses: List[float] = dataclasses.field(default_factory=list)


def prepare_data(testbed: str, train_seeds: Sequence[int],
                 eval_seeds: Sequence[int], n_traces: int = 80,
                 edge_features: bool = False
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The stacked, standardized ``(train, eval)`` batches of
    :func:`train_rca` (host numpy; built once, reusable across models;
    ``edge_features`` for the line graph)."""
    train_samples, _ = build_dataset(testbed, train_seeds, n_traces,
                                     edge_features=edge_features)
    eval_samples, _ = build_dataset(testbed, eval_seeds, n_traces,
                                    edge_features=edge_features)
    e_max = max(train_samples[0].edge_src.shape[0],
                eval_samples[0].edge_src.shape[0])
    repad_edges(train_samples, e_max)
    repad_edges(eval_samples, e_max)
    train, evalb = _stack(train_samples), _stack(eval_samples)
    standardize_features(train, [evalb])
    return train, evalb


def fit(model_name: str, train: Dict[str, np.ndarray],
        evalb: Dict[str, np.ndarray], model: torch.nn.Module,
        epochs: int = 150, lr: float = 3e-3, verbose: bool = False,
        checkpoint_dir=None, resume: bool = False, save_every: int = 50,
        meta: Optional[dict] = None) -> TrainResult:
    """Train ``model`` (its current parameters are the initial ones, on
    its device) on the prepared batches and evaluate it on ``evalb``.

    ``checkpoint_dir`` persists params + optimizer state + the completed
    epoch count every ``save_every`` epochs and at the end; with
    ``resume=True`` training continues from the saved epoch.  ``meta``
    (model, testbed) is stored with each save, and a checkpoint whose
    meta disagrees is refused."""
    device = next(model.parameters()).device
    optimizer = make_optimizer(model, lr)
    meta = dict(meta or {"model": model_name})
    start_ep = 0
    if checkpoint_dir is not None and resume:
        # no checkpoint yet = first attempt of an always-pass-resume job
        if has_checkpoint(checkpoint_dir):
            params, opt_state, start_ep, saved = \
                restore_train_state(checkpoint_dir)
            for key, want in meta.items():
                if saved.get(key) not in (None, want):
                    raise ValueError(
                        f"checkpoint at {checkpoint_dir} was trained with "
                        f"{key}={saved.get(key)!r}, not {want!r}")
            model.load_state_dict(params)
            optimizer.load_state_dict(opt_state)
            if verbose:
                print(f"resumed from epoch {start_ep}")
        elif verbose:
            print(f"no checkpoint at {checkpoint_dir} yet; starting fresh")

    def save(completed: int) -> None:
        save_train_state(checkpoint_dir, model.state_dict(),
                         optimizer.state_dict(), completed, meta=meta)

    losses = train_loop(model_name, model, optimizer,
                        to_device(train, device), start_ep, epochs,
                        save=save if checkpoint_dir is not None else None,
                        save_every=save_every, verbose=verbose)
    with torch.no_grad():
        scores = apply_model(model_name, model,
                             to_device(evalb, device)).cpu().numpy()
    top1, top3, auc, n_eval = topk_eval(scores, evalb)
    return TrainResult(model_name=model_name, top1=top1, top3=top3,
                       detection_auc=auc, n_eval=n_eval,
                       params=model.state_dict(), losses=losses)


def train_rca(testbed: str = "TT", model_name: str = "gcn",
              train_seeds: Sequence[int] = range(8),
              eval_seeds: Sequence[int] = range(100, 104),
              epochs: int = 150, lr: float = 3e-3,
              n_traces: int = 80, verbose: bool = False,
              checkpoint_dir=None, resume: bool = False,
              save_every: int = 50,
              device: DeviceLike = None) -> TrainResult:
    """Train an RCA scorer of :data:`MODELS` on chaos labels; report
    held-out top-k.

    The entry point of the ``rca`` command: builds the dataset on the
    host (with the per-edge features for ``linegraph``, as the JAX
    package does), draws the model's parameters from ``torch.Generator``
    seed 0 (the JAX package's ``PRNGKey(0)``), trains on ``device``
    (``cuda`` unless ``cpu`` is asked for) and evaluates on
    ``eval_seeds``.  ``checkpoint_dir`` / ``resume`` / ``save_every`` as
    in :func:`fit`.  The device is resolved after the host dataset is
    built, so that a probe of the card runs beside that work."""
    _check_model(model_name)
    train, evalb = prepare_data(testbed, train_seeds, eval_seeds, n_traces,
                                edge_features=model_name == "linegraph")
    model = init_model(model_name, train, 0, resolve_device(device))
    return fit(model_name, train, evalb, model, epochs=epochs, lr=lr,
               verbose=verbose, checkpoint_dir=checkpoint_dir, resume=resume,
               save_every=save_every,
               meta={"model": model_name, "testbed": testbed})


def train_rca_resilient(*args, resume: bool = False, checkpoint_dir=None,
                        failover: bool = False, device: DeviceLike = None,
                        **kwargs) -> Tuple[TrainResult, Optional[str]]:
    """:func:`train_rca` with the opt-in CPU failover.

    With ``failover=True``, a training run on the card that dies because
    the card was lost (``utils.platform.is_backend_loss``) reruns once on
    the CPU.  The retry resumes ONLY from a checkpoint this call itself
    published (its ``checkpoint_mtime`` at or after the call's start): a
    stale checkpoint left by an earlier run is not resumed into a
    "freshly trained" result, and with none the retry trains from
    scratch.  With ``failover=False`` (the default) a loss raises.

    Returns ``(result, failover_note)``: the note is None on the clean
    path and one line saying where the retry ran from when it ran."""
    import time

    from anomod_torch.utils.checkpoint import checkpoint_mtime
    from anomod_torch.utils.platform import with_cpu_failover

    t_start = time.time()
    tried = []
    note = []

    def _saved_this_run() -> bool:
        if not checkpoint_dir:
            return False
        m = checkpoint_mtime(checkpoint_dir)
        return m is not None and m >= t_start

    def _attempt(dev):
        do_resume = resume if not tried else (resume or _saved_this_run())
        tried.append(1)
        return train_rca(*args, resume=do_resume,
                         checkpoint_dir=checkpoint_dir, device=dev, **kwargs)

    def _on_failover(exc):
        # the retry resumes only when a restorable checkpoint exists at
        # retry time AND the resume gate passes: "--resume with an empty
        # dir, died before the first save" trains from scratch, and says so
        will_resume = ((resume or _saved_this_run())
                       and checkpoint_dir is not None
                       and checkpoint_mtime(checkpoint_dir) is not None)
        note.append(f"device backend lost mid-train ({type(exc).__name__});"
                    f" retried on the CPU failover backend"
                    + (" from the last checkpoint"
                       if will_resume else " from scratch"))

    result = with_cpu_failover(_attempt, device, allow=failover,
                               on_failover=_on_failover)
    return result, (note[0] if note else None)

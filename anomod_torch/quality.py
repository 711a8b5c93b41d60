"""De-saturated quality benchmark (counterpart of ``anomod/quality.py``):
degradation curves over fault severity and a train-shift / eval-shift
table, on the hard axes of ``synth.HardMode``.

At full strength every model and the z-score baseline reach top-1 1.0,
so nothing can rank the models.  These sweeps evaluate at mild effects
(``severity``), wider baselines (``noise``) and decoy services
(``confounders``): each learned model trains ONCE on a mixed-severity
corpus (full, mid and low thirds of the train seeds) and is evaluated at
every sweep point on held-out seeds; the z-score detector and the
multimodal stream detector run as the training-free rows, on the same
corpora (``rca.experiment_stream``).

Training and scoring run on the card (``cuda`` unless the caller passes
``device="cpu"``); corpora and the finished cells stay in numpy.  A
failure on the card raises, unless the caller asked for the failover
(``failover=True``): then a learned row whose card was lost mid-row
(``utils.platform.with_cpu_failover``) is redone on the CPU, the rows
after it run on the CPU too, and :data:`LAST_FAILOVER` says so.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from anomod_torch import detect, synth
from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.rca import (_stack, apply_model, build_dataset,
                              experiment_stream, init_model, make_optimizer,
                              standardize_features, to_device, topk_eval,
                              train_loop)
from anomod_torch.utils.platform import with_cpu_failover

#: The default sweep grid: full-strength down to the hard regime.
SEVERITIES = (1.0, 0.4, 0.2, 0.1, 0.05)

#: Set to a one-line note when the most recent sweep lost its card
#: mid-run and completed on the CPU (``failover=True`` only); the CLI
#: copies it into the capture record so a mixed-device table is labeled
#: as such.  Reset at each sweep's start.
LAST_FAILOVER: Optional[str] = None

#: The de-saturated operating point: mild effects + decoys + noise.
HARD_POINT = dict(severity=0.12, noise=0.5, n_confounders=2)

#: Named distribution shifts for the train-shift/eval-shift table: models
#: train on the default effect model ("in-dist") and are evaluated under
#: each shifted generator (``synth.HardMode``'s effect_shape /
#: fault_profile / fault_locus axes).
SHIFTS: Dict[str, Dict[str, str]] = {
    "in-dist": {},
    "additive": {"effect_shape": "add"},
    "tail-only": {"effect_shape": "tail"},
    "bursty": {"fault_profile": "bursty"},
    "partial-window": {"fault_profile": "partial"},
    "edge-locus": {"fault_locus": "edge"},
}

#: the rows that need no training
TRAINING_FREE = ("zscore", "stream")
#: the rows a sweep runs unless told otherwise (the JAX CLI's)
DEFAULT_MODELS = ("zscore", "gcn", "gat", "sage", "temporal", "lru",
                  "transformer", "moe")

Cell = Tuple[float, float, float, int]


@dataclasses.dataclass
class QualityPoint:
    model: str
    severity: float
    noise: float
    n_confounders: int
    top1: float
    top3: float
    detection_auc: float
    n_eval: int
    shift: str = "in-dist"


def _repad_edges(stacked: Dict[str, np.ndarray], e_max: int) -> None:
    cur = stacked["edge_src"].shape[1]
    if cur < e_max:
        pad = ((0, 0), (0, e_max - cur))
        for k in ("edge_src", "edge_dst"):
            stacked[k] = np.pad(stacked[k], pad)
        stacked["edge_mask"] = np.pad(stacked["edge_mask"], pad)
        if "edge_x" in stacked:
            stacked["edge_x"] = np.pad(
                stacked["edge_x"], pad + ((0, 0), (0, 0)))


def _train_model(model_name: str, train: Dict[str, np.ndarray],
                 epochs: int = 150, lr: float = 3e-3,
                 device: DeviceLike = None) -> torch.nn.Module:
    """Full-batch AdamW (``rca.make_optimizer``) from the model's draw of
    generator seed 0, on ``device``."""
    dev = resolve_device(device)
    model = init_model(model_name, train, seed=0, device=dev)
    train_loop(model_name, model, make_optimizer(model, lr),
               to_device(train, dev), 0, epochs)
    return model


def _rank_auc(pos, neg) -> float:
    p, q = np.asarray(pos), np.asarray(neg)
    return float((p[:, None] > q[None, :]).mean()) \
        if len(p) and len(q) else 1.0


def _zscore_eval(testbed: str, seeds: Sequence[int], hard: synth.HardMode,
                 n_confounders: int, n_traces: int,
                 device: DeviceLike = None) -> Cell:
    """Training-free z-score detector over the hard corpora
    (``detect.evaluate_corpus`` a seed, averaged), on the corpora the
    learned models are scored on.  The detection statistic is the
    rank-based AUC over experiment scores, as ``rca.topk_eval``'s."""
    top1s, top3s, aucs, n = [], [], [], 0
    for seed in seeds:
        exps = [exp for _, exp in experiment_stream(
            testbed, seed, n_traces=n_traces, hard=hard,
            n_confounders=n_confounders)]
        s = detect.evaluate_corpus(exps, device=device)
        top1s.append(s.top1)
        top3s.append(s.top3)
        aucs.append(_rank_auc(
            [r.score for r in s.results if r.is_anomaly_true],
            [r.score for r in s.results if not r.is_anomaly_true]))
        n += s.n_rca_cases
    return (float(np.mean(top1s)), float(np.mean(top3s)),
            float(np.mean(aucs)), n)


def _stream_eval(testbed: str, seeds: Sequence[int], hard: synth.HardMode,
                 n_confounders: int, n_traces: int,
                 device: DeviceLike = None, **detector_kw) -> Cell:
    """Training-free multimodal streaming detector over the same corpora
    (its chunk fold is the dense replay kernel on the card), with the
    same contract as :func:`_zscore_eval`.  ``detector_kw`` goes to
    ``stream_experiment_multimodal`` (``replay_factory``, for one)."""
    from anomod_torch.stream import stream_experiment_multimodal
    top1s, top3s, aucs, n = [], [], [], 0
    for seed in seeds:
        hits1 = hits3 = cases = 0
        pos, neg = [], []
        for label, exp in experiment_stream(
                testbed, seed, n_traces=n_traces, hard=hard,
                n_confounders=n_confounders):
            det = stream_experiment_multimodal(exp, device=device,
                                               **detector_kw)
            score = max((a.score for a in det.alerts), default=0.0)
            (pos if label.is_anomaly else neg).append(score)
            if label.is_anomaly and label.target_service:
                ranked = det.ranked_services()
                hits1 += bool(ranked) and ranked[0] == label.target_service
                hits3 += label.target_service in ranked[:3]
                cases += 1
        top1s.append(hits1 / cases if cases else 0.0)
        top3s.append(hits3 / cases if cases else 0.0)
        aucs.append(_rank_auc(pos, neg))
        n += cases
    return (float(np.mean(top1s)), float(np.mean(top3s)),
            float(np.mean(aucs)), n)


def severity_sweep(testbed: str = "TT",
                   model_names: Sequence[str] = DEFAULT_MODELS,
                   severities: Sequence[float] = SEVERITIES,
                   train_seeds: Sequence[int] = range(6),
                   eval_seeds: Sequence[int] = range(100, 103),
                   n_traces: int = 60, epochs: int = 120,
                   noise: float = 0.5, n_confounders: int = 2,
                   verbose: bool = False,
                   device: DeviceLike = None,
                   failover: bool = False) -> List[QualityPoint]:
    """Degradation curves: train once on mixed severity, evaluate at each
    severity with noise and confounders.  One QualityPoint per (model,
    severity).  ``failover``: the opt-in CPU failover of the learned
    rows (module docstring)."""
    eval_modes = {sev: synth.HardMode(severity=sev, noise=noise)
                  for sev in severities}
    cells = _eval_grid(testbed, model_names, eval_modes, train_seeds,
                       eval_seeds, n_traces, epochs, noise, n_confounders,
                       verbose, device=device, failover=failover)
    return [QualityPoint(name, sev, noise, n_confounders, *cell)
            for (name, sev), cell in cells.items()]


def shift_sweep(testbed: str = "TT",
                model_names: Sequence[str] = DEFAULT_MODELS,
                shifts: Sequence[str] = tuple(SHIFTS),
                severity: float = 0.3,
                train_seeds: Sequence[int] = range(6),
                eval_seeds: Sequence[int] = range(100, 103),
                n_traces: int = 60, epochs: int = 120,
                noise: float = 0.5, n_confounders: int = 2,
                verbose: bool = False, edge_aware: bool = False,
                device: DeviceLike = None,
                failover: bool = False) -> List[QualityPoint]:
    """Train-shift/eval-shift table: models train ONCE on the default
    effect model (the mixed-severity corpus of :func:`severity_sweep`)
    and are evaluated under each generator of :data:`SHIFTS` at one
    severity.  ``edge_aware``: out-edge feature blocks, per-edge features
    and a node + edge mixed-locus training corpus (the line graph's
    setting); ``failover`` as in :func:`severity_sweep`."""
    eval_modes = {name: synth.HardMode(severity=severity, noise=noise,
                                       **SHIFTS[name])
                  for name in shifts}
    cells = _eval_grid(testbed, model_names, eval_modes, train_seeds,
                       eval_seeds, n_traces, epochs, noise, n_confounders,
                       verbose, edge_features=edge_aware,
                       train_loci=("node", "edge") if edge_aware
                       else ("node",), device=device, failover=failover)
    return [QualityPoint(name, severity, noise, n_confounders, *cell,
                         shift=shift)
            for (name, shift), cell in cells.items()]


def _grid_batches(testbed, eval_modes: Dict[object, synth.HardMode],
                  train_seeds, eval_seeds, n_traces, noise, n_confounders,
                  edge_features=False, train_loci=("node",)
                  ) -> Tuple[Dict[str, np.ndarray],
                             Dict[object, Dict[str, np.ndarray]]]:
    """The learned rows' host batches: the mixed-severity training corpus
    (full + mid + low thirds of the train seeds, each training locus) and
    one held-out batch an eval mode, every edge axis padded to one width
    and the features standardized on the training statistics."""
    thirds = np.array_split(np.asarray(list(train_seeds)), 3)
    train_parts = []
    for sev, part in zip((1.0, 0.4, 0.15), thirds):
        if len(part) == 0:
            continue
        for locus in train_loci:
            samples, _ = build_dataset(
                testbed, [int(s) for s in part], n_traces=n_traces,
                hard=synth.HardMode(severity=sev, noise=noise,
                                    fault_locus=locus),
                n_confounders=n_confounders, edge_features=edge_features)
            train_parts.append(_stack(samples))
    e_max = max(p["edge_src"].shape[1] for p in train_parts)
    for p in train_parts:
        _repad_edges(p, e_max)
    train = {k: np.concatenate([p[k] for p in train_parts])
             for k in train_parts[0]}
    eval_batches: Dict[object, Dict[str, np.ndarray]] = {}
    for key, mode in eval_modes.items():
        samples, _ = build_dataset(testbed, eval_seeds, n_traces=n_traces,
                                   hard=mode, n_confounders=n_confounders,
                                   edge_features=edge_features)
        ev = _stack(samples)
        e_max = max(e_max, ev["edge_src"].shape[1])
        eval_batches[key] = ev
    _repad_edges(train, e_max)
    for ev in eval_batches.values():
        _repad_edges(ev, e_max)
    standardize_features(train, list(eval_batches.values()))
    return train, eval_batches


def _eval_grid(testbed, model_names, eval_modes: Dict[object,
                                                      synth.HardMode],
               train_seeds, eval_seeds, n_traces, epochs, noise,
               n_confounders, verbose=False, edge_features=False,
               train_loci=("node",), device: DeviceLike = None,
               failover: bool = False
               ) -> Dict[Tuple[str, object], Cell]:
    """The sweep engine: one mixed-severity training pass a learned model
    (:func:`_grid_batches`), then every model evaluated on every
    eval-mode corpus.  Returns ``{(model, mode_key): (top1, top3, auc,
    n_eval)}``; the corpora a cell scores are the same for every model.

    Each learned row (train + every eval) runs under
    ``with_cpu_failover(allow=failover)``: host input, host output, so a
    row whose card was lost is redone wholesale on the CPU.  A card that
    lost its context does not come back in this process, so every row
    after a failover runs on the CPU too.  The training-free rows are not
    wrapped."""
    global LAST_FAILOVER
    LAST_FAILOVER = None
    dev = resolve_device(device)
    if any(name not in TRAINING_FREE for name in model_names):
        train, eval_batches = _grid_batches(
            testbed, eval_modes, train_seeds, eval_seeds, n_traces, noise,
            n_confounders, edge_features, train_loci)

    def _train_and_eval(name, where):
        row = {}
        model = _train_model(name, train, epochs=epochs, device=where)
        with torch.no_grad():
            for key, ev in eval_batches.items():
                scores = apply_model(name, model,
                                     to_device(ev, where)).cpu().numpy()
                row[(name, key)] = topk_eval(scores, ev)
        return row

    def _note_failover(exc, model):
        global LAST_FAILOVER
        LAST_FAILOVER = (f"device backend lost mid-sweep at model "
                         f"{model!r} ({type(exc).__name__}); remaining "
                         f"rows completed on the CPU failover backend")
        print(f"[anomod_torch.quality] {LAST_FAILOVER}", file=sys.stderr)

    cells: Dict[Tuple[str, object], Cell] = {}
    for name in model_names:
        if name in TRAINING_FREE:
            ev_fn = _zscore_eval if name == "zscore" else _stream_eval
            for key, mode in eval_modes.items():
                cells[(name, key)] = ev_fn(testbed, eval_seeds, mode,
                                           n_confounders, n_traces,
                                           device=dev)
                if verbose:
                    print(f"{name} {key}: top1={cells[(name, key)][0]:.2f}")
            continue
        row = with_cpu_failover(
            lambda where, _n=name: _train_and_eval(_n, where), dev,
            allow=failover,
            on_failover=lambda e, _n=name: _note_failover(e, _n))
        if LAST_FAILOVER is not None:
            dev = torch.device("cpu")
        cells.update(row)
        if verbose:
            for (n, key), cell in row.items():
                print(f"{n} {key}: top1={cell[0]:.2f}")
    return cells


def render_shift_markdown(points: Sequence[QualityPoint]) -> str:
    """Train-shift/eval-shift table: one row per model, one top1 column per
    shifted generator (training is always in-distribution)."""
    shifts = list(dict.fromkeys(p.shift for p in points))
    models: Dict[str, Dict[str, QualityPoint]] = {}
    for p in points:
        models.setdefault(p.model, {})[p.shift] = p
    head = "| model | " + " | ".join(f"top1 {s}" for s in shifts) + " |"
    rows = [head, "|" + "---|" * (1 + len(shifts))]
    for name, by_shift in models.items():
        cells = " | ".join(f"{by_shift[s].top1:.2f}" if s in by_shift else "-"
                           for s in shifts)
        rows.append(f"| {name} | {cells} |")
    return "\n".join(rows)


def render_markdown(points: Sequence[QualityPoint]) -> str:
    """Degradation-curve table: one row per model, one column per severity."""
    severities = sorted({p.severity for p in points}, reverse=True)
    models: Dict[str, Dict[float, QualityPoint]] = {}
    for p in points:
        models.setdefault(p.model, {})[p.severity] = p
    head = "| model | " + " | ".join(f"top1@{s:g}" for s in severities) + \
        " | " + " | ".join(f"top3@{s:g}" for s in severities) + " |"
    sep = "|" + "---|" * (1 + 2 * len(severities))
    rows = [head, sep]
    for name, by_sev in models.items():
        t1 = " | ".join(f"{by_sev[s].top1:.2f}" if s in by_sev else "-"
                        for s in severities)
        t3 = " | ".join(f"{by_sev[s].top3:.2f}" if s in by_sev else "-"
                        for s in severities)
        rows.append(f"| {name} | {t1} | {t3} |")
    return "\n".join(rows)

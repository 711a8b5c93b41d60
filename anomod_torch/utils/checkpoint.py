"""Checkpoint / resume for RCA training (counterpart of
``anomod/utils/checkpoint.py``), on ``torch.save``.

A training state is ``(params, opt_state)``: the model's ``state_dict``
and the optimizer's, moved to the host before they are written.

Crash-safety contract: each save writes the full state into a fresh
``v<step>`` version directory FIRST, then publishes it by ``os.replace``-ing
``meta.json`` (whose ``version`` field names the live directory), then
removes older versions.  A kill at any point leaves ``meta.json``
referencing a complete state — the previous one if the new version was not
published yet — so a checkpointed run is always resumable.  ``step`` is
the number of completed epochs, and caller ``meta`` cannot clobber it.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

_STATE = "state.pt"


def _to_host(tree: Any) -> Any:
    """A nested dict / list of tensors with every tensor copied to the
    host."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_train_state(path, params: Any, opt_state: Any, step: int,
                     meta: Optional[dict] = None) -> str:
    """Persist a training state; returns the backend used (``"torch"``).

    Writes ``path/v<step>/state.pt`` first, publishes it by atomically
    replacing ``path/meta.json``, then removes superseded versions."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    version = f"v{step}"
    state_dir = path / version
    state_dir.mkdir(parents=True, exist_ok=True)
    tmp_state = state_dir / (_STATE + ".tmp")
    torch.save({"params": _to_host(params),
                "opt_state": _to_host(opt_state)}, tmp_state)
    os.replace(tmp_state, state_dir / _STATE)
    # publish: meta written to a temp file then atomically moved into
    # place; caller meta must not clobber the step/version keys
    tmp = path / "meta.json.tmp"
    tmp.write_text(json.dumps({**(meta or {}),
                               "step": step, "version": version}))
    os.replace(tmp, path / "meta.json")
    for old in path.glob("v*"):
        if old.name != version and old.is_dir():
            shutil.rmtree(old, ignore_errors=True)
    return "torch"


def restore_train_state(path) -> Tuple[Any, Any, int, dict]:
    """Restore ``(params, opt_state, step, meta)``; tensors land on the
    host (``load_state_dict`` moves them to the model's device)."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    step = int(meta.pop("step", 0))
    state_dir = path / meta.pop("version")
    state = torch.load(state_dir / _STATE, map_location="cpu",
                       weights_only=True)
    return state["params"], state["opt_state"], step, meta


def checkpoint_mtime(path) -> Optional[float]:
    """Publish time (meta.json mtime) of the live checkpoint, or None.

    meta.json is atomically replaced as the LAST step of every save, so its
    mtime is the moment the checkpoint became live."""
    path = Path(path)
    if not has_checkpoint(path):
        return None
    try:
        return (path / "meta.json").stat().st_mtime
    except OSError:
        return None


def has_checkpoint(path) -> bool:
    """True when a published AND restorable checkpoint exists at
    ``path``: a ``meta.json`` that names a version whose state file is
    there."""
    meta_file = Path(path) / "meta.json"
    if not meta_file.exists():
        return False
    try:
        meta = json.loads(meta_file.read_text())
    except (OSError, ValueError):
        return False
    return "version" in meta \
        and (Path(path) / meta["version"] / _STATE).exists()

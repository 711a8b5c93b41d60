"""Device selection for the port (counterpart of ``anomod/backend.py``).

The port's entry points run on the card.  The host is used only when the
caller says so (``device="cpu"``, as the CPU tests do): a run that asked
for no device and finds no CUDA raises instead of quietly measuring the
host.

The JAX package's ``backend={cpu, jax}`` switch maps onto the ``device``
argument every entry point takes: ``cpu`` (the numpy oracle) is
``device="cpu"``, the plain PyTorch versions on the host; ``jax`` /
``jax-tpu`` / ``tpu`` are the card, ``device="cuda"`` (the default).  The
probe of the card and the opt-in CPU failover live in
:mod:`anomod_torch.utils.platform`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from anomod_torch.utils.platform import await_probe

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked for explicitly.

    Raises ``RuntimeError`` when CUDA is wanted (by default or by name)
    and this process has no CUDA device.  A probe of the card started
    beside the caller's host work (``utils.platform.start_probe``) is
    joined first, so a dead card raises its diagnostic before CUDA is
    touched here."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        await_probe()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "host explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda|cpu)")
    return dev


def device_name(dev: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``cpu``."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

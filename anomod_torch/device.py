"""Device selection for the port (counterpart of ``anomod/utils/platform.py``).

The port's entry points run on the card.  The host is used only when the
caller says so (``device="cpu"``, as the CPU tests do): a run that asked
for no device and finds no CUDA raises instead of quietly measuring the
host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked for explicitly.

    Raises ``RuntimeError`` when CUDA is wanted (by default or by name)
    and this process has no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "host explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda|cpu)")
    return dev

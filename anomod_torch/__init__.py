"""anomod_torch — the PyTorch/CUDA port of anomod for one NVIDIA H100.

The JAX package ``anomod`` stays the reference; this package mirrors its
module names (``replay``, ``stream``, ``synth`` ...) and imports nothing
from it.  Device compute runs on ``cuda`` by default: the replay fold is a
pair of hand-written CUDA kernels (``anomod_torch/csrc/replay.cu``, bound in
``anomod_torch.ops.replay_kernels``) with a plain PyTorch version beside
each, which the CPU path and the parity tests use.
"""

from anomod_torch.device import resolve_device

__all__ = ["resolve_device"]

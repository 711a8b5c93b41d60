"""The port's counterparts of ``anomod/parallel`` on ``torch.distributed``:
the mesh and its launcher (``mesh``), the collectives, the sharded batch
replay (``replay``) and the sharded streaming plane (``stream``), plus the
single-device cores the sequence models call (``full_attention``,
``linear_recurrence``).  ``multihost``, ``train``, ``pipeline``, the mesh
halves of ``ring_attention`` and ``seqscan``, ``ulysses`` and
``sp_transformer`` are not ported yet."""

from anomod_torch.parallel.mesh import Mesh, launch, make_mesh, shard_chunks
from anomod_torch.parallel.replay import (make_sharded_replay_fn,
                                          sharded_throughput, stage_sharded)

__all__ = ["Mesh", "launch", "make_mesh", "shard_chunks",
           "make_sharded_replay_fn", "stage_sharded", "sharded_throughput"]

"""The port's counterparts of ``anomod/parallel`` on ``torch.distributed``
(one process a device, every rank running the same program): the mesh and
its launcher (``mesh``), the collectives (plain and differentiable), the
sharded batch replay (``replay``) and streaming plane (``stream``), the
multi-host hybrid mesh (``multihost``), dp x tp x ep training
(``train``), the GPipe pipeline (``pipeline``), the sequence-parallel
planes (ring and Ulysses attention, the sequence-parallel transformer)
and the sequence-parallel scan (``seqscan``)."""

from anomod_torch.parallel.mesh import (Mesh, launch, make_mesh,
                                        make_named_mesh, shard_chunks)
from anomod_torch.parallel.replay import (make_sharded_replay_fn,
                                          sharded_throughput, stage_sharded)
from anomod_torch.parallel.ring_attention import make_ring_attention
from anomod_torch.parallel.sp_transformer import make_sp_transformer
from anomod_torch.parallel.ulysses import make_ulysses_attention

__all__ = ["Mesh", "launch", "make_mesh", "make_named_mesh", "shard_chunks",
           "make_sharded_replay_fn", "stage_sharded", "sharded_throughput",
           "make_ring_attention", "make_sp_transformer",
           "make_ulysses_attention"]

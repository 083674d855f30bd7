"""repro_torch.dist — distribution on ``torch.distributed`` (the port of
``repro.dist``), one process per rank of a device mesh:

* :mod:`repro_torch.dist.sharding` maps logical axes onto a device mesh;
* :mod:`repro_torch.dist.insitu` compresses fields where they live, one
  shard per rank, with the halo exchange closing the seams: one field at a
  time, or a snapshot's leaves batched into stream arenas;
* :mod:`repro_torch.dist.collectives` is the compressed cross-pod gradient
  mean: block-wise int8/int4 codes with error feedback on the wire in place
  of f32 gradients;
* :mod:`repro_torch.dist.spmd` is the sharded train step's compute: a
  parameter's blocks gathered where the model uses it, the gradients
  reduce-scattered back, expert parallelism and the MoE's row collectives.
"""

from repro_torch.dist import collectives, insitu, sharding, spmd  # noqa: F401

__all__ = ["collectives", "insitu", "sharding", "spmd"]

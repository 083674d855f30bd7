"""repro_torch.dist — distribution on ``torch.distributed`` (the port of
``repro.dist``): :mod:`repro_torch.dist.sharding` maps logical axes onto a
device mesh, and :mod:`repro_torch.dist.insitu` compresses one field where
it lives, one shard per rank, with the halo exchange closing the seams.
The sharded arena and ``repro.dist.collectives`` wait for the port's next
dist slice."""

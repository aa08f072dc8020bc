"""Device meshes on ``torch.distributed`` (port of pcr_tpu/parallel/): one
process a device, NCCL on the cards, gloo on the CPU.  Import the submodules
by name; this package imports none of them.

  mesh            the Mesh, the process-group start-up and the collectives
  pair_sharding   pair-parallel registration (stage 1 and stage 2)
  point_sharding  within-pair point sharding, and both axes at once
  distributed_pg  the edge-sharded pose-graph solve
"""

"""Data- and tensor-parallel PPO over ``torch.distributed`` (JAX package
``parallel/``): the (dp, tp) process-group mesh, the edge-partitioned ring
attention, the data-parallel train step and the multi-process launch."""

"""Multi-chip parallelism: device meshes, sharded rendering, sharded training.

The reference has NO distributed code of any kind (SURVEY §2.3 — it is a
single-process, single-GPU viewer); everything here implements the north star:
splat-primitive sharding for projection, tile sharding for rasterization, and
gradient reduction — over `jax.sharding.Mesh` + `shard_map`, whose XLA
collectives run over NCCL on the GPU.
"""

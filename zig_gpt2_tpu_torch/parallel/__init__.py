"""Tensor- and data-parallel serving over ``torch.distributed``.

The port's counterpart of ``zig_gpt2_tpu.parallel``: ``sharding`` (padding
for tp), ``distributed`` (the bounded start and the collectives),
``mesh`` (the rank's (data, model) coordinate, the Megatron placement
table, the per-rank config and the serving constructor policy; it holds
the rules of the JAX ``step_spmd`` too) and ``shard_kernels`` (the
per-rank index rules of the JAX package's sharded kernels).
"""

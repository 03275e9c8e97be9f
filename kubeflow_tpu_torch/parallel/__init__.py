"""Parallelism strategies as named mesh axes (``kubeflow_tpu/parallel``):
sharding rules (FSDP over ``fsdp``, Megatron column/row splits over
``model``), ring attention and Ulysses over ``seq``, MoE over ``expert``
and the pipeline schedules over ``pipe``."""

from kubeflow_tpu_torch.parallel.sharding import (  # noqa: F401
    P,
    ShardingRules,
    transformer_rules,
)

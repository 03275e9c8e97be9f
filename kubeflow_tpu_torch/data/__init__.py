"""Input pipeline of the port: the synthetic LM dataset and its sharded
host iterator (numpy, bit-equal to the JAX package's)."""

from kubeflow_tpu_torch.data.synthetic import (  # noqa: F401
    TokenLMDataset,
    local_shard_iterator,
)

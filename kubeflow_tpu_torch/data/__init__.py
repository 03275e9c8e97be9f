"""Input pipeline of the port: the synthetic image and LM datasets and
their sharded host iterator (numpy, bit-equal to the JAX package's)."""

from kubeflow_tpu_torch.data.synthetic import (  # noqa: F401
    ClassPrototypeDataset,
    TokenLMDataset,
    local_shard_iterator,
)

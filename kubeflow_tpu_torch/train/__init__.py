"""Training plane of the port: loop, checkpointing, metric writers,
prefetch and optimizer for one CUDA device."""

from kubeflow_tpu_torch.train.checkpoint import (  # noqa: F401
    CheckpointConfig,
    Checkpointer,
)
from kubeflow_tpu_torch.train.loop import TrainConfig, Trainer  # noqa: F401
from kubeflow_tpu_torch.train.metrics import MetricWriter  # noqa: F401
from kubeflow_tpu_torch.train.optim import adamw  # noqa: F401

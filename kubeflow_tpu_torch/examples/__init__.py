"""Runnable examples of the port (``python -m kubeflow_tpu_torch.examples.<name>``)."""

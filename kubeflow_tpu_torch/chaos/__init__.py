"""Fault injectors of the chaos harness (``kubeflow_tpu/chaos``), as far as
the port's slices need them."""

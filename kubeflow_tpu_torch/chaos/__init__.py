"""Chaos harness (``kubeflow_tpu/chaos``), as far as the port's slices
need it: the serving fault plans (``plan``) and the engine-seam
injectors (``injectors``)."""

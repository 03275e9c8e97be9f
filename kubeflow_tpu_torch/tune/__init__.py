"""AutoML plane: the Katib equivalent (SURVEY.md §2.3, §7 step 6), the
port's copy of ``kubeflow_tpu/tune/`` with the JAX package's exports.

- ``spec``      — Experiment / Trial / search-space / objective types.
- ``suggest``   — suggestion algorithms behind one interface: random, grid,
                  bayesian (GP+EI), TPE, hyperband, CMA-ES.
- ``metrics``   — metrics collectors: stdout-regex scraper (zero-SDK, the
                  Katib sidecar trick) and TFEvents reader.
- ``earlystop`` — median-stop early stopping.
- ``controller``— Experiment controller: parallel trials through callables
                  (the orchestrator's runner waits for ROADMAP queue 1
                  item 15), optimal tracking, goal completion.
- ``db``        — sqlite trial and observation store (resume).
- ``nas``       — DARTS and ENAS on a torch supernet.

The gRPC suggestion service (``service``) is not ported: the card's host
has no grpcio (ROADMAP queue 1 item 11).
"""

from kubeflow_tpu_torch.tune.spec import (
    ExperimentSpec,
    Objective,
    ObjectiveType,
    ParameterSpec,
    TrialAssignment,
)
from kubeflow_tpu_torch.tune.suggest import make_suggester
from kubeflow_tpu_torch.tune.controller import ExperimentController

__all__ = [
    "ExperimentSpec",
    "Objective",
    "ObjectiveType",
    "ParameterSpec",
    "TrialAssignment",
    "make_suggester",
    "ExperimentController",
]

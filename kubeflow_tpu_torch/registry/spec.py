"""Registry records and the stage vocabulary.

A copy of ``kubeflow_tpu/registry/spec.py`` (pure Python).

Reference analog: [model-registry]'s RegisteredModel / ModelVersion /
ModelArtifact entities (MLMD-typed contexts and artifacts — UNVERIFIED,
mount empty, SURVEY.md §0). One deliberate narrowing: an artifact here is
exactly one content-addressed blob (file or directory) per version, which
is what the serving path needs to pin bytes end-to-end.
"""

from __future__ import annotations

import dataclasses
from typing import Any

#: The stage lifecycle. ``staging`` and ``production`` are exclusive —
#: at most one version of a model holds each at a time (the per-stage
#: alias the serving path resolves); ``none``/``archived`` are unbounded.
STAGES = ("none", "staging", "production", "archived")
EXCLUSIVE_STAGES = ("staging", "production")


@dataclasses.dataclass
class RegisteredModel:
    """The model name-level record: versions hang off it."""

    name: str
    description: str = ""
    created: float = 0.0
    updated: float = 0.0
    latest_version: int = 0
    #: exclusive-stage holders, e.g. {"production": 3, "staging": 5}
    stages: dict[str, int] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ModelVersion:
    """One immutable version: content hash + stage + metadata."""

    model: str
    version: int
    sha256: str
    stage: str = "none"
    source_uri: str = ""
    created: float = 0.0
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ref(self) -> str:
        """The immutable ``registry://`` spelling of this version."""
        return f"registry://{self.model}@v{self.version}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LineageEdge:
    """Producer edge: which pipeline run / tune trial / checkpoint made a
    version (the MLMD event analog, collapsed to the output direction)."""

    kind: str            # "pipeline_run" | "tune_trial" | "checkpoint" | ...
    ref: str             # run_id, "<experiment>/<trial_id>", ckpt path…
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    created: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RegisterOnSave:
    """``Checkpointer.save(..., register=RegisterOnSave(...))`` payload:
    where and as what to register a just-written checkpoint."""

    store: Any                    # registry.store.ModelStore
    name: str
    stage: str | None = None      # promote right after registering
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)

"""Artifact types and store.

A copy of ``kubeflow_tpu/pipelines/artifacts.py``; remote uris resolve
through the port's ``serve/storage.py``.

Reference analog (SURVEY.md §2.4): KFP artifacts (`dsl.Dataset`,
`dsl.Model`, `dsl.Metrics`) stored in MinIO under
`<bucket>/<pipeline>/<run>/<task>/<output>`; the launcher downloads
inputs and uploads outputs ([pipelines] backend/src/v2/component/
launcher_v2.go — UNVERIFIED, SURVEY.md §0).

Here artifacts are directories/files under a local root with the same
run-scoped layout, addressed by `uri`. A `file://` uri maps straight to
the path; other schemes resolve through `kubeflow_tpu_torch.serve.storage`
fetchers so `gs://` stubs plug in uniformly.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from kubeflow_tpu_torch.serve import storage as _storage


@dataclasses.dataclass
class Artifact:
    """A named, typed blob with metadata — the MLMD artifact analog."""

    name: str = ""
    uri: str = ""
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)

    TYPE = "system.Artifact"

    @property
    def path(self) -> str:
        """Local filesystem path for reading/writing the payload."""
        if self.uri.startswith("file://"):
            return self.uri[len("file://"):]
        if "://" not in self.uri:
            return self.uri
        raise ValueError(
            f"artifact {self.name!r} uri {self.uri!r} is not local; "
            "call ArtifactStore.localize() first"
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "uri": self.uri,
            "type": self.TYPE,
            "metadata": dict(self.metadata),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Artifact":
        klass = _TYPE_REGISTRY.get(d.get("type", cls.TYPE), Artifact)
        return klass(
            name=d.get("name", ""),
            uri=d.get("uri", ""),
            metadata=dict(d.get("metadata", {})),
        )


class Dataset(Artifact):
    TYPE = "system.Dataset"


class Model(Artifact):
    TYPE = "system.Model"


class Metrics(Artifact):
    TYPE = "system.Metrics"

    def log_metric(self, key: str, value: float) -> None:
        self.metadata[key] = float(value)


_TYPE_REGISTRY = {
    k.TYPE: k for k in (Artifact, Dataset, Model, Metrics)
}


class ArtifactStore:
    """Run-scoped artifact root: ``<root>/<pipeline>/<run_id>/<task>/<name>``."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def uri_for(self, pipeline: str, run_id: str, task: str, name: str) -> str:
        path = os.path.join(self.root, pipeline, run_id, task, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return "file://" + path

    def localize(self, artifact: Artifact, dest_dir: str) -> str:
        """Materialize a (possibly remote) artifact locally; returns path."""
        if artifact.uri.startswith("file://") or "://" not in artifact.uri:
            return artifact.path
        return _storage.download(artifact.uri, dest_dir)

    # -- parameter (small JSON value) storage ------------------------- #

    def put_value(self, pipeline: str, run_id: str, task: str,
                  name: str, value: Any) -> str:
        uri = self.uri_for(pipeline, run_id, task, name + ".json")
        with open(uri[len("file://"):], "w") as f:
            json.dump(value, f)
        return uri

    def get_value(self, uri: str) -> Any:
        with open(uri[len("file://"):]) as f:
            return json.load(f)

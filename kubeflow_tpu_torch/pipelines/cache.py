"""Step cache: skip a task when the same (component, inputs) ran before.

A copy of ``kubeflow_tpu/pipelines/cache.py``: the same component and
inputs give the same key in both packages.

Reference analog (SURVEY.md §2.4 "Cache server", §5.4): KFP's cache
webhook matches the component spec + resolved inputs fingerprint against
MLMD and short-circuits execution, reusing recorded outputs
([pipelines] backend/src/cache/ — UNVERIFIED, SURVEY.md §0).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any

from kubeflow_tpu_torch.pipelines.ir import ComponentIR


def cache_key(component: ComponentIR, resolved_inputs: dict[str, Any]) -> str:
    """Digest of the executable contract + the concrete input values.

    Artifact inputs contribute their uri + metadata (content identity is
    run-scoped uris, so a re-produced artifact at a new uri is a miss —
    same conservative behavior as the reference's fingerprinting).
    """
    payload = json.dumps(
        {"component": component.fingerprint(), "inputs": resolved_inputs},
        sort_keys=True, default=str,
    )
    return hashlib.sha256(payload.encode()).hexdigest()


class StepCache:
    """File-backed key → recorded outputs map (one JSON per entry)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    def lookup(self, key: str) -> dict | None:
        with self._lock:
            path = self._path(key)
            if not os.path.exists(path):
                self.misses += 1
                return None
            with open(path) as f:
                entry = json.load(f)
            # stale entry: a recorded file:// output was GC'd
            for uri in entry.get("artifact_uris", []):
                if uri.startswith("file://") and not os.path.exists(uri[7:]):
                    self.misses += 1
                    return None
            self.hits += 1
            return entry["outputs"]

    def record(self, key: str, outputs: dict) -> None:
        # stale-check only artifacts that were actually materialized —
        # metadata-only artifacts (e.g. Metrics) have no file to GC
        uris = [
            o["uri"] for o in outputs.values()
            if isinstance(o, dict) and "uri" in o
            and o["uri"].startswith("file://")
            and os.path.exists(o["uri"][7:])
        ]
        with self._lock:
            tmp = self._path(key) + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"outputs": outputs, "artifact_uris": uris}, f)
            os.replace(tmp, self._path(key))

    def clear(self) -> None:
        with self._lock:
            for name in os.listdir(self.root):
                if name.endswith(".json"):
                    os.unlink(os.path.join(self.root, name))
            self.hits = self.misses = 0

"""Model Registry: versioned, governed model artifacts with lineage; the
port's copy of ``kubeflow_tpu/registry/``, on the same sqlite schema and
blob layout.

Reference analog (VERDICT.md §1 gap): [model-registry] — upstream
kubeflow/model-registry, a Go REST service over ML-Metadata that turns
"a checkpoint on disk" into a RegisteredModel → ModelVersion → Artifact
chain with stage promotion, connecting training, pipelines, and serving.
Here the same data model rides sqlite (the `tune/db.py` idiom) plus a
content-addressed blob store, and the serving link is a `registry://`
scheme registered into `serve/storage.py` so an InferenceService resolves
`registry://name@production` to an exact content hash at load time.

Modules:

- ``spec``    — records (RegisteredModel, ModelVersion, LineageEdge) and
  the stage vocabulary.
- ``store``   — ``ModelStore``: sqlite + sha256-deduplicated blobs.
- ``stages``  — stage lifecycle: atomic promote / rollback / archive.
- ``api``     — REST surface: not ported yet (it rides aiohttp, which
  the card's host lacks; ROADMAP queue 1 item 11).
- ``fetcher`` — ``registry://`` resolution for the storage initializer.
"""

from kubeflow_tpu_torch.registry.spec import (  # noqa: F401
    STAGES,
    LineageEdge,
    ModelVersion,
    RegisteredModel,
    RegisterOnSave,
)
from kubeflow_tpu_torch.registry.store import (  # noqa: F401
    ModelStore,
    default_store,
    set_default_store,
)

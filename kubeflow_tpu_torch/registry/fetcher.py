"""``registry://name@selector`` — serving straight from the registry.

A copy of ``kubeflow_tpu/registry/fetcher.py``, registered with the
port's ``serve/storage.py``.

Reference analog: KServe's ``storage-initializer`` resolving a model URI
before the server starts. The registry scheme adds one governance step:
the mutable selector (``@production``, ``@staging``, an alias, or
nothing for latest) is **canonicalized to an immutable version + content
hash at download time** (:func:`canonicalize`), so

- the bytes a server loads are exactly the bytes the promoted version
  hashed to (single-file payloads are further pinned end-to-end via
  ``expected_sha256``), and
- a later promotion changes what the NEXT download resolves — it can
  never mutate a cached copy under a running server (the cache key is
  the immutable ``registry://name@vN`` spelling).
"""

from __future__ import annotations

import os
import shutil

from kubeflow_tpu_torch.registry.spec import ModelVersion
from kubeflow_tpu_torch.registry.store import ModelStore, default_store


def parse_ref(uri: str) -> tuple[str, str | None]:
    """``registry://name[@selector]`` → (name, selector|None). The name
    may contain ``/`` (pipelines register as ``<pipeline>/<output>``)."""
    if not uri.startswith("registry://"):
        raise ValueError(f"not a registry uri: {uri!r}")
    rest = uri[len("registry://"):]
    name, sep, selector = rest.partition("@")
    if not name:
        raise ValueError(f"registry uri {uri!r} has no model name")
    return name, (selector if sep else None) or None


def resolve(uri: str, store: ModelStore | None = None) -> ModelVersion:
    name, selector = parse_ref(uri)
    return (store or default_store()).resolve(name, selector)


def canonicalize(
    uri: str, store: ModelStore | None = None
) -> tuple[str, str | None]:
    """Mutable ref → (immutable ``registry://name@vN`` uri, pinned sha256
    for single-file payloads, None for directories). ``serve.storage``
    calls this before its cache check so stage moves are never masked by
    a stale cached copy."""
    store = store or default_store()
    mv = resolve(uri, store)
    blob = store.blob_path(mv.sha256)
    return mv.ref, (None if os.path.isdir(blob) else mv.sha256)


def _fetch_registry(uri: str, staging: str) -> str:
    """Scheme fetcher for ``serve.storage.download``: materialise the
    resolved version's blob into the staging dir."""
    store = default_store()
    mv = resolve(uri, store)
    src = store.blob_path(mv.sha256)
    # one filesystem name per (model, version): distinct versions must not
    # collide in a shared model dir, and "/" in model names must not
    # escape it
    name = f"{mv.model.replace('/', '-')}-v{mv.version}"
    staged = os.path.join(staging, name)
    if os.path.isdir(src):
        shutil.copytree(src, staged)
    else:
        shutil.copy2(src, staged)
    return staged


def register() -> None:
    from kubeflow_tpu_torch.serve import storage

    storage.register_fetcher("registry", _fetch_registry)


register()

"""Storage initializer: fetch model artifacts to a local model dir.

A copy of ``kubeflow_tpu/serve/storage.py`` with the ``file``/local and
``registry`` schemes. The http/s3/gs/hdfs fetchers
(``serve/cloudstorage.py``) are not ported yet (ROADMAP queue 1 item
11): those schemes fail with the "no fetcher registered" error unless a
caller registers one.

Reference analog: KServe's storage-initializer init container + Storage
class ([kserve] python/kserve/kserve/storage/storage.py — UNVERIFIED, mount
empty, SURVEY.md §0): downloads ``gs://``/``s3://``/``pvc://``/http URIs to
``/mnt/models`` before the server starts, retrying flaky transfers and
never exposing a half-written model dir.

This env has zero egress (SURVEY.md §0), so remote schemes are represented
by a registry of fetchers: ``file://`` and bare paths work out of the box;
``gs://``/``s3://`` raise a clear error unless a fetcher is registered
(tests register in-memory fakes; production registers real clients).
``registry://name@stage-or-version`` resolves through the model registry
(`kubeflow_tpu_torch.registry.fetcher`) with the ref canonicalized to an exact
content hash before the cache is consulted.

Download discipline (VERDICT r3 missing #7 — the machinery, independent of
which schemes are live):

- **Staging + atomic promote**: every fetch lands in a ``.staging-*`` dir
  next to the destination and is ``os.replace``d into place only after it
  verifies — a crashed or partial download is never visible to the server.
- **Retries with backoff**: transient fetcher/IO failures are retried
  (``retries``/``backoff_s``), mirroring the init container's restart-loop.
- **Checksums**: a sha256 manifest over every file is written next to the
  artifact; ``verify()`` rechecks it (bit-rot, torn copies), ``download``
  reuses a verified cached copy without refetching, and an
  ``expected_sha256`` (single-file artifacts) pins the content end-to-end.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import uuid
from typing import Callable

# scheme -> fetcher(uri, dest_dir) -> local path (file or directory)
_FETCHERS: dict[str, Callable[[str, str], str]] = {}

MANIFEST_SUFFIX = ".kft-sha256.json"


def register_fetcher(scheme: str, fn: Callable[[str, str], str]) -> None:
    _FETCHERS[scheme] = fn


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest(path: str) -> dict[str, str]:
    """relpath → sha256 for a file or directory artifact."""
    if os.path.isfile(path):
        return {os.path.basename(path): _sha256_file(path)}
    out = {}
    for root, _, files in os.walk(path):
        for name in sorted(files):
            p = os.path.join(root, name)
            out[os.path.relpath(p, path)] = _sha256_file(p)
    return out


def _manifest_path(dest: str) -> str:
    return dest.rstrip("/") + MANIFEST_SUFFIX


def _read_manifest(dest: str) -> dict | None:
    mp = _manifest_path(dest)
    if not (os.path.exists(dest) and os.path.isfile(mp)):
        return None
    try:
        m = json.loads(open(mp).read())
    except (OSError, json.JSONDecodeError):
        return None
    # legacy flat {relpath: hash} manifests read as files-only
    return m if "files" in m else {"uri": None, "files": m}


def verify(dest: str, *, uri: str | None = None) -> bool:
    """True iff ``dest`` matches its recorded sha256 manifest — and, when
    ``uri`` is given, was downloaded FROM that uri (two artifacts sharing a
    basename in one dest_dir must never satisfy each other's cache)."""
    m = _read_manifest(dest)
    if m is None:
        return False
    if uri is not None and m.get("uri") != uri:
        return False
    if os.path.isfile(dest):
        have = {os.path.basename(dest): _sha256_file(dest)}
    else:
        have = _manifest(dest)
    return have == m["files"]


def _promote(staged: str, dest: str, uri: str) -> str:
    """Checksum the staged artifact, then atomically move into place."""
    manifest = {"uri": uri, "files": _manifest(staged)}
    tmp_mp = staged.rstrip("/") + MANIFEST_SUFFIX
    with open(tmp_mp, "w") as f:
        json.dump(manifest, f)
    if os.path.isdir(dest):
        shutil.rmtree(dest)
    elif os.path.exists(dest):
        os.remove(dest)
    os.replace(staged, dest)
    os.replace(tmp_mp, _manifest_path(dest))
    return dest


def _fetch_file(rest: str, staging: str) -> str:
    src = rest if rest.startswith("/") else os.path.abspath(rest)
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    staged = os.path.join(staging, os.path.basename(src.rstrip("/")))
    if os.path.isdir(src):
        shutil.copytree(src, staged)
    else:
        shutil.copy2(src, staged)
    return staged


def download(
    storage_uri: str,
    dest_dir: str,
    *,
    retries: int = 3,
    backoff_s: float = 0.1,
    expected_sha256: str | None = None,
) -> str:
    """Materialise ``storage_uri`` under ``dest_dir``; returns the local
    path. Retries transient failures; partial fetches are never visible; a
    verified cached copy short-circuits the fetch."""
    os.makedirs(dest_dir, exist_ok=True)
    scheme, sep, rest = storage_uri.partition("://")
    if not sep:
        scheme, rest = "file", storage_uri

    if scheme == "registry":
        # Model-registry refs are MUTABLE (`@production` moves on promote):
        # canonicalize to the immutable `@vN` spelling BEFORE the cache
        # check, so a stage move is never masked by a stale cached copy —
        # and pin single-file payloads to the registered content hash.
        from kubeflow_tpu_torch.registry import fetcher as _registry  # self-registers

        storage_uri, pinned = _registry.canonicalize(storage_uri)
        rest = storage_uri.partition("://")[2]
        if expected_sha256 is None:
            expected_sha256 = pinned

    # cache check: the manifest records the SOURCE uri, so a same-named
    # artifact from a different uri is a miss (and the fetcher may name its
    # output differently from the uri basename — check that path too); an
    # expected_sha256 additionally requires the cached bytes to hash to it
    name = os.path.basename(rest.rstrip("/")) or "model"
    for candidate in {os.path.join(dest_dir, name)} | {
        p[: -len(MANIFEST_SUFFIX)]
        for p in (
            os.path.join(dest_dir, f) for f in os.listdir(dest_dir)
            if f.endswith(MANIFEST_SUFFIX)
        )
    }:
        if not verify(candidate, uri=storage_uri):
            continue
        if expected_sha256 is not None and not (
            os.path.isfile(candidate)
            and _sha256_file(candidate) == expected_sha256
        ):
            continue
        return candidate

    last_err: Exception | None = None
    for attempt in range(max(1, retries)):
        staging = os.path.join(dest_dir, f".staging-{uuid.uuid4().hex[:8]}")
        os.makedirs(staging)
        try:
            if scheme == "file":
                staged = _fetch_file(rest, staging)
            else:
                fetcher = _FETCHERS.get(scheme)
                if fetcher is None and scheme == "registry":
                    from kubeflow_tpu_torch.registry import (  # noqa: F401
                        fetcher as _registry_fetcher,     # self-registers
                    )

                    fetcher = _FETCHERS.get(scheme)
                if fetcher is None:
                    raise RuntimeError(
                        f"no fetcher registered for scheme '{scheme}://' "
                        "(register one with "
                        "kubeflow_tpu_torch.serve.storage.register_fetcher)"
                    )
                staged = fetcher(storage_uri, staging)
                if not os.path.exists(staged):
                    raise RuntimeError(
                        f"fetcher for {scheme}:// returned missing path "
                        f"{staged!r}"
                    )
            if expected_sha256 is not None:
                if not os.path.isfile(staged):
                    raise RuntimeError(
                        "expected_sha256 applies to single-file artifacts; "
                        f"{staged!r} is a directory"
                    )
                got = _sha256_file(staged)
                if got != expected_sha256:
                    raise RuntimeError(
                        f"checksum mismatch for {storage_uri}: "
                        f"got {got}, want {expected_sha256}"
                    )
            dest = os.path.join(dest_dir, os.path.basename(staged.rstrip("/")))
            return _promote(staged, dest, storage_uri)
        except FileNotFoundError:
            raise  # a missing local source is permanent; retrying can't help
        except (RuntimeError, OSError) as e:
            last_err = e
            if isinstance(e, RuntimeError) and "no fetcher registered" in str(e):
                raise  # config error: retrying cannot help
            if attempt < retries - 1:  # no pointless sleep after the last try
                time.sleep(backoff_s * (2 ** attempt))
        finally:
            shutil.rmtree(staging, ignore_errors=True)
    raise RuntimeError(
        f"download of {storage_uri!r} failed after {retries} attempts: "
        f"{last_err}"
    ) from last_err

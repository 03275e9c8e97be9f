"""Versioned model store: sqlite records + content-addressed blobs.

A copy of ``kubeflow_tpu/registry/store.py``: the same schema, blob
layout and content hashes, so a store either package wrote resolves in
the other.

Reference analog: [model-registry]'s MLMD backing store (UNVERIFIED,
mount empty, SURVEY.md §0) — RegisteredModel/ModelVersion rows over
MySQL, artifacts by URI. Here the artifact bytes live IN the store,
content-addressed by sha256 under ``<root>/blobs/``, so registering the
same checkpoint twice (two pipeline runs, a retrain that converged to
identical weights) costs one copy — and the serving path can pin the
exact digest it resolved (`fetcher.canonicalize`).

Concurrency follows ``tune/db.py``: one connection, one lock, explicit
commits; the stage state machine (`stages.py`) runs inside the same
lock via :meth:`ModelStore.tx` so promotion/rollback is atomic.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import sqlite3
import threading
import time
import uuid

from kubeflow_tpu_torch.registry.spec import (
    STAGES,
    LineageEdge,
    ModelVersion,
    RegisteredModel,
)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS models (
    name        TEXT PRIMARY KEY,
    description TEXT NOT NULL DEFAULT '',
    created     REAL NOT NULL,
    updated     REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS versions (
    model      TEXT NOT NULL REFERENCES models(name),
    version    INTEGER NOT NULL,
    sha256     TEXT NOT NULL,
    stage      TEXT NOT NULL DEFAULT 'none',
    source_uri TEXT NOT NULL DEFAULT '',
    created    REAL NOT NULL,
    metadata   TEXT NOT NULL DEFAULT '{}',
    PRIMARY KEY (model, version)
);
CREATE TABLE IF NOT EXISTS blobs (
    sha256  TEXT PRIMARY KEY,
    is_dir  INTEGER NOT NULL,
    size    INTEGER NOT NULL,
    created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS lineage (
    model    TEXT NOT NULL,
    version  INTEGER NOT NULL,
    kind     TEXT NOT NULL,
    ref      TEXT NOT NULL,
    metadata TEXT NOT NULL DEFAULT '{}',
    created  REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_lineage_mv ON lineage(model, version);
CREATE TABLE IF NOT EXISTS aliases (
    model   TEXT NOT NULL,
    alias   TEXT NOT NULL,
    version INTEGER NOT NULL,
    PRIMARY KEY (model, alias)
);
CREATE TABLE IF NOT EXISTS promotions (
    id           INTEGER PRIMARY KEY AUTOINCREMENT,
    model        TEXT NOT NULL,
    stage        TEXT NOT NULL,
    from_version INTEGER,
    to_version   INTEGER NOT NULL,
    ts           REAL NOT NULL
);
"""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def content_hash(path: str) -> tuple[str, bool, int]:
    """(digest, is_dir, total_bytes) for a file or directory payload.

    A file hashes to its byte sha256 — the same digest
    ``serve.storage.download(expected_sha256=...)`` pins, so a resolved
    version verifies end-to-end. A directory hashes its sorted
    (relpath, file-sha256) manifest."""
    if os.path.isfile(path):
        return _sha256_file(path), False, os.path.getsize(path)
    entries = []
    total = 0
    for root, _, files in os.walk(path):
        for name in sorted(files):
            p = os.path.join(root, name)
            entries.append((os.path.relpath(p, path), _sha256_file(p)))
            total += os.path.getsize(p)
    h = hashlib.sha256()
    for rel, digest in sorted(entries):
        h.update(rel.encode())
        h.update(b"\0")
        h.update(digest.encode())
        h.update(b"\0")
    return h.hexdigest(), True, total


class ModelStore:
    """``<root>/registry.sqlite`` + ``<root>/blobs/<sha256>`` payloads."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.blob_root = os.path.join(self.root, "blobs")
        os.makedirs(self.blob_root, exist_ok=True)
        self._db = sqlite3.connect(
            os.path.join(self.root, "registry.sqlite"),
            check_same_thread=False,
        )
        self._db.executescript(_SCHEMA)
        self._db.commit()
        self._lock = threading.RLock()

    @contextlib.contextmanager
    def tx(self):
        """One atomic unit: lock + commit, rollback on any exception.
        The stage machine (`stages.py`) composes multi-row updates here."""
        with self._lock:
            try:
                yield self._db
                self._db.commit()
            except BaseException:
                self._db.rollback()
                raise

    # -- models --------------------------------------------------------- #

    def create_model(self, name: str, description: str = "") -> RegisteredModel:
        if not name or name.startswith(".") or any(
            c in name for c in ("@", "\\", "\n", "\r")
        ):
            raise ValueError(f"invalid model name {name!r}")
        now = time.time()
        with self.tx() as db:
            db.execute(
                "INSERT INTO models (name, description, created, updated)"
                " VALUES (?,?,?,?)"
                " ON CONFLICT(name) DO UPDATE SET updated=excluded.updated,"
                " description=CASE WHEN excluded.description != ''"
                " THEN excluded.description ELSE models.description END",
                (name, description, now, now),
            )
        return self.get_model(name)

    def get_model(self, name: str) -> RegisteredModel:
        with self._lock:
            row = self._db.execute(
                "SELECT name, description, created, updated FROM models"
                " WHERE name=?",
                (name,),
            ).fetchone()
            if row is None:
                raise KeyError(f"model {name!r} not registered")
            latest = self._db.execute(
                "SELECT MAX(version) FROM versions WHERE model=?", (name,)
            ).fetchone()[0]
            stages = dict(
                self._db.execute(
                    "SELECT stage, version FROM versions WHERE model=?"
                    " AND stage IN ('staging','production')",
                    (name,),
                ).fetchall()
            )
        return RegisteredModel(
            name=row[0], description=row[1], created=row[2], updated=row[3],
            latest_version=latest or 0, stages=stages,
        )

    def list_models(self) -> list[RegisteredModel]:
        with self._lock:
            names = [
                r[0]
                for r in self._db.execute(
                    "SELECT name FROM models ORDER BY name"
                ).fetchall()
            ]
        return [self.get_model(n) for n in names]

    # -- blobs ---------------------------------------------------------- #

    def blob_path(self, sha256: str) -> str:
        p = os.path.join(self.blob_root, sha256)
        if not os.path.exists(p):
            raise FileNotFoundError(f"blob {sha256} missing from {self.blob_root}")
        return p

    def _ingest_blob(self, path: str) -> tuple[str, bool, int]:
        """Copy ``path`` into the blob store, deduplicating by content:
        an already-present digest costs zero bytes. Returns
        (sha256, is_dir, size)."""
        digest, is_dir, size = content_hash(path)
        dest = os.path.join(self.blob_root, digest)
        if not os.path.exists(dest):
            staging = os.path.join(
                self.blob_root, f".staging-{uuid.uuid4().hex[:8]}"
            )
            try:
                if is_dir:
                    shutil.copytree(path, staging)
                else:
                    shutil.copy2(path, staging)
                # a racing ingest of the same content may beat us: either
                # replace wins, the bytes are identical
                os.replace(staging, dest)
            finally:
                if os.path.isdir(staging):
                    shutil.rmtree(staging, ignore_errors=True)
                elif os.path.exists(staging):
                    os.remove(staging)
        return digest, is_dir, size

    # -- versions ------------------------------------------------------- #

    def register_version(
        self,
        name: str,
        path: str,
        *,
        source_uri: str = "",
        metadata: dict | None = None,
        stage: str | None = None,
        lineage: list[tuple[str, str, dict]] | None = None,
    ) -> ModelVersion:
        """Ingest a file/directory payload as the next version of
        ``name`` (the model record is created on first use). ``lineage``
        rows are (kind, ref, metadata) producer edges; ``stage`` promotes
        atomically right after registration."""
        if not os.path.exists(path):
            raise FileNotFoundError(f"model payload {path!r} does not exist")
        self.create_model(name)
        digest, is_dir, size = self._ingest_blob(path)
        now = time.time()
        with self.tx() as db:
            db.execute(
                "INSERT OR IGNORE INTO blobs (sha256, is_dir, size, created)"
                " VALUES (?,?,?,?)",
                (digest, int(is_dir), size, now),
            )
            version = (
                db.execute(
                    "SELECT COALESCE(MAX(version), 0) + 1 FROM versions"
                    " WHERE model=?",
                    (name,),
                ).fetchone()[0]
            )
            db.execute(
                "INSERT INTO versions"
                " (model, version, sha256, stage, source_uri, created,"
                "  metadata) VALUES (?,?,?,?,?,?,?)",
                (name, version, digest, "none", source_uri, now,
                 json.dumps(metadata or {})),
            )
            db.execute(
                "UPDATE models SET updated=? WHERE name=?", (now, name)
            )
            for kind, ref, meta in lineage or []:
                db.execute(
                    "INSERT INTO lineage"
                    " (model, version, kind, ref, metadata, created)"
                    " VALUES (?,?,?,?,?,?)",
                    (name, version, kind, ref, json.dumps(meta or {}), now),
                )
        mv = self.get_version(name, version)
        if stage is not None:
            from kubeflow_tpu_torch.registry import stages as _stages

            _stages.promote(self, name, version, stage)
            mv = self.get_version(name, version)
        return mv

    def _version_from_row(self, row) -> ModelVersion:
        model, version, sha, stage, uri, created, meta = row
        return ModelVersion(
            model=model, version=version, sha256=sha, stage=stage,
            source_uri=uri, created=created, metadata=json.loads(meta),
        )

    def get_version(self, name: str, version: int) -> ModelVersion:
        with self._lock:
            row = self._db.execute(
                "SELECT model, version, sha256, stage, source_uri, created,"
                " metadata FROM versions WHERE model=? AND version=?",
                (name, int(version)),
            ).fetchone()
        if row is None:
            raise KeyError(f"model {name!r} has no version {version}")
        return self._version_from_row(row)

    def list_versions(self, name: str) -> list[ModelVersion]:
        self.get_model(name)  # KeyError on unknown model
        with self._lock:
            rows = self._db.execute(
                "SELECT model, version, sha256, stage, source_uri, created,"
                " metadata FROM versions WHERE model=? ORDER BY version",
                (name,),
            ).fetchall()
        return [self._version_from_row(r) for r in rows]

    def resolve(self, name: str, selector: str | None = None) -> ModelVersion:
        """Resolve a mutable selector to a concrete version:

        - ``None`` / ``"latest"`` → highest version number
        - a stage name (``production``/``staging``) → its current holder
        - a custom alias → its pinned version
        - ``"v3"`` / ``"3"`` → that exact version
        """
        model = self.get_model(name)
        if selector is None or selector == "latest":
            if not model.latest_version:
                raise KeyError(f"model {name!r} has no versions")
            return self.get_version(name, model.latest_version)
        if selector in STAGES:
            if selector not in model.stages:
                raise KeyError(
                    f"model {name!r} has no version in stage {selector!r}"
                )
            return self.get_version(name, model.stages[selector])
        with self._lock:
            row = self._db.execute(
                "SELECT version FROM aliases WHERE model=? AND alias=?",
                (name, selector),
            ).fetchone()
        if row is not None:
            return self.get_version(name, row[0])
        digits = selector[1:] if selector.startswith("v") else selector
        if digits.isdigit():
            return self.get_version(name, int(digits))
        raise KeyError(
            f"cannot resolve {name!r}@{selector!r}: not a stage, alias, or"
            " version number"
        )

    def set_alias(self, name: str, alias: str, version: int) -> None:
        """Pin a custom alias (``champion``, ``canary``…) to a version.
        Stage names are reserved — they are managed by promotion."""
        if alias in STAGES or alias == "latest" or not alias:
            raise ValueError(f"alias {alias!r} is reserved")
        self.get_version(name, version)  # KeyError if missing
        with self.tx() as db:
            db.execute(
                "INSERT OR REPLACE INTO aliases (model, alias, version)"
                " VALUES (?,?,?)",
                (name, alias, int(version)),
            )

    # -- lineage -------------------------------------------------------- #

    def add_lineage(
        self, name: str, version: int, kind: str, ref: str,
        metadata: dict | None = None,
    ) -> None:
        self.get_version(name, version)
        with self.tx() as db:
            db.execute(
                "INSERT INTO lineage"
                " (model, version, kind, ref, metadata, created)"
                " VALUES (?,?,?,?,?,?)",
                (name, int(version), kind, ref, json.dumps(metadata or {}),
                 time.time()),
            )

    def lineage_of(self, name: str, version: int) -> list[LineageEdge]:
        self.get_version(name, version)
        with self._lock:
            rows = self._db.execute(
                "SELECT kind, ref, metadata, created FROM lineage"
                " WHERE model=? AND version=? ORDER BY created, rowid",
                (name, int(version)),
            ).fetchall()
        return [
            LineageEdge(kind=k, ref=r, metadata=json.loads(m), created=c)
            for k, r, m, c in rows
        ]

    def promotion_history(self, name: str, stage: str) -> list[dict]:
        with self._lock:
            rows = self._db.execute(
                "SELECT id, from_version, to_version, ts FROM promotions"
                " WHERE model=? AND stage=? ORDER BY id",
                (name, stage),
            ).fetchall()
        return [
            {"id": i, "from_version": f, "to_version": t, "ts": ts}
            for i, f, t, ts in rows
        ]

    def close(self) -> None:
        with self._lock:
            self._db.close()


# --------------------------------------------------------------------------- #
# process-default store — what `registry://` fetches resolve against
# --------------------------------------------------------------------------- #

_DEFAULT: ModelStore | None = None


def set_default_store(store: ModelStore | None) -> None:
    global _DEFAULT
    _DEFAULT = store


def default_store() -> ModelStore:
    """The processwide registry: set explicitly (tests, embedded servers)
    or implied by ``KFT_REGISTRY_ROOT`` (CLI, serving containers)."""
    global _DEFAULT
    if _DEFAULT is None:
        root = os.environ.get("KFT_REGISTRY_ROOT")
        if not root:
            raise RuntimeError(
                "no model registry configured: call"
                " registry.set_default_store(ModelStore(root)) or set"
                " KFT_REGISTRY_ROOT"
            )
        _DEFAULT = ModelStore(root)
    return _DEFAULT

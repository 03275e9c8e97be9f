"""Stage lifecycle: ``none → staging → production → archived``.

A copy of ``kubeflow_tpu/registry/stages.py`` (pure Python).

Reference analog: model-registry / MLflow stage transitions. Two
invariants the rest of the platform leans on:

- **Exclusivity** — at most one version per model holds ``staging`` or
  ``production`` at any instant, so ``registry://name@production`` is a
  total function. Promotion demotes the previous holder to ``archived``
  in the same transaction.
- **Reversibility** — every promotion appends to a history log, and
  :func:`rollback` restores the previous holder atomically (the
  "which model was in production before this one, put it back" path).
"""

from __future__ import annotations

import time

from kubeflow_tpu_torch.registry.spec import EXCLUSIVE_STAGES, STAGES
from kubeflow_tpu_torch.registry.store import ModelStore


def _require_version(db, model: str, version: int) -> str:
    row = db.execute(
        "SELECT stage FROM versions WHERE model=? AND version=?",
        (model, int(version)),
    ).fetchone()
    if row is None:
        raise KeyError(f"model {model!r} has no version {version}")
    return row[0]


def promote(store: ModelStore, model: str, version: int, stage: str) -> dict:
    """Move ``version`` into ``stage`` atomically. For exclusive stages
    the previous holder is archived in the same transaction and the
    transition is recorded for :func:`rollback`. Returns a summary dict
    {model, stage, version, previous}."""
    if stage not in STAGES or stage == "none":
        raise ValueError(
            f"cannot promote to stage {stage!r} (valid: "
            f"{[s for s in STAGES if s != 'none']})"
        )
    with store.tx() as db:
        _require_version(db, model, version)
        previous = None
        if stage in EXCLUSIVE_STAGES:
            row = db.execute(
                "SELECT version FROM versions WHERE model=? AND stage=?",
                (model, stage),
            ).fetchone()
            previous = row[0] if row else None
            if previous == version:
                return {"model": model, "stage": stage, "version": version,
                        "previous": previous}
            if previous is not None:
                db.execute(
                    "UPDATE versions SET stage='archived'"
                    " WHERE model=? AND version=?",
                    (model, previous),
                )
            db.execute(
                "INSERT INTO promotions"
                " (model, stage, from_version, to_version, ts)"
                " VALUES (?,?,?,?,?)",
                (model, stage, previous, int(version), time.time()),
            )
        db.execute(
            "UPDATE versions SET stage=? WHERE model=? AND version=?",
            (stage, model, int(version)),
        )
        db.execute(
            "UPDATE models SET updated=? WHERE name=?", (time.time(), model)
        )
    return {"model": model, "stage": stage, "version": int(version),
            "previous": previous}


def rollback(store: ModelStore, model: str, stage: str) -> dict:
    """Undo the most recent promotion into an exclusive ``stage``: the
    current holder steps down to ``archived`` and the previous holder
    (recorded at promotion time) is restored — or the stage empties if
    the undone promotion was the first. Atomic; consumes one history
    entry per call, so repeated rollbacks walk further back."""
    if stage not in EXCLUSIVE_STAGES:
        raise ValueError(
            f"rollback applies to exclusive stages {EXCLUSIVE_STAGES},"
            f" not {stage!r}"
        )
    with store.tx() as db:
        last = db.execute(
            "SELECT id, from_version, to_version FROM promotions"
            " WHERE model=? AND stage=? ORDER BY id DESC LIMIT 1",
            (model, stage),
        ).fetchone()
        if last is None:
            raise KeyError(
                f"model {model!r} has no promotion history for {stage!r}"
            )
        pid, from_version, to_version = last
        holder = db.execute(
            "SELECT version FROM versions WHERE model=? AND stage=?",
            (model, stage),
        ).fetchone()
        if holder is None or holder[0] != to_version:
            raise RuntimeError(
                f"stage {stage!r} of {model!r} is held by"
                f" {holder[0] if holder else None}, but the last recorded"
                f" promotion installed {to_version} — refusing a blind"
                " rollback"
            )
        db.execute(
            "UPDATE versions SET stage='archived' WHERE model=? AND version=?",
            (model, to_version),
        )
        if from_version is not None:
            _require_version(db, model, from_version)
            db.execute(
                "UPDATE versions SET stage=? WHERE model=? AND version=?",
                (stage, model, from_version),
            )
        db.execute("DELETE FROM promotions WHERE id=?", (pid,))
        db.execute(
            "UPDATE models SET updated=? WHERE name=?", (time.time(), model)
        )
    return {"model": model, "stage": stage, "version": from_version,
            "previous": to_version}


def archive(store: ModelStore, model: str, version: int) -> dict:
    """Retire a version outright (also the way to empty an exclusive
    stage without installing a successor)."""
    with store.tx() as db:
        _require_version(db, model, version)
        db.execute(
            "UPDATE versions SET stage='archived' WHERE model=? AND version=?",
            (model, int(version)),
        )
    return {"model": model, "stage": "archived", "version": int(version)}

"""Lineage store: the MLMD equivalent.

A copy of ``kubeflow_tpu/pipelines/metadata.py``, on the same sqlite
schema. Each package reads only its own store.

Reference analog (SURVEY.md §2.4 "Metadata (MLMD)"): ml-metadata (C++
gRPC service over MySQL) records executions, artifacts, and events so
runs are queryable by lineage. Per SURVEY.md §2.8, C++ is not
perf-critical here — this is a sqlite-backed store with the same data
model: executions ←events→ artifacts, contexts (runs) grouping both.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Any

_SCHEMA = """
CREATE TABLE IF NOT EXISTS executions (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id TEXT NOT NULL,
    task TEXT NOT NULL,
    component TEXT NOT NULL,
    state TEXT NOT NULL,
    cache_hit INTEGER NOT NULL DEFAULT 0,
    started REAL NOT NULL,
    finished REAL,
    error TEXT
);
CREATE TABLE IF NOT EXISTS artifacts (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    uri TEXT NOT NULL,
    type TEXT NOT NULL,
    name TEXT NOT NULL,
    metadata TEXT NOT NULL DEFAULT '{}'
);
CREATE TABLE IF NOT EXISTS events (
    execution_id INTEGER NOT NULL REFERENCES executions(id),
    artifact_id INTEGER NOT NULL REFERENCES artifacts(id),
    direction TEXT NOT NULL CHECK (direction IN ('input','output'))
);
CREATE INDEX IF NOT EXISTS idx_exec_run ON executions(run_id);
CREATE INDEX IF NOT EXISTS idx_art_uri ON artifacts(uri);
"""


class LineageStore:
    def __init__(self, path: str = ":memory:"):
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.executescript(_SCHEMA)
        self._lock = threading.Lock()

    # -- write path ---------------------------------------------------- #

    def begin_execution(self, run_id: str, task: str, component: str) -> int:
        with self._lock:
            cur = self._db.execute(
                "INSERT INTO executions (run_id, task, component, state, started)"
                " VALUES (?,?,?,?,?)",
                (run_id, task, component, "RUNNING", time.time()),
            )
            self._db.commit()
            return cur.lastrowid

    def finish_execution(self, exec_id: int, *, state: str,
                         cache_hit: bool = False, error: str = "") -> None:
        with self._lock:
            self._db.execute(
                "UPDATE executions SET state=?, cache_hit=?, finished=?, error=?"
                " WHERE id=?",
                (state, int(cache_hit), time.time(), error or None, exec_id),
            )
            self._db.commit()

    def record_artifact(self, exec_id: int, *, uri: str, type_: str,
                        name: str, direction: str,
                        metadata: dict[str, Any] | None = None) -> int:
        with self._lock:
            row = self._db.execute(
                "SELECT id FROM artifacts WHERE uri=? AND name=?", (uri, name)
            ).fetchone()
            if row:
                art_id = row[0]
            else:
                art_id = self._db.execute(
                    "INSERT INTO artifacts (uri, type, name, metadata)"
                    " VALUES (?,?,?,?)",
                    (uri, type_, name, json.dumps(metadata or {})),
                ).lastrowid
            self._db.execute(
                "INSERT INTO events (execution_id, artifact_id, direction)"
                " VALUES (?,?,?)",
                (exec_id, art_id, direction),
            )
            self._db.commit()
            return art_id

    # -- query path ---------------------------------------------------- #

    def runs(self) -> list[dict]:
        """All pipeline runs with task-state rollups (the frontend's run
        list — SURVEY.md §2.4 Frontend row)."""
        with self._lock:
            rows = self._db.execute(
                # case-insensitive: the runner writes 'SUCCEEDED'/'FAILED'
                "SELECT run_id, COUNT(*),"
                " SUM(UPPER(state)='SUCCEEDED'), SUM(UPPER(state)='FAILED'),"
                " SUM(cache_hit), MIN(started), MAX(finished)"
                " FROM executions GROUP BY run_id ORDER BY MIN(started) DESC"
            ).fetchall()
        out = []
        for run_id, total, ok, failed, cached, started, finished in rows:
            state = (
                "Failed" if failed else
                "Succeeded" if ok == total else "Running"
            )
            out.append(
                {
                    "run_id": run_id,
                    "state": state,
                    "tasks": total,
                    "succeeded": ok or 0,
                    "failed": failed or 0,
                    "cache_hits": cached or 0,
                    "started": started,
                    "finished": finished,
                }
            )
        return out

    def executions(self, run_id: str) -> list[dict]:
        with self._lock:
            rows = self._db.execute(
                "SELECT id, task, component, state, cache_hit, started,"
                " finished, error FROM executions WHERE run_id=? ORDER BY id",
                (run_id,),
            ).fetchall()
        keys = ("id", "task", "component", "state", "cache_hit", "started",
                "finished", "error")
        return [dict(zip(keys, r)) for r in rows]

    def artifacts_of(self, exec_id: int, direction: str | None = None) -> list[dict]:
        q = ("SELECT a.id, a.uri, a.type, a.name, a.metadata, e.direction"
             " FROM artifacts a JOIN events e ON a.id = e.artifact_id"
             " WHERE e.execution_id=?")
        args: tuple = (exec_id,)
        if direction:
            q += " AND e.direction=?"
            args = (exec_id, direction)
        with self._lock:
            rows = self._db.execute(q, args).fetchall()
        return [
            {"id": r[0], "uri": r[1], "type": r[2], "name": r[3],
             "metadata": json.loads(r[4]), "direction": r[5]}
            for r in rows
        ]

    def lineage(self, uri: str) -> list[dict]:
        """All executions that produced or consumed an artifact uri."""
        with self._lock:
            rows = self._db.execute(
                "SELECT DISTINCT x.id, x.run_id, x.task, x.component,"
                " x.state, e.direction"
                " FROM executions x JOIN events e ON x.id = e.execution_id"
                " JOIN artifacts a ON a.id = e.artifact_id WHERE a.uri=?"
                " ORDER BY x.id",
                (uri,),
            ).fetchall()
        keys = ("id", "run_id", "task", "component", "state", "direction")
        return [dict(zip(keys, r)) for r in rows]

    def close(self) -> None:
        self._db.close()

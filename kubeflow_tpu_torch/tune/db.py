"""Trial/observation persistence — the Katib DB-manager analog.

A copy of ``kubeflow_tpu/tune/db.py``: the same sqlite schema, so a
database either package wrote resumes in the other.

Reference analog: [katib] cmd/db-manager + pkg/db/v1beta1/ — a gRPC facade
over MySQL storing trial observation logs, which is what lets an experiment
survive controller restarts (SURVEY.md §2.3 "DB manager + storage" row;
UNVERIFIED, mount empty — §0). Here: sqlite (available in this image) with
the same two tables — trials and observation logs — and the same
restart-resume contract, exercised by
tests/test_persistence.py::test_experiment_resumes_after_controller_restart.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time

from kubeflow_tpu_torch.tune.spec import Trial, TrialAssignment, TrialState

_SCHEMA = """
CREATE TABLE IF NOT EXISTS trials (
    experiment TEXT NOT NULL,
    trial_id   TEXT NOT NULL,
    parameters TEXT NOT NULL,
    state      TEXT NOT NULL,
    metrics    TEXT NOT NULL DEFAULT '{}',
    message    TEXT NOT NULL DEFAULT '',
    updated    REAL NOT NULL,
    PRIMARY KEY (experiment, trial_id)
);
CREATE TABLE IF NOT EXISTS observations (
    experiment TEXT NOT NULL,
    trial_id   TEXT NOT NULL,
    metric     TEXT NOT NULL,
    step       INTEGER NOT NULL,
    value      REAL NOT NULL,
    ts         REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_obs_trial
    ON observations(experiment, trial_id, metric);
"""


class TrialDB:
    """sqlite-backed trial + observation-log store."""

    def __init__(self, path: str = ":memory:"):
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.executescript(_SCHEMA)
        self._db.commit()
        self._lock = threading.Lock()

    # -- trials --------------------------------------------------------- #

    def record_trial(self, experiment: str, trial: Trial) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO trials"
                " (experiment, trial_id, parameters, state, metrics, message,"
                "  updated) VALUES (?,?,?,?,?,?,?)",
                (
                    experiment,
                    trial.assignment.trial_id,
                    json.dumps(trial.assignment.parameters),
                    trial.state.value,
                    json.dumps(trial.metrics),
                    trial.message,
                    time.time(),
                ),
            )
            self._db.commit()

    def experiments(self) -> list[dict]:
        """Experiment rollups for the tuner UI (Katib-UI analog)."""
        with self._lock:
            rows = self._db.execute(
                "SELECT experiment, COUNT(*),"
                " SUM(state='Succeeded'), SUM(state='Failed'),"
                " SUM(state='Running'), MAX(updated)"
                " FROM trials GROUP BY experiment ORDER BY MAX(updated) DESC"
            ).fetchall()
        return [
            {
                "name": name,
                "trials": total,
                "succeeded": ok or 0,
                "failed": failed or 0,
                "running": running or 0,
                "updated": updated,
            }
            for name, total, ok, failed, running, updated in rows
        ]

    def load_trials(self, experiment: str) -> list[Trial]:
        with self._lock:
            rows = self._db.execute(
                "SELECT trial_id, parameters, state, metrics, message"
                " FROM trials WHERE experiment=? ORDER BY updated",
                (experiment,),
            ).fetchall()
        out = []
        for tid, params, state, metrics, message in rows:
            t = Trial(
                assignment=TrialAssignment(json.loads(params), trial_id=tid),
                state=TrialState(state),
                metrics=json.loads(metrics),
                message=message,
            )
            t.observations = self.observations(experiment, tid)
            out.append(t)
        return out

    # -- observation log (ReportObservationLog analog) ------------------ #

    def report_observation(
        self, experiment: str, trial_id: str, metric: str,
        step: int, value: float,
    ) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO observations"
                " (experiment, trial_id, metric, step, value, ts)"
                " VALUES (?,?,?,?,?,?)",
                (experiment, trial_id, metric, int(step), float(value),
                 time.time()),
            )
            self._db.commit()

    def report_observations(
        self, experiment: str, trial_id: str, metric: str,
        series: list[tuple[int, float]],
    ) -> None:
        with self._lock:
            now = time.time()
            self._db.executemany(
                "INSERT INTO observations"
                " (experiment, trial_id, metric, step, value, ts)"
                " VALUES (?,?,?,?,?,?)",
                [
                    (experiment, trial_id, metric, int(s), float(v), now)
                    for s, v in series
                ],
            )
            self._db.commit()

    def replace_observations(
        self, experiment: str, trial_id: str, metric: str,
        series: list[tuple[int, float]],
    ) -> None:
        """Atomically rewrite one trial's observation log for a metric —
        the recovery path when a stored log diverges from the in-memory
        one (restart races); plain appends would record a wrong tail."""
        with self._lock:
            now = time.time()
            self._db.execute(
                "DELETE FROM observations"
                " WHERE experiment=? AND trial_id=? AND metric=?",
                (experiment, trial_id, metric),
            )
            self._db.executemany(
                "INSERT INTO observations"
                " (experiment, trial_id, metric, step, value, ts)"
                " VALUES (?,?,?,?,?,?)",
                [
                    (experiment, trial_id, metric, int(s), float(v), now)
                    for s, v in series
                ],
            )
            self._db.commit()

    def observations(
        self, experiment: str, trial_id: str, metric: str | None = None
    ) -> list[tuple[int, float]]:
        q = (
            "SELECT step, value FROM observations"
            " WHERE experiment=? AND trial_id=?"
        )
        args: list = [experiment, trial_id]
        if metric is not None:
            q += " AND metric=?"
            args.append(metric)
        q += " ORDER BY rowid"
        with self._lock:
            return [
                (int(s), float(v))
                for s, v in self._db.execute(q, args).fetchall()
            ]

    def close(self) -> None:
        with self._lock:
            self._db.close()

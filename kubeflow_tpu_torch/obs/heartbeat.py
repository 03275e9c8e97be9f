"""Worker liveness heartbeats: the port of ``kubeflow_tpu/obs/heartbeat.py``.

A hung worker (alive but stuck in a collective) is what exit monitoring
misses. The worker side, :class:`HeartbeatWriter`, rewrites a per-worker
JSON file in the job workdir on a background thread and on every
completed step; the JAX supervisor reads it with :func:`read_heartbeat` /
:func:`is_stale` (the file format is the JAX package's, so either side
reads the other's). The file's path comes from the orchestrator's gang
wiring, whose names the port keeps its own copy of (:data:`ENV_WORKDIR`
and friends, ``kubeflow_tpu/orchestrator/envwire.py``'s).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from pathlib import Path

#: the orchestrator's gang wiring (envwire's names)
ENV_REPLICA_TYPE = "KFT_REPLICA_TYPE"
ENV_REPLICA_INDEX = "KFT_REPLICA_INDEX"
ENV_WORKDIR = "KFT_WORKDIR"
ENV_ATTEMPT = "KFT_ATTEMPT"

#: filename pattern inside the job workdir
_FILE = "heartbeat-{rtype}-{index}.json"


def heartbeat_path(workdir: str | Path, rtype: str, index: int) -> Path:
    return Path(workdir) / _FILE.format(rtype=rtype, index=index)


def heartbeat_path_from_env(env: dict[str, str] | None = None) -> Path | None:
    """This worker's heartbeat file from the gang wiring; None outside a
    gang."""
    e = os.environ if env is None else env
    workdir = e.get(ENV_WORKDIR)
    rtype = e.get(ENV_REPLICA_TYPE)
    index = e.get(ENV_REPLICA_INDEX)
    if not (workdir and rtype and index is not None):
        return None
    return heartbeat_path(workdir, rtype, int(index))


@dataclasses.dataclass
class Heartbeat:
    #: ``time.monotonic()`` stamp: staleness is duration math, and
    #: CLOCK_MONOTONIC is boot-relative host-wide, so worker and
    #: supervisor stamps compare on one host
    time: float
    pid: int
    step: int = -1
    attempt: int = 0

    def age(self, now: float | None = None) -> float:
        return (time.monotonic() if now is None else now) - self.time


class HeartbeatWriter:
    """Background beat plus an explicit ``beat(step=...)`` a step."""

    def __init__(self, path: str | Path, *, interval: float = 1.0,
                 attempt: int = 0):
        self.path = Path(path)
        self.interval = interval
        self.attempt = attempt
        self._step = -1
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._write_lock = threading.Lock()
        self.path.parent.mkdir(parents=True, exist_ok=True)

    @classmethod
    def from_env(cls, *, interval: float = 1.0) -> "HeartbeatWriter | None":
        path = heartbeat_path_from_env()
        if path is None:
            return None
        return cls(path, interval=interval,
                   attempt=int(os.environ.get(ENV_ATTEMPT, "0")))

    def start(self) -> "HeartbeatWriter":
        if self._thread is None:
            self.beat()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="kft-heartbeat")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.beat()

    def beat(self, step: int | None = None) -> None:
        # one lock from the step update to the rename: the background beat
        # and beat(step) share one tmp file, and a payload built outside
        # the lock could publish an older step after a newer one
        tmp = self.path.with_suffix(".tmp")
        with self._write_lock:
            if step is not None:
                self._step = step
            payload = json.dumps(dataclasses.asdict(Heartbeat(
                time=time.monotonic(), pid=os.getpid(), step=self._step,
                attempt=self.attempt)))
            tmp.write_text(payload)
            os.replace(tmp, self.path)  # readers never see a torn file

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def __enter__(self) -> "HeartbeatWriter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def read_heartbeat(path: str | Path) -> Heartbeat | None:
    """None if the file is absent or torn (no beat yet)."""
    try:
        return Heartbeat(**json.loads(Path(path).read_text()))
    except (OSError, ValueError, TypeError):
        return None


def is_stale(path: str | Path, timeout: float, *, min_attempt: int = 0,
             now: float | None = None) -> bool:
    """True when the latest beat (of at least ``min_attempt``) is older
    than ``timeout``; a missing file is not stale. ``now`` is a
    ``time.monotonic()`` reading."""
    hb = read_heartbeat(path)
    if hb is None or hb.attempt < min_attempt:
        return False
    return hb.age(now) > timeout

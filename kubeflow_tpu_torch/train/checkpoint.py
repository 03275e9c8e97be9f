"""Checkpoint/restore of the port's training state, with sha256 integrity.

Counterpart of the JAX package's ``train/checkpoint.py``, with the same
``CheckpointConfig`` fields and ``Checkpointer`` lifecycle, in the port's
own format: one directory per step, ``<directory>/<step>/``, holding
``state.pt`` (``torch.save`` of the model and optimizer ``state_dict``s
and the step) and ``_KFT_MANIFEST.json``, a per-file sha256 manifest.
These are not Orbax checkpoints: trained weights reach the JAX package
through ``models/bridge.py`` ``state_dict_to_params``.

A step directory is written under a temporary name and renamed into
place, so a step that exists is whole; the manifest catches what the
rename cannot (bit-rot, torn copies, injected corruption), and
``restore`` walks back past steps that fail it. ``async_save`` copies the
state to host memory on the caller's thread (a consistent snapshot),
then writes and hashes it on a background thread that ``wait`` and
``close`` join.

``save(register=RegisterOnSave(...))`` links training into the model
registry (``registry/``) as the JAX ``Checkpointer`` does: a step that
saved becomes a new model version with a ``checkpoint`` lineage edge and
its ``step`` in the metadata, at once for a synchronous save and, for an
asynchronous one, at the next ``save`` that finds the write finished or
at ``wait``/``close``: the registry never hashes a half-written step.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import torch

logger = logging.getLogger(__name__)

MANIFEST_NAME = "_KFT_MANIFEST.json"
STATE_NAME = "state.pt"


class CorruptCheckpointError(RuntimeError):
    """A checkpoint step failed its sha256 manifest verification."""


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    save_every_steps: int = 100
    max_to_keep: int = 3
    async_save: bool = True


def _to_host(tree: Any) -> Any:
    """A host copy of every tensor in a nested state (dicts, lists,
    tuples), so later in-place updates on the device cannot reach it."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class Checkpointer:
    """Save on an interval, keep the newest ``max_to_keep`` steps, verify
    and restore. ``state`` is a dict of picklable values and tensors
    (the trainer saves ``{"model": ..., "optimizer": ..., "step": n}``)."""

    def __init__(self, config: CheckpointConfig):
        self.config = config
        self.path = Path(config.directory).absolute()
        self.path.mkdir(parents=True, exist_ok=True)
        self._writer: threading.Thread | None = None
        self._pending: int | None = None  # the step the writer is writing
        self._error: BaseException | None = None
        #: registering saves not yet ingested: [(step, RegisterOnSave)]
        self._pending_register: list[tuple[int, Any]] = []
        #: the ModelVersion of the most recent registering save
        self.last_registered: Any | None = None

    # ------------------------------------------------------------------ #

    def should_save(self, step: int) -> bool:
        """The interval policy: ``step`` is a multiple of
        ``save_every_steps``, newer than the latest step, not yet saved."""
        latest = self.latest_step()
        return (step % self.config.save_every_steps == 0
                and (latest is None or step > latest))

    def save(self, step: int, state: Any, *, force: bool = False,
             register: Any | None = None) -> bool:
        """Save ``state`` as ``step`` if :meth:`should_save` (or ``force``,
        unless the step exists). Returns whether it saved. ``register``
        (a ``registry.spec.RegisterOnSave``) registers the saved step."""
        self._ingest_ready()  # the previous write may be durable now
        if step == self._pending or (self.path / str(step)).exists():
            return False
        if not (force or self.should_save(step)):
            return False
        snapshot = _to_host(state)
        self.wait()  # one write in flight at a time, in step order
        self._pending = step
        if register is not None:
            self._pending_register.append((step, register))
        if self.config.async_save:
            self._writer = threading.Thread(
                target=self._write_guarded, args=(step, snapshot),
                name="kft-checkpoint", daemon=True,
            )
            self._writer.start()
        else:
            self._write_guarded(step, snapshot)
            self.wait()
        return True

    def _ingest_ready(self, block: bool = False) -> None:
        """Register the pending registering saves once their write is
        durable: at once with ``block``, else only if the writer is done."""
        if not self._pending_register:
            return
        if not block and self._writer is not None and self._writer.is_alive():
            return
        self._join()
        pending, self._pending_register = self._pending_register, []
        for step, register in pending:
            ckpt = str(self.path / str(step))
            self.last_registered = register.store.register_version(
                register.name,
                ckpt,
                source_uri="file://" + ckpt,
                metadata={**dict(register.metadata), "step": int(step)},
                stage=register.stage,
                lineage=[(
                    "checkpoint",
                    f"{self.config.directory}@{step}",
                    {"step": int(step)},
                )],
            )

    def _write_guarded(self, step: int, snapshot: Any) -> None:
        try:
            self._write(step, snapshot)
        except BaseException as e:  # noqa: BLE001 — re-raised by wait()
            self._error = e

    def _write(self, step: int, snapshot: Any) -> None:
        final = self.path / str(step)
        tmp = self.path / f".{step}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(snapshot, tmp / STATE_NAME)
        manifest = {"step": int(step), "files": _hash_tree(tmp)}
        (tmp / MANIFEST_NAME).write_text(json.dumps(manifest, sort_keys=True))
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.config.max_to_keep]:
            shutil.rmtree(self.path / str(old), ignore_errors=True)

    # -- integrity ------------------------------------------------------ #

    def verify_step(self, step: int) -> bool | None:
        """True: the manifest is present and every file matches. False:
        mismatch, unreadable or missing step (corrupt). None: no manifest
        (trusted, since a step directory only appears whole)."""
        step_dir = self.path / str(step)
        if not step_dir.is_dir():
            return False
        mpath = step_dir / MANIFEST_NAME
        if not mpath.exists():
            return None
        try:
            want = json.loads(mpath.read_text())["files"]
            return _hash_tree(step_dir) == want
        except (OSError, ValueError, KeyError):
            return False

    def latest_step(self) -> int | None:
        """The newest saved step, counting a write still in flight."""
        steps = self.all_steps()
        if self._pending is not None:
            steps.append(self._pending)
        return max(steps) if steps else None

    def all_steps(self) -> list[int]:
        return sorted(
            int(p.name) for p in self.path.iterdir()
            if p.is_dir() and p.name.isdigit()
        )

    def latest_valid_step(self) -> int | None:
        """Newest step whose manifest verifies (or that has none); None
        when every step is corrupt or none exist."""
        for step in reversed(self.all_steps()):
            if self.verify_step(step) is not False:
                return step
        return None

    # ------------------------------------------------------------------ #

    def restore(self, step: int | None = None) -> Any:
        """The saved state (on the CPU) of ``step``, or with ``step=None``
        of the newest step that verifies and loads: corrupt steps are
        skipped with a warning. An explicit ``step`` that fails
        verification raises ``CorruptCheckpointError``."""
        self.wait()
        if step is not None:
            if self.verify_step(step) is False:
                raise CorruptCheckpointError(
                    f"checkpoint step {step} under {self.path} fails its "
                    "sha256 manifest"
                )
            return self._load(step)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint found under {self.path}")
        last_err: Exception | None = None
        for s in reversed(steps):
            if self.verify_step(s) is False:
                logger.warning("checkpoint step %d fails its sha256 manifest; "
                               "falling back to the previous step", s)
                continue
            try:
                return self._load(s)
            except Exception as e:  # noqa: BLE001 — unreadable ≈ corrupt
                last_err = e
                logger.warning("checkpoint step %d failed to load (%s: %s); "
                               "falling back", s, type(e).__name__, e)
        raise CorruptCheckpointError(
            f"every checkpoint under {self.path} is corrupt or unreadable "
            f"(steps {steps})"
        ) from last_err

    def _load(self, step: int) -> Any:
        return torch.load(self.path / str(step) / STATE_NAME,
                          map_location="cpu", weights_only=True)

    def _join(self) -> None:
        """Block until the write in flight is durable; re-raise its error
        (its registration, if any, is dropped with it)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            self._pending_register.clear()
            raise err

    def wait(self) -> None:
        """Block until the write in flight is durable, then run deferred
        registrations; re-raise the write's error."""
        self._join()
        self._ingest_ready(block=True)

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _hash_tree(root: Path) -> dict[str, str]:
    """relpath → sha256 of every file under ``root`` (manifest excluded)."""
    out: dict[str, str] = {}
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if name == MANIFEST_NAME:
                continue
            p = Path(dirpath) / name
            h = hashlib.sha256()
            with open(p, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            out[os.path.relpath(p, root)] = h.hexdigest()
    return out

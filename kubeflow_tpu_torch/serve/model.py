"""Serving model base: the ``load / preprocess / predict / postprocess``
lifecycle of ``kubeflow_tpu/serve/model.py:Model`` (KServe's ``Model``),
``BucketSpec``, the closed set of padded shapes a runtime serves, and
:class:`TorchModel`, the bucketed predictor with device-resident weights
(the JAX ``JAXModel``)."""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch import resolve_device


def retire(model: "Model") -> None:
    """Permanently remove a model (service deleted, or replaced by a
    rollout). A mesh-backed model tells retire (deregister) from unload
    (release the weights, keep the registration: scale to zero); a plain
    model just unloads."""
    getattr(model, "retire", model.unload)()


class Model:
    """Base serving model: subclass and override the lifecycle hooks.

    The server calls ``preprocess → predict → postprocess`` per request;
    ``load()`` runs once before the model is marked ready.
    """

    def __init__(self, name: str):
        self.name = name
        self.ready = False

    def load(self) -> bool:
        self.ready = True
        return self.ready

    def preprocess(self, payload: Any, headers: Mapping[str, str] | None = None) -> Any:
        return payload

    def predict(self, inputs: Any, headers: Mapping[str, str] | None = None) -> Any:
        raise NotImplementedError

    def postprocess(self, outputs: Any, headers: Mapping[str, str] | None = None) -> Any:
        return outputs

    def unload(self) -> None:
        self.ready = False

    def explain(self, payload: Any, headers: Mapping[str, str] | None = None) -> Any:
        """The ``:explain`` verb (KServe explainer component). Runtimes with
        a meaningful attribution story override this; the default is 501."""
        raise NotImplementedError(f"model '{self.name}' has no explainer")

    def __call__(self, payload: Any, headers: Mapping[str, str] | None = None) -> Any:
        x = self.preprocess(payload, headers)
        return self.postprocess(self.predict(x, headers), headers)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Closed set of padded shapes a runtime serves.

    ``batch_sizes`` and ``seq_lens`` must be sorted ascending. A request
    of shape (b, s) is padded up to the smallest bucket >= it; an
    oversize request raises.
    """

    batch_sizes: tuple[int, ...] = (1, 4, 16)
    seq_lens: tuple[int, ...] = (32, 128, 512)

    def bucket_batch(self, n: int) -> int:
        i = bisect.bisect_left(self.batch_sizes, n)
        if i == len(self.batch_sizes):
            raise ValueError(f"batch {n} exceeds max bucket {self.batch_sizes[-1]}")
        return self.batch_sizes[i]

    def bucket_seq(self, n: int) -> int:
        i = bisect.bisect_left(self.seq_lens, n)
        if i == len(self.seq_lens):
            raise ValueError(f"seq {n} exceeds max bucket {self.seq_lens[-1]}")
        return self.seq_lens[i]


class TorchModel(Model):
    """A PyTorch predictor with device-resident weights and bucket
    batching: the twin of the JAX ``JAXModel``.

    ``init_module(device) -> nn.Module`` builds the weights on ``device``
    (``None`` = the CUDA card) at :meth:`load`, once; readiness means they
    are there. ``apply_fn(module, input_ids, attention_mask,
    token_type_ids) -> Tensor`` is the forward, given ``(bucket_batch,
    bucket_seq)`` int32 tensors on the device and run under
    ``torch.inference_mode()``, one call at a time. A request pads up to
    its (batch, seq) bucket, with id 0 and mask 0, and gets back
    ``out[:n]``: batch padding is stripped, seq padding is the caller's
    to see. Eager torch compiles nothing, so ``stats`` has no
    ``compiles``: ``requests`` (forwards) and ``predict_ms``.
    """

    def __init__(
        self,
        name: str,
        apply_fn: Callable[..., torch.Tensor],
        init_module: Callable[[torch.device], torch.nn.Module],
        *,
        buckets: BucketSpec | None = None,
        device=None,
    ):
        super().__init__(name)
        self._apply_fn = apply_fn
        self._init_module = init_module
        self.buckets = buckets or BucketSpec()
        self._device = device
        self.module: torch.nn.Module | None = None
        self._dev: torch.device | None = None
        self._lock = threading.Lock()  # one forward at a time
        self.stats: dict[str, Any] = {
            "requests": 0,
            "predict_ms": deque(maxlen=1024),  # bounded: long-lived servers
        }

    # -- lifecycle --------------------------------------------------------- #

    def load(self) -> bool:
        dev = resolve_device(self._device)
        module = self._init_module(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # ready means the weights are there
        self.module, self._dev = module, dev
        self.ready = True
        return True

    def unload(self) -> None:
        self.module = None
        self.ready = False

    def warmup(self) -> None:
        """One forward per (batch, seq) bucket, so the first real requests
        pay no first-launch costs (kernel build, library handles)."""
        for b in self.buckets.batch_sizes:
            for s in self.buckets.seq_lens:
                ids = np.zeros((b, s), np.int32)
                self._forward(ids, np.zeros_like(ids), np.zeros_like(ids))

    # -- data path --------------------------------------------------------- #

    def _normalize_row(self, r: Any) -> Any:
        """One instance → 1-D id array, or a dict of named 1-D arrays
        (input_ids required; attention_mask/token_type_ids optional)."""
        if isinstance(r, Mapping):
            if "input_ids" not in r:
                raise ValueError(
                    f"named instance must carry 'input_ids'; got {sorted(r)}"
                )
            out = {"input_ids": np.asarray(r["input_ids"], np.int32).reshape(-1)}
            n = out["input_ids"].shape[0]
            for k in ("attention_mask", "token_type_ids"):
                if r.get(k) is not None:
                    arr = np.asarray(r[k], np.int32).reshape(-1)
                    if arr.shape[0] != n:
                        # reject HERE with a clear message: a ragged row
                        # reaching predict() would fail the shared batch
                        raise ValueError(
                            f"{k} length {arr.shape[0]} != input_ids length {n}"
                        )
                    out[k] = arr
            return out
        return np.asarray(r, np.int32)

    @staticmethod
    def payload_rows(payload: Any) -> list[Any]:
        """{"instances": [...]} | {"inputs": {name: batch array}} | sequence
        → raw per-instance rows: the one normalization point for the two
        payload shapes (the server and every runtime route through
        here)."""
        if isinstance(payload, Mapping) and isinstance(payload.get("inputs"), Mapping):
            from kubeflow_tpu_torch.serve.protocol import rows_from_named

            return rows_from_named(payload["inputs"])
        if isinstance(payload, Mapping) and "instances" in payload:
            return list(payload["instances"])
        return list(payload)

    def preprocess(self, payload: Any, headers: Mapping[str, str] | None = None) -> Any:
        rows = [self._normalize_row(r) for r in self.payload_rows(payload)]
        if not rows:
            raise ValueError("empty request")
        return rows

    def _forward(self, ids, mask, tt) -> tuple[np.ndarray, float]:
        """The forward of one padded bucket: its output on the host and
        its wall ms (uploads and the copy back included)."""
        with self._lock, torch.inference_mode():
            t0 = time.perf_counter()
            out = self._apply_fn(self.module, *(
                torch.from_numpy(a).to(self._dev) for a in (ids, mask, tt)))
            out = out.cpu().numpy()
            return out, (time.perf_counter() - t0) * 1e3

    def predict(self, inputs: Sequence[Any], headers=None) -> np.ndarray:
        def ids_of(r):
            return r["input_ids"] if isinstance(r, Mapping) else r

        n = len(inputs)
        s = max(int(ids_of(r).shape[-1]) for r in inputs)
        bb = self.buckets.bucket_batch(n)
        bs = self.buckets.bucket_seq(s)
        ids = np.zeros((bb, bs), np.int32)
        mask = np.zeros((bb, bs), np.int32)
        tt = np.zeros((bb, bs), np.int32)
        for i, r in enumerate(inputs):
            row = ids_of(r)
            ln = row.shape[-1]
            ids[i, :ln] = row
            if isinstance(r, Mapping) and "attention_mask" in r:
                mask[i, :ln] = r["attention_mask"][:ln]
            else:
                mask[i, :ln] = 1
            if isinstance(r, Mapping) and "token_type_ids" in r:
                tt[i, :ln] = r["token_type_ids"][:ln]
        out, ms = self._forward(ids, mask, tt)
        with self._lock:
            self.stats["predict_ms"].append(ms)
            self.stats["requests"] += 1
        return out[:n]  # strip batch padding; seq padding is caller-visible

    def postprocess(self, outputs: np.ndarray, headers=None) -> Any:
        return {"predictions": outputs.tolist()}

"""sklearn-format serving runtime — the non-transformer predictor. The
port of ``kubeflow_tpu/serve/sklearn_runtime.py``.

Load a pickled estimator from the model dir and answer v1/v2 predict
requests (KServe's sklearnserver):

- **Linear-family estimators** (``sklearn.linear_model``: anything
  exposing ``coef_``/``intercept_`` there — LinearRegression, Ridge,
  LogisticRegression, SGD*) run ``X @ W + b`` in f32 on the device, with
  the argmax (or the sign of the one decision column) on the device for
  classifiers, mapped through ``classes_`` on the host; the weights stay
  resident from ``load`` on.
- **Everything else** (forests, pipelines, SVC, …) serves through the
  estimator's own ``predict`` on the host.

``joblib`` and ``sklearn`` are imported only inside ``load`` (unpickling
an estimator needs them), so the package imports on a host without them.

Storage layout (the /mnt/models contract): ``model.joblib`` / ``model.pkl``
/ any single ``*.joblib``/``*.pkl`` file in the directory, or the file
itself as ``storage_path``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from kubeflow_tpu_torch import resolve_device
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.tabular import coerce_tabular_payload, find_model_file


def _find_model_file(storage_path: str) -> str:
    return find_model_file(
        storage_path,
        preferred=("model.joblib", "model.pkl", "model.pickle"),
        suffixes=(".joblib", ".pkl", ".pickle"),
        kind="sklearn",
    )


class DeviceLinearEstimator:
    """An OVR/plain-linear estimator's decision function resident on a
    device: ``(B, F)`` float32 rows → scores ``X @ W + b`` (regressors),
    or the class index (classifiers: the argmax of the scores, or
    ``score > 0`` for one decision column), as a tensor on the device."""

    def __init__(self, coef, intercept, *, classifier: bool, device=None):
        dev = resolve_device(device)
        self.device, self.classifier = dev, classifier
        self.w = torch.from_numpy(
            np.ascontiguousarray(np.atleast_2d(np.asarray(coef)).T, np.float32)).to(dev)
        self.b = torch.from_numpy(
            np.ascontiguousarray(np.ravel(np.asarray(intercept)), np.float32)).to(dev)

    def __call__(self, x) -> torch.Tensor:
        with torch.inference_mode():
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            scores = torch.addmm(self.b, x.to(self.device, torch.float32), self.w)
            n_out = scores.shape[1]
            if not self.classifier:
                return scores[:, 0] if n_out == 1 else scores
            if n_out == 1:  # binary: one decision column
                return (scores[:, 0] > 0).to(torch.int32)
            return torch.argmax(scores, dim=-1).to(torch.int32)


class SklearnRuntimeModel(Model):
    """Pickled sklearn estimator behind the standard Model lifecycle;
    ``device=None`` is the card (the linear fast path's)."""

    def __init__(self, name: str, storage_path: str | None, *, device=None,
                 **_ignored: Any):
        super().__init__(name)
        if storage_path is None:
            raise ValueError(
                f"sklearn model {name!r} requires a storage_path"
            )
        self._storage_path = storage_path
        self._device = device
        self._estimator = None
        self._linear: DeviceLinearEstimator | None = None  # the device path
        self._classes = None

    # -- lifecycle ---------------------------------------------------------- #

    def load(self) -> bool:
        path = _find_model_file(self._storage_path)
        try:
            import joblib

            est = joblib.load(path)
        except ImportError:  # joblib ships with sklearn, but stay honest
            import pickle

            with open(path, "rb") as f:
                est = pickle.load(f)
        if not hasattr(est, "predict"):
            # fail closed: never report ready over a non-estimator pickle
            raise RuntimeError(
                f"{path!r} unpickled to {type(est).__name__}, which has no "
                "predict()"
            )
        self._estimator = est

        coef = getattr(est, "coef_", None)
        intercept = getattr(est, "intercept_", None)
        # Gate the fast path to sklearn.linear_model estimators: their
        # decision functions are OVR/plain-linear, so argmax of X@W+b IS
        # their predict. SVC-family estimators expose coef_ too but with one
        # row per class PAIR (OVO voting — shape-indistinguishable at n=3),
        # so anything outside linear_model serves on host. Correct > fast.
        if not type(est).__module__.startswith("sklearn.linear_model"):
            coef = None
        if coef is not None and intercept is not None:
            self._classes = getattr(est, "classes_", None)
            self._linear = DeviceLinearEstimator(
                coef, intercept, classifier=self._classes is not None,
                device=self._device)
            # weights on the device; one forward before ready
            n_feat = self._linear.w.shape[0]
            self._linear(np.zeros((1, n_feat), np.float32)).cpu()
        self.ready = True
        return True

    def unload(self) -> None:
        self._estimator = None
        self._linear = None
        self.ready = False

    # -- data path ----------------------------------------------------------- #

    def preprocess(self, payload: Any, headers: Mapping[str, str] | None = None):
        return coerce_tabular_payload(payload)

    def predict(self, inputs: np.ndarray, headers=None) -> np.ndarray:
        if self._linear is not None:
            out = self._linear(inputs).cpu().numpy()
            if self._classes is not None:
                return np.asarray(self._classes)[out]
            return out
        return np.asarray(self._estimator.predict(inputs))

    def postprocess(self, outputs: np.ndarray, headers=None) -> Any:
        return {"predictions": outputs.tolist()}

    def explain(self, payload: Any, headers=None) -> Any:
        """Exact attributions for linear-family estimators: feature i of
        row x contributes ``x_i * w_i`` to the decision (plus intercept) —
        no approximation needed, unlike tree/deep explainers."""
        est = self._estimator
        coef = getattr(est, "coef_", None)
        intercept = getattr(est, "intercept_", None)
        # same gate as the predict fast path: OVO estimators (linear SVC)
        # expose pairwise coef_ rows — presenting those as per-class
        # attributions would be silently wrong
        if (
            coef is None
            or intercept is None
            or not type(est).__module__.startswith("sklearn.linear_model")
        ):
            raise NotImplementedError(
                f"model '{self.name}': exact attributions need a "
                "sklearn.linear_model estimator (coef_/intercept_, OVR)"
            )
        x = self.preprocess(payload, headers)
        w = np.atleast_2d(np.asarray(coef))  # (n_out, n_feat)
        contrib = x[:, None, :] * w[None, :, :]  # (batch, n_out, n_feat)
        return {
            "explanations": [
                {
                    "contributions": c.squeeze(0).tolist()
                    if c.shape[0] == 1
                    else c.tolist(),
                    "intercept": np.ravel(np.asarray(intercept)).tolist(),
                }
                for c in contrib
            ]
        }

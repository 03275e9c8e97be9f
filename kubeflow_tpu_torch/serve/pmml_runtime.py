"""PMML serving runtime: XML model exchange on the shared device paths.
The port of ``kubeflow_tpu/serve/pmml_runtime.py``.

A first-party reader of the PMML 4.x elements that cover the
sklearn2pmml/JPMML exports people actually serve (the reference wraps
pypmml, a JVM bridge):

- ``RegressionModel`` (linear / logistic / softmax) → one f32 matmul +
  inverse link on the device (:func:`build_linear_predict`);
- ``TreeModel`` (binary SimplePredicate splits) and ``MiningModel``
  segmentations of TreeModels (sum / average / weightedAverage —
  forests and GBDTs) → the SAME lockstep device walk as the
  XGBoost/LightGBM runtimes (``xgboost_runtime.BoosterArrays``):
  ``lessOrEqual``/``lessThan`` left-branch thresholds convert to the
  walk's strict ``<`` with the float32 nextafter trick.

Anything outside that envelope — compound predicates, categorical
splits, n-ary nodes, missing-value strategies other than none/defaultChild-
free trees — fails CLOSED at parse: a silently-wrong traversal would
serve wrong answers.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Any, Mapping

import numpy as np

import torch

from kubeflow_tpu_torch import resolve_device
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.tabular import coerce_tabular_payload, find_model_file
from kubeflow_tpu_torch.serve.xgboost_runtime import (
    BoosterArrays,
    bucket_rows,
    build_device_predict,
)


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _children(el, name):
    return [c for c in el if _local(c.tag) == name]


def _child(el, name):
    got = _children(el, name)
    return got[0] if got else None


def _le_to_lt32(t: float) -> np.float32:
    """Smallest float32 strictly greater than the double ``t``: round
    toward −inf first — round-to-nearest can land above t, and nextafter
    from there misroutes v == float32(t) by one ULP (same defect class
    as lightgbm_runtime._le_to_lt)."""
    t32 = np.float32(t)
    if float(t32) > t:
        t32 = np.nextafter(t32, np.float32(-np.inf))
    return np.nextafter(t32, np.float32(np.inf))


def _lt_to_lt32(t: float) -> np.float32:
    """Smallest float32 >= the double ``t`` — the strict-< threshold for
    PMML ``lessThan``: when round-to-nearest lands BELOW t, the bare
    float32 cast excludes v == float32(t) < t from the left branch."""
    t32 = np.float32(t)
    if float(t32) < t:
        t32 = np.nextafter(t32, np.float32(np.inf))
    return t32


class _Fields:
    """Feature order = DataDictionary order minus the model's target
    field(s) (MiningSchema usageType="target") — the contract pmmlserver
    users rely on when POSTing positional feature rows."""

    def __init__(self, root, model_el):
        dd = _child(root, "DataDictionary")
        targets = set()
        ms = _child(model_el, "MiningSchema") if model_el is not None else None
        if ms is not None:
            targets = {
                f.get("name")
                for f in _children(ms, "MiningField")
                if f.get("usageType") in ("target", "predicted")
            }
        self.order: list[str] = []
        if dd is not None:
            for f in _children(dd, "DataField"):
                if f.get("name") not in targets:
                    self.order.append(f.get("name"))
        self.index = {n: i for i, n in enumerate(self.order)}

    def feature(self, name: str, *, path: str) -> int:
        if name not in self.index:
            raise RuntimeError(
                f"{path!r}: field {name!r} not in DataDictionary order "
                f"{self.order}"
            )
        return self.index[name]


# --------------------------------------------------------------------------- #
# TreeModel → BoosterArrays rows
# --------------------------------------------------------------------------- #


#: Deepest Node chain accepted in one TreeModel. Past this the lockstep
#: device walk is pathological anyway (every tree pads to the max depth),
#: and an unbounded chain must end in the module's fail-closed
#: RuntimeError, never in an uncontrolled RecursionError.
_MAX_TREE_DEPTH = 512


def _parse_tree(tree_el, fields: _Fields, *, path: str):
    """Flatten one binary TreeModel into node lists (feat, thresh, lc, rc,
    leaf values); returns (nodes, depth). PMML left child carries the
    lessOrEqual/lessThan predicate; the right child must be its
    complement (greaterThan/greaterOrEqual on the same field+value) or
    a True catch-all. Explicit work stack — document shape must never
    drive the Python stack."""
    root_node = _child(tree_el, "Node")
    if root_node is None:
        raise RuntimeError(f"{path!r}: TreeModel has no root Node")
    nodes: list[dict] = []
    max_depth = 0
    # (element, depth, parent index, child slot); popping the left child
    # first preserves the preorder numbering of the old recursive visit
    stack: list[tuple] = [(root_node, 0, -1, "")]
    while stack:
        el, d, parent, slot = stack.pop()
        if d > _MAX_TREE_DEPTH:
            raise RuntimeError(
                f"{path!r}: Node chain deeper than {_MAX_TREE_DEPTH} — "
                "refusing (degenerate tree; the padded lockstep walk "
                "would be pathological)"
            )
        idx = len(nodes)
        nodes.append({})
        if parent >= 0:
            nodes[parent][slot] = idx
        kids = _children(el, "Node")
        if not kids:
            score = el.get("score")
            if score is None:
                raise RuntimeError(f"{path!r}: leaf Node without score")
            nodes[idx] = {"leaf": float(score)}
            max_depth = max(max_depth, d)
            continue
        if len(kids) != 2:
            raise RuntimeError(
                f"{path!r}: only binary TreeModels are supported "
                f"(node has {len(kids)} children)"
            )
        # PMML evaluates children in DOCUMENT ORDER, first match wins.
        # The representable envelope is therefore strict: the FIRST child
        # must carry the lessOrEqual/lessThan predicate, and the second
        # must be its exact complement (same field+value) or <True/>.
        # Anything else — first-child True, non-complementary pair,
        # compound predicates — fails closed.
        for kid in kids:
            if _child(kid, "SimplePredicate") is None and _child(
                kid, "True"
            ) is None:
                raise RuntimeError(
                    f"{path!r}: child Node needs SimplePredicate or True "
                    "(compound predicates unsupported)"
                )
        sp = _child(kids[0], "SimplePredicate")
        op = sp.get("operator") if sp is not None else None
        if op not in ("lessOrEqual", "lessThan"):
            raise RuntimeError(
                f"{path!r}: first child of a split must carry "
                f"lessOrEqual/lessThan (got {op!r}) — PMML first-match "
                "order cannot be represented otherwise"
            )
        sp2 = _child(kids[1], "SimplePredicate")
        if sp2 is not None:
            complement = {
                "lessOrEqual": "greaterThan", "lessThan": "greaterOrEqual"
            }[op]
            if (
                sp2.get("operator") != complement
                or sp2.get("field") != sp.get("field")
                or float(sp2.get("value")) != float(sp.get("value"))
            ):
                raise RuntimeError(
                    f"{path!r}: second child's predicate is not the "
                    f"complement of the first ({sp.get('field')} {op} "
                    f"{sp.get('value')} vs {sp2.get('field')} "
                    f"{sp2.get('operator')} {sp2.get('value')}) — a "
                    "non-complementary pair would silently drop cases"
                )
        t = float(sp.get("value"))
        thresh = _le_to_lt32(t) if op == "lessOrEqual" else _lt_to_lt32(t)
        nodes[idx] = {
            "feat": fields.feature(sp.get("field"), path=path),
            "thresh": float(thresh),
        }
        stack.append((kids[1], d + 1, idx, "right"))
        stack.append((kids[0], d + 1, idx, "left"))

    return nodes, max_depth


def _trees_to_booster(
    tree_lists, weights, fields: _Fields, *, objective: str, path: str,
) -> BoosterArrays:
    T = len(tree_lists)
    n = max(len(nodes) for nodes, _ in tree_lists)
    feat = np.zeros((T, n), np.int32)
    thresh = np.zeros((T, n), np.float32)
    left = np.zeros((T, n), np.int32)
    right = np.zeros((T, n), np.int32)
    dleft = np.zeros((T, n), bool)
    is_leaf = np.ones((T, n), bool)
    leaf_val = np.zeros((T, n), np.float32)
    max_depth = 1
    for ti, ((nodes, d), w) in enumerate(zip(tree_lists, weights)):
        max_depth = max(max_depth, d)
        idx = np.arange(n)
        left[ti], right[ti] = idx.copy(), idx.copy()
        for i, nd in enumerate(nodes):
            if "leaf" in nd:
                leaf_val[ti, i] = nd["leaf"] * w
            else:
                feat[ti, i] = nd["feat"]
                thresh[ti, i] = nd["thresh"]
                left[ti, i] = nd["left"]
                right[ti, i] = nd["right"]
                is_leaf[ti, i] = False
                # PMML has no per-node NaN default; route NaN as 0.0 (the
                # pmmlserver behavior for dense inputs)
                dleft[ti, i] = 0.0 < nd["thresh"]
    return BoosterArrays(
        feat, thresh, left, right, dleft, is_leaf, leaf_val,
        np.zeros((T,), np.int32),
        max_depth=max_depth,
        num_class=1,
        num_feature=len(fields.order),
        base_score=0.0,
        objective=objective,
    )


# --------------------------------------------------------------------------- #
# document → predictor
# --------------------------------------------------------------------------- #


def _require_regression_trees(function_name: str | None, *, path: str) -> None:
    """Tree paths serve raw summed scores: a classification TreeModel /
    MiningModel (majorityVote, per-class score distributions…) under
    that walk would emit output with silently different shape and
    meaning than pmmlserver — outside the envelope, fail closed."""
    if function_name == "classification":
        raise RuntimeError(
            f"{path!r}: functionName='classification' tree models are "
            "not a supported shape (the lockstep walk serves regression "
            "scores; a category mapping would be silently dropped) — "
            "export as regression or use a RegressionModel with "
            "logit/softmax"
        )


def parse_pmml(path: str):
    """Returns (kind, what its predictor is built from). Two shapes:
    ("linear", (W, b, norm, num_feature)) or ("trees", BoosterArrays)."""
    try:
        root = ET.parse(path).getroot()
    except ET.ParseError as e:
        raise RuntimeError(f"{path!r} is not valid PMML XML: {e}") from e
    if _local(root.tag) != "PMML":
        raise RuntimeError(f"{path!r}: root element is not <PMML>")
    model_el = next(
        (
            c for c in root
            if _local(c.tag) in ("RegressionModel", "TreeModel", "MiningModel")
        ),
        None,
    )
    fields = _Fields(root, model_el)

    reg = _child(root, "RegressionModel")
    if reg is not None:
        tables = _children(reg, "RegressionTable")
        if not tables:
            raise RuntimeError(f"{path!r}: RegressionModel without tables")
        norm = reg.get("normalizationMethod", "none")
        # functionName="classification" promises probabilities/categories;
        # serving raw margins under that contract (norm none/unsupported)
        # would silently change output meaning vs pmmlserver — fail closed
        if reg.get("functionName") == "classification" and norm not in (
            "logit", "softmax"
        ):
            raise RuntimeError(
                f"{path!r}: classification RegressionModel with "
                f"normalizationMethod={norm!r} is not a supported shape "
                "(logit/softmax only) — raw margins would silently drop "
                "the category mapping"
            )
        F = len(fields.order)
        W = np.zeros((len(tables), F), np.float32)
        b = np.zeros((len(tables),), np.float32)
        for ci, tab in enumerate(tables):
            b[ci] = float(tab.get("intercept", "0"))
            for p in _children(tab, "NumericPredictor"):
                if int(p.get("exponent", "1")) != 1:
                    raise RuntimeError(
                        f"{path!r}: NumericPredictor exponent != 1"
                    )
                W[ci, fields.feature(p.get("name"), path=path)] = float(
                    p.get("coefficient")
                )
            if _children(tab, "CategoricalPredictor"):
                raise RuntimeError(
                    f"{path!r}: CategoricalPredictor unsupported — one-hot "
                    "encode features before export"
                )
        return "linear", (W, b, norm, F)

    tm = _child(root, "TreeModel")
    if tm is not None:
        _require_regression_trees(tm.get("functionName"), path=path)
        booster = _trees_to_booster(
            [_parse_tree(tm, fields, path=path)], [1.0], fields,
            objective="reg:squarederror", path=path,
        )
        return "trees", booster

    mm = _child(root, "MiningModel")
    if mm is not None:
        _require_regression_trees(mm.get("functionName"), path=path)
        seg = _child(mm, "Segmentation")
        if seg is None:
            raise RuntimeError(f"{path!r}: MiningModel without Segmentation")
        method = seg.get("multipleModelMethod", "sum")
        if method not in ("sum", "average", "weightedAverage"):
            raise RuntimeError(
                f"{path!r}: multipleModelMethod {method!r} unsupported "
                "(sum/average/weightedAverage)"
            )
        segments = _children(seg, "Segment")
        tree_lists, weights = [], []
        for s in segments:
            t = _child(s, "TreeModel")
            if t is None:
                raise RuntimeError(
                    f"{path!r}: only TreeModel segments are supported"
                )
            tree_lists.append(_parse_tree(t, fields, path=path))
            weights.append(float(s.get("weight", "1")))
        if method == "average":
            weights = [1.0 / len(segments)] * len(segments)
        elif method == "sum":
            weights = [1.0] * len(segments)
        else:  # weightedAverage: a weighted MEAN, not a weighted sum
            total = sum(weights)
            if total <= 0:
                raise RuntimeError(
                    f"{path!r}: weightedAverage needs positive weights"
                )
            weights = [w / total for w in weights]
        booster = _trees_to_booster(
            tree_lists, weights, fields,
            objective="reg:squarederror", path=path,
        )
        return "trees", booster

    kinds = sorted({_local(c.tag) for c in root})
    raise RuntimeError(
        f"{path!r}: no supported model element (have {kinds}; supported: "
        "RegressionModel, TreeModel, MiningModel-of-TreeModels)"
    )


class DeviceLinear:
    """A RegressionModel resident on a device: ``x @ W.T + b`` in f32 and
    the inverse link. Called on ``(B, F)`` float32 rows (numpy or a
    tensor), it gives a tensor on the device."""

    def __init__(self, W, b, norm, device=None):
        if norm not in ("none", "logit", "softmax"):
            raise RuntimeError(f"normalizationMethod {norm!r} unsupported")
        dev = resolve_device(device)
        self.device, self.norm = dev, norm
        self.W = torch.from_numpy(np.ascontiguousarray(W, np.float32)).to(dev)
        self.b = torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(dev)

    @property
    def resident_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.W, self.b))

    def __call__(self, x) -> torch.Tensor:
        with torch.inference_mode():
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            x = x.to(self.device, torch.float32)
            margin = torch.addmm(self.b, x, self.W.t())  # (B, C)
            if self.norm == "logit":
                return torch.sigmoid(margin[:, 0])
            if self.norm == "softmax":
                return torch.softmax(margin, dim=-1)
            return margin[:, 0] if margin.shape[1] == 1 else margin


def build_linear_predict(W, b, norm, device=None) -> DeviceLinear:
    """``(B, F)`` rows → the RegressionModel's output on ``device``
    (``None`` is the card)."""
    return DeviceLinear(W, b, norm, device)


def _find_model_file(storage_path: str) -> str:
    return find_model_file(
        storage_path,
        preferred=("model.pmml",),
        suffixes=(".pmml", ".xml"),
        exclude_suffixes=(),
        kind="pmml",
    )


class PMMLRuntimeModel(Model):
    """PMML document behind the standard Model lifecycle; ``device=None``
    is the card."""

    def __init__(self, name: str, storage_path: str | None, *, device=None,
                 **_ignored: Any):
        super().__init__(name)
        if storage_path is None:
            raise ValueError(f"pmml model {name!r} requires a storage_path")
        self._storage_path = storage_path
        self._device = device
        self.predictor = None
        self.num_feature = 0

    def load(self) -> bool:
        kind, payload = parse_pmml(_find_model_file(self._storage_path))
        if kind == "linear":
            W, b, norm, F = payload
            self.predictor = build_linear_predict(W, b, norm, self._device)
            self.num_feature = F
        else:
            self.predictor = build_device_predict(payload, device=self._device)
            self.num_feature = payload.num_feature
        self.predictor(np.zeros((1, max(1, self.num_feature)), np.float32)).cpu()
        self.ready = True
        return True

    def unload(self) -> None:
        self.predictor = None
        self.ready = False

    def preprocess(self, payload: Any, headers: Mapping[str, str] | None = None):
        arr = coerce_tabular_payload(payload)
        if self.num_feature and arr.shape[1] != self.num_feature:
            raise ValueError(
                f"model {self.name!r} expects {self.num_feature} features; "
                f"got {arr.shape[1]}"
            )
        return arr

    def predict(self, inputs: np.ndarray, headers=None) -> np.ndarray:
        n = inputs.shape[0]
        return self.predictor(bucket_rows(inputs)).cpu().numpy()[:n]

    def postprocess(self, outputs: np.ndarray, headers=None) -> Any:
        return {"predictions": outputs.tolist()}

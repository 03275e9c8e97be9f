"""LightGBM-format serving runtime: text checkpoints on the GBDT device
walk. The port of ``kubeflow_tpu/serve/lightgbm_runtime.py``.

A first-party reader of LightGBM's **text checkpoint format**
(``booster.save_model("model.txt")`` — the ``tree`` / ``Tree=N`` section
layout, stable across v2–v4) that lowers onto the SAME lockstep walk as
the XGBoost runtime (``xgboost_runtime.build_device_predict``): trees
become padded node arrays, inference is gathers + ``where`` over
(trees × rows), no branches.

Semantics translation, exact where it matters:

- LightGBM splits are ``value <= threshold → left`` while the shared walk
  uses XGBoost's strict ``value < threshold``. Thresholds are converted
  at parse with float32 ``nextafter(t, +inf)``, making the two forms
  bit-identical for every float32 input.
- Leaf/internal node unification: LightGBM stores internal nodes and
  leaves separately (negative child ⇒ leaf ``-c-1``); both flatten into
  one node axis, leaves self-looping.
- Missing handling per node via ``decision_type``: NaN-missing nodes
  route NaN by the default-left bit; None-missing nodes treat NaN as 0.0
  (LightGBM's predict-time behavior), encoded as default_left =
  (0 <= threshold). ``zero_as_missing`` models fail closed at parse.
- Categorical splits fail closed at parse (same stance as the XGBoost
  runtime): a silently-wrong threshold walk would serve wrong answers.
"""

from __future__ import annotations

import numpy as np

from kubeflow_tpu_torch.serve.tabular import find_model_file
from kubeflow_tpu_torch.serve.xgboost_runtime import (
    BoosterArrays,
    XGBoostRuntimeModel,
)

#: LightGBM objective family → the objective string the shared device
#: program interprets (identity / sigmoid / softmax inverse links)
_OBJECTIVES = {
    "regression": "reg:squarederror",
    "regression_l1": "reg:squarederror",
    "regression_l2": "reg:squarederror",
    "huber": "reg:squarederror",
    "fair": "reg:squarederror",
    "quantile": "reg:squarederror",
    "mape": "reg:squarederror",
    "binary": "binary:logistic",
    "multiclass": "multi:softprob",
    "softmax": "multi:softprob",
}


def _parse_kv_block(lines: list[str], start: int) -> tuple[dict, int]:
    """key=value lines until a blank line; returns (dict, next_index)."""
    out: dict[str, str] = {}
    i = start
    while i < len(lines) and lines[i].strip():
        line = lines[i].strip()
        if "=" in line:
            k, _, v = line.partition("=")
            out[k] = v
        i += 1
    return out, i + 1


def _le_to_lt(thresholds: np.ndarray) -> np.ndarray:
    """float32 thresholds t' with (v < t') ⇔ (v <= t) for all float32 v.

    t' must be the smallest float32 STRICTLY greater than the double t,
    so the double threshold is first rounded toward −inf to float32:
    plain round-to-nearest can land ABOVE t (LightGBM thresholds are
    midpoints between observed values, which tie and round up about half
    the time), and nextafter from there admits v == float32(t) > t on
    the left — a one-ULP misroute at exactly the serving values the
    training data contained."""
    t64 = np.asarray(thresholds, np.float64)
    t32 = t64.astype(np.float32)
    overshoot = t32.astype(np.float64) > t64
    t32 = np.where(
        overshoot,
        np.nextafter(t32, np.float32(-np.inf), dtype=np.float32),
        t32,
    )
    return np.nextafter(t32, np.float32(np.inf), dtype=np.float32)


def parse_lightgbm_txt(path: str) -> BoosterArrays:
    """Read a ``save_model("model.txt")`` checkpoint into padded arrays."""
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines or lines[0].strip() != "tree":
        raise RuntimeError(
            f"{path!r} is not a LightGBM text checkpoint (missing 'tree' "
            "header)"
        )
    header, i = _parse_kv_block(lines, 1)
    objective_raw = header.get("objective", "regression")
    family = objective_raw.split()[0] if objective_raw else "regression"
    if family not in _OBJECTIVES:
        raise RuntimeError(
            f"{path!r}: objective {objective_raw!r} is not supported "
            f"(supported families: {sorted(_OBJECTIVES)}; poisson et al. "
            "need inverse links the shared GBDT program does not apply)"
        )
    num_class = max(1, int(header.get("num_class", "1")))
    num_feature = int(header.get("max_feature_idx", "-1")) + 1

    # tree sections
    trees: list[dict] = []
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            t, i = _parse_kv_block(lines, i + 1)
            trees.append(t)
            continue
        if line == "end of trees":
            break
        i += 1
    if not trees:
        raise RuntimeError(f"{path!r}: booster has no trees")

    def ints(t, key, default=""):
        raw = t.get(key, default).split()
        return [int(x) for x in raw]

    def floats(t, key):
        return [float(x) for x in t.get(key, "").split()]

    max_nodes = max(2 * int(t["num_leaves"]) - 1 for t in trees)
    T = len(trees)
    feat = np.zeros((T, max_nodes), np.int32)
    thresh = np.zeros((T, max_nodes), np.float32)
    left = np.zeros((T, max_nodes), np.int32)
    right = np.zeros((T, max_nodes), np.int32)
    dleft = np.zeros((T, max_nodes), bool)
    is_leaf = np.ones((T, max_nodes), bool)
    leaf_val = np.zeros((T, max_nodes), np.float32)
    depth = 0
    for ti, t in enumerate(trees):
        L = int(t["num_leaves"])
        inner = L - 1
        if int(t.get("num_cat", "0")):
            raise RuntimeError(
                f"{path!r}: tree {ti} uses categorical splits, which this "
                "runtime does not support — re-train with numeric features"
            )
        if L == 1:
            # single-leaf tree: node 0 is the leaf
            leaf_val[ti, 0] = floats(t, "leaf_value")[0]
            left[ti, :] = np.arange(max_nodes)
            right[ti, :] = np.arange(max_nodes)
            continue
        dtypes = ints(t, "decision_type", " ".join(["2"] * inner))
        if any(((d >> 2) & 3) == 1 for d in dtypes):
            raise RuntimeError(
                f"{path!r}: tree {ti} was trained with zero_as_missing, "
                "which the shared traversal cannot represent — re-train "
                "with NaN missing values"
            )
        raw_thresh = np.asarray(floats(t, "threshold"), np.float64)
        lt_thresh = _le_to_lt(raw_thresh)

        def node_idx(c: int) -> int:
            return c if c >= 0 else inner + (-c - 1)

        lc = [node_idx(c) for c in ints(t, "left_child")]
        rc = [node_idx(c) for c in ints(t, "right_child")]
        feat[ti, :inner] = ints(t, "split_feature")
        thresh[ti, :inner] = lt_thresh
        left[ti, :inner] = lc
        right[ti, :inner] = rc
        for n, d in enumerate(dtypes):
            nan_missing = ((d >> 2) & 3) == 2
            if nan_missing:
                dleft[ti, n] = bool(d & 2)
            else:
                # None-missing: NaN behaves as 0.0 ⇒ left iff 0 <= t,
                # i.e. 0 < converted threshold
                dleft[ti, n] = 0.0 < lt_thresh[n]
        is_leaf[ti, :inner] = False
        vals = floats(t, "leaf_value")
        leaf_val[ti, inner : inner + L] = vals
        # leaves and padding self-loop (extra walk iterations are no-ops)
        idx = np.arange(max_nodes)
        left[ti, inner:] = idx[inner:]
        right[ti, inner:] = idx[inner:]

        # depth of THIS tree: longest root→leaf path over mapped children
        def tdepth() -> int:
            best, stack = 0, [(0, 0)]
            while stack:
                node, d = stack.pop()
                if node >= inner:
                    best = max(best, d)
                    continue
                stack.append((lc[node], d + 1))
                stack.append((rc[node], d + 1))
            return best

        depth = max(depth, tdepth())

    # LightGBM interleaves multiclass trees: iteration k emits num_class
    # trees, class = tree_index % num_class
    tree_class = np.asarray(
        [i % num_class for i in range(T)], np.int32
    )
    base_score = 0.5 if family == "binary" else 0.0  # logit(0.5) = 0:
    # LightGBM folds its boost_from_average intercept into leaf values
    return BoosterArrays(
        feat, thresh, left, right, dleft, is_leaf, leaf_val, tree_class,
        max_depth=max(depth, 1),
        num_class=num_class,
        num_feature=num_feature,
        base_score=base_score,
        objective=_OBJECTIVES[family],
    )


def _find_model_file(storage_path: str) -> str:
    return find_model_file(
        storage_path,
        preferred=("model.txt", "model.lgb.txt"),
        suffixes=(".txt",),
        exclude_suffixes=(),
        kind="lightgbm",
    )


class LightGBMRuntimeModel(XGBoostRuntimeModel):
    """Saved LightGBM booster behind the standard Model lifecycle — the
    data path (bucketed batches, tabular coercion, v1/v2 codecs, the
    device walk) is the XGBoost runtime's; only checkpoint discovery and
    parsing differ."""

    def _parse(self, path: str) -> BoosterArrays:
        return parse_lightgbm_txt(path)

    def _find(self) -> str:
        return _find_model_file(self._storage_path)

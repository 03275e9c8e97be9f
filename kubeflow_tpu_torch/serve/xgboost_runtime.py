"""XGBoost-format serving runtime: GBDT inference as a lockstep tree walk
on the card. The port of ``kubeflow_tpu/serve/xgboost_runtime.py``.

A first-party reader of XGBoost's published JSON checkpoint format
(``booster.save_model("model.json")``, stable since XGBoost 1.0): a
user's saved booster serves unchanged, with no xgboost dependency.

- :func:`parse_xgboost_json` turns each tree's node arrays
  (``split_indices`` / ``split_conditions`` / ``left_children`` /
  ``right_children`` / ``default_left``) into one padded ``(n_trees,
  max_nodes)`` array set, :class:`BoosterArrays` (the JAX parser, copied).
- :func:`build_device_predict` keeps those arrays resident on the device
  and walks every (tree, row) cursor in lockstep for ``max_depth`` steps:
  a step gathers the cursor's split feature, threshold and
  ``default_left``, reads ``x`` at (row, feature) through one flat index,
  sends NaN by ``default_left`` and moves to the left or right child.
  Leaves loop to themselves, so shallower trees and padding cost nothing
  but the step. The trees are laid out by class (XGBoost's ``tree_info``,
  round-robin for multiclass), so each class's margin is one f32 sum over
  its trees in a fixed order; then the base margin and the objective's
  inverse link, as the JAX program does. The reference's walk is one
  XLA program, not a Pallas kernel, and this one is plain torch ops,
  about ten a depth step.
- :func:`margin_numpy` is the plain host walk, one row and tree at a
  time, the oracle the device walk is held to; :func:`leaves_numpy` is
  the same rule vectorised over rows and trees, for checks at full size.

Missing values (NaN) follow ``default_left``, exactly as the reference's
sparsity-aware traversal does.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Mapping

import numpy as np
import torch

from kubeflow_tpu_torch import resolve_device
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.tabular import coerce_tabular_payload, find_model_file


class BoosterArrays:
    """A parsed booster: padded per-node arrays + objective metadata."""

    def __init__(
        self,
        feat: np.ndarray,          # (T, N) int32   split feature per node
        thresh: np.ndarray,        # (T, N) float32 split threshold
        left: np.ndarray,          # (T, N) int32   left child (self at leaf)
        right: np.ndarray,         # (T, N) int32   right child (self at leaf)
        default_left: np.ndarray,  # (T, N) bool    NaN routing
        is_leaf: np.ndarray,       # (T, N) bool
        leaf_value: np.ndarray,    # (T, N) float32 0 at internal nodes
        tree_class: np.ndarray,    # (T,)   int32   class id per tree
        *,
        max_depth: int,
        num_class: int,
        num_feature: int,
        base_score: float,
        objective: str,
    ):
        self.feat = feat
        self.thresh = thresh
        self.left = left
        self.right = right
        self.default_left = default_left
        self.is_leaf = is_leaf
        self.leaf_value = leaf_value
        self.tree_class = tree_class
        self.max_depth = max_depth
        self.num_class = num_class
        self.num_feature = num_feature
        self.base_score = base_score
        self.objective = objective

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]


def _tree_depth(left: list[int], right: list[int]) -> int:
    """Longest root→leaf path (edge count), iteratively (deep trees)."""
    depth, stack = 0, [(0, 0)]
    while stack:
        node, d = stack.pop()
        if left[node] == -1:
            depth = max(depth, d)
        else:
            stack.append((left[node], d + 1))
            stack.append((right[node], d + 1))
    return depth


def parse_xgboost_json(path: str) -> BoosterArrays:
    """Read a ``save_model("*.json")`` checkpoint into padded arrays."""
    with open(path) as f:
        doc = json.load(f)
    try:
        learner = doc["learner"]
        trees = learner["gradient_booster"]["model"]["trees"]
        lmp = learner["learner_model_param"]
    except (KeyError, TypeError) as e:
        raise RuntimeError(
            f"{path!r} is not an XGBoost JSON checkpoint (missing "
            f"learner/gradient_booster structure: {e})"
        ) from e
    objective = learner.get("objective", {}).get("name", "reg:squarederror")
    num_class = max(1, int(lmp.get("num_class", "0") or 0))
    num_feature = int(lmp.get("num_feature", "0") or 0)
    base_score = float(lmp.get("base_score", "0.5") or 0.5)
    tree_info = learner["gradient_booster"]["model"].get(
        "tree_info", [0] * len(trees)
    )
    if not trees:
        raise RuntimeError(f"{path!r}: booster has no trees")

    n = max(len(t["left_children"]) for t in trees)
    T = len(trees)
    feat = np.zeros((T, n), np.int32)
    thresh = np.zeros((T, n), np.float32)
    left = np.zeros((T, n), np.int32)
    right = np.zeros((T, n), np.int32)
    dleft = np.zeros((T, n), bool)
    is_leaf = np.ones((T, n), bool)  # padding counts as leaves (self-loop)
    leaf_val = np.zeros((T, n), np.float32)
    depth = 0
    for i, t in enumerate(trees):
        # categorical splits (split_type=1) store a category-set reference in
        # split_conditions, not a threshold — evaluating it as `v < cond`
        # would serve silently-wrong answers. Fail closed, like .ubj.
        if any(int(s) != 0 for s in t.get("split_type", ())) or t.get(
            "categories"
        ):
            raise RuntimeError(
                f"{path!r}: tree {i} uses categorical splits "
                "(enable_categorical=True), which this runtime does not "
                "support — re-train with numeric/one-hot features"
            )
        lc = [int(x) for x in t["left_children"]]
        rc = [int(x) for x in t["right_children"]]
        cond = np.asarray(t["split_conditions"], np.float32)
        k = len(lc)
        idx = np.arange(k)
        leaf = np.asarray(lc) == -1
        feat[i, :k] = np.asarray(t["split_indices"], np.int32)
        feat[i, :k][leaf] = 0  # leaf "feature" must stay in-bounds
        thresh[i, :k] = np.where(leaf, 0.0, cond)
        # leaves chase to themselves → extra iterations are no-ops
        left[i, :k] = np.where(leaf, idx, lc)
        right[i, :k] = np.where(leaf, idx, rc)
        dleft[i, :k] = np.asarray(t["default_left"], bool)[:k]
        is_leaf[i, :k] = leaf
        leaf_val[i, :k] = np.where(leaf, cond, 0.0)
        # pad rows self-loop too
        left[i, k:] = np.arange(k, n)
        right[i, k:] = np.arange(k, n)
        depth = max(depth, _tree_depth(lc, rc))
    return BoosterArrays(
        feat, thresh, left, right, dleft, is_leaf, leaf_val,
        np.asarray(tree_info, np.int32),
        max_depth=depth,
        num_class=num_class,
        num_feature=num_feature,
        base_score=base_score,
        objective=objective,
    )


def margin_numpy(b: BoosterArrays, x: np.ndarray) -> np.ndarray:
    """Host-side reference traversal (one row at a time) — used for parity
    tests and as the ground truth the device program must match."""
    out = np.zeros((x.shape[0], b.num_class), np.float64)
    for r in range(x.shape[0]):
        for t in range(b.n_trees):
            node = 0
            while not b.is_leaf[t, node]:
                v = x[r, b.feat[t, node]]
                go_left = b.default_left[t, node] if math.isnan(v) else (
                    v < b.thresh[t, node]
                )
                node = b.left[t, node] if go_left else b.right[t, node]
            out[r, b.tree_class[t]] += b.leaf_value[t, node]
    return out + _base_margin(b)


def leaves_numpy(b: BoosterArrays, x: np.ndarray) -> np.ndarray:
    """The leaf each (tree, row) reaches, ``(T, B)``: :func:`margin_numpy`'s
    rule (NaN by ``default_left``, else ``v < threshold``) vectorised over
    rows and trees on the host."""
    x = np.asarray(x, np.float32)
    rows = np.arange(x.shape[0])[None, :]
    trees = np.arange(b.n_trees)[:, None]
    node = np.zeros((b.n_trees, x.shape[0]), np.int64)
    for _ in range(b.max_depth):
        v = x[rows, b.feat[trees, node]]
        go_left = np.where(np.isnan(v), b.default_left[trees, node],
                           v < b.thresh[trees, node])
        node = np.where(go_left, b.left[trees, node], b.right[trees, node])
    return node


def _base_margin(b: BoosterArrays) -> float:
    """XGBoost stores base_score in OUTPUT space; the margin-space intercept
    is its inverse link (logit for logistic objectives, identity else)."""
    if b.objective.startswith(("binary:logistic", "reg:logistic")):
        p = min(max(b.base_score, 1e-7), 1 - 1e-7)
        return math.log(p / (1 - p))
    return b.base_score


def _apply_link(b: BoosterArrays, margin: torch.Tensor, output: str):
    """``(B, C)`` f32 margins → the objective's natural output (class index
    for multi:softmax, probability for logistic/softprob, value for
    regression), or the margins themselves for ``output="margin"``."""
    if output == "margin":
        return margin
    if b.objective.startswith(("binary:logistic", "reg:logistic")):
        return torch.sigmoid(margin[:, 0])
    if b.objective == "multi:softprob" or (
        output == "prob" and b.objective == "multi:softmax"
    ):
        return torch.softmax(margin, dim=-1)
    if b.objective == "multi:softmax":
        return torch.argmax(margin, dim=-1).to(torch.int32)
    if b.objective == "binary:hinge":
        return (margin[:, 0] > 0).to(torch.int32)
    return margin[:, 0] if b.num_class == 1 else margin


class DeviceTreeWalk:
    """A booster resident on a device and its lockstep walk.

    The trees are laid out class-major, ``(C, R)``: class c's trees in
    booster order, then all-leaf trees of value 0 to fill the class's R
    slots (none for XGBoost's and LightGBM's round-robin layouts). The
    node arrays are flattened over those slots with every child stored as
    a flat index (``slot * N + node``), so a cursor is one int64 per
    (slot, row) and each gather is one ``torch.take``; a class's margin
    is one sum over its R slots, in a fixed order (no atomics), so a row
    gets the same bits every time. Calling the walk on ``(B, F)`` float32
    rows (numpy or a tensor; NaN = missing) gives the objective's output
    (``output``: "margin" | "prob" | "auto") as a tensor on the device;
    :meth:`leaves` gives the final cursors in booster order."""

    def __init__(self, b: BoosterArrays, output: str = "auto", device=None):
        dev = resolve_device(device)
        T, N = b.feat.shape
        C = b.num_class
        members = [np.flatnonzero(b.tree_class == c) for c in range(C)]
        R = max(len(m) for m in members)
        slots = np.full((C, R), T, np.int64)  # T: the all-leaf filler tree
        for c, m in enumerate(members):
            slots[c, :len(m)] = m
        slots = slots.reshape(-1)
        base = np.arange(C * R, dtype=np.int64)[:, None] * N
        nodes = np.arange(N, dtype=np.int64)

        def lay(a, filler):
            """(T, N) per-node array → flat (C * R * N) over the slots."""
            return np.concatenate([a, filler[None]])[slots].reshape(-1)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        self.booster, self.output, self.device = b, output, dev
        self.n_classes, self.n_slots = C, R
        self.feat = put(lay(b.feat, np.zeros(N, np.int32)), torch.int64)
        self.thresh = put(lay(b.thresh, np.zeros(N, np.float32)), torch.float32)
        self.dleft = put(lay(b.default_left, np.zeros(N, bool)), torch.bool)
        self.left = put(lay(b.left, nodes).reshape(C * R, N) + base, torch.int64).reshape(-1)
        self.right = put(lay(b.right, nodes).reshape(C * R, N) + base, torch.int64).reshape(-1)
        self.leaf_value = put(lay(b.leaf_value, np.zeros(N, np.float32)), torch.float32)
        self.root = put(base, torch.int64)  # (C * R, 1) flat roots
        #: booster tree t's slot, for :meth:`leaves`
        self._slot_of = np.empty(T, np.int64)
        real = slots < T
        self._slot_of[slots[real]] = np.flatnonzero(real)
        self.base_margin = _base_margin(b)

    @property
    def resident_bytes(self) -> int:
        """Bytes the booster holds on its device."""
        return sum(t.numel() * t.element_size() for t in (
            self.feat, self.thresh, self.dleft, self.left, self.right,
            self.leaf_value, self.root))

    def _rows(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def _walk(self, x: torch.Tensor) -> torch.Tensor:
        """Flat cursors ``(C * R, B)`` after ``max_depth`` lockstep steps."""
        B, F = x.shape
        # row r's features start at r * F of the flat x
        off = torch.arange(0, B * F, F, device=self.device)[None, :]
        xf = x.reshape(-1)
        node = self.root.expand(-1, B)
        for _ in range(self.booster.max_depth):
            xv = xf.take(self.feat.take(node) + off)
            go_left = torch.where(xv.isnan(), self.dleft.take(node),
                                  xv < self.thresh.take(node))
            node = torch.where(go_left, self.left.take(node), self.right.take(node))
        return node

    def leaves(self, x) -> np.ndarray:
        """The node each (tree, row) ends the walk on, ``(T, B)`` in
        booster order on the host: :func:`leaves_numpy`'s answer."""
        node = (self._walk(self._rows(x)) - self.root).cpu().numpy()
        return node[self._slot_of]

    def margins(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, C)`` f32 margins: per-class leaf sums plus the base margin."""
        vals = self.leaf_value.take(self._walk(x))  # (C * R, B)
        sums = vals.view(self.n_classes, self.n_slots, -1).sum(1)
        return sums.t() + self.base_margin

    def __call__(self, x) -> torch.Tensor:
        with torch.inference_mode():
            return _apply_link(self.booster, self.margins(self._rows(x)), self.output)


def build_device_predict(b: BoosterArrays, output: str = "auto",
                         device=None) -> DeviceTreeWalk:
    """The booster's prediction as a walk resident on ``device`` (``None``
    is the card).

    output: "margin" | "prob" | "auto" (objective's natural output —
    class index for multi:softmax, probability for logistic/softprob,
    value for regression).
    """
    return DeviceTreeWalk(b, output, device)


def _find_model_file(storage_path: str) -> str:
    try:
        return find_model_file(
            storage_path,
            preferred=("model.json", "model.xgb.json"),
            suffixes=(".json",),
            exclude_suffixes=("-sha256.json",),
            kind="xgboost",
        )
    except RuntimeError:
        if os.path.isdir(storage_path) and any(
            n.endswith(".ubj") for n in os.listdir(storage_path)
        ):
            raise RuntimeError(
                "UBJSON checkpoints are not supported — re-save with "
                'booster.save_model("model.json")'
            ) from None
        raise


def bucket_rows(inputs: np.ndarray) -> np.ndarray:
    """Pad the batch to the next power of two with zero rows, so varying
    request sizes reach a bounded set of shapes (log2 many) on the device,
    as the JAX runtime's compiled shapes."""
    n = inputs.shape[0]
    bucket = 1 << (n - 1).bit_length() if n > 1 else 1
    if bucket != n:
        inputs = np.concatenate(
            [inputs, np.zeros((bucket - n, inputs.shape[1]), inputs.dtype)]
        )
    return inputs


class XGBoostRuntimeModel(Model):
    """Saved XGBoost booster behind the standard Model lifecycle;
    ``device=None`` is the card."""

    def __init__(self, name: str, storage_path: str | None, *, device=None,
                 **_ignored: Any):
        super().__init__(name)
        if storage_path is None:
            raise ValueError(f"xgboost model {name!r} requires a storage_path")
        self._storage_path = storage_path
        self._device = device
        self.booster: BoosterArrays | None = None
        self.walk: DeviceTreeWalk | None = None

    def _parse(self, path: str) -> BoosterArrays:
        return parse_xgboost_json(path)

    def _find(self) -> str:
        return _find_model_file(self._storage_path)

    def load(self) -> bool:
        self.booster = self._parse(self._find())
        self.walk = build_device_predict(self.booster, device=self._device)
        # the arrays are on the device; one batch-1 walk before ready
        self.walk(np.zeros((1, max(1, self.booster.num_feature)), np.float32)).cpu()
        self.ready = True
        return True

    def unload(self) -> None:
        self.booster = None
        self.walk = None
        self.ready = False

    def preprocess(self, payload: Any, headers: Mapping[str, str] | None = None):
        arr = coerce_tabular_payload(payload)
        nf = self.booster.num_feature
        if nf and arr.shape[1] != nf:
            raise ValueError(
                f"model {self.name!r} expects {nf} features; got {arr.shape[1]}"
            )
        return arr

    def predict(self, inputs: np.ndarray, headers=None) -> np.ndarray:
        # pad rows are all-zero and sliced away
        n = inputs.shape[0]
        return self.walk(bucket_rows(inputs)).cpu().numpy()[:n]

    def postprocess(self, outputs: np.ndarray, headers=None) -> Any:
        return {"predictions": outputs.tolist()}

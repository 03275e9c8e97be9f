"""InferenceGraph: sequence / switch / ensemble / splitter routing. A copy
of ``kubeflow_tpu/serve/graph.py`` on threads.

Reference analog: [kserve] pkg/apis/serving/v1alpha1/inference_graph.go and
cmd/router (UNVERIFIED, mount empty, SURVEY.md §0). Node types preserved:

- ``Sequence``: steps run in order, each step's output feeds the next
  (optionally gated by a condition on the previous output);
- ``Switch``:   first step whose condition matches the input handles it;
- ``Ensemble``: all steps run at once (a thread a step), outputs merged by
  step name;
- ``Splitter``: weighted random routing across steps.

A step targets either a model on a dataplane or another graph node. The
dataplane is anything with ``has(name)`` and ``infer(name, payload)``: the
port's ``ModelServer`` is one, running a model's whole predict path
(batcher included) on the calling thread.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Mapping, Protocol


class DataPlane(Protocol):
    """What a graph needs of the server it runs on."""

    def has(self, name: str) -> bool: ...

    def infer(self, name: str, payload: Any, headers=None) -> Any: ...


Condition = Callable[[Any], bool]

#: condition operators, longest-first so `>=` wins over `>` when splitting
_OPS = ("==", "!=", ">=", "<=", ">", "<", " contains ")


def _walk(payload: Any, path: str) -> Any:
    """Dotted-path lookup into a JSON payload; integer segments index
    lists. Missing paths return None (conditions treat that as no-match,
    never an exception mid-request)."""
    cur = payload
    for seg in path.split("."):
        try:
            if isinstance(cur, list):
                cur = cur[int(seg)]
            elif isinstance(cur, Mapping):
                cur = cur[seg]
            else:
                return None
        except (KeyError, IndexError, ValueError, TypeError):
            return None
    return cur


def parse_condition(expr: str) -> Condition:
    """Compile a manifest condition string into a payload predicate.

    Grammar (the serializable stand-in for the reference's gjson-style
    condition strings — [kserve] inference_graph.go step conditions,
    UNVERIFIED, SURVEY.md §0): ``<dotted.path> <op> <json-literal>`` with
    ops ``== != > < >= <= contains``, or a bare ``<dotted.path>`` meaning
    "path exists and is truthy". Examples::

        predictions.0.label == "cat"
        instances.0.0 > 5
        outputs.0.data contains 3
    """
    expr = expr.strip()
    if not expr:
        raise ValueError("empty condition")
    # LEFTMOST operator wins (longest on a tie): scanning ops in fixed
    # order would split inside a string literal for `label != "a==b"`
    found = [(i, op) for op in _OPS if (i := expr.find(op)) >= 0]
    if not found:
        # bare path = exists-and-truthy; whitespace means a mistyped
        # operator (`a = 5`, `tags contains3`) — reject at admission
        # rather than compiling a dead always-false branch
        if any(c.isspace() for c in expr):
            raise ValueError(
                f"condition {expr!r} has no operator (expected one of "
                f"{[o.strip() for o in _OPS]}) and is not a bare path"
            )

        def exists(payload, *, _path=expr) -> bool:
            return bool(_walk(payload, _path))

        return exists

    idx, raw_op = min(found, key=lambda t: (t[0], -len(t[1])))
    path, op = expr[:idx].strip(), raw_op.strip()
    if not path or any(c.isspace() for c in path):
        raise ValueError(f"bad condition path in {expr!r}")
    rhs = expr[idx + len(raw_op):]
    try:
        want = json.loads(rhs.strip())
    except json.JSONDecodeError:
        want = rhs.strip()  # bare words read as strings

    def cond(payload, *, _path=path, _op=op, _want=want) -> bool:
        got = _walk(payload, _path)
        try:
            if _op == "==":
                return got == _want
            if _op == "!=":
                return got != _want
            if _op == "contains":
                return got is not None and _want in got
            if got is None:
                return False
            if _op == ">":
                return got > _want
            if _op == "<":
                return got < _want
            if _op == ">=":
                return got >= _want
            return got <= _want
        except TypeError:  # e.g. str > int — no match, not a 500
            return False

    return cond


@dataclasses.dataclass
class Step:
    name: str
    model: str | None = None  # DataPlane model name
    node: str | None = None  # or another graph node
    weight: int = 1
    condition: Condition | None = None


@dataclasses.dataclass
class Node:
    kind: str  # Sequence | Switch | Ensemble | Splitter
    steps: list[Step]


NODE_KINDS = ("Sequence", "Switch", "Ensemble", "Splitter")


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """Serializable step: targets a served model (``serviceName``) or
    another node (``nodeName``); ``condition`` is a parse_condition
    string."""

    name: str
    service: str | None = None
    node: str | None = None
    weight: int = 1
    condition: str | None = None

    def to_step(self) -> Step:
        return Step(
            name=self.name,
            model=self.service,
            node=self.node,
            weight=self.weight,
            condition=(
                None if self.condition is None
                else parse_condition(self.condition)
            ),
        )


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    kind: str
    steps: tuple[StepSpec, ...]


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """InferenceGraph CRD analog — the deployable form of a graph.

    Accepts the reference manifest shape 1:1 ([kserve] v1alpha1
    InferenceGraph — UNVERIFIED, mount empty, SURVEY.md §0):
    ``spec.nodes.<name>.routerType`` + ``steps[].{serviceName,nodeName,
    name,condition,weight}``. ``build(dataplane)`` materializes a live
    router over already-registered models."""

    name: str
    namespace: str = "default"
    nodes: Mapping[str, NodeSpec] = dataclasses.field(default_factory=dict)
    root: str = "root"

    @classmethod
    def from_manifest(cls, doc: Mapping[str, Any]) -> "GraphSpec":
        meta = doc.get("metadata", {})
        spec = doc.get("spec", {})
        nodes: dict[str, NodeSpec] = {}
        for node_name, node in spec.get("nodes", {}).items():
            steps = []
            for i, s in enumerate(node.get("steps", ())):
                steps.append(
                    StepSpec(
                        name=s.get("name") or f"step-{i}",
                        service=s.get("serviceName"),
                        node=s.get("nodeName"),
                        weight=int(s.get("weight", 1)),
                        condition=s.get("condition"),
                    )
                )
            nodes[node_name] = NodeSpec(
                kind=node.get("routerType", "Sequence"), steps=tuple(steps)
            )
        g = cls(
            name=meta.get("name", "graph"),
            namespace=meta.get("namespace", "default"),
            nodes=nodes,
        )
        g.validate()
        return g

    def validate(self) -> None:
        if not self.name:
            raise ValueError("InferenceGraph needs metadata.name")
        if self.root not in self.nodes:
            raise ValueError(
                f"InferenceGraph {self.name!r} needs a {self.root!r} node "
                f"(has {sorted(self.nodes)})"
            )
        for node_name, node in self.nodes.items():
            if node.kind not in NODE_KINDS:
                raise ValueError(
                    f"node {node_name!r}: routerType {node.kind!r} not in "
                    f"{NODE_KINDS}"
                )
            if not node.steps:
                raise ValueError(f"node {node_name!r} has no steps")
            names = [s.name for s in node.steps]
            if len(set(names)) != len(names):
                # Ensemble merges outputs BY STEP NAME — a duplicate would
                # silently drop one model's prediction from the response
                raise ValueError(
                    f"node {node_name!r} has duplicate step names: {names}"
                )
            for s in node.steps:
                if (s.service is None) == (s.node is None):
                    raise ValueError(
                        f"node {node_name!r} step {s.name!r}: exactly one "
                        "of serviceName / nodeName"
                    )
                if s.node is not None and s.node not in self.nodes:
                    raise ValueError(
                        f"node {node_name!r} step {s.name!r}: unknown "
                        f"nodeName {s.node!r}"
                    )
                if s.weight < 1:
                    raise ValueError(
                        f"node {node_name!r} step {s.name!r}: weight must "
                        f"be >= 1, got {s.weight}"
                    )
                if s.condition is not None:
                    parse_condition(s.condition)  # reject bad syntax now
        # node-to-node references must not cycle (a cycle would recurse
        # forever at request time — fail at admission instead)
        state: dict[str, int] = {}

        def visit(name: str) -> None:
            if state.get(name) == 1:
                raise ValueError(
                    f"InferenceGraph {self.name!r}: node cycle through "
                    f"{name!r}"
                )
            if state.get(name) == 2:
                return
            state[name] = 1
            for s in self.nodes[name].steps:
                if s.node is not None:
                    visit(s.node)
            state[name] = 2

        for n in self.nodes:
            visit(n)

    def services(self) -> set[str]:
        """Every model name the graph routes to (admission checks these
        against the registry/dataplane before the graph goes live)."""
        return {
            s.service
            for node in self.nodes.values()
            for s in node.steps
            if s.service is not None
        }

    def build(
        self, dataplane: DataPlane, *, rng: random.Random | None = None
    ) -> "InferenceGraph":
        self.validate()
        missing = sorted(
            svc for svc in self.services()
            if not dataplane.has(svc)
        )
        if missing:
            raise ValueError(
                f"InferenceGraph {self.name!r} references models not on "
                f"the dataplane: {missing}"
            )
        return InferenceGraph(
            {
                name: Node(n.kind, [s.to_step() for s in n.steps])
                for name, n in self.nodes.items()
            },
            dataplane,
            root=self.root,
            rng=rng,
        )


class InferenceGraph:
    def __init__(
        self,
        nodes: Mapping[str, Node],
        dataplane: DataPlane,
        *,
        root: str = "root",
        rng: random.Random | None = None,
    ):
        if root not in nodes:
            raise ValueError(f"graph needs a '{root}' node")
        self.nodes = dict(nodes)
        self.dataplane = dataplane
        self.root = root
        self._rng = rng or random.Random(0)
        self._rng_lock = threading.Lock()  # concurrent requests share it

    def infer(self, payload: Any) -> Any:
        return self._run_node(self.root, payload)

    def _run_step(self, step: Step, payload: Any) -> Any:
        if step.model is not None:
            return self.dataplane.infer(step.model, payload)
        return self._run_node(step.node, payload)

    def _run_node(self, name: str, payload: Any) -> Any:
        node = self.nodes[name]
        if node.kind == "Sequence":
            out = payload
            for step in node.steps:
                if step.condition is not None and not step.condition(out):
                    continue
                out = self._run_step(step, out)
            return out
        if node.kind == "Switch":
            for step in node.steps:
                if step.condition is None or step.condition(payload):
                    return self._run_step(step, payload)
            raise ValueError(f"switch node '{name}': no branch matched")
        if node.kind == "Ensemble":
            # every branch at once (asyncio.gather in the reference); a
            # failing branch's error is raised once every branch has ended
            with ThreadPoolExecutor(max_workers=len(node.steps),
                                    thread_name_prefix=f"graph-{name}") as ex:
                futs = [ex.submit(self._run_step, s, payload) for s in node.steps]
                outs = [f.result() for f in futs]
            return {s.name: o for s, o in zip(node.steps, outs)}
        if node.kind == "Splitter":
            total = sum(s.weight for s in node.steps)
            with self._rng_lock:
                pick = self._rng.uniform(0, total)
            acc = 0.0
            for step in node.steps:
                acc += step.weight
                if pick <= acc:
                    return self._run_step(step, payload)
            return self._run_step(node.steps[-1], payload)
        raise ValueError(f"unknown node kind '{node.kind}'")

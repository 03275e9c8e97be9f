"""Component executor: the KFP launcher analog.

A copy of ``kubeflow_tpu/pipelines/executor.py``. The rank is read from
``JAX_PROCESS_ID``, the name the port's orchestrator writes
(``orchestrator/envwire.py``).

Reference analog (SURVEY.md §2.4 "v2 driver & launcher"): the launcher
pod wraps the user container — downloads input artifacts, execs the
component, uploads outputs, records to MLMD ([pipelines]
backend/src/v2/component/launcher_v2.go — UNVERIFIED, SURVEY.md §0).

Here the runner writes ``task.json`` into a workdir, then either calls
:func:`execute` in-process (fast path) or launches
``python -m kubeflow_tpu_torch.pipelines.executor --workdir D`` as a JAXJob
through the orchestrator (TPU/multi-worker steps, §3.5 mapping). The
executor re-execs the serialized component source, wires parameters and
artifacts, and writes ``outputs.json``; lineage is recorded by the
runner, which owns the stores.

task.json = {component: ComponentIR dict, inputs: {name: value | artifact
dict}, output_uris: {name: uri}, parameters_uri: uri}
"""

from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import Any

from kubeflow_tpu_torch.pipelines.artifacts import Artifact, _TYPE_REGISTRY
from kubeflow_tpu_torch.pipelines.ir import ComponentIR


def _load_fn(component: ComponentIR):
    if not component.source:
        raise RuntimeError(
            f"component {component.name!r} has no serializable source "
            "(defined interactively?) — run it in-process instead"
        )
    ns: dict[str, Any] = {}
    exec(compile(component.source, f"<component:{component.name}>", "exec"), ns)
    fn = ns.get(component.fn_name)
    if fn is None:
        raise RuntimeError(
            f"component {component.name!r}: {component.fn_name!r} not found "
            "after exec of serialized source"
        )
    return fn


def execute(task: dict) -> dict:
    """Run one component invocation; returns the outputs dict
    {name: {"value": v} | artifact dict}."""
    component = ComponentIR.from_dict(task["component"])
    kinds = dict(component.input_kinds)
    kwargs: dict[str, Any] = {}
    input_artifacts: list[Artifact] = []
    for name in component.inputs:
        raw = task["inputs"][name]
        if kinds.get(name, "parameter") != "parameter":
            art = Artifact.from_dict(raw)
            kwargs[name] = art
            input_artifacts.append(art)
        else:
            kwargs[name] = raw

    output_artifacts: dict[str, Artifact] = {}
    for out in component.outputs:
        if out.kind == "parameter":
            continue
        klass = _TYPE_REGISTRY.get(out.kind, Artifact)
        art = klass(name=out.name, uri=task["output_uris"][out.name])
        kwargs[out.name] = art
        output_artifacts[out.name] = art

    fn = _load_fn(component)
    ret = fn(**kwargs)

    outputs: dict[str, Any] = {}
    for out in component.outputs:
        if out.kind == "parameter":
            outputs[out.name] = {"value": ret}
        else:
            art = output_artifacts[out.name]
            if art.TYPE == "system.Model":
                _stamp_model_digest(art)
            outputs[out.name] = art.to_dict()
    return outputs


def _stamp_model_digest(art: Artifact) -> None:
    """Record the written payload's sha256 in the artifact metadata (the
    launcher-side half of model governance): the registry can verify its
    ingest against the hash computed where the bytes were produced, and
    a serving fetch can pin it. Single-file payloads only — directory
    digests are manifest-shaped and belong to the registry."""
    try:
        path = art.path
    except ValueError:
        return  # non-local uri: the producing side cannot hash it
    if os.path.isfile(path):
        import hashlib

        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        art.metadata.setdefault("sha256", h.hexdigest())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="kft-executor")
    ap.add_argument("--workdir", required=True)
    ns = ap.parse_args(argv)
    with open(os.path.join(ns.workdir, "task.json")) as f:
        task = json.load(f)
    # component-declared env applies to this process only (the in-process
    # fast path must not mutate the runner's environment)
    component = ComponentIR.from_dict(task["component"])
    for k, v in dict(component.base_env).items():
        os.environ.setdefault(k, v)
    # Multi-worker gangs: every rank executes the fn (SPMD steps need all
    # participants for collectives), but only rank 0 publishes
    # outputs.json — the others would race the same workdir. Components
    # writing artifact files from a gang must follow the same
    # rank-0-writes convention.
    rank = int(os.environ.get("JAX_PROCESS_ID", "0"))
    try:
        outputs = execute(task)
    except Exception:
        suffix = "" if rank == 0 else f"-{rank}"
        with open(os.path.join(ns.workdir, f"error{suffix}.txt"), "w") as f:
            f.write(traceback.format_exc())
        return 1
    if rank == 0:
        tmp = os.path.join(ns.workdir, "outputs.json.tmp")
        with open(tmp, "w") as f:
            json.dump(outputs, f, default=str)
        os.replace(tmp, os.path.join(ns.workdir, "outputs.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

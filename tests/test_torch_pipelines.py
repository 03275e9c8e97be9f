"""The port's pipelines plane against the JAX package's.

``kubeflow_tpu_torch.pipelines`` is held against ``kubeflow_tpu.pipelines``
on the cases of ``tests/test_pipelines.py``. The same plain functions are
decorated once with each package's DSL (``bind`` points their
``Input``/``Output``/artifact annotations at that package), so both
compile the same sources:

- the IR JSON of every pipeline is byte-equal, and each package reads the
  other's back to the same JSON;
- compiler and parameter errors raise the same type with the same message;
- ``cache_key`` is equal for the same component and inputs;
- each runner case (end to end, overrides, a failure skipping downstream,
  retries, concurrent tasks, cache hits, a busted cache, caching off)
  gives equal task states, outputs (store paths taken out), cache hits,
  attempts and errors, and equal ``LineageStore`` rows (ids, times and
  paths taken out);
- an IR compiled by one package runs on the other's runner;
- a chip step runs as a gang job on the port's ``LocalCluster``;
- ``system.Model`` outputs register alike in each package's registry;
- recurring runs fire, pause and stop alike.

Then the slice as a whole at small size: ``chip_smoke.py``'s
``lm-pipeline`` (make-data → train-lm → eval-lm) on the port's runner
with ``device="cpu"``, against the same pipeline on JAX components and
the JAX ``Trainer``, from one seed's weights bridged by
``models/bridge.py``.

Concurrency is shown by a barrier the tasks meet at, and a slow schedule
by an Event it waits on: no case reads a wall time. Every wait has a
deadline of at least 60 s.
"""

from __future__ import annotations

import functools
import json
import pickle
import sys
import threading
import time
import types

import numpy as np
import pytest

import chip_smoke
import kubeflow_tpu.pipelines as jp
import kubeflow_tpu_torch.pipelines as tp
from kubeflow_tpu.pipelines import Dataset, Input, Metrics, Model, Output
from kubeflow_tpu.pipelines import cache as jcache
from kubeflow_tpu.pipelines import dsl as jdsl
from kubeflow_tpu_torch.pipelines import cache as tcache
from kubeflow_tpu_torch.pipelines import dsl as tdsl

PKGS = {"jax": jp, "torch": tp}
WAIT_S = 60.0

#: what a component body reaches across the executor's fresh namespace:
#: the barrier concurrent tasks meet at and the Event a slow task waits on
SYNC = types.ModuleType("_kft_pipeline_sync")
sys.modules[SYNC.__name__] = SYNC


def bind(fn, pkg):
    """``fn`` with its annotations' names (``Input``, ``Output`` and the
    artifact types) resolving to ``pkg``'s: the same source, decorable by
    that package's DSL."""
    names = {n: getattr(pkg, n) for n in
             ("Input", "Output", "Dataset", "Metrics", "Model")}
    out = types.FunctionType(fn.__code__, {**fn.__globals__, **names},
                             fn.__name__, fn.__defaults__, fn.__closure__)
    out.__annotations__ = dict(fn.__annotations__)
    return out


def _keep(_note):
    """A decorator that leaves the function as it is: the DSL must strip
    its multi-line call from the serialized source."""
    return lambda fn: fn


# --------------------------------------------------------------------- #
# the plain functions both DSLs decorate (tests/test_pipelines.py's)


def make_data(n: int, out: Output[Dataset]) -> None:
    with open(out.path, "w") as f:
        f.write(",".join(str(i) for i in range(n)))
    out.metadata["rows"] = n


def total(data: Input[Dataset]) -> int:
    with open(data.path) as f:
        return sum(int(x) for x in f.read().split(","))


def add(a: int, b: int) -> int:
    return a + b


def report(value: int, metrics: Output[Metrics]) -> None:
    metrics.log_metric("value", float(value))


def boom() -> int:
    raise RuntimeError("kaboom")


def flaky(path: str) -> int:
    import os
    if not os.path.exists(path):
        open(path, "w").close()
        raise RuntimeError("first attempt fails")
    return 42


def rendezvous(tag: str) -> str:
    import _kft_pipeline_sync as sync
    sync.barrier.wait(timeout=60)
    return tag


def slow() -> int:
    import _kft_pipeline_sync as sync
    if not sync.release.wait(timeout=60):
        raise TimeoutError("never released")
    return 1


def quick() -> int:
    return 2


def devcount() -> int:
    import os
    return int(os.environ.get("JAX_NUM_PROCESSES", "0"))


def echo(tag: str) -> str:
    return str(tag)


@_keep(
    "a multi-line decorator call",
)
def g(a: int) -> int:
    return a + 1


def one(a: int) -> int:
    return a * 2


def two(a: int) -> int:
    return a * 100


def write_model(tag: str, model: Output[Model], other: Output[Model]) -> None:
    with open(model.path, "w") as f:
        f.write("weights-" + tag)
    with open(other.path, "w") as f:
        f.write("other-" + tag)
    model.metadata["register_as"] = "handoff-model"
    model.metadata["tag"] = tag


@functools.cache
def components(key: str) -> types.SimpleNamespace:
    pkg = PKGS[key]
    plain = (make_data, total, add, report, boom, flaky, rendezvous, slow,
             quick, devcount, echo, write_model)
    c = {f.__name__: pkg.component(bind(f, pkg)) for f in plain}
    c["g"] = pkg.component(name="ml-deco")(bind(g, pkg))
    c["one"] = pkg.component(bind(one, pkg), name="same")
    c["two"] = pkg.component(bind(two, pkg), name="same")
    return types.SimpleNamespace(**c)


@functools.cache
def pipelines(key: str) -> dict:
    """Each pipeline of ``tests/test_pipelines.py`` (and a few more), on
    ``key``'s DSL: name → ``Pipeline``."""
    pkg, c = PKGS[key], components(key)

    @pkg.pipeline(name="sum-pipeline", description="make → total → add → report")
    def sum_pipeline(n: int = 10, offset: int = 5):
        d = c.make_data(n=n)
        t = c.total(data=d.output)
        s = c.add(a=t.output, b=offset)
        c.report(value=s.output)

    @pkg.pipeline
    def twice():
        c.add(a=1, b=2)
        c.add(a=3, b=4)

    @pkg.pipeline
    def ordered():
        x = c.add(a=1, b=2)
        c.add(a=3, b=4).after(x)

    @pkg.pipeline
    def retried(path: str = ""):
        c.flaky(path=path).set_retry(2)

    @pkg.pipeline
    def chip_step():
        c.devcount().set_tpu_request(chips=1, num_workers=2)

    @pkg.pipeline
    def resources():
        (c.add(a=1, b=1).set_tpu_request(chips=4, topology="2x2")
         .set_cpu_request(500).set_memory_request(1024)
         .set_caching_options(False))

    @pkg.pipeline
    def failing():
        b = c.boom()
        c.add(a=b.output, b=1)

    @pkg.pipeline
    def fanout():
        for _ in range(4):
            c.rendezvous(tag="met").set_caching_options(False)

    @pkg.pipeline
    def no_cache():
        c.add(a=1, b=2).set_caching_options(False)

    @pkg.pipeline
    def multiline():
        c.g(a=41)

    @pkg.pipeline
    def none_default(tag: str = None):  # noqa: RUF013 — None default is intended
        c.echo(tag=tag)

    @pkg.pipeline
    def required(n: int):
        c.add(a=n, b=1)

    @pkg.pipeline
    def tick():
        c.add(a=1, b=1).set_caching_options(False)

    @pkg.pipeline
    def slow_p():
        c.slow().set_caching_options(False)

    @pkg.pipeline
    def quick_p():
        c.quick().set_caching_options(False)

    @pkg.pipeline(name="handoff")
    def handoff(tag: str = "v"):
        c.write_model(tag=tag)

    @pkg.pipeline
    def cyclic():
        x = c.add(a=1, b=2)
        y = c.add(a=3, b=4)
        x.after(y)
        y.after(x)

    @pkg.pipeline
    def task_as_input():
        x = c.add(a=1, b=2)
        c.add(a=x, b=1)

    @pkg.pipeline
    def conflicting():
        c.one(a=1)
        c.two(a=1)

    return {p.name: p for p in locals().values() if isinstance(p, pkg.dsl.Pipeline)}


def compiled(key: str, name: str):
    return PKGS[key].compile_pipeline(pipelines(key)[name])


def _runner(key, root, **kw):
    pkg = PKGS[key]
    return pkg.PipelineRunner(
        artifact_store=pkg.ArtifactStore(str(root / "artifacts")),
        cache=pkg.StepCache(str(root / "cache")),
        lineage=pkg.LineageStore(str(root / "mlmd.db")),
        max_parallel=4, **kw)


def _tail(uri: str) -> str:
    """An artifact uri without its store root and run id: task/name."""
    return "/".join(uri.split("/")[-2:])


def _outputs(outputs: dict) -> dict:
    return {k: ({**v, "uri": _tail(v["uri"])} if "uri" in v else v)
            for k, v in outputs.items()}


def _tasks(res) -> dict:
    return {n: {"state": t.state, "outputs": _outputs(t.outputs),
                "cache_hit": t.cache_hit, "attempts": t.attempts,
                "error": t.error}
            for n, t in res.tasks.items()}


def _lineage(store, run_id) -> list:
    """The run's executions with their artifacts, and each artifact's
    producers and consumers, ids, times and store paths taken out."""
    rows = []
    for e in store.executions(run_id):
        arts = sorted(
            (a["type"], a["name"], a["direction"], _tail(a["uri"]),
             json.dumps(a["metadata"], sort_keys=True))
            for a in store.artifacts_of(e["id"]))
        users = sorted(
            (a["name"], x["task"], x["component"], x["state"], x["direction"])
            for a in store.artifacts_of(e["id"], "output")
            for x in store.lineage(a["uri"]))
        rows.append((e["task"], e["component"], e["state"], e["cache_hit"],
                     e["error"], arts, users))
    return rows


# --------------------------------------------------------------------- #
# the IR and the compiler

IR_CASES = ("sum-pipeline", "twice", "ordered", "retried", "chip-step",
            "resources", "failing", "fanout", "no-cache", "multiline",
            "none-default", "required", "handoff")


@pytest.mark.parametrize("name", IR_CASES)
def test_ir_json_is_byte_equal_and_reads_across(name):
    j, t = compiled("jax", name), compiled("torch", name)
    js, ts = j.to_json(), t.to_json()
    assert ts == js
    assert json.loads(ts)["schemaVersion"] == "kft/v1"
    assert tp.PipelineIR.from_json(js).to_json() == js
    assert jp.PipelineIR.from_json(ts).to_json() == ts
    assert t.topological_order() == j.topological_order()
    for task in t.tasks:
        assert task.resources.wants_job == j.task(task.name).resources.wants_job


def test_ir_structure_matches_the_reference():
    ir = compiled("torch", "sum-pipeline")
    assert [t.name for t in ir.tasks] == ["make-data", "total", "add", "report"]
    assert dict(ir.parameters) == {"n": 10, "offset": 5}
    assert dict(ir.task("add").inputs)["a"].task_output == ("total", "Output")
    assert compiled("torch", "multiline").component("ml-deco").source.startswith("def g")
    assert [t.name for t in compiled("torch", "twice").tasks] == ["add", "add-2"]
    res = compiled("torch", "chip-step").task("devcount").resources
    assert res.to_dict()["tpuChips"] == 1 and res.num_workers == 2


def _raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("name,params", [
    ("cyclic", None), ("task-as-input", None), ("conflicting", None),
    ("required", {}), ("sum-pipeline", {"nope": 1}), ("not-a-pipeline", None)])
def test_errors_match(name, params, tmp_path):
    """A cycle through ``after``, a task passed where an output is meant
    and conflicting component names fail at compile; a REQUIRED
    parameter left unset and an unknown one fail at submit: the same
    type and message in both packages."""
    def attempt(key):
        pkg = PKGS[key]
        if name == "not-a-pipeline":
            return _raised(lambda: pkg.compile_pipeline(components(key).add))
        if params is None:
            return _raised(lambda: compiled(key, name))
        runner = _runner(key, tmp_path / key)
        return _raised(lambda: runner.run(compiled(key, name), params))

    j, t = attempt("jax"), attempt("torch")
    assert t == j
    assert t[0] in ("ValueError", "TypeError", "KeyError")


@pytest.mark.parametrize("inputs", [
    {"a": 1, "b": 2},
    {"a": None, "b": "x"},
    {"data": {"name": "out", "uri": "file:///a/b/out", "type": "system.Dataset",
              "metadata": {"rows": 4}}},
])
def test_cache_keys_are_equal(inputs):
    for name in ("add", "total"):
        j = compiled("jax", "sum-pipeline").component(name)
        t = compiled("torch", "sum-pipeline").component(name)
        assert t.fingerprint() == j.fingerprint()
        assert tcache.cache_key(t, inputs) == jcache.cache_key(j, inputs)
    assert tdsl.REQUIRED == jdsl.REQUIRED


# --------------------------------------------------------------------- #
# the runner, the cache and the lineage

#: case → the runs it makes, in order, on one runner: (pipeline, params)
RUN_CASES = {
    "end_to_end": [("sum-pipeline", {"n": 4})],
    "parameter_override": [("sum-pipeline", {"n": 3, "offset": 100})],
    "failure_skips_downstream": [("failing", {})],
    "retries": [("retried", {"path": "MARKER"})],
    "concurrent": [("fanout", {})],
    "multiline_decorator": [("multiline", {})],
    "none_default": [("none-default", {})],
    "cache_hit_on_rerun": [("sum-pipeline", {"n": 4}), ("sum-pipeline", {"n": 4})],
    "parameter_change_busts_cache": [("sum-pipeline", {"n": 4}),
                                     ("sum-pipeline", {"n": 5})],
    "caching_disabled": [("no-cache", {}), ("no-cache", {})],
}


def _runs(key, case, root):
    runner = _runner(key, root)
    out = []
    for name, params in RUN_CASES[case]:
        params = {k: str(root / "marker") if v == "MARKER" else v
                  for k, v in params.items()}
        SYNC.barrier = threading.Barrier(4)
        res = runner.run(compiled(key, name), params)
        out.append((res.state, _tasks(res), _lineage(runner.lineage, res.run_id)))
    rollup = [{k: v for k, v in r.items() if k not in ("run_id", "started", "finished")}
              for r in runner.lineage.runs()]
    return out, rollup


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_runner_matches_jax_runner(case, tmp_path):
    (j, jroll), (t, troll) = (_runs(k, case, tmp_path / k) for k in PKGS)
    assert t == j
    assert sorted(map(str, troll)) == sorted(map(str, jroll))
    last = t[-1]
    if case == "end_to_end":
        assert last[0] == "SUCCEEDED"
        assert last[1]["add"]["outputs"]["Output"] == {"value": 11}
        assert last[1]["make-data"]["outputs"]["out"]["metadata"] == {"rows": 4}
        assert last[1]["report"]["outputs"]["metrics"]["metadata"] == {"value": 11.0}
        assert [(r[0], r[-1]) for r in last[2]][0] == ("make-data", [
            ("out", "make-data", "make-data", "SUCCEEDED", "output"),
            ("out", "total", "total", "SUCCEEDED", "input")])
    if case == "failure_skips_downstream":
        assert last[0] == "FAILED"
        assert last[1]["boom"]["error"] == "RuntimeError: kaboom"
        assert last[1]["add"]["state"] == "SKIPPED"
    if case == "retries":
        assert last[1]["flaky"]["attempts"] == 2
    if case == "concurrent":  # four tasks met at one barrier
        assert last[0] == "SUCCEEDED" and len(last[1]) == 4
    if case == "cache_hit_on_rerun":
        assert all(x["cache_hit"] for x in last[1].values())
    if case == "parameter_change_busts_cache":
        assert not last[1]["make-data"]["cache_hit"]
        assert last[1]["total"]["outputs"]["Output"] == {"value": 10}
    if case == "caching_disabled":
        assert not last[1]["add"]["cache_hit"]


@pytest.mark.parametrize("ir_from,runs_on", [("jax", "torch"), ("torch", "jax")])
def test_ir_runs_on_the_other_runner(ir_from, runs_on, tmp_path):
    """The IR one package compiled, run by the other package's runner,
    gives what its own runner gives."""
    ir = compiled(ir_from, "sum-pipeline")
    other = PKGS[runs_on].PipelineIR.from_json(ir.to_json())
    own = _runner(ir_from, tmp_path / "own").run(ir, {"n": 6})
    foreign = _runner(runs_on, tmp_path / "foreign").run(other, {"n": 6})
    assert foreign.state == "SUCCEEDED"
    assert _tasks(foreign) == _tasks(own)
    assert foreign.output("add") == 15 + 5


def test_chip_step_runs_as_gang_job(tmp_path):
    """``tests/test_pipelines.py``'s gang step on the port's
    ``LocalCluster`` (``cpu_sim`` wiring): the executor runs as a
    two-worker job and rank 0 publishes the step's output."""
    from kubeflow_tpu_torch.orchestrator.cluster import LocalCluster
    from kubeflow_tpu_torch.orchestrator.resources import Fleet

    with LocalCluster(fleet=Fleet.homogeneous(2, "2x2"),
                      base_dir=str(tmp_path / "cluster"),
                      resync_period=0.05) as cluster:
        runner = tp.PipelineRunner(
            artifact_store=tp.ArtifactStore(str(tmp_path / "artifacts")),
            cluster=cluster, job_timeout_s=WAIT_S * 2)
        res = runner.run(compiled("torch", "chip-step"), {})
        (uid, job), = cluster.jobs.list()
    assert res.state == "SUCCEEDED", res.tasks["devcount"].error
    assert res.output("devcount") == 2
    assert job.spec.labels == {"pipeline": "chip-step", "run": res.run_id,
                               "task": "devcount"}
    assert job.status.phase == "Succeeded"


def _registry_rows(store, run_ids):
    """Every model's versions (sha256 and metadata) and lineage edges,
    run ids as their index in ``run_ids``."""
    out = {}
    for m in sorted(store.list_models(), key=lambda m: m.name):
        out[m.name] = [
            (v.version, v.sha256, v.metadata, _tail(v.source_uri),
             [(e.kind, run_ids.index(e.ref), e.metadata)
              for e in store.lineage_of(m.name, v.version)])
            for v in store.list_versions(m.name)]
    return out


def test_model_outputs_register_alike(tmp_path):
    """``system.Model`` outputs register under ``register_as`` and under
    ``<pipeline>/<output>``, with the sha256 the executor stamped and a
    ``pipeline_run`` edge; a cached rerun registers the next version with
    ``cache_hit``. The rows equal those the JAX runner writes into the
    JAX registry."""
    from kubeflow_tpu.registry import ModelStore as JModelStore
    from kubeflow_tpu_torch.registry import ModelStore as TModelStore

    rows = {}
    for key, store_cls in (("jax", JModelStore), ("torch", TModelStore)):
        store = store_cls(str(tmp_path / key / "registry"))
        runner = _runner(key, tmp_path / key, model_registry=store)
        runs = [runner.run(compiled(key, "handoff"), {}) for _ in range(2)]
        assert [r.state for r in runs] == ["SUCCEEDED"] * 2
        stamped = runs[0].tasks["write-model"].outputs["model"]["metadata"]["sha256"]
        assert store.resolve("handoff-model", "v1").sha256 == stamped
        rows[key] = _registry_rows(store, [r.run_id for r in runs])
        store.close()
    assert rows["torch"] == rows["jax"]
    assert set(rows["torch"]) == {"handoff-model", "handoff/other"}
    (v1, v2) = rows["torch"]["handoff-model"]
    assert v1[4] == [("pipeline_run", 0, {"pipeline": "handoff", "task": "write-model",
                                          "output": "model", "cache_hit": False})]
    assert v2[2]["cache_hit"] is True and v2[1] == v1[1]


# --------------------------------------------------------------------- #
# recurring runs

def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


@pytest.mark.parametrize("case", ["stops_at_max", "slow_does_not_starve", "pause_resume"])
def test_recurring_runs_fire_alike(case, tmp_path):
    """``tests/test_pipelines.py``'s scheduler cases, the fire counts
    equal in both packages. ``max_runs=2`` fires twice and then no more
    over three further intervals; a schedule whose run waits on an Event
    fires once while a quick one fires four times, and the Event is set
    only then; a paused schedule does not fire, and fires again once
    resumed."""
    counts = {}
    for key, pkg in PKGS.items():
        runner = _runner(key, tmp_path / key)
        if case == "stops_at_max":
            rr = pkg.RecurringRun(pipeline=compiled(key, "tick"), interval_s=0.1,
                                  max_runs=2)
            with pkg.RunScheduler(runner) as sched:
                sched.add(rr)
                _wait(lambda: len(rr.history) == 2, "two fires")
                time.sleep(0.3)  # would fire again if max_runs were ignored
            counts[key] = (rr.fired, [h.state for h in rr.history])
        elif case == "slow_does_not_starve":
            SYNC.release = threading.Event()
            a = pkg.RecurringRun(pipeline=compiled(key, "slow-p"), interval_s=0.05)
            b = pkg.RecurringRun(pipeline=compiled(key, "quick-p"), interval_s=0.05)

            seen = {}

            def on_result(rr, _res, a=a, b=b, seen=seen):
                if rr is b and len(b.history) >= 4 and not seen:
                    seen["slow_fired"] = a.fired  # its run is still waiting
                    SYNC.release.set()

            with pkg.RunScheduler(runner, on_result=on_result) as sched:
                sched.add(a)
                sched.add(b)
                _wait(lambda: len(a.history) >= 1, "the slow run")
            counts[key] = (seen["slow_fired"], a.history[0].state)
        else:
            rr = pkg.RecurringRun(pipeline=compiled(key, "tick"), interval_s=0.05)
            with pkg.RunScheduler(runner) as sched:
                uid = sched.add(rr)
                _wait(lambda: rr.fired >= 1, "a first fire")
                sched.pause(uid)
                fired = rr.fired
                time.sleep(0.2)
                paused_fires = rr.fired - fired
                sched.resume(uid)
                _wait(lambda: rr.fired > fired, "a fire after resume")
            counts[key] = (paused_fires, rr.fired > fired, rr.paused)
    assert counts["torch"] == counts["jax"]
    assert counts["torch"] == {"stops_at_max": (2, ["SUCCEEDED"] * 2),
                               "slow_does_not_starve": (1, "SUCCEEDED"),
                               "pause_resume": (0, True, False)}[case]


# --------------------------------------------------------------------- #
# the slice as a whole: chip_smoke.py's lm-pipeline at small size

LM = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
          causal=True, use_rope=True)
LM_BATCH, LM_SEQ = 8, 32


def jax_make_data(steps: int, vocab_size: int, batch: int, seq: int,
                  data: Output[Dataset]) -> None:
    import numpy as np

    from kubeflow_tpu.data import synthetic

    it = synthetic.local_shard_iterator(
        synthetic.TokenLMDataset(vocab_size=vocab_size, seq_len=seq, seed=0), batch)
    rows = []
    for _ in range(steps):
        b = next(it)
        rows.append(np.concatenate([b["inputs"], b["targets"][:, -1:]], 1))
    with open(data.path, "wb") as f:
        np.save(f, np.stack(rows))
    data.metadata["shape"] = [steps, batch, seq + 1]


def jax_train_lm(data: Input[Dataset], lr: float, steps: int, config: dict,
                 init: str, model: Output[Model]) -> float:
    import pickle

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from kubeflow_tpu.core.mesh import MeshSpec
    from kubeflow_tpu.models import transformer as jtf
    from kubeflow_tpu.train.loop import TrainConfig, Trainer

    with open(data.path, "rb") as f:
        toks = np.load(f)
    with open(init, "rb") as f:
        params = pickle.load(f)
    lm = jtf.TransformerLM(jtf.TransformerConfig(**config, dtype=jnp.float32,
                                                 interpret_kernels=True))
    trainer = Trainer(
        init_params=lambda rng: jax.tree_util.tree_map(jnp.asarray, params),
        loss_fn=jtf.make_loss_fn(lm), optimizer=optax.adamw(lr),
        config=TrainConfig(mesh=MeshSpec.data_parallel(len(jax.devices())),
                           global_batch=toks.shape[1], steps=steps, log_every=1))
    state, history = trainer.fit(
        lambda s: ({"inputs": t[:, :-1], "targets": t[:, 1:]} for t in toks[s:]))
    with open(model.path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, state.params), f)
    model.metadata["register_as"] = "lm-pipeline"
    model.metadata["losses"] = [float(h["loss"]) for h in history]
    return float(history[-1]["loss"])


def jax_eval_lm(model: Input[Model], steps: int, config: dict, batch: int,
                seq: int, metrics: Output[Metrics]) -> None:
    import pickle

    import jax.numpy as jnp

    from kubeflow_tpu.data import synthetic
    from kubeflow_tpu.models import transformer as jtf

    with open(model.path, "rb") as f:
        params = pickle.load(f)
    lm = jtf.TransformerLM(jtf.TransformerConfig(**config, dtype=jnp.float32,
                                                 interpret_kernels=True))
    held = next(synthetic.local_shard_iterator(
        synthetic.TokenLMDataset(vocab_size=config["vocab_size"], seq_len=seq, seed=0),
        batch, start_step=steps))
    loss, _ = jtf.make_loss_fn(lm)(params, held, None)
    metrics.log_metric("eval_loss", float(loss))


def _jax_lm_pipeline(init):
    make = jp.component(jax_make_data, name="make-data")
    train = jp.component(jax_train_lm, name="train-lm")
    evaluate = jp.component(jax_eval_lm, name="eval-lm")

    @jp.pipeline(name="lm-pipeline", description="make-data → train-lm → eval-lm")
    def pipe(lr: float = chip_smoke.PIPE_LR, steps: int = chip_smoke.PIPE_STEPS):
        d = make(steps=steps, vocab_size=LM["vocab_size"], batch=LM_BATCH, seq=LM_SEQ)
        t = train(data=d.output, lr=lr, steps=steps, config=LM,
                  init=init).set_tpu_request(chips=1)
        evaluate(model=t.outputs["model"], steps=steps, config=LM, batch=LM_BATCH,
                 seq=LM_SEQ).set_tpu_request(chips=1)

    return pipe


def test_lm_pipeline_matches_jax_at_small_size(tmp_path):
    """``chip_smoke.lm_pipeline`` (the card phase's pipeline, its steps
    in process on the CPU: no cluster) against the same pipeline on JAX
    components: f32, 2 layers at d_model 64, ``lr=1e-3`` and 8 steps of
    8 x 32 from one seed's weights (JAX's init, bridged to the port).
    Per-step losses, the returned loss and ``eval_loss`` within rtol 1e-4
    (``tests/test_torch_train.py``'s trainer tolerance); the same task
    states and lineage shape."""
    import jax
    import torch

    from kubeflow_tpu.models import transformer as jtf
    from kubeflow_tpu_torch.models.bridge import params_to_state_dict

    init = jax.tree_util.tree_map(np.asarray, jtf.make_init_fn(
        jtf.TransformerLM(jtf.TransformerConfig(**LM, interpret_kernels=True)),
        LM_SEQ)(jax.random.PRNGKey(0)))
    with open(tmp_path / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    torch.save(params_to_state_dict(init), tmp_path / "init.pt")
    irs = {"jax": jp.compile_pipeline(_jax_lm_pipeline(str(tmp_path / "init.pkl"))),
           "torch": tp.compile_pipeline(chip_smoke.lm_pipeline(
               LM, batch=LM_BATCH, seq=LM_SEQ, dtype="float32", device="cpu",
               init=str(tmp_path / "init.pt")))}
    got = {}
    for key, ir in irs.items():
        runner = _runner(key, tmp_path / key)
        res = runner.run(ir, {})
        assert res.state == "SUCCEEDED", {n: t.error for n, t in res.tasks.items()}
        shape = [(e["task"], e["state"], e["cache_hit"], sorted(
            (a["type"], a["name"], a["direction"]) for a in runner.lineage.artifacts_of(e["id"])))
            for e in runner.lineage.executions(res.run_id)]
        got[key] = {"states": {n: (t.state, t.attempts) for n, t in res.tasks.items()},
                    "losses": res.output("train-lm", "model").metadata["losses"],
                    "loss": res.output("train-lm", "Output"),
                    "eval": res.output("eval-lm", "metrics").metadata["eval_loss"],
                    "shape": shape,
                    "data": res.output("make-data").metadata}
    j, t = got["jax"], got["torch"]
    assert t["states"] == j["states"]
    assert t["shape"] == j["shape"] and t["data"] == j["data"]
    assert len(t["losses"]) == chip_smoke.PIPE_STEPS
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-4)
    np.testing.assert_allclose([t["loss"], t["eval"]], [j["loss"], j["eval"]], rtol=1e-4)
    assert t["losses"][-1] < t["losses"][0]

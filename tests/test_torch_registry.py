"""The port's model registry (``kubeflow_tpu_torch/registry/``), storage
initializer (``serve/storage.py``) and ``Checkpointer.save(register=)``
against the JAX package's on the CPU.

A store either side wrote (versions, sha256 and deduplication, stages,
aliases, lineage, promotion history) reads back equal on the other, and
a promotion and a rollback made there read back equal on the first;
``registry://`` fetches are byte-equal, manifests included; the
checkpoint hook registers synchronous saves at once and asynchronous
ones at ``wait``/``close`` or the next interval check; the controller
registers the winning trial. The slice as a whole: a tiny LM tuned by
the port's controller, its best checkpoint registered, promoted,
fetched by ``registry://…@production`` and served by ``LMEngineModel``
gives greedy tokens identical to a JAX engine on the bridged weights of
the same checkpoint.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.registry import fetcher as j_fetcher
from kubeflow_tpu.registry import stages as j_stages
from kubeflow_tpu.registry import store as j_store
from kubeflow_tpu.serve import storage as j_storage
from kubeflow_tpu_torch.registry import fetcher as t_fetcher
from kubeflow_tpu_torch.registry import stages as t_stages
from kubeflow_tpu_torch.registry import store as t_store
from kubeflow_tpu_torch.registry.spec import RegisterOnSave
from kubeflow_tpu_torch.serve import storage as t_storage
from kubeflow_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer

SIDES = {"jax": (j_store, j_stages, j_storage, j_fetcher),
         "torch": (t_store, t_stages, t_storage, t_fetcher)}


@pytest.fixture
def root(tmp_path):
    yield str(tmp_path / "registry")
    for store_mod, *_ in SIDES.values():
        store_mod.set_default_store(None)


def _payload(tmp_path, name: str, data: bytes) -> str:
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def _populate(side, root, tmp_path):
    """Versions with dedup, a directory payload, an alias, exclusive
    stages moved and rolled back, lineage, the stage shortcut."""
    R, S, *_ = SIDES[side]
    store = R.ModelStore(root)
    a = _payload(tmp_path, "a.bin", b"weights-1")
    store.register_version("bert", a, source_uri="file://" + a,
                           metadata={"run": 1})
    store.register_version("bert", a, lineage=[("pipeline_run", "r-7", {"k": 1})])
    store.register_version("bert", _payload(tmp_path, "b.bin", b"weights-2"))
    d = tmp_path / "ckpt"
    (d / "sub").mkdir(parents=True)
    (d / "w.bin").write_bytes(b"www")
    (d / "sub" / "meta.json").write_bytes(b"{}")
    store.register_version("team/dir-model", str(d), stage="staging",
                           lineage=[("checkpoint", "ckpt@3", {"step": 3})])
    store.set_alias("bert", "champion", 1)
    S.promote(store, "bert", 1, "production")
    S.promote(store, "bert", 3, "production")
    S.promote(store, "bert", 2, "staging")
    S.rollback(store, "bert", "production")
    S.promote(store, "bert", 3, "production")
    S.archive(store, "bert", 2)
    store.add_lineage("bert", 3, "tune_trial", "exp/t1", {"objective": 0.5})
    return store


def _snapshot(store):
    out = {"models": [m.to_dict() for m in store.list_models()], "versions": {},
           "lineage": {}, "resolve": {}, "history": {},
           "blobs": sorted(os.listdir(store.blob_root))}
    for m in store.list_models():
        vs = store.list_versions(m.name)
        out["versions"][m.name] = [v.to_dict() for v in vs]
        out["lineage"][m.name] = {v.version: [e.to_dict() for e in
                                              store.lineage_of(m.name, v.version)]
                                  for v in vs}
        for sel in (None, "latest", "production", "staging", "v1", "2", "champion"):
            try:
                out["resolve"][m.name, sel] = store.resolve(m.name, sel).to_dict()
            except KeyError as e:
                out["resolve"][m.name, sel] = str(e)
        out["history"][m.name] = {st: store.promotion_history(m.name, st)
                                  for st in ("production", "staging")}
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_store_written_by_one_side_resolves_in_the_other(root, tmp_path,
                                                        writer, reader):
    w = _populate(writer, root, tmp_path)
    want = _snapshot(w)
    assert len(want["blobs"]) == 3  # the two payloads of bert v1/v2 dedup
    R2, S2, *_ = SIDES[reader]
    r = R2.ModelStore(root)
    assert _snapshot(r) == want
    assert r.blob_path(want["versions"]["bert"][2]["sha256"])
    # the reader moves stages; the writer's package reads the result
    S2.promote(r, "bert", 1, "production")
    S2.rollback(r, "bert", "production")
    S2.promote(r, "team/dir-model", 1, "production")
    r.register_version("bert", _payload(tmp_path, "a2.bin", b"weights-1"))
    after = _snapshot(r)
    r.close()
    w.close()
    assert _snapshot(SIDES[writer][0].ModelStore(root)) == after
    assert after["versions"]["bert"][3]["sha256"] == want["versions"]["bert"][0]["sha256"]


def test_content_hash_and_errors_match(root, tmp_path):
    d = tmp_path / "tree"
    (d / "a" / "b").mkdir(parents=True)
    (d / "x.bin").write_bytes(b"1" * 3000)
    (d / "a" / "b" / "y").write_bytes(b"")
    f = _payload(tmp_path, "f", b"bytes")
    for p in (str(d), f):
        assert t_store.content_hash(p) == j_store.content_hash(p)
    errs = {}
    for side, (R, S, *_) in SIDES.items():
        store = R.ModelStore(os.path.join(root, side))
        out = []
        for fn in (lambda: store.get_model("ghost"),
                   lambda: store.register_version("m", str(tmp_path / "nope")),
                   lambda: store.create_model("bad@name"),
                   lambda: store.get_version("m", 1),
                   lambda: store.set_alias("m", "production", 1),
                   lambda: S.promote(store, "m", 1, "none"),
                   lambda: S.rollback(store, "m", "archived")):
            try:
                fn()
                out.append(None)
            except (KeyError, ValueError, FileNotFoundError, RuntimeError) as e:
                out.append((type(e).__name__, str(e).replace(store.root, "<root>")))
        store.register_version("m", f)
        for fn in (lambda: S.promote(store, "m", 5, "production"),
                   lambda: S.rollback(store, "m", "production"),
                   lambda: store.resolve("m", "nonsense")):
            try:
                fn()
            except (KeyError, ValueError) as e:
                out.append((type(e).__name__, str(e)))
        errs[side] = out
        store.close()
    assert errs["torch"] == errs["jax"]


def _tree(path):
    if os.path.isfile(path):
        return open(path, "rb").read()
    return {os.path.relpath(os.path.join(r, n), path): open(os.path.join(r, n), "rb").read()
            for r, _, fs in os.walk(path) for n in fs}


@pytest.mark.parametrize("uri", ["registry://bert@production", "registry://bert@v1",
                                 "registry://bert", "registry://team/dir-model@staging",
                                 "registry://bert@champion"])
def test_registry_fetch_is_byte_equal(root, tmp_path, uri):
    """Both storage initializers fetch from one store: the same file or
    directory bytes under the same name, the same sha256 manifest."""
    _populate("jax", root, tmp_path).close()
    got = {}
    for side, (R, _, storage, fetcher) in SIDES.items():
        store = R.ModelStore(root)
        R.set_default_store(store)
        mnt = str(tmp_path / f"mnt-{side}")
        local = storage.download(uri, mnt)
        assert storage.verify(local)
        canon, pinned = fetcher.canonicalize(uri)
        assert storage.verify(local, uri=canon)
        manifest = json.loads(open(local.rstrip("/") + storage.MANIFEST_SUFFIX).read())
        got[side] = (os.path.relpath(local, mnt), _tree(local), manifest, canon, pinned,
                     fetcher.parse_ref(uri))
        # a second download is the verified cached copy
        assert storage.download(uri, mnt) == local
    assert got["torch"] == got["jax"]


def test_fetch_follows_promotion_and_pins_single_files(root, tmp_path):
    """The JAX fetch tests on the port: a promotion changes the next
    download, a rollback serves the cached copy again, a corrupted
    single-file blob fails its pinned fetch, and an unconfigured registry
    is a clear error."""
    store = t_store.ModelStore(root)
    t_store.set_default_store(store)
    store.register_version("m", _payload(tmp_path, "p1", b"old-weights"))
    store.register_version("m", _payload(tmp_path, "p2", b"new-weights"))
    t_stages.promote(store, "m", 1, "production")
    mnt = str(tmp_path / "mnt")
    local = t_storage.download("registry://m@production", mnt)
    assert open(local, "rb").read() == b"old-weights"
    assert t_storage.verify(local, uri="registry://m@v1")
    t_stages.promote(store, "m", 2, "production")
    assert open(t_storage.download("registry://m@production", mnt), "rb").read() == (
        b"new-weights")
    t_stages.rollback(store, "m", "production")
    assert t_storage.download("registry://m@production", mnt) == local
    mv = store.register_version("m", _payload(tmp_path, "p3", b"good"),
                                stage="production")
    with open(store.blob_path(mv.sha256), "wb") as f:
        f.write(b"rotten")
    with pytest.raises(RuntimeError, match="checksum mismatch|failed"):
        t_storage.download("registry://m@production", str(tmp_path / "mnt2"),
                           retries=1)
    t_store.set_default_store(None)
    os.environ.pop("KFT_REGISTRY_ROOT", None)
    with pytest.raises(RuntimeError, match="no model registry"):
        t_storage.download("registry://m@production", str(tmp_path / "mnt3"))
    for scheme in ("s3://b/k", "gs://b/k", "https://h/m.bin", "hdfs://n/p"):
        with pytest.raises(RuntimeError, match="no fetcher registered"):
            t_storage.download(scheme, str(tmp_path / "mnt4"))


def test_file_scheme_and_manifests_match(tmp_path):
    src = tmp_path / "model"
    (src / "d").mkdir(parents=True)
    (src / "w.pt").write_bytes(b"abc" * 100)
    (src / "d" / "c.json").write_bytes(b"{}")
    got = {}
    for side, (_, _, storage, _) in SIDES.items():
        out = {}
        for uri in (str(src), "file://" + str(src), str(src / "w.pt")):
            mnt = tmp_path / f"mnt-{side}-{len(out)}"
            local = storage.download(uri, str(mnt))
            out[uri] = (os.path.relpath(local, mnt), _tree(local),
                        open(local + storage.MANIFEST_SUFFIX).read())
            with open(os.path.join(local, "w.pt") if os.path.isdir(local) else local,
                      "ab") as f:
                f.write(b"x")  # bit-rot: the manifest no longer verifies
            out[uri] += (storage.verify(local),)
        with pytest.raises(FileNotFoundError):
            storage.download(str(tmp_path / "missing"), str(tmp_path / "m"))
        got[side] = out
    assert got["torch"] == got["jax"]


# --------------------------------------------------------- checkpoint hook


class TestCheckpointHook:
    """``tests/test_registry.py``'s ``TestCheckpointHook`` on the port's
    ``Checkpointer``."""

    def test_train_register_promote_serve_round_trip(self, root, tmp_path):
        store = t_store.ModelStore(root)
        t_store.set_default_store(store)
        state = {"w": torch.arange(8, dtype=torch.float32), "step": 0}
        cfg = CheckpointConfig(directory=str(tmp_path / "ckpts"), save_every_steps=1,
                               async_save=False)
        with Checkpointer(cfg) as c:
            assert c.save(1, state, register=RegisterOnSave(
                store=store, name="trained", stage="production",
                metadata={"experiment": "unit"}))
            mv = c.last_registered  # a synchronous save registers at once
        assert mv is not None and mv.version == 1
        assert mv.metadata == {"experiment": "unit", "step": 1}
        assert store.resolve("trained", "production").sha256 == mv.sha256
        edges = store.lineage_of("trained", 1)
        assert edges[0].kind == "checkpoint" and edges[0].ref.endswith("@1")
        assert edges[0].metadata == {"step": 1}
        local = t_storage.download("registry://trained@production",
                                   str(tmp_path / "mnt"))
        assert os.path.isdir(local)
        fetched = {f for _, _, fs in os.walk(local) for f in fs}
        blob = {f for _, _, fs in os.walk(store.blob_path(mv.sha256)) for f in fs}
        assert fetched == blob and blob
        assert t_store.content_hash(local)[0] == mv.sha256
        # the JAX side resolves the same version
        assert j_store.ModelStore(root).resolve("trained", "production").sha256 == mv.sha256
        loaded = Checkpointer(CheckpointConfig(directory=str(tmp_path / "ckpts"))).restore(1)
        torch.testing.assert_close(loaded["w"], state["w"])

    def test_async_save_defers_registration_off_the_hot_loop(self, root, tmp_path):
        store = t_store.ModelStore(root)
        reg = RegisterOnSave(store=store, name="async-trained")
        cfg = CheckpointConfig(directory=str(tmp_path / "ackpts"), save_every_steps=1,
                               async_save=True)
        with Checkpointer(cfg) as c:
            assert c.save(1, {"w": torch.arange(4, dtype=torch.float32)}, register=reg)
            c.wait()
            assert c.last_registered is not None
            assert c.last_registered.version == 1
        assert store.resolve("async-trained", "1").metadata["step"] == 1
        cfg2 = CheckpointConfig(directory=str(tmp_path / "bckpts"), save_every_steps=1,
                                async_save=True)
        with Checkpointer(cfg2) as c2:
            c2.save(1, {"w": torch.zeros(2)}, register=reg)
            c2.save(2, {"w": torch.ones(2)}, register=reg)
        versions = store.list_versions("async-trained")
        assert [v.metadata["step"] for v in versions] == [1, 1, 2]
        assert c2.last_registered.metadata["step"] == 2

    def test_deferred_registration_waits_for_the_write(self, root, tmp_path,
                                                       monkeypatch):
        """An asynchronous save is not registered while its write is in
        flight (a later ``save`` that finds it running defers again), and
        is registered by the first check after it lands."""
        import threading

        from kubeflow_tpu_torch.train import checkpoint as ck

        store = t_store.ModelStore(root)
        gate = threading.Event()
        real = ck.torch.save

        def slow_save(obj, f, *a, **kw):
            gate.wait(30)
            return real(obj, f, *a, **kw)

        monkeypatch.setattr(ck.torch, "save", slow_save)
        cfg = CheckpointConfig(directory=str(tmp_path / "c"), save_every_steps=2,
                               async_save=True)
        c = Checkpointer(cfg)
        assert c.save(2, {"w": torch.ones(3)}, register=RegisterOnSave(store, "slow"))
        assert not c.save(3, {"w": torch.ones(3)})  # off-interval: a probe only
        assert c.last_registered is None
        with pytest.raises(KeyError):
            store.get_model("slow")
        gate.set()
        c._writer.join(30)
        assert not c.save(3, {"w": torch.ones(3)})  # the next check ingests
        assert c.last_registered is not None and c.last_registered.metadata["step"] == 2
        c.close()

    def test_failed_write_registers_nothing(self, root, tmp_path, monkeypatch):
        from kubeflow_tpu_torch.train import checkpoint as ck

        store = t_store.ModelStore(root)

        def broken(*a, **kw):
            raise OSError("disk full")

        monkeypatch.setattr(ck.torch, "save", broken)
        c = Checkpointer(CheckpointConfig(directory=str(tmp_path / "c"),
                                          save_every_steps=1, async_save=True))
        c.save(1, {"w": torch.ones(1)}, register=RegisterOnSave(store, "never"))
        with pytest.raises(OSError, match="disk full"):
            c.wait()
        c.close()
        assert c.last_registered is None
        with pytest.raises(KeyError):
            store.get_model("never")


# -------------------------------------------------------- controller handoff


def _reg_spec(S, name="reg-exp", parallel=2):
    return S.ExperimentSpec.from_dict({
        "name": name,
        "objective": {"type": "maximize", "metric": "score"},
        "parameters": [{"name": "x", "type": "double", "min": 0.0, "max": 1.0}],
        "max_trial_count": 6,
        "parallel_trial_count": parallel,
    })


def test_tune_controller_registers_winner(root, tmp_path):
    """The JAX ``test_tune_controller_registers_winner`` on the port, one
    trial at a time beside the JAX controller: the same winner, metadata
    and lineage edge, registered as the same content."""
    from kubeflow_tpu.tune import controller as j_ctrl
    from kubeflow_tpu.tune import spec as j_spec
    from kubeflow_tpu_torch.tune import controller as t_ctrl
    from kubeflow_tpu_torch.tune import spec as t_spec

    got = {}
    for side, S, C in (("jax", j_spec, j_ctrl), ("torch", t_spec, t_ctrl)):
        R = SIDES[side][0]
        store = R.ModelStore(os.path.join(root, side))
        ckpts = tmp_path / f"trials-{side}"
        ckpts.mkdir()

        def objective(params):
            (ckpts / f"x={params['x']}.bin").write_bytes(json.dumps(params).encode())
            return -((params["x"] - 0.3) ** 2)

        ctrl = C.ExperimentController(
            _reg_spec(S, parallel=1), C.CallableTrialRunner(objective), seed=1,
            model_registry=store, register_best_as="tuned-model",
            best_model_path=lambda t: str(ckpts / f"x={t.assignment.parameters['x']}.bin"))
        status = ctrl.run()
        mv = store.resolve("tuned-model")
        assert ctrl.registered_best is not None and mv.version == ctrl.registered_best.version
        assert mv.metadata["trial_id"] == status.optimal.assignment.trial_id
        (edge,) = store.lineage_of("tuned-model", mv.version)
        assert edge.kind == "tune_trial"
        assert edge.ref == f"reg-exp/{status.optimal.assignment.trial_id}"
        assert mv.source_uri.startswith("file://") and mv.source_uri.endswith(".bin")
        got[side] = (mv.sha256, {k: v for k, v in mv.metadata.items() if k != "trial_id"},
                     edge.metadata)
        store.close()
    assert got["torch"] == got["jax"]


# ------------------------------------------------------ the slice as a whole


KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128)


def test_tune_register_promote_fetch_serve_matches_jax_engine(root, tmp_path):
    """Tune a tiny LM's learning rate with the port's controller (each
    trial a ``Trainer.fit`` with a checkpoint at its last step), register
    the best trial, promote it, fetch ``registry://lm-tuned@production``
    and serve it with ``LMEngineModel``: greedy tokens equal the port's
    engine on the trial's checkpoint directly and a JAX engine on the
    bridged weights of the same checkpoint."""
    from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
    from kubeflow_tpu.models.transformer import TransformerLM as JaxLM
    from kubeflow_tpu.serve.engine import LMEngine as JaxEngine
    from kubeflow_tpu_torch.data.synthetic import TokenLMDataset, local_shard_iterator
    from kubeflow_tpu_torch.models.bridge import state_dict_to_params
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        make_init_fn,
        make_loss_fn,
    )
    from kubeflow_tpu_torch.serve.engine import LMEngineModel
    from kubeflow_tpu_torch.serve.generate import restore_state
    from kubeflow_tpu_torch.train.loop import TrainConfig, Trainer
    from kubeflow_tpu_torch.train.optim import adamw
    from kubeflow_tpu_torch.tune import controller as C
    from kubeflow_tpu_torch.tune import spec as S

    cfg = TransformerConfig(**KW)
    ds = TokenLMDataset(vocab_size=KW["vocab_size"], seq_len=16, seed=0)
    dirs = {}

    def trial(params):
        d = str(tmp_path / "trials" / f"lr{params['lr']:.6g}")
        trainer = Trainer(
            init_params=make_init_fn(cfg), loss_fn=make_loss_fn(),
            optimizer=adamw(params["lr"]),
            config=TrainConfig(mesh=None, global_batch=4, steps=3, log_every=100,
                               handle_sigterm=False,
                               checkpoint=CheckpointConfig(directory=d,
                                                           save_every_steps=3,
                                                           async_save=False)),
            device="cpu")
        _, history = trainer.fit(lambda s: local_shard_iterator(ds, 4, start_step=s))
        dirs[params["lr"]] = d
        return [(h["step"], h["loss"]) for h in history]

    spec = S.ExperimentSpec(
        name="lm-exp",
        parameters=(S.ParameterSpec("lr", S.ParameterType.DOUBLE, min=1e-4,
                                    max=3e-3, log_scale=True),),
        objective=S.Objective("loss", S.ObjectiveType.MINIMIZE),
        algorithm=S.AlgorithmSpec("tpe", {"n_initial": 2}),
        parallel_trial_count=2, max_trial_count=3,
        early_stopping=S.EarlyStoppingSpec(min_trials_required=2, start_step=1))
    store = t_store.ModelStore(root)
    t_store.set_default_store(store)
    ctrl = C.ExperimentController(
        spec, C.CallableTrialRunner(trial), seed=0, model_registry=store,
        register_best_as="lm-tuned",
        best_model_path=lambda t: dirs[t.assignment.parameters["lr"]])
    status = ctrl.run()
    assert all(t.state.value in ("Succeeded", "EarlyStopped") for t in status.trials)
    best = status.optimal
    objs = [t.metrics["__objective__"] for t in status.trials]
    assert best.metrics["__objective__"] == min(objs)
    mv = ctrl.registered_best
    assert mv.metadata["trial_id"] == best.assignment.trial_id
    t_stages.promote(store, "lm-tuned", mv.version, "production")
    local = t_storage.download("registry://lm-tuned@production", str(tmp_path / "mnt"))
    assert t_store.content_hash(local)[0] == mv.sha256
    assert _tree(local) == _tree(store.blob_path(mv.sha256))

    prompts = [[5, 9, 17, 3], [2, 8], [40, 41, 42, 43, 44, 45]]
    paged = dict(kv_pool_tokens=16 * 16, page_size=16, eos_id=1)
    served = {}
    for name, path in (("registry", local),
                       ("direct", dirs[best.assignment.parameters["lr"]])):
        m = LMEngineModel("lm", path, config=cfg, device="cpu", max_batch=4,
                          prefill_buckets=(16,), max_new_tokens=8, watchdog=False,
                          **paged)
        m.load()
        try:
            served[name] = [m.engine.submit(p, max_new_tokens=8) for p in prompts]
        finally:
            m.unload()
    assert served["registry"] == served["direct"]

    params = state_dict_to_params(restore_state(local))
    jcfg = JaxConfig(**KW, attn_impl="reference", dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jeng = JaxEngine(JaxLM(jcfg), jcfg, jparams, max_batch=4, max_seq=32,
                     prefill_buckets=(16,), **paged).start()
    try:
        want = [jeng.submit(p, max_new_tokens=8) for p in prompts]
    finally:
        jeng.stop()
    assert served["registry"] == want
    assert all(len(t) >= 1 for t in want)
    assert np.isfinite(objs).all()

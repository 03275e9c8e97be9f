"""The port's engine watchdog (``kubeflow_tpu_torch/serve/watchdog.py``)
against the JAX package's.

Both watchdogs are driven through the same fake engine and the same
injected-clock sequence, tick by tick: each must give the same trip
reasons, rebuilds, readiness flips, poison errors and retries of a failed
rebuild. Then the port's watchdog supervises a real CPU engine wedged
inside its ``pre_chunk`` fault hook on an Event. No test sleeps: every
wait is on an Event or a bounded join, and every trip is decided by the
injected clock.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from kubeflow_tpu.serve import watchdog as jax_wd
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.serve import watchdog as torch_wd
from kubeflow_tpu_torch.serve.engine import LMEngineModel

KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=128)


class _Thread:
    def __init__(self):
        self.alive = True

    def is_alive(self):
        return self.alive


class FakeEngine:
    """The surface the watchdog reads: liveness, heartbeat, work, EWMA."""

    def __init__(self):
        self._fatal = None
        self._stop = threading.Event()
        self._thread = _Thread()
        self.beat = 0.0
        self.work = False
        self.overlap = {"decode_gap_ms": 0.0}
        self.poisoned = None

    def heartbeat(self):
        return self.beat

    def busy(self):
        return self.work

    def poison(self, err):
        self.poisoned = err
        self._stop.set()


# each step: (clock, what to do to the live engine before the tick)
SCENARIOS = {
    "wedged_then_grace": [
        (0.0, "busy"), (4.0, None), (5.5, None),        # 5.5 s > 5 s: trip
        (6.0, "busy"), (30.0, None),                    # new engine, in grace
        (36.0, None),                                   # grace over: trips
    ],
    "ewma_threshold": [
        (0.0, "gap2000"), (0.0, "busy"), (10.0, None),  # 16 s threshold
        (17.0, None),
    ],
    "fatal": [(1.0, "fatal"), (2.0, None)],
    "loop_dead": [(1.0, "dead"), (2.0, None)],
    "deliberate_stop": [(1.0, "stop"), (1.0, "busy"), (100.0, None)],
    "idle_stale": [(100.0, None), (1000.0, None)],
    "rebuild_fails_twice": [
        (1.0, "fatal"), (2.0, None), (3.0, None), (4.0, None), (5.0, None),
    ],
}


def _run(mod, steps, *, failing_rebuilds=0):
    """Drive one watchdog module through a scenario; returns its trace."""
    now = [0.0]
    engines = [FakeEngine()]
    flips, rebuilds, trace = [], [], []
    fails = [failing_rebuilds]

    def rebuild(err):
        rebuilds.append((type(err).__name__, str(err)))
        if fails[0]:
            fails[0] -= 1
            raise RuntimeError("transient rebuild failure")
        engines.append(FakeEngine())
        engines[-1].beat = now[0]
        return engines[-1]

    wd = mod.EngineWatchdog(
        lambda: engines[-1], rebuild, on_ready=flips.append,
        config=mod.WatchdogConfig(min_wedge_s=5.0, wedge_factor=8.0,
                                  post_restart_grace_s=30.0),
        clock=lambda: now[0], model_name="wd-parity",
    )
    for t, action in steps:
        now[0] = t
        eng = engines[-1]
        if action == "busy":
            eng.work, eng.beat = True, t
        elif action == "gap2000":
            eng.overlap["decode_gap_ms"] = 2000.0
        elif action == "fatal":
            eng._fatal = RuntimeError("device failure")
        elif action == "dead":
            eng._thread.alive = False
        elif action == "stop":
            eng._stop.set()
        reason = wd.tick()
        poisoned = [None if e.poisoned is None
                    else (type(e.poisoned).__name__, str(e.poisoned),
                          type(e.poisoned.__cause__).__name__)
                    for e in engines]
        trace.append((t, reason, list(flips), len(engines), poisoned))
    return {"trace": trace, "rebuilds": rebuilds, "stats": wd.stats}


def _counter(mod, metric, **labels):
    child = getattr(mod, metric)._children.get(tuple(sorted(labels.items())))
    return child.value if child else 0.0


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_watchdog_matches_jax_tick_for_tick(name):
    fails = 2 if name == "rebuild_fails_twice" else 0
    trips0 = {m: {r: _counter(m, "WATCHDOG_TRIPS", model="wd-parity", reason=r)
                  for r in ("wedged", "fatal", "loop_dead")}
              for m in (jax_wd, torch_wd)}
    restarts0 = {m: _counter(m, "ENGINE_RESTARTS", model="wd-parity")
                 for m in (jax_wd, torch_wd)}
    want = _run(jax_wd, SCENARIOS[name], failing_rebuilds=fails)
    got = _run(torch_wd, SCENARIOS[name], failing_rebuilds=fails)
    assert got == want
    for m in (jax_wd, torch_wd):  # the registries count what stats count
        for r, n0 in trips0[m].items():
            assert _counter(m, "WATCHDOG_TRIPS", model="wd-parity",
                            reason=r) - n0 == got["stats"]["trips"].get(r, 0)
        assert (_counter(m, "ENGINE_RESTARTS", model="wd-parity")
                - restarts0[m]) == got["stats"]["restarts"]
    # and the scenario did what its name says
    reasons = [step[1] for step in got["trace"]]
    expect = {
        "wedged_then_grace": [None, None, "wedged", None, None, "wedged"],
        "ewma_threshold": [None, None, None, "wedged"],
        "fatal": ["fatal", None],
        "loop_dead": ["loop_dead", None],
        "deliberate_stop": [None, None, None],
        "idle_stale": [None, None],
        "rebuild_fails_twice": ["fatal", None, None, None, None],
    }[name]
    assert reasons == expect
    if name == "rebuild_fails_twice":
        # not ready through both failed rebuilds, ready after the third
        assert [s[2] for s in got["trace"]][:3] == [[False], [False],
                                                   [False, True]]
        assert len(got["rebuilds"]) == 3 and got["stats"]["restarts"] == 1
    if name == "wedged_then_grace":
        assert got["trace"][2][4][0][0] == "EngineRestarting"
        assert got["stats"] == {"trips": {"wedged": 2}, "restarts": 2}


# ---------------------------------------------------------------- real engine


def _model(name, **kw):
    m = LMEngineModel(
        name, config=TransformerConfig(**KW), device="cpu", seed=0,
        max_new_tokens=8, prefill_buckets=(16,), max_batch=2,
        kv_pool_tokens=16 * 8, page_size=16, chunk_steps=2, eos_id=96,
        watchdog=False, **kw,
    )
    m.load()
    return m


def _wedge(engine):
    """Block the engine's next chunk dispatch until ``release`` is set;
    ``entered`` is set once the loop is inside the hook."""
    entered, release = threading.Event(), threading.Event()

    def hook(eng):
        entered.set()
        release.wait(60)
        eng._fault_hooks.pop("pre_chunk", None)

    engine._fault_hooks["pre_chunk"] = hook
    return entered, release


@pytest.mark.parametrize("depth", [0, 1])
def test_watchdog_restarts_a_wedged_cpu_engine(depth):
    m = _model(f"wd-cpu-{depth}", pipeline_depth=depth)
    now = [0.0]
    flips: list[bool] = []

    def on_ready(r):
        flips.append(r)
        m._set_ready(r)

    wd = torch_wd.EngineWatchdog(
        lambda: m.engine, m.restart_engine, on_ready=on_ready,
        config=torch_wd.WatchdogConfig(min_wedge_s=5.0),
        clock=lambda: now[0], model_name=f"wd-cpu-{depth}",
    )
    old = m.engine
    entered, release = _wedge(old)
    try:
        it = old.stream([3, 4, 5, 6], max_new_tokens=8)
        first = next(it)  # the prefill's token; the first chunk wedges
        assert entered.wait(60) and old.busy()
        now[0] = old.heartbeat() + 1.0
        assert wd.tick() is None
        now[0] = old.heartbeat() + 10.0
        assert wd.tick() == "wedged"
        assert flips == [False, True] and m.ready and m.engine is not old
        with pytest.raises(torch_wd.EngineRestarting):
            next(it)
        with pytest.raises(torch_wd.EngineRestarting):
            old.submit([5, 6], max_new_tokens=3)
        assert m.engine.submit([5, 6], max_new_tokens=3)  # the new one serves
        release.set()
        old._thread.join(60)
        assert not old._thread.is_alive()
        # the wedged thread drained its chunk into no request: the failed
        # stream holds only what it had before the trip
        assert it._req.tokens == first
        assert wd.stats == {"trips": {"wedged": 1}, "restarts": 1}
    finally:
        release.set()
        m.unload()


def test_watchdog_no_trip_on_idle_or_deliberate_stop():
    m = _model("wd-idle")
    wd = torch_wd.EngineWatchdog(
        lambda: m.engine, m.restart_engine, on_ready=m._set_ready,
        config=torch_wd.WatchdogConfig(min_wedge_s=0.0, wedge_factor=0.0),
        clock=lambda: 1e9,  # everything looks stale
        model_name="wd-idle",
    )
    try:
        assert wd.tick() is None  # idle: busy() is False
        m.engine.stop()
        assert wd.tick() is None  # a deliberate stop is not a fault
    finally:
        m.unload()


def test_restart_builds_fresh_state_and_shares_weights():
    m = _model("wd-fresh")
    try:
        old = m.engine
        old.submit([3, 4, 5], max_new_tokens=4)
        old.poison(torch_wd.EngineRestarting("test"))
        new = m.restart_engine()
        assert new.model is old.model  # the weights are shared
        for attr in ("cache", "pager", "uploader", "_outputs", "_gen"):
            assert getattr(new, attr) is not getattr(old, attr), attr
        assert new.stats["admitted"] == 0 and new.model_name == "wd-fresh"
        assert np.all(new.pager.table == 0)
    finally:
        m.unload()

"""The port's Katib plane (``kubeflow_tpu_torch/tune/``) against the JAX
package's ``kubeflow_tpu/tune/`` on the CPU.

Suggesters: the same seed and the same history give equal assignments
(random, grid, TPE, CMA-ES, Hyperband, PBT); the Bayesian suggester's GP,
written in numpy and scipy, gives sklearn's posterior within
``GP_RTOL`` and the same assignment wherever the two best expected
improvements are more than ``EI_TIE`` apart. Spec validation, template
substitution, the scraper and medianstop agree; the controller gives
JAX's parameter sequence, optimum and stop reason one trial at a time,
the same parameter sets and counts two at a time, and the same failure
budget and goal; a ``TrialDB`` either side wrote resumes in the other.
"""

from __future__ import annotations

import math
import random
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest

from kubeflow_tpu.tune import controller as j_ctrl
from kubeflow_tpu.tune import db as j_db
from kubeflow_tpu.tune import earlystop as j_es
from kubeflow_tpu.tune import metrics as j_metrics
from kubeflow_tpu.tune import spec as j_spec
from kubeflow_tpu.tune import suggest as j_sug
from kubeflow_tpu_torch.tune import controller as t_ctrl
from kubeflow_tpu_torch.tune import db as t_db
from kubeflow_tpu_torch.tune import earlystop as t_es
from kubeflow_tpu_torch.tune import metrics as t_metrics
from kubeflow_tpu_torch.tune import spec as t_spec
from kubeflow_tpu_torch.tune import suggest as t_sug

#: relative error of the port GP's posterior mean and std against sklearn's
GP_RTOL = 1e-6
#: two candidates whose expected improvements are closer than this may
#: be picked differently by two GPs within GP_RTOL of each other
EI_TIE = 1e-9

SIDES = {"jax": (j_spec, j_sug, j_ctrl, j_es, j_metrics, j_db),
         "torch": (t_spec, t_sug, t_ctrl, t_es, t_metrics, t_db)}


def _space(S):
    P = S.ParameterType
    return (
        S.ParameterSpec("lr", P.DOUBLE, min=1e-4, max=1e-1, log_scale=True),
        S.ParameterSpec("layers", P.INT, min=1, max=8),
        S.ParameterSpec("opt", P.CATEGORICAL, values=("sgd", "adam")),
    )


def _exp(S, algorithm="random", goal=None, max_trials=12, parallel=3,
         maximize=False, **settings):
    return S.ExperimentSpec(
        name="e",
        parameters=_space(S),
        objective=S.Objective(
            "loss",
            S.ObjectiveType.MAXIMIZE if maximize else S.ObjectiveType.MINIMIZE,
            goal=goal),
        algorithm=S.AlgorithmSpec(algorithm, settings),
        parallel_trial_count=parallel,
        max_trial_count=max_trials,
    )


def _quadratic(p):
    # optimum at lr=1e-2, layers=4; adam a little better
    return ((math.log10(p["lr"]) + 2) ** 2 + (p["layers"] - 4) ** 2 * 0.1
            + (0.0 if p.get("opt") == "adam" else 0.05))


# ------------------------------------------------------------- suggesters


@pytest.mark.parametrize("algo,settings", [
    ("random", {}), ("grid", {"points_per_dim": 3}), ("tpe", {"n_initial": 4}),
    ("hyperopt", {"n_initial": 3, "gamma": 0.4}), ("cmaes", {}),
    ("cmaes", {"sigma0": 0.1}), ("hyperband", {"eta": 2, "max_budget": 8}),
    ("pbt", {"population": 3}),
], ids=lambda v: v if isinstance(v, str) else ",".join(map(str, v.values())) or "-")
@pytest.mark.parametrize("maximize", [False, True])
def test_suggesters_match_jax_on_the_same_history(algo, settings, maximize):
    """Rounds of 2 suggestions, each scored by one objective and fed back
    as history: equal assignments every round on both sides."""
    seqs = {}
    for side, (S, G, *_) in SIDES.items():
        sug = G.make_suggester(_exp(S, algo, maximize=maximize, **settings), seed=5)
        history, trials, seq = [], [], []
        for r in range(8):
            if algo == "pbt":
                got = sug.suggest_trials(2, trials)
            else:
                got = sug.suggest(2, history)
            for n, a in enumerate(got):
                params = dict(a.parameters)
                seq.append(params)
                value = _quadratic(params)
                history.append((params, value))
                t = S.Trial(assignment=S.TrialAssignment(params, trial_id=f"t{r}.{n}"),
                            state=S.TrialState.SUCCEEDED)
                t.metrics["__objective__"] = value
                trials.append(t)
        seqs[side] = seq
    assert seqs["torch"] == seqs["jax"]
    assert len(seqs["jax"]) == 16


class _Recorder:
    """Keeps every sklearn GP the JAX Bayesian suggester fits."""

    def __init__(self, monkeypatch):
        from sklearn import gaussian_process

        self.fitted = []
        base = gaussian_process.GaussianProcessRegressor
        rec = self

        class Recording(base):
            def fit(self, X, y):
                out = super().fit(X, y)
                rec.fitted.append(self)
                return out

        monkeypatch.setattr(gaussian_process, "GaussianProcessRegressor", Recording)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bayesian_gp_posterior_matches_sklearn(monkeypatch, seed):
    """On a seeded history, the port's GP posterior mean and std are
    within GP_RTOL (relative) of the JAX suggester's sklearn GP, and the
    fitted hyperparameters agree."""
    rec = _Recorder(monkeypatch)
    r = random.Random(seed)
    spec_j, spec_t = _exp(j_spec, "bayesian"), _exp(t_spec, "bayesian")
    history = []
    for _ in range(6 + seed * 3):
        p = {"lr": 10 ** r.uniform(-4, -1), "layers": r.randint(1, 8),
             "opt": r.choice(("sgd", "adam"))}
        history.append((p, _quadratic(p) + r.gauss(0, 0.05)))
    j_sug.make_suggester(spec_j, seed=seed).suggest(1, history)
    sk = rec.fitted[-1]
    port = t_sug.make_suggester(spec_t, seed=seed)
    gp, _ = port.fit_gp(history)
    np.testing.assert_allclose(np.exp(gp.theta), np.exp(sk.kernel_.theta), rtol=GP_RTOL)
    cand = np.random.RandomState(seed).rand(512, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m_sk, s_sk = sk.predict(cand, return_std=True)
    m, s = gp.predict(cand)
    np.testing.assert_allclose(m, m_sk, rtol=GP_RTOL, atol=0)
    np.testing.assert_allclose(s, s_sk, rtol=GP_RTOL, atol=1e-12)


def _ei_gap(port_state, spec, history, n_candidates):
    """The gap between the two best expected improvements of the port's
    first round from ``port_state`` (its ``random.Random`` state)."""
    sug = t_sug.make_suggester(spec, seed=0)
    sug.rng.setstate(port_state)
    gp, y = sug.fit_gp(history)
    cand = np.array([[sug.rng.random() for _ in sug.params]
                     for _ in range(n_candidates)])
    mu, sigma = gp.predict(cand)
    sigma = np.maximum(sigma, 1e-9)
    imp = y.min() - mu - sug.xi
    z = imp / sigma
    ei = np.sort(imp * t_sug._norm_cdf(z) + sigma * t_sug._norm_pdf(z))
    return ei[-1] - ei[-2]


@pytest.mark.parametrize("maximize", [False, True])
def test_bayesian_assignments_match_unless_ei_ties(maximize):
    """Bayesian rounds of one suggestion fed back into both suggesters:
    equal assignments, except where the top two expected improvements
    are within EI_TIE."""
    kw = dict(n_initial=4, n_candidates=256)
    sj = j_sug.make_suggester(_exp(j_spec, "bayesian", maximize=maximize, **kw), seed=2)
    spec_t = _exp(t_spec, "bayesian", maximize=maximize, **kw)
    st = t_sug.make_suggester(spec_t, seed=2)
    history = []
    for _ in range(10):
        state = st.rng.getstate()
        (aj,), (at,) = sj.suggest(1, history), st.suggest(1, history)
        if aj.parameters != at.parameters:
            assert _ei_gap(state, spec_t, history, 256) <= EI_TIE
        history.append((aj.parameters, _quadratic(aj.parameters)))


def test_unknown_algorithm_and_nas_names():
    for S, G in ((j_spec, j_sug), (t_spec, t_sug)):
        with pytest.raises(ValueError, match="unknown algorithm"):
            G.make_suggester(_exp(S, "simulated-annealing"))
        with pytest.raises(ValueError, match="runs in-process: use .*tune.nas"):
            G.make_suggester(_exp(S, "enas"))


# ------------------------------------------------- spec, metrics, medianstop


def _spec_error(S, build):
    try:
        build(S)
    except (ValueError, KeyError) as e:
        return type(e).__name__, str(e)
    return None


BAD_SPECS = {
    "min_gt_max": lambda S: S.ParameterSpec("a", S.ParameterType.DOUBLE, min=2, max=1),
    "no_bounds": lambda S: S.ParameterSpec("a", S.ParameterType.INT),
    "log_nonpositive": lambda S: S.ParameterSpec(
        "a", S.ParameterType.DOUBLE, min=0.0, max=1.0, log_scale=True),
    "categorical_no_values": lambda S: S.ParameterSpec("a", S.ParameterType.CATEGORICAL),
    "bad_type": lambda S: S.ParameterType("float"),
    "no_params": lambda S: S.ExperimentSpec(
        name="x", parameters=(), objective=S.Objective("l")).validate(),
    "zero_parallel": lambda S: S.ExperimentSpec(
        name="x", parameters=_space(S), objective=S.Objective("l"),
        parallel_trial_count=0).validate(),
    "duplicate_names": lambda S: S.ExperimentSpec(
        name="x", parameters=_space(S) + _space(S)[:1],
        objective=S.Objective("l")).validate(),
    "valid": lambda S: _exp(S).validate(),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_spec_validation_errors_match(case):
    assert _spec_error(t_spec, BAD_SPECS[case]) == _spec_error(j_spec, BAD_SPECS[case])


def test_spec_mappings_round_trip_and_template_substitution():
    for S in (j_spec, t_spec):
        assert S.substitute_template("x", {}) == "x"
    units = [i / 10 for i in range(11)]
    for pj, pt in zip(_space(j_spec), _space(t_spec)):
        assert [pt.from_unit(u) for u in units] == [pj.from_unit(u) for u in units]
        assert pt.grid(4) == pj.grid(4)
        vals = [pj.from_unit(u) for u in units]
        assert [pt.to_unit(v) for v in vals] == [pj.to_unit(v) for v in vals]
    d = dict(_exp(j_spec, "tpe", goal=0.1, n_initial=3).to_dict(),
             trial_template={"cmd": ["train", "--lr=${trialParameters.lr}"],
                             "env": {"L": "${trialParameters.layers}"}},
             early_stopping={"name": "medianstop", "min_trials_required": 2,
                             "start_step": 1})
    sj, st = j_spec.ExperimentSpec.from_dict(d), t_spec.ExperimentSpec.from_dict(d)
    assert st.to_dict() == sj.to_dict()
    params = {"lr": 0.01, "layers": 3, "missing": None}
    assert (t_spec.substitute_template(st.trial_template, params)
            == j_spec.substitute_template(sj.trial_template, params))
    assert t_spec.substitute_template(("a ${trialParameters.lr}",), params) == (
        "a 0.01",)


LOGS = [
    "starting up\nepoch=1 loss=0.9 accuracy=0.5\nepoch=2 loss=0.5 accuracy=0.7\n"
    "noise line without metrics\nstep=30 loss=0.3\nfinal: accuracy: 0.91\n",
    "loss=-1.5e-3\nLOSS=2E+2 iteration=7\nval|loss: 3 acc-top1=0.5",
    "step=1 loss=1.0\nstep=1 loss=0.8 lr=1e-3\nepoch: 2, loss: 0.7\n",
    "",
]


@pytest.mark.parametrize("log", range(len(LOGS)))
def test_scraper_gives_equal_series(log):
    text = LOGS[log]
    for extra in ([], ["accuracy", "acc-top1", "lr"]):
        sj = j_metrics.collect_from_text(text, "loss", extra)
        st = t_metrics.collect_from_text(text, "loss", extra)
        assert st == sj
        for k in sj:
            assert t_metrics.latest(st[k]) == j_metrics.latest(sj[k])
            for minimize in (True, False):
                assert t_metrics.best(st[k], minimize) == j_metrics.best(sj[k], minimize)
    assert t_metrics.parse_lines(text.splitlines()) == j_metrics.parse_lines(
        text.splitlines())


def test_scraper_reads_the_port_metric_writer():
    """A trial that only prints (the zero-SDK contract): the port's
    ``MetricWriter`` lines scrape to the logged series on both sides."""
    import io

    from kubeflow_tpu_torch.train.metrics import MetricWriter

    out = io.StringIO()
    w = MetricWriter(None, stdout=out)
    logged = [(s, 2.0 / (s + 1), 0.1 * s) for s in range(1, 6)]
    for s, loss, acc in logged:
        w.write(s, {"loss": loss, "accuracy": acc})
    text = out.getvalue()
    want = {"loss": [(s, pytest.approx(v, rel=1e-6)) for s, v, _ in logged],
            "accuracy": [(s, pytest.approx(a, rel=1e-6, abs=1e-9)) for s, _, a in logged]}
    for M in (t_metrics, j_metrics):
        assert M.collect_from_text(text, "loss", ["accuracy"]) == want


def test_port_modules_import_without_sklearn_grpc_or_tensorboard():
    """The card's host has none of them: every port tune and registry
    module imports, and the Bayesian suggester suggests, with all three
    blocked; the TFEvents reader reaches for tensorboard only when
    called."""
    code = """
import sys
import threading
for m in ("sklearn", "grpc", "tensorboard"):
    sys.modules[m] = None
import kubeflow_tpu_torch.tune as tune
from kubeflow_tpu_torch.tune import (controller, db, earlystop, metrics, nas,
                                     spec, suggest)
from kubeflow_tpu_torch import registry
from kubeflow_tpu_torch.registry import fetcher, stages, store
from kubeflow_tpu_torch.serve import storage
S = spec
sp = S.ExperimentSpec(name="b", parameters=(S.ParameterSpec(
    "x", S.ParameterType.DOUBLE, min=0.0, max=1.0),), objective=S.Objective("l"),
    algorithm=S.AlgorithmSpec("bayesian", {"n_initial": 2, "n_candidates": 16}))
s = suggest.make_suggester(sp)
h = [({"x": 0.1}, 1.0), ({"x": 0.5}, 0.2), ({"x": 0.9}, 0.7)]
assert len(s.suggest(2, h)) == 2
try:
    metrics.collect_from_tfevents(".", "loss")
except ImportError:
    print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _trial(S, vals, state=None, tid=""):
    t = S.Trial(assignment=S.TrialAssignment({}, trial_id=tid),
                state=state or S.TrialState.SUCCEEDED)
    t.observations = list(enumerate(vals))
    return t


@pytest.mark.parametrize("maximize", [False, True])
def test_medianstop_makes_equal_decisions(maximize):
    decisions = {}
    for side, (S, _, _, E, *_) in SIDES.items():
        obj = S.Objective("loss", S.ObjectiveType.MAXIMIZE if maximize
                          else S.ObjectiveType.MINIMIZE)
        out = []
        rr = random.Random(3)
        for case in range(40):
            es = S.EarlyStoppingSpec(min_trials_required=rr.randint(1, 4),
                                     start_step=rr.randint(0, 5))
            stop = E.make_early_stopper(es, obj)
            done = [_trial(S, [rr.random() for _ in range(rr.randint(0, 8))],
                           rr.choice([S.TrialState.SUCCEEDED, S.TrialState.FAILED]))
                    for _ in range(rr.randint(0, 6))]
            mine = _trial(S, [rr.random() for _ in range(rr.randint(0, 8))],
                          S.TrialState.RUNNING)
            out.append(stop.should_stop(mine, done))
        assert E.make_early_stopper(None, obj) is None
        assert E.make_early_stopper(S.EarlyStoppingSpec(name="none"), obj) is None
        with pytest.raises(ValueError, match="unknown early-stopping"):
            E.make_early_stopper(S.EarlyStoppingSpec(name="curvefit"), obj)
        decisions[side] = out
    assert decisions["torch"] == decisions["jax"]
    assert any(decisions["jax"]) and not all(decisions["jax"])


# --------------------------------------------------------------- controller


def _curve(p):
    """An 8-step falling curve ending at the quadratic."""
    end = _quadratic(p)
    return [(s, end + (8 - s) * 0.1) for s in range(8)]


@pytest.mark.parametrize("algo,settings", [
    ("random", {}), ("tpe", {"n_initial": 3}), ("bayesian", {"n_initial": 3,
                                                            "n_candidates": 128}),
    ("cmaes", {}), ("grid", {"points_per_dim": 2}),
])
def test_controller_one_at_a_time_matches_jax(algo, settings):
    """parallel_trial_count=1 with medianstop: the same parameter
    sequence, states, optimum and stop reason."""
    got = {}
    for side, (S, _, C, *_) in SIDES.items():
        spec = S.ExperimentSpec(
            name="seq", parameters=_space(S), objective=S.Objective("loss"),
            algorithm=S.AlgorithmSpec(algo, settings), parallel_trial_count=1,
            max_trial_count=9,
            early_stopping=S.EarlyStoppingSpec(min_trials_required=2, start_step=3))
        status = C.ExperimentController(spec, C.CallableTrialRunner(_curve), seed=4).run()
        got[side] = ([(dict(t.assignment.parameters), t.state.value,
                       t.metrics.get("__objective__")) for t in status.trials],
                     dict(status.optimal.assignment.parameters), status.reason,
                     (status.succeeded, status.failed, status.early_stopped))
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("algo", ["random", "grid"])
def test_controller_two_at_a_time_matches_jax_sets(algo):
    got = {}
    for side, (S, _, C, *_) in SIDES.items():
        spec = S.ExperimentSpec(
            name="par", parameters=_space(S), objective=S.Objective("loss"),
            algorithm=S.AlgorithmSpec(algo, {"points_per_dim": 2}),
            parallel_trial_count=2, max_trial_count=8)
        status = C.ExperimentController(spec, C.CallableTrialRunner(_quadratic),
                                        seed=9).run()
        got[side] = (sorted(map(repr, (sorted(t.assignment.parameters.items())
                                       for t in status.trials))),
                     len(status.trials), status.succeeded, status.reason,
                     status.optimal.metrics["__objective__"])
    assert got["torch"] == got["jax"]


def test_failure_budget_and_goal_match_jax():
    got = {}
    for side, (S, _, C, *_) in SIDES.items():
        calls = {"n": 0}

        def flaky(p):
            calls["n"] += 1
            if calls["n"] % 2 == 0:
                raise RuntimeError("boom")
            return _quadratic(p)

        spec = S.ExperimentSpec(name="f", parameters=_space(S),
                                objective=S.Objective("loss"), max_trial_count=50,
                                max_failed_trial_count=3, parallel_trial_count=1)
        s1 = C.tune(flaky, spec, seed=1)
        spec2 = _exp(S, "tpe", goal=0.3, max_trials=40, parallel=1, n_initial=4)
        s2 = C.tune(_quadratic, spec2, seed=3)
        got[side] = (s1.reason, s1.failed, s1.succeeded, calls["n"],
                     [t.message for t in s1.trials if t.message],
                     s2.reason, len(s2.trials), s2.optimal.metrics["__objective__"])
    assert got["torch"] == got["jax"]
    assert got["jax"][0] == "max_failed_trial_count exceeded"
    assert got["jax"][5] == "objective goal reached"


def test_callable_runner_accepts_curves_and_dicts():
    for S, C in ((j_spec, j_ctrl), (t_spec, t_ctrl)):
        t = S.Trial(assignment=S.TrialAssignment({"x": 1}))
        C.CallableTrialRunner(lambda p: [(0, 1.0), (1, 0.4)]).run(t, _exp(S))
        assert (t.state.value, t.metrics, t.observations) == (
            "Succeeded", {"loss": 0.4, "__objective__": 0.4}, [(0, 1.0), (1, 0.4)])
        t2 = S.Trial(assignment=S.TrialAssignment({}))
        C.CallableTrialRunner(lambda p: {"loss": 0.2, "acc": 0.9}).run(t2, _exp(S))
        assert t2.metrics == {"loss": 0.2, "acc": 0.9, "__objective__": 0.2}


def test_job_trial_runner_waits_for_the_orchestrator():
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        t_ctrl.JobTrialRunner(object())


def test_register_best_requires_path_fn():
    with pytest.raises(ValueError, match="register_best_as needs"):
        t_ctrl.ExperimentController(_exp(t_spec),
                                    t_ctrl.CallableTrialRunner(_quadratic),
                                    register_best_as="x")


# ------------------------------------------------------------------ TrialDB


def _db_exp(S, max_trials):
    return S.ExperimentSpec(
        name="resume-me",
        parameters=(S.ParameterSpec("x", S.ParameterType.DOUBLE, min=0.0, max=1.0),),
        objective=S.Objective("loss", S.ObjectiveType.MINIMIZE),
        algorithm=S.AlgorithmSpec("random"),
        parallel_trial_count=1, max_trial_count=max_trials,
        early_stopping=S.EarlyStoppingSpec(min_trials_required=1, start_step=0))


@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
def test_trialdb_resumes_across_frameworks(tmp_path, first, second):
    """One side's controller writes 3 trials (curves in the observation
    log) and a trial left RUNNING; the other side's controller on the same
    file marks it KILLED, keeps the lineage and runs only the rest of the
    budget; the second side's rows read back equal on both sides."""
    path = str(tmp_path / "katib.db")
    S1, _, C1, _, _, D1 = SIDES[first]
    db1 = D1.TrialDB(path)
    c1 = C1.ExperimentController(_db_exp(S1, 3), C1.CallableTrialRunner(
        lambda p: [(0, 1.0), (1, abs(p["x"] - 0.25))]), seed=1, db=db1)
    c1.run()
    hung = S1.Trial(assignment=S1.TrialAssignment({"x": 0.9}, trial_id="hung1"),
                    state=S1.TrialState.RUNNING)
    db1.record_trial("resume-me", hung)
    db1.close()

    S2, _, C2, _, _, D2 = SIDES[second]
    ran = []
    db2 = D2.TrialDB(path)
    c2 = C2.ExperimentController(_db_exp(S2, 6), C2.CallableTrialRunner(
        lambda p: ran.append(p) or abs(p["x"] - 0.25)), seed=2, db=db2)
    first_ids = {t.assignment.trial_id for t in c1.trials}
    assert {t.assignment.trial_id for t in c2.trials} == first_ids | {"hung1"}
    assert [t.assignment.trial_id for t in c2.trials
            if t.state is S2.TrialState.KILLED] == ["hung1"]
    resumed = {t.assignment.trial_id: (t.assignment.parameters, t.state.value,
                                       t.metrics, t.observations)
               for t in c2.trials}
    want = {t.assignment.trial_id: (t.assignment.parameters, t.state.value,
                                    t.metrics, t.observations)
            for t in c1.trials}
    assert {k: resumed[k] for k in want} == want
    status = c2.run()
    assert len(ran) == 2 and status.complete
    objs = [t.metrics["__objective__"] for t in c2.trials if "__objective__" in t.metrics]
    assert status.optimal.metrics["__objective__"] == min(objs)
    db2.close()
    rows = {}
    for side in ("jax", "torch"):
        d = SIDES[side][5].TrialDB(path)
        rows[side] = [(t.assignment.trial_id, t.assignment.parameters, t.state.value,
                       t.metrics, t.message, t.observations)
                      for t in d.load_trials("resume-me")]
        rows[side + "_exps"] = [{k: v for k, v in e.items() if k != "updated"}
                                for e in d.experiments()]
        d.close()
    assert rows["torch"] == rows["jax"] and len(rows["jax"]) == 6
    assert rows["torch_exps"] == rows["jax_exps"]


def test_kernel_counters_hold_under_concurrent_launches():
    """Trials train on threads of one process (``chip_smoke.py`` phase 18
    runs two ``Trainer.fit`` at a time), so kernel wrappers count from
    several threads: with more threads than cores and a short switch
    interval, every counter of the flash and paged wrappers keeps each
    of the concurrent counts."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import flash_attention_bwd as fb
    from kubeflow_tpu_torch.ops import paged_attention as pa

    names = {fa: ("LAUNCHES", "LAUNCHES_BY_BODY", "LAUNCHES_BY_SHAPE"),
             fb: ("DQ_LAUNCHES", "DQ_LAUNCHES_BY_BODY", "DQ_LAUNCHES_BY_SHAPE",
                  "DKV_LAUNCHES", "DKV_LAUNCHES_BY_BODY", "DKV_LAUNCHES_BY_SHAPE"),
             pa: ("LAUNCHES", "LAUNCHES_BY_S", "LAUNCHES_BY_BODY", "LAUNCHES_BY_SHAPE")}
    saved = {(m, n): getattr(m, n) for m, ns in names.items() for n in ns}
    threads_n, per = 16, 2000

    def work():
        for _ in range(per):
            fa.count_launch("wgmma", "s")
            fb.count_dq("wgmma", "s")
            fb.count_dkv("fma", "s")
            pa.count_launch(1, "decode", "s")

    old = sys.getswitchinterval()
    try:
        for (m, n), v in saved.items():
            setattr(m, n, {k: 0 for k in v} if isinstance(v, dict) and "BODY" in n
                     else {} if isinstance(v, dict) else 0)
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        total = threads_n * per
        assert fa.LAUNCHES == fa.LAUNCHES_BY_BODY["wgmma"] == fa.LAUNCHES_BY_SHAPE["s"] == total
        assert fb.DQ_LAUNCHES == fb.DQ_LAUNCHES_BY_BODY["wgmma"] == total
        assert fb.DQ_LAUNCHES_BY_SHAPE["s"] == fb.DKV_LAUNCHES_BY_SHAPE["s"] == total
        assert fb.DKV_LAUNCHES == fb.DKV_LAUNCHES_BY_BODY["fma"] == total
        assert pa.LAUNCHES == pa.LAUNCHES_BY_S[1] == pa.LAUNCHES_BY_BODY["decode"] == total
        assert pa.LAUNCHES_BY_SHAPE["s"] == total
    finally:
        sys.setswitchinterval(old)
        for (m, n), v in saved.items():
            setattr(m, n, v)

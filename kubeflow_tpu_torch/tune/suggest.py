"""Suggestion algorithms behind one interface.

A copy of ``kubeflow_tpu/tune/suggest.py`` with one change: the Bayesian
suggester's Gaussian process is written here in numpy and scipy
(:class:`MaternGP`), as sklearn's ``GaussianProcessRegressor`` computes
it, since the card's host has no sklearn. Every ``random.Random`` and
numpy draw is taken in the JAX suggesters' order, so the same seed and
history give the same assignments.

Reference analog: [katib] pkg/suggestion/v1beta1/{hyperopt,optuna,skopt,
hyperband,...}/service.py behind the ``GetSuggestions`` gRPC proto
(UNVERIFIED, mount empty, SURVEY.md §0). The image has none of those
libraries (SURVEY.md §0), so the algorithms are first-party:

- ``random``    — uniform over the (log-aware) feasible space;
- ``grid``      — cartesian grid sweep;
- ``bayesian``  — GP regression (Matérn) + expected improvement,
                  the skopt-service analog;
- ``tpe``       — Tree-structured Parzen Estimator (hyperopt-service analog);
- ``cmaes``     — (μ/μ_w, λ) CMA-ES (optuna-cmaes analog);
- ``hyperband`` — successive-halving budget scheduler.

All optimizers work in the unit cube; ``ParameterSpec`` handles the
log/int/categorical mapping.
"""

from __future__ import annotations

import itertools
import math
import random as _random
from typing import Sequence

import numpy as np

from kubeflow_tpu_torch.tune.spec import (
    AlgorithmSpec,
    ExperimentSpec,
    ObjectiveType,
    ParameterSpec,
    TrialAssignment,
)


class Suggester:
    """GetSuggestions interface: observations in, new assignments out."""

    def __init__(self, spec: ExperimentSpec, seed: int = 0):
        self.spec = spec
        self.params = spec.parameters
        self.rng = _random.Random(seed)

    def suggest(
        self,
        count: int,
        history: Sequence[tuple[dict, float]],  # (parameters, objective)
    ) -> list[TrialAssignment]:
        raise NotImplementedError

    # helpers ---------------------------------------------------------------

    def _random_point(self) -> dict:
        return {p.name: p.from_unit(self.rng.random()) for p in self.params}

    def _to_unit_row(self, parameters: dict) -> list[float]:
        return [p.to_unit(parameters[p.name]) for p in self.params]

    def _from_unit_row(self, row: Sequence[float]) -> dict:
        return {p.name: p.from_unit(u) for p, u in zip(self.params, row)}

    def _sign(self) -> float:
        """Internally always minimize: flip maximize objectives."""
        return 1.0 if self.spec.objective.type is ObjectiveType.MINIMIZE else -1.0


class RandomSuggester(Suggester):
    def suggest(self, count, history):
        return [TrialAssignment(self._random_point()) for _ in range(count)]


class GridSuggester(Suggester):
    def __init__(self, spec: ExperimentSpec, seed: int = 0):
        super().__init__(spec, seed)
        n = int(spec.algorithm.settings.get("points_per_dim", 5))
        axes = [p.grid(n) for p in self.params]
        self._points = [
            dict(zip([p.name for p in self.params], combo))
            for combo in itertools.product(*axes)
        ]
        self._cursor = 0

    def suggest(self, count, history):
        out = []
        while count > 0 and self._cursor < len(self._points):
            out.append(TrialAssignment(self._points[self._cursor]))
            self._cursor += 1
            count -= 1
        return out  # exhausted grid returns fewer (controller completes)


class MaternGP:
    """GP regression with the kernel ``c · Matern(length_scale=l, nu=2.5)``
    on normalised targets: sklearn's ``GaussianProcessRegressor(kernel=
    ConstantKernel(1.0) * Matern(nu=2.5), normalize_y=True, alpha=...)``,
    step for step in float64.

    :meth:`fit` maximises the log marginal likelihood over ``θ = (log c,
    log l)`` with one L-BFGS-B run from ``θ0 = (0, 0)`` inside the bounds
    ``[log 1e-5, log 1e5]`` (sklearn's defaults, no restarts), from the
    analytic gradient; :meth:`predict` gives the posterior mean and
    standard deviation in the targets' units."""

    BOUNDS = ((math.log(1e-5), math.log(1e5)),) * 2

    def __init__(self, alpha: float = 1e-6):
        self.alpha = alpha
        self.theta = np.zeros(2)

    @staticmethod
    def _matern(dists: np.ndarray) -> np.ndarray:
        k = dists * math.sqrt(5)
        return (1.0 + k + k**2 / 3.0) * np.exp(-k)

    def _gram(self, X: np.ndarray, theta: np.ndarray):
        """``K(X, X)`` and its gradient in log-hyperparameter space
        ``(n, n, 2)``."""
        from scipy.spatial.distance import pdist, squareform

        c, ls = np.exp(theta)
        dists = pdist(X / ls, metric="euclidean")
        m = squareform(self._matern(dists))
        np.fill_diagonal(m, 1)
        d2 = squareform(dists**2)[:, :, np.newaxis]
        tmp = np.sqrt(5 * d2.sum(-1))[..., np.newaxis]
        m_grad = 5.0 / 3.0 * d2 * (tmp + 1) * np.exp(-tmp)
        c_full = np.full(m.shape, c)
        grad = np.dstack((c_full[:, :, np.newaxis] * m[:, :, np.newaxis],
                          m_grad * c_full[:, :, np.newaxis]))
        return c_full * m, grad

    def log_marginal_likelihood(self, theta: np.ndarray):
        """``(lml, d lml / d θ)`` of the training data at ``θ``."""
        from scipy.linalg import cho_solve, cholesky

        K, K_gradient = self._gram(self.X_train_, theta)
        K[np.diag_indices_from(K)] += self.alpha
        try:
            L = cholesky(K, lower=True, check_finite=False)
        except np.linalg.LinAlgError:
            return -np.inf, np.zeros_like(theta)
        y = self.y_train_[:, np.newaxis]
        alpha = cho_solve((L, True), y, check_finite=False)
        lml = -0.5 * np.einsum("ik,ik->k", y, alpha)
        lml -= np.log(np.diag(L)).sum()
        lml -= K.shape[0] / 2 * np.log(2 * np.pi)
        inner = np.einsum("ik,jk->ijk", alpha, alpha)
        K_inv = cho_solve((L, True), np.eye(K.shape[0]), check_finite=False)
        inner -= K_inv[..., np.newaxis]
        grad = 0.5 * np.einsum("ijl,jik->kl", inner, K_gradient)
        return lml.sum(axis=-1), grad.sum(axis=-1)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "MaternGP":
        import scipy.optimize
        from scipy.linalg import cho_solve, cholesky

        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self._y_mean = np.mean(y, axis=0)
        std = np.std(y, axis=0)
        # sklearn's _handle_zeros_in_scale: a constant target keeps scale 1
        self._y_std = 1.0 if std == 0.0 else std
        self.X_train_ = X
        self.y_train_ = (y - self._y_mean) / self._y_std

        def obj(theta):
            lml, grad = self.log_marginal_likelihood(theta)
            return -lml, -grad

        res = scipy.optimize.minimize(obj, np.zeros(2), method="L-BFGS-B",
                                      jac=True, bounds=self.BOUNDS)
        self.theta = res.x
        K, _ = self._gram(X, self.theta)
        K[np.diag_indices_from(K)] += self.alpha
        self.L_ = cholesky(K, lower=True, check_finite=False)
        self.alpha_ = cho_solve((self.L_, True), self.y_train_,
                                check_finite=False)
        return self

    def predict(self, Xq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and standard deviation at the rows of ``Xq``."""
        from scipy.linalg import solve_triangular
        from scipy.spatial.distance import cdist

        Xq = np.asarray(Xq, dtype=np.float64)
        c, ls = np.exp(self.theta)
        K_trans = c * self._matern(
            cdist(Xq / ls, self.X_train_ / ls, metric="euclidean"))
        mean = self._y_std * (K_trans @ self.alpha_) + self._y_mean
        V = solve_triangular(self.L_, K_trans.T, lower=True, check_finite=False)
        var = np.full(Xq.shape[0], c)
        var -= np.einsum("ij,ji->i", V.T, V)
        var[var < 0] = 0.0
        return mean, np.sqrt(var * self._y_std**2)


class BayesianSuggester(Suggester):
    """GP + expected improvement over the unit cube.

    A Matérn-5/2 GP with normalized y (:class:`MaternGP`); EI maximized by
    random multistart (cheap and dimension-robust — no scipy optimizer
    state).
    """

    def __init__(self, spec: ExperimentSpec, seed: int = 0):
        super().__init__(spec, seed)
        s = spec.algorithm.settings
        self.n_initial = int(s.get("n_initial", 5))
        self.n_candidates = int(s.get("n_candidates", 1024))
        self.xi = float(s.get("xi", 0.01))

    def fit_gp(self, history) -> tuple[MaternGP, np.ndarray]:
        """The GP over ``history`` (internally minimised) and the targets."""
        X = np.array([self._to_unit_row(p) for p, _ in history])
        y = self._sign() * np.array([v for _, v in history])
        # the JAX suggester seeds sklearn's GP from the stream here (unused
        # without restarts); the draw keeps later ones in step
        self.rng.randrange(2**31)
        return MaternGP(alpha=1e-6).fit(X, y), y

    def suggest(self, count, history):
        if len(history) < self.n_initial:
            return [TrialAssignment(self._random_point()) for _ in range(count)]

        gp, y = self.fit_gp(history)
        best = y.min()

        out: list[TrialAssignment] = []
        for _ in range(count):
            cand = np.array(
                [[self.rng.random() for _ in self.params]
                 for _ in range(self.n_candidates)]
            )
            mu, sigma = gp.predict(cand)
            sigma = np.maximum(sigma, 1e-9)
            imp = best - mu - self.xi
            z = imp / sigma
            ei = imp * _norm_cdf(z) + sigma * _norm_pdf(z)
            # penalize points already picked this batch (batch diversity)
            for a in out:
                d = np.linalg.norm(cand - np.array(self._to_unit_row(a.parameters)), axis=1)
                ei = np.where(d < 0.05, -np.inf, ei)
            out.append(TrialAssignment(self._from_unit_row(cand[int(np.argmax(ei))])))
        return out


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _norm_cdf(z):
    from scipy.special import ndtr

    return ndtr(z)


class TPESuggester(Suggester):
    """Tree-structured Parzen Estimator: model p(x|good) / p(x|bad).

    Per-dimension 1-D Parzen windows (Gaussian KDE over unit interval),
    candidates drawn from the good-KDE, ranked by likelihood ratio l(x)/g(x)
    — the hyperopt formulation.
    """

    def __init__(self, spec: ExperimentSpec, seed: int = 0):
        super().__init__(spec, seed)
        s = spec.algorithm.settings
        self.n_initial = int(s.get("n_initial", 5))
        self.gamma = float(s.get("gamma", 0.25))
        self.n_candidates = int(s.get("n_candidates", 64))

    def suggest(self, count, history):
        if len(history) < self.n_initial:
            return [TrialAssignment(self._random_point()) for _ in range(count)]

        X = np.array([self._to_unit_row(p) for p, _ in history])
        y = self._sign() * np.array([v for _, v in history])
        order = np.argsort(y)
        n_good = max(1, int(math.ceil(self.gamma * len(y))))
        good, bad = X[order[:n_good]], X[order[n_good:]]
        if len(bad) == 0:
            bad = X

        out = []
        rng = np.random.default_rng(self.rng.randrange(2**31))
        bw = max(0.05, 1.0 / max(1, len(good)) ** 0.5)
        for _ in range(count):
            row = []
            for d in range(len(self.params)):
                centers = good[:, d]
                cands = np.clip(
                    rng.choice(centers, self.n_candidates)
                    + rng.normal(0, bw, self.n_candidates),
                    0, 1,
                )
                lg = _parzen_logpdf(cands, centers, bw)
                lb = _parzen_logpdf(cands, bad[:, d], bw)
                row.append(float(cands[int(np.argmax(lg - lb))]))
            out.append(TrialAssignment(self._from_unit_row(row)))
        return out


def _parzen_logpdf(x: np.ndarray, centers: np.ndarray, bw: float) -> np.ndarray:
    d = (x[:, None] - centers[None, :]) / bw
    log_k = -0.5 * d * d - math.log(bw * math.sqrt(2 * math.pi))
    m = log_k.max(axis=1, keepdims=True)
    return (m + np.log(np.exp(log_k - m).sum(axis=1, keepdims=True))).ravel() - math.log(
        len(centers)
    )


class CMAESSuggester(Suggester):
    """(μ/μ_w, λ) CMA-ES in the unit cube, diagonal covariance variant."""

    def __init__(self, spec: ExperimentSpec, seed: int = 0):
        super().__init__(spec, seed)
        d = len(self.params)
        self.mean = np.full(d, 0.5)
        self.sigma = float(spec.algorithm.settings.get("sigma0", 0.3))
        self.C = np.ones(d)  # diagonal covariance
        self._seen = 0

    def suggest(self, count, history):
        rng = np.random.default_rng(self.rng.randrange(2**31))
        # update distribution from any new completed trials
        if len(history) > self._seen and len(history) >= 4:
            X = np.array([self._to_unit_row(p) for p, _ in history])
            y = self._sign() * np.array([v for _, v in history])
            mu = max(2, len(y) // 4)
            elite = X[np.argsort(y)[:mu]]
            w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
            w = w / w.sum()
            new_mean = (w[:, None] * elite).sum(0)
            var = (w[:, None] * (elite - self.mean) ** 2).sum(0)
            self.C = 0.8 * self.C + 0.2 * var / max(self.sigma**2, 1e-12)
            self.sigma = max(0.02, 0.9 * self.sigma)
            self.mean = new_mean
            self._seen = len(history)
        pts = rng.normal(self.mean, self.sigma * np.sqrt(self.C), (count, len(self.params)))
        return [TrialAssignment(self._from_unit_row(np.clip(r, 0, 1))) for r in pts]


class HyperbandSuggester(Suggester):
    """Successive halving: suggest() also assigns a per-trial budget.

    The budget parameter (default ``epochs``) is injected into each
    assignment; the controller runs trials at that budget and halving keeps
    the top 1/eta fraction at eta× budget.
    """

    def __init__(self, spec: ExperimentSpec, seed: int = 0):
        super().__init__(spec, seed)
        s = spec.algorithm.settings
        self.eta = int(s.get("eta", 3))
        self.min_budget = int(s.get("min_budget", 1))
        self.max_budget = int(s.get("max_budget", 27))
        self.budget_param = s.get("budget_param", "epochs")
        self._rungs: list[list[tuple[dict, float]]] = []
        self._budget = self.min_budget

    def suggest(self, count, history):
        # promote survivors when a rung completes
        completed = [(p, v) for p, v in history if p.get(self.budget_param) == self._budget]
        rung_size = max(count, 1)
        if completed and len(completed) >= rung_size and self._budget < self.max_budget:
            sign = self._sign()
            survivors = sorted(completed, key=lambda t: sign * t[1])[
                : max(1, len(completed) // self.eta)
            ]
            self._budget = min(self.max_budget, self._budget * self.eta)
            out = []
            for p, _ in survivors[:count]:
                q = dict(p)
                q[self.budget_param] = self._budget
                out.append(TrialAssignment(q))
            while len(out) < count:
                q = self._random_point()
                q[self.budget_param] = self._budget
                out.append(TrialAssignment(q))
            return out
        out = []
        for _ in range(count):
            q = self._random_point()
            q[self.budget_param] = self._budget
            out.append(TrialAssignment(q))
        return out


class PBTSuggester(Suggester):
    """Population Based Training (the Katib PBT service analog).

    Trial-based PBT: each generation's members inherit a top performer's
    weights via the ``checkpoint_param`` trial parameter (set to the parent
    trial id — the template maps it to a checkpoint path) and explore by
    perturbing the parent's hyperparameters (numeric ×{0.8,1.2} in unit
    space, categoricals resampled with ``resample_prob``). Needs trial
    identities, so it implements ``suggest_trials``.
    """

    def __init__(self, spec: ExperimentSpec, seed: int = 0):
        super().__init__(spec, seed)
        s = spec.algorithm.settings
        self.population = int(s.get("population", spec.parallel_trial_count))
        self.quantile = float(s.get("quantile", 0.25))
        self.perturb_factors = tuple(s.get("perturb_factors", (0.8, 1.2)))
        self.resample_prob = float(s.get("resample_prob", 0.25))
        self.checkpoint_param = s.get("checkpoint_param", "parent_trial")

    def suggest_trials(self, count: int, trials) -> list[TrialAssignment]:
        from kubeflow_tpu_torch.tune.spec import TrialState

        done = [
            t
            for t in trials
            if t.state is TrialState.SUCCEEDED and t.objective_value is not None
        ]
        out = []
        if len(done) < self.population:
            for _ in range(count):
                q = self._random_point()
                q[self.checkpoint_param] = ""  # fresh member, no parent
                out.append(TrialAssignment(q))
            return out
        sign = self._sign()
        ranked = sorted(done, key=lambda t: sign * t.objective_value)
        k = max(1, int(len(ranked) * self.quantile))
        top = ranked[:k]
        for _ in range(count):
            parent = self.rng.choice(top)
            q = self._exploit_explore(parent.assignment.parameters)
            q[self.checkpoint_param] = parent.assignment.trial_id
            out.append(TrialAssignment(q))
        return out

    def _exploit_explore(self, params: dict) -> dict:
        q = {}
        for p in self.params:
            v = params.get(p.name)
            if v is None or self.rng.random() < self.resample_prob:
                q[p.name] = p.from_unit(self.rng.random())
                continue
            if p.type.value in ("double", "int"):
                # Standard PBT perturbs the parameter VALUE, not its unit
                # coordinate — a unit-space multiply pins values at the
                # lower bound (0 × factor = 0) forever. A value of exactly
                # 0 can't move multiplicatively either, so nudge it in unit
                # space instead.
                factor = self.rng.choice(self.perturb_factors)
                if float(v) != 0.0:
                    u = p.to_unit(float(v) * factor)
                else:
                    u = p.to_unit(v) + (factor - 1.0)
                q[p.name] = p.from_unit(min(1.0, max(0.0, u)))
            else:
                q[p.name] = v
        return q

    def suggest(self, count, history):
        # history-only callers (no lineage): degrade to perturbed top points
        if not history:
            return [TrialAssignment(self._random_point()) for _ in range(count)]
        sign = self._sign()
        ranked = sorted(history, key=lambda t: sign * t[1])
        k = max(1, int(len(ranked) * self.quantile))
        return [
            TrialAssignment(
                self._exploit_explore(dict(self.rng.choice(ranked[:k])[0]))
            )
            for _ in range(count)
        ]


_REGISTRY = {
    "random": RandomSuggester,
    "grid": GridSuggester,
    "bayesian": BayesianSuggester,
    "skopt": BayesianSuggester,  # Katib algorithm-name alias
    "tpe": TPESuggester,
    "hyperopt": TPESuggester,  # alias
    "cmaes": CMAESSuggester,
    "hyperband": HyperbandSuggester,
    "pbt": PBTSuggester,
}


def make_suggester(spec: ExperimentSpec, seed: int = 0) -> Suggester:
    if spec.algorithm.name in ("darts", "enas"):
        # NAS is not a parameter suggester here: the whole search runs in
        # the trial's process (no controller/service split) — use
        # kubeflow_tpu_torch.tune.nas.DARTSSearcher in the trial.
        raise ValueError(
            f"algorithm '{spec.algorithm.name}' runs in-process: use "
            "kubeflow_tpu_torch.tune.nas (DARTSSearcher) instead of a suggester"
        )
    try:
        cls = _REGISTRY[spec.algorithm.name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm '{spec.algorithm.name}' "
            f"(have: {sorted(_REGISTRY)})"
        ) from None
    return cls(spec, seed)

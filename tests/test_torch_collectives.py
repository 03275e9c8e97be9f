"""The port's ``core/collectives.py`` against the JAX package's, in one gloo
world of 8 CPU ranks: every case of ``tests/test_collectives.py`` (each
rank's result held against the JAX shard at its device), then the
gradient through each differentiable collective against its transpose
worked out in numpy. Tolerance: 1e-6 relative (f32 sums of a few terms).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_worlds as tw
from kubeflow_tpu.core import collectives as jcoll
from kubeflow_tpu.core.mesh import Axis, MeshSpec, build_mesh

RTOL = 1e-6
N = 8
X16 = np.arange(16.0, dtype=np.float32)
SWAP = np.random.RandomState(0).randn(16, 8, 4).astype(np.float32)
GRAD_X = np.random.RandomState(1).randn(N * 2, 8).astype(np.float32)
#: the per-rank objective weights: rank i's row
GRAD_W = np.random.RandomState(2).randn(N, 2, 8).astype(np.float32)
GRAD_W_GATHER = np.random.RandomState(3).randn(N, N * 2, 8).astype(np.float32)
GRAD_W_A2A = np.random.RandomState(4).randn(N, N * 2, 1).astype(np.float32)
GRAD_KINDS = ("psum", "enter", "all_gather", "reduce_scatter", "ring_shift",
              "all_to_all")


def _weights(kind):
    if kind == "psum":
        return GRAD_W[0]
    if kind == "all_gather":
        return GRAD_W_GATHER
    if kind == "all_to_all":
        return GRAD_W_A2A
    return GRAD_W


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = [
        ("grad_allreduce", dict(fn="collective", spec=dict(data=8),
                                kind="grad_allreduce", x=np.arange(8.0, dtype=np.float32),
                                axis="data")),
        ("ring_shift", dict(fn="collective", spec=dict(data=8), kind="ring_shift",
                            x=np.arange(8.0, dtype=np.float32), axis="data")),
        ("gather_scatter", dict(fn="collective", spec=dict(fsdp=8),
                                kind="gather_scatter", x=X16, axis="fsdp")),
        ("all_to_all_swap", dict(fn="collective", spec=dict(seq=8),
                                 kind="all_to_all_swap", x=SWAP, axis="seq")),
        ("bench", dict(fn="bench", spec=dict(data=8), axis="data", suite=False)),
        ("suite", dict(fn="bench", spec=dict(data=8), axis="data", suite=True)),
        ("counters", dict(fn="staged_counts", spec=dict(data=8))),
    ] + [(f"grad_{k}", dict(fn="collective_grad", spec=dict(data=8), kind=k,
                            x=GRAD_X, w=_weights(k), axis="data"))
         for k in GRAD_KINDS]
    return tw.world(N, cases, tmp_path_factory.mktemp("world"))


def _shmap(mesh, fn, in_specs, out_specs):
    return jcoll.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


def _stack(results):
    return np.concatenate([np.atleast_1d(r) for r in results])


def test_grad_allreduce_is_mean(world, devices8):
    mesh = build_mesh(MeshSpec.data_parallel(8))
    x = jnp.arange(8.0)
    want = _shmap(mesh, lambda x: jcoll.grad_allreduce({"g": x}, Axis.DATA)["g"],
                  P(Axis.DATA), P(Axis.DATA))(x)
    np.testing.assert_allclose(_stack(world["grad_allreduce"]), np.asarray(want),
                               rtol=RTOL)


def test_ring_shift(world, devices8):
    mesh = build_mesh(MeshSpec.data_parallel(8))
    want = _shmap(mesh, lambda x: jcoll.ring_shift(x, Axis.DATA), P(Axis.DATA),
                  P(Axis.DATA))(jnp.arange(8.0))
    np.testing.assert_allclose(_stack(world["ring_shift"]), np.asarray(want))
    np.testing.assert_allclose(_stack(world["ring_shift"]), np.roll(np.arange(8.0), 1))


def test_all_gather_and_reduce_scatter_roundtrip(world, devices8):
    mesh = build_mesh(MeshSpec.fsdp_parallel(8))

    def body(xs):
        return jcoll.reduce_scatter(jcoll.all_gather(xs, Axis.FSDP), Axis.FSDP)

    want = _shmap(mesh, body, P(Axis.FSDP), P(Axis.FSDP))(jnp.asarray(X16))
    np.testing.assert_allclose(_stack(world["gather_scatter"]), np.asarray(want))
    np.testing.assert_allclose(_stack(world["gather_scatter"]), X16 * 8)


def test_all_to_all_ulysses_swap(world, devices8):
    mesh = build_mesh(MeshSpec(seq=8))

    def body(xs):
        ys = jcoll.all_to_all(xs, Axis.SEQ, split_axis=1, concat_axis=0)
        return jcoll.all_to_all(ys, Axis.SEQ, split_axis=0, concat_axis=1)

    want = _shmap(mesh, body, P(Axis.SEQ), P(Axis.SEQ))(jnp.asarray(SWAP))
    np.testing.assert_allclose(np.concatenate(world["all_to_all_swap"]),
                               np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(np.concatenate(world["all_to_all_swap"]), SWAP)


def test_benchmark_collective_runs(world, devices8):
    mesh = build_mesh(MeshSpec.data_parallel(8))
    want = jcoll.benchmark_collective(mesh, Axis.DATA, "psum", mb_per_shard=0.1,
                                      iters=2, warmup=1)
    for r in world["bench"]:
        assert set(r) == set(want)
        assert r["sec_per_op"] > 0 and r["bus_gbps"] > 0 and r["axis_size"] == 8
        assert r["bytes_per_shard"] == want["bytes_per_shard"]


def test_benchmark_suite_all_kinds(world):
    for rs in world["suite"]:
        assert {r["kind"] for r in rs} == {"psum", "all_gather", "reduce_scatter",
                                           "ppermute", "all_to_all"}


def test_counters_count_calls_and_no_staging_on_the_cpu(world):
    for r in world["counters"]:
        assert r["staged"] == 0 and r["calls"] == {"all_reduce": 1}


def _expected_grad(kind, i):
    """d(sum of every rank's objective)/d(rank i's shard), in numpy."""
    rows = GRAD_X.shape[0] // N
    if kind == "psum":          # one replicated objective: identity
        return GRAD_W[0]
    if kind == "enter":         # replicated input: the objectives' sum
        return GRAD_W.sum(0)
    if kind == "all_gather":    # reduce-scatter of every rank's weights
        return GRAD_W_GATHER.sum(0)[i * rows:(i + 1) * rows]
    if kind == "reduce_scatter":  # all-gather of each rank's kept column
        return np.stack([GRAD_W[k][:, k] for k in range(N)], axis=1)
    if kind == "ring_shift":    # the inverse shift
        return GRAD_W[(i + 1) % N]
    if kind == "all_to_all":    # the inverse exchange
        return np.stack([GRAD_W_A2A[k][i * rows:(i + 1) * rows, 0]
                         for k in range(N)], axis=1)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", GRAD_KINDS)
def test_gradient_is_the_transposed_collective(world, kind):
    for i, got in enumerate(world[f"grad_{kind}"]):
        np.testing.assert_allclose(got, _expected_grad(kind, i), rtol=RTOL,
                                   atol=1e-6, err_msg=f"{kind} rank {i}")

"""The port's ``core/mesh.py``, ``core/distributed.py`` and
``obs/heartbeat.py`` against the JAX package's.

Rank r of the port's mesh must hold the coordinates JAX device r holds
for the same ``MeshSpec`` (the JAX mesh is built on this process's 8 CPU
devices), so batch and sequence shards line up between the two packages.
One gloo world of 8 CPU ranks checks each rank's coordinates, batch
index and axis groups (an all-reduce of the ranks over every axis).
"""

from __future__ import annotations

import numpy as np
import pytest

import torch_worlds as tw
from kubeflow_tpu.core import distributed as jdist
from kubeflow_tpu.core import mesh as jmesh
from kubeflow_tpu_torch.core import distributed as tdist
from kubeflow_tpu_torch.core import mesh as tmesh

SPECS = {
    "data8": dict(data=8),
    "fsdp8": dict(fsdp=8),
    "model8": dict(model=8),
    "data2_model4": dict(data=2, model=4),
    "data2_fsdp2_model2": dict(data=2, fsdp=2, model=2),
    "dcn2_model4": dict(model=4, dcn_data=2),
    "dcn2_fsdp2_model2": dict(dcn_data=2, fsdp=2, model=2),
    "pipe4_data2": dict(pipe=4, data=2),
    "data2_seq4": dict(data=2, seq=4),
    "expert2_seq2_model2": dict(expert=2, seq=2, model=2),
}


def _jax_ids(spec_kw):
    m = jmesh.build_mesh(jmesh.MeshSpec(**spec_kw))
    return np.vectorize(lambda d: d.id)(m.devices), dict(m.shape)


@pytest.mark.parametrize("name", list(SPECS))
def test_rank_grid_equals_jax_device_grid(name, devices8):
    ids, shape = _jax_ids(SPECS[name])
    got = tmesh.jax_device_grid(tmesh.MeshSpec(**SPECS[name]))
    np.testing.assert_array_equal(got, ids)
    for r in range(8):
        assert tmesh.Mesh(tmesh.MeshSpec(**SPECS[name]), r,
                          device="cpu").shape == shape


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = [(n, dict(fn="mesh_coords", spec=s)) for n, s in SPECS.items()]
    return tw.world(8, cases, tmp_path_factory.mktemp("world"))


@pytest.mark.parametrize("name", list(SPECS))
def test_rank_coordinates_and_groups(world, name, devices8):
    """Each rank sits where its JAX device sits; its batch index is the
    JAX (data, fsdp) shard index; each axis group holds the ranks that
    differ from it in that axis alone."""
    ids, shape = _jax_ids(SPECS[name])
    names = list(shape)
    spec = tmesh.MeshSpec(**SPECS[name])
    grid = tmesh.rank_grid(spec)
    for rank, res in enumerate(world[name]):
        pos = dict(zip(names, (int(c) for c in np.argwhere(ids == rank)[0])))
        dcn = res["coords"]["dcn_data"]
        assert pos["data"] == dcn * spec.data + res["coords"]["data"]
        for a in ("pipe", "fsdp", "expert", "seq", "model"):
            assert pos[a] == res["coords"][a]
        assert res["batch_index"] == pos["data"] * shape["fsdp"] + pos["fsdp"]
        assert res["jax_shape"] == shape
        for a in tmesh.Axis.GRID:
            sel = tuple(slice(None) if (b == a or (a == "data" and b == "dcn_data"))
                        else res["coords"][b] for b in tmesh.Axis.GRID)
            assert res["peer_sums"][a] == int(grid[sel].sum()), (a, rank)


def test_slice_topology_matches_jax():
    for n in (1, 2, 4, 7, 8, 12, 16, 256):
        assert tmesh.slice_topology(n) == jmesh.slice_topology(n)


def test_meshspec_validation_and_roundtrip_match_jax():
    for cls in (tmesh.MeshSpec, jmesh.MeshSpec):
        cls(data=8).validate(8)
        with pytest.raises(ValueError):
            cls(data=4).validate(8)
        with pytest.raises(ValueError):
            cls(data=0).validate()
        with pytest.raises(ValueError):
            cls.from_dict({"nope": 2})
        spec = cls(data=2, model=4, dcn_data=2)
        assert cls.from_dict(spec.to_dict()) == spec
        assert spec.total_devices == 16 and spec.batch_partitions == 4
    assert tmesh.MeshSpec(fsdp=3).to_dict() == jmesh.MeshSpec(fsdp=3).to_dict()


def test_per_device_batch_matches_jax():
    for cls, fn in ((tmesh.MeshSpec, tmesh.per_device_batch),
                    (jmesh.MeshSpec, jmesh.per_device_batch)):
        assert fn(64, cls(data=2, fsdp=4)) == 8
        assert fn(64, cls(data=2, dcn_data=2)) == 16
        with pytest.raises(ValueError):
            fn(10, cls(data=4))


def test_mesh_context_is_ambient():
    m = tmesh.Mesh(tmesh.MeshSpec(), 0, device="cpu")
    assert tmesh.current_mesh() is None
    with tmesh.mesh_context(m):
        assert tmesh.current_mesh() is m
    assert tmesh.current_mesh() is None
    # a one-device spec needs no process group
    one = tmesh.build_mesh(tmesh.MeshSpec(), device="cpu")
    assert one.group("data") is None and one.batch_index == 0


def test_mesh_device_defaults_to_the_card():
    """``device=None`` is the card, as for every entry point of the port:
    on a host without one the mesh raises rather than fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        assert tmesh.build_mesh(tmesh.MeshSpec()).device.type == "cuda"
        assert tmesh.Mesh(tmesh.MeshSpec(seq=2), 1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            tmesh.build_mesh(tmesh.MeshSpec())
        with pytest.raises(RuntimeError, match="CUDA device"):
            tmesh.Mesh(tmesh.MeshSpec(seq=2), 1)
    assert tmesh.Mesh(tmesh.MeshSpec(seq=2), 1, device="cpu").device.type == "cpu"


ENVS = [
    {},
    {"JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2",
     "JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_LOCAL_DEVICE_IDS": "0,1"},
    {"JAX_NUM_PROCESSES": "1"},
    {"TPU_WORKER_HOSTNAMES": "a,b,c", "TPU_WORKER_ID": "1"},
    {"TPU_WORKER_HOSTNAMES": "solo"},
]
BAD_ENVS = [
    {"JAX_NUM_PROCESSES": "2"},                                   # no coordinator
    {"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "2",
     "JAX_COORDINATOR_ADDRESS": "h:1"},                           # rank too big
    {"JAX_NUM_PROCESSES": "0"},
    {"TPU_WORKER_HOSTNAMES": "a,b"},                              # no worker id
]


@pytest.mark.parametrize("env", ENVS, ids=[str(i) for i in range(len(ENVS))])
def test_distributed_config_from_env_matches_jax(env):
    want = jdist.DistributedConfig.from_env(env)
    got = tdist.DistributedConfig.from_env(env)
    assert got.__dict__ == want.__dict__
    assert got.is_multiprocess == want.is_multiprocess


@pytest.mark.parametrize("env", BAD_ENVS, ids=[str(i) for i in range(len(BAD_ENVS))])
def test_distributed_config_errors_match_jax(env):
    with pytest.raises(ValueError) as jerr:
        jdist.DistributedConfig.from_env(env)
    with pytest.raises(ValueError) as terr:
        tdist.DistributedConfig.from_env(env)
    assert str(terr.value) == str(jerr.value)


def test_backend_choice():
    """gloo on the CPU and for several ranks sharing a card; nccl only
    when each local rank names a card of its own."""
    assert tdist.choose_backend("cpu", 4) == "gloo"
    assert tdist.choose_backend("cuda", 4) == "gloo"          # all on card 0
    assert tdist.choose_backend("cuda", 1) == "nccl"
    assert tdist.choose_backend("cuda", 2, (0, 1)) == "gloo"   # two ids a rank


MULTI_HOST = {"JAX_NUM_PROCESSES": "16", "JAX_PROCESS_ID": "9",
              "JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234"}


@pytest.mark.parametrize("extra,cards,want", [
    # 2 hosts x 8 cards, a rank a card: the world's 16 ranks are not local
    ({"JAX_LOCAL_DEVICE_IDS": "1"}, 8, "nccl"),
    ({"JAX_LOCAL_DEVICE_IDS": "1", "LOCAL_WORLD_SIZE": "8"}, 8, "nccl"),
    # more ranks on this host than cards, or a card it does not have
    ({"JAX_LOCAL_DEVICE_IDS": "1", "LOCAL_WORLD_SIZE": "9"}, 8, "gloo"),
    ({"JAX_LOCAL_DEVICE_IDS": "8"}, 8, "gloo"),
    # one rank a host on its card 0, as JAX runs one process a host
    ({}, 8, "nccl"),
    ({"LOCAL_WORLD_SIZE": "1"}, 1, "nccl"),
    # four ranks on one card (the launcher's layout): host-staged gloo
    ({"LOCAL_WORLD_SIZE": "4"}, 1, "gloo"),
])
def test_backend_choice_from_env(monkeypatch, extra, cards, want):
    """The backend follows the ranks on this host (``LOCAL_WORLD_SIZE``)
    and the card each names, never the world size."""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    env = {**MULTI_HOST, **extra}
    cfg = tdist.DistributedConfig.from_env(env)
    got = tdist.choose_backend("cuda", tdist.local_world_size(env),
                               cfg.local_device_ids)
    assert got == want


def test_launch_fails_on_a_raising_rank(tmp_path):
    """A rank that raises fails the world with its traceback; the other
    ranks are stopped, not left waiting."""
    with pytest.raises(RuntimeError, match="RuntimeError: rank 1 refuses"):
        tdist.launch(tw.refuse, 2, args=(1,), timeout_s=60.0, device="cpu",
                     rendezvous=f"file://{tmp_path / 'rdv'}")


def test_group_timeout_follows_the_default_group(tmp_path, monkeypatch):
    """Groups a mesh or an engine creates take the default group's timeout,
    also when another launcher brought that group up, and never torch's
    30-minute default."""
    import datetime

    import torch.distributed as dist

    monkeypatch.setattr(tdist, "_timeout", None)
    assert tdist.group_timeout() == datetime.timedelta(
        seconds=tdist.DEFAULT_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=42))
    try:
        assert tdist.group_timeout() == datetime.timedelta(seconds=42)
    finally:
        dist.destroy_process_group()


def test_heartbeat_files_cross_both_ways(tmp_path):
    """The port's writer is read by the JAX supervisor's reader and the
    JAX writer by the port's, with the same staleness rule."""
    import time

    from kubeflow_tpu.obs import heartbeat as jhb
    from kubeflow_tpu_torch.obs import heartbeat as thb

    env = {"KFT_WORKDIR": str(tmp_path), "KFT_REPLICA_TYPE": "worker",
           "KFT_REPLICA_INDEX": "3"}
    assert thb.heartbeat_path_from_env(env) == jhb.heartbeat_path_from_env(env)
    assert thb.heartbeat_path_from_env({}) is None
    for writer, reader in ((thb, jhb), (jhb, thb)):
        path = tmp_path / f"{writer.__name__}.json"
        w = writer.HeartbeatWriter(path, interval=60.0, attempt=1)
        w.beat(step=7)
        hb = reader.read_heartbeat(path)
        assert (hb.step, hb.attempt) == (7, 1)
        assert not reader.is_stale(path, 5.0)
        assert reader.is_stale(path, 5.0, now=time.monotonic() + 10)
        assert not reader.is_stale(path, 5.0, min_attempt=2,
                                   now=time.monotonic() + 10)
    assert thb.read_heartbeat(tmp_path / "absent.json") is None

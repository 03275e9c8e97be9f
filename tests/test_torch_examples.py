"""The port's JAXJob workers under the JAX orchestrator.

Mirrors of ``tests/test_e2e_mnist.py`` and ``tests/test_multislice.py``:
the JAX ``LocalCluster`` gangs ``python -m kubeflow_tpu_torch.examples.
mnist`` (and ``.multislice``) as two workers wired by its ``cpu_sim`` env
contract, and each worker brings up one gloo rank from that contract.
The port runs one rank a process, so the gang that the JAX job sees as
"4 local / 8 global" devices is two ranks here, "1 local / 2 global".
Both jobs run at once on a fleet of four slices; the resume job runs
after the first MNIST job, from its checkpoint. Each worker uses one
CPU thread (``OMP_NUM_THREADS=1``), as the test worlds' ranks do.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

from kubeflow_tpu.orchestrator import JobSpec, LocalCluster, ReplicaSpec, TPURequest
from kubeflow_tpu.orchestrator.envwire import WiringConfig
from kubeflow_tpu.orchestrator.resources import Fleet
from kubeflow_tpu.train.metrics import parse_stdout_metrics

REPO = str(Path(__file__).resolve().parent.parent)
PY = sys.executable
JOB_TIMEOUT_S = 240


def _job(name, module, *argv):
    return JobSpec(
        name=name,
        replicas={"worker": ReplicaSpec(
            replicas=2,
            command=(PY, "-m", f"kubeflow_tpu_torch.examples.{module}",
                     "--device", "cpu", *argv),
            env={"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
            tpu=TPURequest(chips=4),
        )},
    )


def _mnist_args(ckpt, steps):
    return ("--steps", str(steps), "--global-batch", "32", "--log-every", "2",
            "--lr", "3e-3", "--checkpoint-dir", str(ckpt),
            "--checkpoint-every", "3", "--prefetch-depth", "0")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """``{job: (phase, worker 0's log, worker 1's log)}`` of the first
    MNIST job, the multislice job and the MNIST job that resumes."""
    base = tmp_path_factory.mktemp("cluster")
    ckpt = base / "ckpt"
    cluster = LocalCluster(
        fleet=Fleet.homogeneous(4, "2x2"),
        wiring=WiringConfig(platform="cpu_sim", devices_per_worker=4),
        base_dir=str(base), resync_period=0.05,
    )
    out = {}
    with cluster:
        uids = {
            "mnist": cluster.submit(_job("mnist-dp", "mnist",
                                         *_mnist_args(ckpt, 6))),
            "multislice": cluster.submit(_job(
                "multislice", "multislice", "--steps", "4", "--seq-len", "64")),
        }
        for name, uid in uids.items():
            status = cluster.wait(uid, timeout=JOB_TIMEOUT_S)
            out[name] = (status.phase, cluster.logs(uid, "worker", 0),
                         cluster.logs(uid, "worker", 1))
        uid = cluster.submit(_job("mnist-resume", "mnist", *_mnist_args(ckpt, 8)))
        status = cluster.wait(uid, timeout=JOB_TIMEOUT_S)
        out["resume"] = (status.phase, cluster.logs(uid, "worker", 0),
                         cluster.logs(uid, "worker", 1))
    out["ckpt"] = ckpt
    return out


def _succeeded(jobs, name):
    phase, log0, log1 = jobs[name]
    assert phase == "Succeeded", f"rank 0 log:\n{log0}\nrank 1 log:\n{log1}"
    return log0, log1


def test_mnist_job_trains_and_logs_on_rank_0_only(jobs):
    log0, log1 = _succeeded(jobs, "mnist")
    # the world formed: one rank a process, two ranks in all
    assert "process 0/2: 1 local / 2 global cpu devices (backend gloo)" in log0
    assert "process 1/2: 1 local / 2 global cpu devices (backend gloo)" in log1
    metrics = parse_stdout_metrics(log0)
    assert [m["step"] for m in metrics] == [2, 4, 6]
    assert metrics[-1]["loss"] < metrics[0]["loss"]
    assert parse_stdout_metrics(log1) == []
    assert "final_loss=" in log0 and "final_loss=" not in log1
    assert "WARNING: loss did not improve" not in log0


def test_mnist_job_writes_a_checkpoint(jobs):
    _succeeded(jobs, "mnist")
    steps = sorted(p.name for p in jobs["ckpt"].iterdir())
    assert steps, "no checkpoint written"


def test_second_mnist_job_resumes_at_the_next_step(jobs):
    log0, log1 = _succeeded(jobs, "resume")
    # both ranks restored step 6 and went on from step 7
    assert "resume_step=6" in log0 and "resume_step=6" in log1
    assert [m["step"] for m in parse_stdout_metrics(log0)] == [8]
    assert parse_stdout_metrics(log1) == []
    assert "final_loss=" in log0


def test_multislice_job_prints_its_ok_lines(jobs):
    log0, log1 = _succeeded(jobs, "multislice")
    # each process checked that every dcn_data block is one slice's rank
    assert "dcn placement ok: 2 slices x 1 devices" in log0
    assert "dcn placement ok: 2 slices x 1 devices" in log1
    # the cross-slice sum crossed slices: 1 + 2
    assert "cross-slice psum ok: 3.0" in log0
    assert "multislice training ok: steps=4" in log0
    assert "multislice training ok" not in log1


@pytest.mark.parametrize("module", ["mnist", "multislice"])
def test_main_runs_in_process_on_one_rank(module, monkeypatch, capsys):
    """Without the env contract each example runs as one rank in the
    calling process and prints what rank 0 prints."""
    import importlib

    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID", "JAX_LOCAL_DEVICE_IDS", "TPU_WORKER_ID",
                "TPU_WORKER_HOSTNAMES", "LOCAL_WORLD_SIZE", "KFT_WORKDIR"):
        monkeypatch.delenv(var, raising=False)
    mod = importlib.import_module(f"kubeflow_tpu_torch.examples.{module}")
    if module == "mnist":
        argv = ["--device", "cpu", "--steps", "4", "--global-batch", "8",
                "--log-every", "2", "--lr", "3e-3", "--prefetch-depth", "0"]
    else:
        argv = ["--device", "cpu", "--steps", "2", "--seq-len", "32",
                "--log-every", "1"]
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    if module == "mnist":
        assert "process 0/1: 1 local / 1 global cpu devices (backend none)" in out
        assert [m["step"] for m in parse_stdout_metrics(out)] == [2, 4]
        assert "final_loss=" in out
    else:
        assert "dcn placement ok: 1 slices x 1 devices" in out
        assert "cross-slice psum ok: 1.0" in out
        assert "multislice training ok: steps=2" in out

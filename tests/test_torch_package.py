"""Static checks of the PyTorch port's package boundary.

``kubeflow_tpu_torch`` and ``chip_smoke.py`` stand alone: they import
neither JAX nor its libraries nor any module of the JAX package, nor
aiohttp, which the card's host does not have (the port's HTTP, gateway
included, is the standard library's). Every
CUDA source under ``ops/csrc/`` has a Python wrapper that builds it and
counts its launches, and no library attention or compiler stands in for
a kernel.
"""

from __future__ import annotations

import ast
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "kubeflow_tpu_torch"
#: the package, the card's smoke script and the rank bodies the CPU tests
#: spawn (children import them by name, so they must stay JAX-free too)
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                     ROOT / "tests" / "torch_worlds.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "kubeflow_tpu", "aiohttp")
CSRC = sorted((PKG / "ops" / "csrc").glob("*.cu"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN  # "kubeflow_tpu_torch" is its own top level


def test_forbidden_matcher():
    assert _forbidden("kubeflow_tpu.ops.paged_attention")
    assert _forbidden("kubeflow_tpu") and _forbidden("jax.numpy")
    assert _forbidden("aiohttp.web") and _forbidden("aiohttp")
    assert not _forbidden("kubeflow_tpu_torch.ops.paged_attention")


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_port_imports_no_jax_and_no_jax_package(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_library_attention_or_compiler(path):
    """The kernels are the port's own: no SDPA, no cuDNN attention, no
    ``torch.compile``. ``chip_smoke.py`` may time SDPA as a yardstick."""
    attrs = [
        node for node in ast.walk(ast.parse(path.read_text()))
        if isinstance(node, ast.Attribute)
    ]
    names = {node.attr for node in attrs}
    banned = {"_scaled_dot_product_cudnn_attention",
              "_scaled_dot_product_flash_attention"}
    if path.name != "chip_smoke.py":
        banned.add("scaled_dot_product_attention")
    assert not names & banned
    assert not any(
        node.attr == "compile" and isinstance(node.value, ast.Name)
        and node.value.id == "torch" for node in attrs
    )


def test_parallel_subpackages_are_covered():
    """The distributed slice's modules exist and are among the files the
    import checks above walk."""
    for rel in ("core/distributed.py", "core/mesh.py", "core/collectives.py",
                "parallel/sharding.py", "parallel/ring_attention.py",
                "parallel/ulysses.py", "parallel/expert.py",
                "parallel/pipeline.py", "obs/heartbeat.py"):
        assert PKG / rel in FILES, rel


def test_tabular_modules_are_covered():
    """The tabular predictors and ModelMesh exist and are among the files
    the import checks above walk; ``sklearn`` and ``joblib`` are imported
    only inside a function (the card's host has neither), never at the
    top of a module."""
    for rel in ("serve/tabular.py", "serve/xgboost_runtime.py",
                "serve/lightgbm_runtime.py", "serve/pmml_runtime.py",
                "serve/sklearn_runtime.py", "serve/modelmesh.py"):
        assert PKG / rel in FILES, rel
    for path in FILES:
        tree = ast.parse(path.read_text())
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        mods = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in mods if m.split(".")[0] in ("sklearn", "joblib")], path


def test_pipelines_modules_are_covered():
    """Every module of the JAX package's ``pipelines/`` has a twin of the
    same name in the port, and so has ``obs/webhost.py``, which the
    pipelines API serves on; all are among the files the import checks
    above walk."""
    jax_pkg = ROOT / "kubeflow_tpu"
    names = sorted(p.name for p in (jax_pkg / "pipelines").glob("*.py"))
    assert len(names) == 11
    for rel in [f"pipelines/{n}" for n in names] + ["obs/webhost.py"]:
        assert (jax_pkg / rel).exists(), rel
        assert PKG / rel in FILES, rel


def test_kernel_sources_exist():
    assert {p.stem for p in CSRC} == {
        "paged_attention", "flash_attention", "flash_attention_bwd"}


def _entry_points(cu: Path) -> list[str]:
    """The kernel-launching C entry points of a source (not the shared
    ``kft_error_string``)."""
    names = re.findall(r'extern "C" int (kft_\w+)\(', cu.read_text())
    return [n for n in names if n != "kft_error_string"]


@pytest.mark.parametrize("cu", CSRC, ids=[p.stem for p in CSRC])
def test_every_kernel_has_a_counting_wrapper(cu):
    """``ops/<name>.py`` loads ``csrc/<name>.cu`` through ``_build`` and
    keeps one module-level launch counter (``LAUNCHES`` or
    ``<KERNEL>_LAUNCHES``) per C entry point of the source, each starting
    at 0 and incremented at exactly one site."""
    wrapper = PKG / "ops" / f"{cu.stem}.py"
    assert wrapper.exists(), f"no wrapper for {cu.name}"
    tree = ast.parse(wrapper.read_text())
    is_counter = re.compile(r"^([A-Z]+_)?LAUNCHES$").match
    counters = [
        n for n in tree.body if isinstance(n, ast.Assign)
        and any(isinstance(t, ast.Name) and is_counter(t.id) for t in n.targets)
    ]
    entries = _entry_points(cu)
    assert entries and len(counters) == len(entries), (entries, counters)
    for counter in counters:
        (name,) = [t.id for t in counter.targets]
        assert isinstance(counter.value, ast.Constant)
        assert counter.value.value == 0
        bumps = [
            n for n in ast.walk(tree) if isinstance(n, ast.AugAssign)
            and isinstance(n.target, ast.Name) and n.target.id == name
        ]
        assert len(bumps) == 1, f"{name}: one launch site, counted once"
    called = {
        n.func.attr for n in ast.walk(tree) if isinstance(n, ast.Call)
        and isinstance(n.func, ast.Attribute) and n.func.attr.startswith("kft_")
    }
    assert set(entries) <= called, "every entry point is launched"
    loads = [
        n for n in ast.walk(tree) if isinstance(n, ast.Call)
        and isinstance(n.func, ast.Attribute) and n.func.attr == "load"
        and n.args and isinstance(n.args[0], ast.Constant)
    ]
    assert [n.args[0].value for n in loads] == [cu.stem]
    text = cu.read_text()
    assert "sm_90a" in text and "Replaces" in text  # the header note


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """On a host without CUDA, or in a directory holding nothing of the
    repo but the script, chip_smoke.py exits non-zero and prints no
    result line."""
    cwd = ROOT
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        cwd = tmp_path
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

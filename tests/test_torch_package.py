"""Static checks of the PyTorch port's package boundary.

``kubeflow_tpu_torch`` and ``chip_smoke.py`` stand alone: they import
neither JAX nor its libraries nor any module of the JAX package. Every
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
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "kubeflow_tpu")
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

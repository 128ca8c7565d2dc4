"""Package rules of the port: no JAX, the card by default, no fallback."""

import ast
import importlib
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks at the top; JAX stays on the CPU)
import pytest
import torch

import repro_torch
from repro_torch.core import RMQ
from repro_torch.kernels import _build
from repro_torch.kernels.hierarchy_fused import ops as fused_ops
from repro_torch.kernels.profiling import count_launches

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


SLICE_MODULES = [
    "repro_torch.kernels.rmq_scan.ops",
    "repro_torch.streaming.updates",
    "repro_torch.streaming.structure",
    "repro_torch.kernels.hierarchy_update.ops",
    "repro_torch.kernels.rmq_short.ops",
    "repro_torch.kernels.rmq_short.ref",
    "repro_torch.kernels.rmq_bulk.ops",
    "repro_torch.core.baselines",
    "repro_torch.core.hybrid",
    "repro_torch.qe.planner",
    "repro_torch.qe.cache",
    "repro_torch.qe.executors",
    "repro_torch.qe.engine",
    "repro_torch.obs.trace",
    "repro_torch.obs.metrics",
    "repro_torch.configs.base",
    "repro_torch.configs.llama3_2_3b",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.models.layers",
    "repro_torch.models.lm",
    "repro_torch.models.interop",
    "repro_torch.serve.eviction",
    "repro_torch.serve.engine",
    "repro_torch.launch.serve",
    "repro_torch.configs.mamba2_1_3b",
    "repro_torch.kernels.ssd_scan.ref",
    "repro_torch.kernels.ssd_scan.ops",
    "repro_torch.models.ssm",
    "repro_torch.train.tree",
    "repro_torch.train.loss",
    "repro_torch.train.optimizer",
    "repro_torch.train.train_step",
    "repro_torch.data.pipeline",
    "repro_torch.checkpoint.checkpoint",
    "repro_torch.launch.train",
]


def test_every_module_imports_without_nvcc_or_a_card():
    names = [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]
    for name in SLICE_MODULES:
        assert name in names
        path = ROOT / "src" / (name.replace(".", "/") + ".py")
        assert path in PORT_FILES  # under the import guard above
    for name in names:
        importlib.import_module(name)


def test_every_cuda_source_is_built():
    sources = {p.stem for p in (ROOT / "src/repro_torch/csrc").glob("*.cu")}
    assert sources == set(_build.SOURCES)
    assert len(_build.SOURCES) == 9
    assert {"hierarchy_update", "rmq_short", "rmq_bulk",
            "flash_attention", "ssd_scan"} <= sources


def test_build_defaults_to_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with count_launches() as counts:
        for backend in ("auto", "fused", "cuda", "eager"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                RMQ.build(torch.arange(5000.0), backend=backend)
    assert counts == {}


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["rmq_scan"])


def test_a_kernel_wrapper_refuses_cpu_operands():
    """The CUDA entry points never take the plain path themselves."""
    from repro_torch.core import build_hierarchy, make_plan

    h = build_hierarchy(torch.rand(5000), make_plan(5000, c=8, t=4), True)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_ops.fused_build_cuda(h.base, h.plan, True)


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

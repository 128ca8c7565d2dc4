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
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


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
    "repro_torch.configs.qwen2_moe_a2_7b",
    "repro_torch.configs.internvl2_2b",
    "repro_torch.configs.minicpm3_4b",
    "repro_torch.models.moe",
    "repro_torch.models.frontends",
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
    "repro_torch.tune.cache",
    "repro_torch.tune.measure",
    "repro_torch.tune.search",
    "repro_torch.qe.service",
    "repro_torch.qe.distributed",
    "repro_torch.core.distributed",
    "repro_torch.launch.mesh",
    "repro_torch.serving.snapshot",
    "repro_torch.serving.tier",
    "repro_torch.serving.aio",
    "repro_torch.serving.metrics",
    "repro_torch.distributed.fault_tolerance",
    "repro_torch.distributed.compression",
    "repro_torch.distributed.shardings",
    "repro_torch.distributed.sharded",
    "repro_torch.launch.cells",
    "repro_torch.launch.dryrun",
    "repro_torch.tune.roofline",
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


def test_examples_are_guarded():
    names = {p.name for p in PORT_FILES}
    for ex in ("torch_quickstart.py", "torch_streaming.py",
               "torch_chaining.py", "torch_train_lm.py",
               "torch_query_engine.py", "torch_serving_async.py",
               "torch_serve_lm.py", "torch_distributed_rmq.py"):
        assert ex in names


# names of the reference's packages that the port leaves to later items
NOT_YET = {}


@pytest.mark.parametrize("pkg", ["core", "obs", "configs", "tune", "qe",
                                 "serving", "distributed"])
def test_the_reference_public_names_exist(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = set(ref.__all__) - set(port.__all__) - NOT_YET.get(
        f"repro.{pkg}", set())
    assert not missing
    for name in set(port.__all__):
        assert hasattr(port, name), name


def test_rmq_config_defaults_are_the_reference():
    import dataclasses

    from repro.configs import RMQConfig as JRMQConfig
    from repro_torch.configs import RMQConfig

    assert dataclasses.asdict(RMQConfig()) == dataclasses.asdict(
        JRMQConfig())


def _record_sequence(mod):
    mod.record_launch("rmq_fused", levels=3, operand_bytes=100)
    mod.record_config("engine_tuned_config", backend="fused", c=128)
    mod.record_launch("rmq_scan", plane="value")
    mod.record_launch("rmq_fused", levels=3, operand_bytes=28)


def test_registry_as_dict_is_the_reference():
    from repro.kernels import profiling as jprof
    from repro_torch.kernels import profiling as prof

    with prof.launch_registry() as reg:
        _record_sequence(prof)
    with jprof.launch_registry() as jreg:
        _record_sequence(jprof)
    assert reg.as_dict() == jreg.as_dict()
    assert set(reg.as_dict()) == {"counts", "launches", "configs"}
    assert reg.as_dict()["counts"] == {"rmq_fused": 2, "rmq_scan": 1}
    assert reg.records[0].as_dict() == jreg.records[0].as_dict() == {
        "name": "rmq_fused", "levels": 3, "operand_bytes": 100}
    assert prof.LaunchRegistry().as_dict() == {"counts": {},
                                               "launches": []}


class _Compiled:
    """A stand-in for a compiled callable: ``cost_analysis()`` as older
    JAX returns it (a one-element list), with a non-scalar entry."""

    def cost_analysis(self):
        return [{"flops": 1024, "bytes accessed": 96.0,
                 "utilization operand 0 {}": "n/a"}]


def test_attach_cost_takes_the_three_sources():
    import torch.utils.flop_counter as fc

    from repro.kernels import profiling as jprof
    from repro_torch.kernels import profiling as prof

    reg, jreg = prof.LaunchRegistry(), jprof.LaunchRegistry()
    assert reg.attach_cost("compiled", _Compiled()) == jreg.attach_cost(
        "compiled", _Compiled()) == {"flops": 1024.0,
                                     "bytes accessed": 96.0}
    assert reg.as_dict() == jreg.as_dict()
    assert reg.as_dict()["cost_estimates"] == {
        "compiled": {"flops": 1024.0, "bytes accessed": 96.0}}
    # a mapping of scalars
    assert reg.attach_cost("mapping", {"flops": 7, "note": "x"}) == {
        "flops": 7.0}
    # a finished FlopCounterMode over one plain matmul: 2 * m * k * n
    a, b = torch.rand(8, 16), torch.rand(16, 4)
    with fc.FlopCounterMode(display=False) as counter:
        torch.matmul(a, b)
    assert reg.attach_cost("matmul", counter) == {"flops": 2.0 * 8 * 16 * 4}
    d = reg.as_dict()
    assert set(d) == {"counts", "launches", "cost_estimates"}
    assert set(d["cost_estimates"]) == {"compiled", "mapping", "matmul"}
    with pytest.raises(TypeError, match="cost_analysis"):
        reg.attach_cost("bad", 3.0)


def test_registry_timings_shape_is_the_reference():
    from repro_torch.kernels import profiling as prof

    with prof.launch_registry(timing=True) as reg:
        for _ in range(3):
            prof.timed_dispatch("site", lambda: None)
    t = reg.as_dict()["timings_s"]["site"]
    assert set(t) == {"calls", "total", "mean", "max"}
    assert t["calls"] == 3 and t["max"] <= t["total"]


def test_current_registry_inside_and_outside():
    from repro_torch.kernels.profiling import (
        current_registry,
        launch_registry,
    )
    from repro_torch.obs import launch_registry as obs_launch_registry

    assert current_registry() is None
    with launch_registry() as reg:
        assert current_registry() is reg
        with obs_launch_registry() as inner:
            assert current_registry() is inner
        assert current_registry() is reg
    assert current_registry() is None


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

"""The port's sharding rules against the JAX package's, on the CPU.

``repro_torch.distributed.shardings`` and ``make_production_mesh`` held
to ``repro.distributed.shardings`` and ``repro.launch.mesh``: every spec
equal.  The reference's specs come from one subprocess with 512 fake CPU
devices (``--xla_force_host_platform_device_count=512``, as its dry run
uses), so the flag never reaches this process: parameter trees for every
architecture at smoke and full width (``jax.eval_shape`` of
``init_params``; the port's on the meta device), both layouts, the
meshes (2, 4), (8, 1), (1, 8), (16, 16) and (2, 16, 16); the train
state's specs; batches that the data axes divide and do not; each
family's decode cache; and ``make_sharder``'s specs and its skip rule as
eager ``with_sharding_constraint`` reports them on the 8-device mesh.

The port keeps its layers as a list, so each per-layer leaf is compared
with the reference's stacked leaf under the path without the layer
index, for every layer.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks at the top; JAX stays on the CPU)
import pytest
import torch

from repro_torch.configs import (
    ARCH_IDS,
    TrainConfig,
    get_config,
    get_smoke_config,
)
from repro_torch.distributed import sharded
from repro_torch.distributed import shardings as S
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.train.train_step import init_train_state
from repro_torch.train.tree import leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(2, 4), (8, 1), (1, 8), (16, 16), (2, 16, 16)]
STATE_MESHES = [(2, 4), (2, 16, 16)]
LAYOUTS = ("tp_sp", "fsdp")
SIZES = {"smoke": get_smoke_config, "full": get_config}
BATCH_ROWS = (8, 3)        # 8 divides the data axes of (2, 4), 3 none
SHARDER_SHAPES = [(8, 16, 32), (3, 16, 32), (8, 6, 32), (8, 16, 30),
                  (8, 32), (3, 32)]
SHARDER_NAMES = ["act_embed", "act_resid", "logits", "moe_dispatch",
                 "moe_expert_in", "loss_head_w", "unknown"]


def _axes(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")


def _mesh(shape) -> Mesh:
    return Mesh(_axes(shape), tuple(shape), torch.device("meta"))


def _key(*parts) -> str:
    return "|".join("x".join(map(str, p)) if isinstance(p, tuple) else str(p)
                    for p in parts)


_REF_PROG = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import ARCH_IDS, get_config, get_smoke_config
from repro.configs.base import TrainConfig
from repro.distributed import shardings as S
from repro.launch.mesh import make_production_mesh
from repro.models import lm
from repro.train.train_step import init_train_state

spec = json.loads(open(sys.argv[1]).read())
devs = np.array(jax.devices())

def mesh_of(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return Mesh(devs[:int(np.prod(shape))].reshape(shape), axes)

def enc(s):
    return [e if e is None or isinstance(e, str) else list(e) for e in s]

def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {S._path_str(p): enc(sh.spec) for p, sh in leaves}

def key(*parts):
    return "|".join("x".join(map(str, p)) if isinstance(p, list) else str(p)
                    for p in parts)

out = {"params": {}, "state": {}, "batch": {}, "cache": {}, "sharder": {}}
meshes = {tuple(m): mesh_of(tuple(m)) for m in spec["meshes"]}
for arch in ARCH_IDS:
    for size, get in (("smoke", get_smoke_config), ("full", get_config)):
        cfg = get(arch)
        k0 = jax.random.PRNGKey(0)
        params = jax.eval_shape(lambda: lm.init_params(cfg, k0))
        state = jax.eval_shape(lambda: init_train_state(cfg, TrainConfig(),
                                                        k0))
        cache = jax.eval_shape(lambda: lm.make_decode_cache(cfg, 8, 64))
        for m in spec["meshes"]:
            mesh = meshes[tuple(m)]
            out["cache"][key(arch, size, m)] = flat(
                S.cache_shardings(mesh, cache))
            for layout in ("tp_sp", "fsdp"):
                out["params"][key(arch, size, m, layout)] = flat(
                    S.param_shardings(mesh, params, layout))
                if m in spec["state_meshes"]:
                    sh = S.train_state_shardings(mesh, state, layout)
                    out["state"][key(arch, size, m, layout)] = {
                        "m": flat(sh.opt.m), "v": flat(sh.opt.v),
                        "params": flat(sh.params),
                        "count": enc(sh.opt.count.spec),
                        "step": enc(sh.step.spec)}
for m in spec["meshes"]:
    for rows in spec["rows"]:
        batch = {"tokens": jax.ShapeDtypeStruct((rows, 16), jnp.int32),
                 "prefix": jax.ShapeDtypeStruct((rows, 4, 32), jnp.float32)}
        for layout in ("tp_sp", "fsdp"):
            out["batch"][key(m, rows, layout)] = flat(
                S.batch_shardings(meshes[tuple(m)], batch, layout))
mesh = meshes[(2, 4)]
for layout in ("tp_sp", "fsdp"):
    for seq in (False, True):
        sh = S.make_sharder(mesh, sequence_sharding=seq, layout=layout)
        for name in spec["names"]:
            for shape in spec["shapes"]:
                x = jnp.zeros(shape, jnp.float32)
                y = sh(x, name)
                out["sharder"][key(layout, seq, name, shape)] = (
                    None if y is x else enc(y.sharding.spec))
single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
out["production"] = {
    "single": [list(single.axis_names), list(single.devices.shape)],
    "multi": [list(multi.axis_names), list(multi.devices.shape)]}
json.dump(out, open(sys.argv[2], "w"))
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reference spec, from one subprocess with 512 fake devices."""
    tmp = tmp_path_factory.mktemp("shardings")
    (tmp / "spec.json").write_text(json.dumps({
        "meshes": [list(m) for m in MESHES],
        "state_meshes": [list(m) for m in STATE_MESHES],
        "rows": list(BATCH_ROWS), "names": SHARDER_NAMES,
        "shapes": [list(s) for s in SHARDER_SHAPES]}))
    res = subprocess.run(
        [sys.executable, "-c", _REF_PROG, str(tmp / "spec.json"),
         str(tmp / "out.json")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=512"})
    assert "REFERENCE_OK" in res.stdout, res.stdout + res.stderr
    return json.loads((tmp / "out.json").read_text())


def _enc(spec):
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


def _by_reference_path(tree, specs):
    """``{reference path: [spec of each port leaf under it]}``."""
    out = {}
    for (path, _), (_, spec) in zip(leaves_with_path(tree),
                                    leaves_with_path(specs)):
        if path[0] == "layers":
            path = (path[0],) + tuple(path[2:])
        out.setdefault("/".join(map(str, path)), []).append(_enc(spec))
    return out


def _same_specs(tree, specs, want, what):
    got = _by_reference_path(tree, specs)
    assert got.keys() == want.keys(), what
    for path, per_leaf in got.items():
        assert all(s == want[path] for s in per_leaf), (what, path,
                                                        per_leaf[0],
                                                        want[path])


@pytest.fixture(scope="module")
def trees():
    """The port's train states on the meta device, by (arch, size)."""
    return {(arch, size): init_train_state(get(arch), TrainConfig(),
                                           device="meta")
            for arch in ARCH_IDS for size, get in SIZES.items()}


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match(reference, trees, arch, size):
    params = trees[arch, size].params
    for shape in MESHES:
        for layout in LAYOUTS:
            specs = S.param_shardings(_mesh(shape), params, layout)
            _same_specs(params, specs,
                        reference["params"][_key(arch, size, shape, layout)],
                        (arch, size, shape, layout))


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_shardings_match(reference, trees, arch, size):
    state = trees[arch, size]
    for shape in STATE_MESHES:
        for layout in LAYOUTS:
            want = reference["state"][_key(arch, size, shape, layout)]
            sh = S.train_state_shardings(_mesh(shape), state, layout)
            what = (arch, size, shape, layout)
            _same_specs(state.params, sh.params, want["params"], what)
            _same_specs(state.opt.m, sh.opt.m, want["m"], what)
            _same_specs(state.opt.v, sh.opt.v, want["v"], what)
            assert _enc(sh.opt.count) == want["count"] == []
            assert _enc(sh.step) == want["step"] == []


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: _key(s))
def test_batch_shardings_match(reference, shape):
    for rows in BATCH_ROWS:
        batch = {"tokens": torch.empty((rows, 16), dtype=torch.int32,
                                       device="meta"),
                 "prefix": torch.empty((rows, 4, 32), device="meta")}
        for layout in LAYOUTS:
            got = S.batch_shardings(_mesh(shape), batch, layout)
            assert {k: _enc(v) for k, v in got.items()} == reference[
                "batch"][_key(shape, rows, layout)], (shape, rows, layout)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_match(reference, arch):
    for size, get in SIZES.items():
        cache = lm.make_decode_cache(get(arch), 8, 64, device="meta")
        for shape in MESHES:
            got = S.cache_shardings(_mesh(shape), cache)
            assert {k: _enc(v) for k, v in got.items()} == reference[
                "cache"][_key(arch, size, shape)], (arch, size, shape)


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_make_sharder_matches(reference, layout, seq):
    """The spec each activation would be pinned to, or the reference's
    skip (a name it does not know, an entry that does not divide)."""
    mesh = _mesh((2, 4))
    sh = S.make_sharder(mesh, sequence_sharding=seq, layout=layout)
    assert sh.mesh is mesh
    skipped = 0
    for name in SHARDER_NAMES:
        for shape in SHARDER_SHAPES:
            want = reference["sharder"][_key(layout, seq, name, shape)]
            got = sh.spec_for(shape, name)
            assert (None if got is None else _enc(got)) == want, (
                layout, seq, name, shape)
            skipped += want is None
            x = torch.zeros(shape)
            assert sh(x, name) is x
    assert skipped > len(SHARDER_SHAPES)   # the unknown name and more


def test_production_mesh_matches(reference):
    for key, mesh in (("single", make_production_mesh()),
                      ("multi", make_production_mesh(multi_pod=True))):
        assert [list(mesh.axis_names), list(mesh.axis_sizes)] == reference[
            "production"][key]
        assert mesh.device.type == "meta" and mesh.group is None
    four = make_production_mesh(multi_pod=True, num_pods=4)
    assert four.shape == {"pod": 4, "data": 16, "model": 16}
    assert four.size == 1024


def test_partition_spec_normalizes_as_jax_does():
    P = S.PartitionSpec
    assert tuple(P("model", ("data",))) == ("model", "data")
    assert tuple(P((), "model")) == (None, "model")
    assert tuple(P(("pod", "data"), None)) == (("pod", "data"), None)
    tree = {"a": P("data"), "b": [P(), P(None, "model")]}
    assert [s for _, s in leaves_with_path(tree)] == [
        P("data"), P(), P(None, "model")]


def test_a_spec_that_shards_the_layer_axis_cannot_be_stored(trees):
    """hymba-1.5b's per-layer SSM vectors are (32 layers, 25 heads): under
    ``fsdp`` the layer axis is the largest, and the reference shards it."""
    params = trees["hymba-1.5b", "full"].params
    specs = S.param_shardings(_mesh((2, 4)), params, "fsdp")
    sharded_layer = [(path, leaf, spec) for (path, leaf), (_, spec) in zip(
        leaves_with_path(params), leaves_with_path(specs))
        if path[0] == "layers" and spec[0] is not None]
    assert sharded_layer
    path, leaf, spec = sharded_layer[0]
    with pytest.raises(ValueError, match="stacked layer axis"):
        sharded.leaf_spec(spec, leaf)
    tp = S.param_shardings(_mesh((2, 4)), params, "tp_sp")
    for (path, leaf), (_, spec) in zip(leaves_with_path(params),
                                       leaves_with_path(tp)):
        assert len(sharded.leaf_spec(spec, leaf)) <= leaf.dim()


def test_unknown_layout_raises(trees):
    with pytest.raises(ValueError, match="layout"):
        S.param_shardings(_mesh((2, 4)), trees["qwen1.5-0.5b",
                                               "smoke"].params, "zero")

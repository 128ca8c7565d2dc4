"""The port's dry run (``repro_torch.launch.cells`` / ``dryrun``) against
the JAX package's, on the CPU.

* The grid: the 40 cells, the 8 skips and their reasons, and
  ``best_config`` of every cell at 256 and 512 chips, equal to the
  reference's.
* ``run_cell``'s counting on smoke configs over a (2, 4) meta mesh, as
  the reference's subprocess test builds its cells: argument bytes equal
  to the bytes of the blocks the specs give, collectives recorded for a
  train step, and llama3.2-3b's prefill and decode FLOPs equal to the
  dot FLOPs of the reference's jaxpr of the same cell (the rank's rows
  and cache blocks, whole weights), counted here; the control (one layer
  fewer) misses.
* ``calibrate_cell`` (2 and 4 layers, extrapolated) equal to the
  full-depth count, which the port counts layer by layer.
* One full-width record through the CLI (qwen1.5-0.5b ``train_4k`` on the
  single-pod mesh) with the reference's keys, and one skipped cell.
"""

import dataclasses
import json
import math

import jax
import jax.extend
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import ARCH_IDS as REF_ARCH_IDS
from repro.launch import cells as ref_cells
from repro.models import lm as ref_lm
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.distributed import sharded
from repro_torch.distributed.shardings import entry_axes
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.train.tree import leaves_with_path

MESH = Mesh(("data", "model"), (2, 4), torch.device("meta"))
SEQ, BATCH = 64, 8


def _count(fn, args, mesh=MESH):
    with sharded.simulate(mesh) as coll:
        out = cells.trace(fn, args)
    out["collective_bytes"] = dict(coll)
    return out


def test_shape_grid_is_the_reference_grid():
    assert ARCH_IDS == REF_ARCH_IDS
    assert cells.SHAPES == ref_cells.SHAPES
    assert cells.LONG_CONTEXT_ARCHS == ref_cells.LONG_CONTEXT_ARCHS
    grid = list(cells.all_cells())
    assert grid == list(ref_cells.all_cells()) and len(grid) == 40
    skips = [c for c in grid if cells.cell_is_skipped(*c)]
    assert len(skips) == 8 and all(s == "long_500k" for _, s in skips)
    for c in grid:
        assert cells.cell_is_skipped(*c) == ref_cells.cell_is_skipped(*c)


@pytest.mark.parametrize("chips", [256, 512])
def test_best_config_matches_the_reference(chips):
    for arch, shape in cells.all_cells():
        for s in (shape, None):
            assert cells.best_config(arch, s, chips) == \
                ref_cells.best_config(arch, s, chips), (arch, s)


def _block_bytes(tree, specs, mesh) -> int:
    """The bytes of each leaf's block, its dimensions divided by its
    spec's entries (computed here, not by the port's blocks)."""
    total = 0
    for (_, leaf), (_, spec) in zip(leaves_with_path(tree),
                                    leaves_with_path(specs)):
        shape = list(leaf.shape)
        for d, e in enumerate(sharded.leaf_spec(spec, leaf)):
            shape[d] //= math.prod(mesh.shape[a] for a in entry_axes(e))
        total += math.prod(shape) * leaf.element_size()
    return total


def test_train_cell_counts_its_blocks_and_collectives():
    from repro_torch.distributed.shardings import train_state_shardings
    from repro_torch.train.train_step import init_train_state

    cfg = get_smoke_config("llama3.2-3b")
    tc = cells.default_train_config(cfg, SEQ, BATCH, "full")
    fn, args, _ = cells.train_cell(cfg, MESH, SEQ, BATCH, tc=tc)
    got = _count(fn, args)
    whole = init_train_state(cfg, tc, device="meta")
    want = _block_bytes(whole, train_state_shardings(MESH, whole), MESH)
    want += (BATCH // 2) * SEQ * 4          # the rank's rows, int32
    assert got["argument_bytes"] == want
    assert got["flops"] > 0 and got["temp_bytes"] > 0
    assert got["collective_bytes"]["all-gather"] > 0
    assert got["collective_bytes"]["all-reduce"] > 0
    assert got["kernels"] == {"flash_attention": 2 * cfg.num_layers}


def _dot_flops(jaxpr) -> int:
    """2 x the multiply-adds of every ``dot_general`` of a jaxpr, through
    its sub-jaxprs (a scan's body times its length)."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += 2 * math.prod(eqn.outvars[0].aval.shape) * math.prod(
                lhs[i] for i in lc)
        times = eqn.params.get("length", 1) if eqn.primitive.name == \
            "scan" else 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if isinstance(inner, jax.extend.core.Jaxpr):
                    total += times * _dot_flops(inner)
    return total


def _reference_flops(kind: str, layers: int) -> int:
    cfg = dataclasses.replace(ref_smoke_config("llama3.2-3b"),
                              num_layers=layers)
    params = jax.eval_shape(lambda: ref_lm.init_params(
        cfg, jax.random.PRNGKey(0)))
    rows = BATCH // 2                      # the data axis's 2 blocks
    if kind == "prefill":
        tokens = jax.ShapeDtypeStruct((rows, SEQ), jnp.int32)
        jaxpr = jax.make_jaxpr(lambda p, t: ref_lm.prefill(
            cfg, p, t, cache_len=SEQ, cache_dtype=jnp.bfloat16))(params,
                                                                tokens)
    else:
        cache = jax.eval_shape(lambda: ref_lm.make_decode_cache(
            cfg, rows, SEQ // 4, jnp.bfloat16))   # sequence over model
        token = jax.ShapeDtypeStruct((rows,), jnp.int32)
        jaxpr = jax.make_jaxpr(lambda p, t, c: ref_lm.decode_step(
            cfg, p, t, c, SEQ // 4 - 1))(params, token, cache)
    return _dot_flops(jaxpr.jaxpr)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_cell_flops_equal_the_reference_jaxpr(kind):
    cfg = get_smoke_config("llama3.2-3b")
    build = cells.prefill_cell if kind == "prefill" else cells.decode_cell
    got = _count(*build(cfg, MESH, SEQ, BATCH))
    want = _reference_flops(kind, cfg.num_layers)
    fewer = _reference_flops(kind, cfg.num_layers - 1)
    print(f"{kind}: port {got['flops']}, reference {want}, one layer "
          f"fewer {fewer}")
    assert got["flops"] == want
    assert got["flops"] != fewer
    assert got["collective_bytes"] == {}   # the port serves unsharded
    params = sum(t.numel() * t.element_size()
                 for _, t in leaves_with_path(build(cfg, MESH, SEQ,
                                                    BATCH)[1][0]))
    assert got["argument_bytes"] > params  # whole weights, and the rows


def test_calibration_reproduces_the_full_depth_count():
    mesh = make_production_mesh()
    full = cells.run_cell("qwen1.5-0.5b", "decode_32k", mesh, "single")
    cal = cells.calibrate_cell("qwen1.5-0.5b", "decode_32k", mesh, "single")
    assert cal["num_layers"] == 24 and cal["per_layer_flops"] > 0
    assert cal["flops_per_device"] == full.flops_per_device
    assert cal["bytes_per_device"] == full.bytes_per_device
    assert full.scan_length == 24 and full.num_while_loops == 0


def test_cli_records_a_full_width_cell_and_a_skip(tmp_path, capsys):
    out = tmp_path / "cells.jsonl"
    for shape in ("train_4k", "long_500k"):
        assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", shape,
                            "--mesh", "single", "--out", str(out)]) == 0
    rec, skip = [json.loads(line) for line in out.read_text().splitlines()]
    keys = {f.name for f in dataclasses.fields(ref_cells.CellResult)}
    assert set(rec) == keys | {"ok"}
    assert rec["ok"] and rec["skipped"] is None
    assert rec["mesh_desc"] == "single" and rec["scan_length"] == 24
    assert rec["flops_per_device"] > 0 and rec["argument_bytes"] > 0
    assert set(rec["collective_bytes"]) == {"all-gather", "all-reduce"}
    assert skip == {"arch": "qwen1.5-0.5b", "shape": "long_500k",
                    "mesh_desc": "single", "ok": True,
                    "skipped": ref_cells.cell_is_skipped("qwen1.5-0.5b",
                                                         "long_500k")}
    assert "[SKIP]" in capsys.readouterr().out

"""Model-parallel training on two gloo ranks against one process and the
JAX package's sharded step, on the CPU.

``launch/train.py --model-parallel`` over a ``torch.distributed`` group
of two ranks (two processes, a ``FileStore``): the meshes (1, 2) and
(2, 1) for qwen1.5-0.5b, mamba2-1.3b, minicpm3-4b and internvl2-2b (with
its prefix), and (1, 2) for qwen2-moe-a2.7b, all at smoke size, three
steps of 4 x 32 tokens from the CLI's defaults; and qwen1.5-0.5b at
(2, 1) with ``--microbatches 2``, where each rank takes its rows of each
micro-batch.  Every run starts from
the reference's initial parameters (``repro.models.lm.init_params``,
carried across by ``repro_torch.models.interop`` into a step-0
checkpoint that restore-or-init picks up).  Each step's loss and grad
norm are held to the one-process port run and to the reference's own
sharded step (``repro.launch.train.build_objects`` on a mesh of 2 fake
CPU devices, in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=2``), and the
parameters after three steps to both.

Tolerances, as ``tests/test_torch_train.py`` states them: 1e-5 relative
on losses and grad norms (``LOSS_RTOL``: float32 sums in other orders),
1e-4 absolute and relative on parameters (``PARAM_TOL``).  Also: each rank's blocks have the shapes its specs give, the
collectives counted; a control whose ranks skip the data-axis reduction
fails the gate; MoE at (2, 1) raises, naming A10c; the restart drill on
two ranks with the reference drill's arguments ends on the uninterrupted
run's loss; a checkpoint written at (1, 2) restores at (2, 1) and in one
process.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.launch import train as train_cli
from repro_torch.models import interop
from repro_torch.train import optimizer
from repro_torch.train.train_step import TrainState, init_train_state
from repro_torch.train.tree import leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
SEED = 0
ARCHS = ["qwen1.5-0.5b", "mamba2-1.3b", "minicpm3-4b", "internvl2-2b",
         "qwen2-moe-a2.7b"]
CASES = [(arch, mesh, 1) for arch in ARCHS for mesh in ((1, 2), (2, 1))
         if not (arch == "qwen2-moe-a2.7b" and mesh == (2, 1))] + [
             ("qwen1.5-0.5b", (2, 1), 2)]
STEPS, SEQ, BATCH = 3, 32, 4
DRILL = ["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "10", "--seq-len",
         "32", "--global-batch", "4", "--checkpoint-every", "3",
         "--log-every", "5", "--device", "cpu", "--model-parallel", "2"]


def _case(arch, mesh, micro=1) -> str:
    return f"{arch}@{mesh[0]}x{mesh[1]}" + (f"/mb{micro}" if micro > 1
                                            else "")


def _args(arch, mesh, ckpt_dir, micro=1):
    """The CLI's arguments of a case: ``--model-parallel`` gives the
    mesh's model axis (two ranks: data = 2 // model)."""
    return ["--arch", arch, "--smoke", "--steps", str(STEPS), "--seq-len",
            str(SEQ), "--global-batch", str(BATCH), "--checkpoint-every",
            "0", "--log-every", "1", "--device", "cpu", "--seed", str(SEED),
            "--model-parallel", str(mesh[1]), "--microbatches", str(micro),
            "--checkpoint-dir", str(ckpt_dir)]


def _flat(params):
    return {"/".join(map(str, p)): t for p, t in leaves_with_path(params)}


# ---------------------------------------------------------------------------
# the reference's sharded steps, once a module, in one subprocess
# ---------------------------------------------------------------------------
_REF_PROG = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.configs.base import TrainConfig
from repro.data.pipeline import SyntheticTokenDataset
from repro.distributed.shardings import _path_str
from repro.launch.mesh import make_test_mesh
from repro.launch.train import build_objects
from repro.models import lm
from repro.train.optimizer import adamw_init
from repro.train.train_step import TrainState

spec = json.loads(open(sys.argv[1]).read())
out = {}
for case, (arch, mesh_shape, micro) in spec["cases"].items():
    cfg = get_smoke_config(arch)
    tc = TrainConfig(total_steps=spec["steps"], warmup_steps=1,
                     seq_len=spec["seq"], global_batch=spec["batch"],
                     microbatches=micro, seed=spec["seed"])
    mesh = make_test_mesh(tuple(mesh_shape), ("data", "model"))
    _, step, state_sh = build_objects(cfg, tc, mesh)
    init = np.load(spec["init"][arch])
    struct = jax.eval_shape(lambda: lm.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(init[_path_str(p)]), struct)
    state = TrainState(params=params, opt=adamw_init(
        params, tc.optimizer_state_dtype), step=jnp.zeros((), jnp.int32))
    state = jax.device_put(state, state_sh)
    data = SyntheticTokenDataset(
        vocab_size=cfg.vocab_size, seq_len=tc.seq_len,
        global_batch=tc.global_batch, seed=tc.seed,
        prefix_tokens=cfg.frontend_tokens if cfg.frontend else 0,
        d_model=cfg.d_model)
    losses, gnorms = [], []
    with mesh:
        for i in range(tc.total_steps):
            batch = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    out[case + "/loss"] = np.array(losses)
    out[case + "/gnorm"] = np.array(gnorms)
    for p, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        out[case + "/p/" + _path_str(p)] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
print("REFERENCE_OK")
"""


# ---------------------------------------------------------------------------
# two gloo ranks: every sharded case, the control, the refusal, the drill
# ---------------------------------------------------------------------------
_RANK_PROG = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(2)
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.distributed import sharded
from repro_torch.distributed.shardings import entry_axes, train_state_shardings
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.train.train_step import init_train_state
from repro_torch.train.tree import leaves_with_path

rank, store, spec = int(sys.argv[1]), sys.argv[2], json.loads(
    open(sys.argv[3]).read())
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
group = dist.group.WORLD
res, meta = {}, {}

def flat(tree):
    return {"/".join(map(str, p)): t for p, t in leaves_with_path(tree)}

def whole(out):
    return sharded.gather(out["state"], out["specs"], out["mesh"])

def expected_collectives(out, steps, micro):
    # a step: one all_gather an axis of size > 1 in each parameter's spec,
    # and a micro-batch one all_reduce a parameter and one for (loss, aux)
    # an axis of size > 1 of the batch; then the checkpoint writer's drain
    # barrier
    mesh, specs = out["mesh"], out["specs"]
    gathers = sum(mesh.shape[a] > 1
                  for (p, leaf), (_, s) in zip(
                      leaves_with_path(out["state"].params),
                      leaves_with_path(specs.params))
                  for e in sharded.leaf_spec(s, leaf)
                  for a in entry_axes(e))
    n = sum(1 for _ in leaves_with_path(specs.params))
    reduced = sum(mesh.shape[a] > 1 for a in ("data",))
    return steps * (gathers + micro * reduced * (n + 1)) + 1

def blocks_ok(out):
    mesh, ok, cut = out["mesh"], True, 0
    full = whole(out)
    for (p, blk), (_, w), (_, s) in zip(leaves_with_path(out["state"]),
                                       leaves_with_path(full),
                                       leaves_with_path(out["specs"])):
        want = list(w.shape)
        for d, e in enumerate(sharded.leaf_spec(s, w)):
            k = 1
            for a in entry_axes(e):
                k *= mesh.shape[a]
            want[d] //= k
        ok &= list(blk.shape) == want
        cut += list(blk.shape) != list(w.shape)
    return bool(ok), cut

for case, (arch, mesh_shape, micro, args) in spec["cases"].items():
    before = sharded.COLLECTIVES.launches
    out = T.run(T.parse_args(args), group=group)
    meta[case] = {"coll": sharded.COLLECTIVES.launches - before,
                  "want_coll": expected_collectives(out, len(out["steps"]),
                                                    micro),
                  "blocks": blocks_ok(out),
                  "shape": list(out["mesh"].axis_sizes),
                  "coords": out["mesh"].coords}
    res[case + "/loss"] = np.array([s["loss"] for s in out["steps"]])
    res[case + "/gnorm"] = np.array([s["grad_norm"] for s in out["steps"]])
    for k, v in flat(whole(out).params).items():
        res[case + "/p/" + k] = v.numpy()

# the control: every rank skips the data-axis reduction
orig = sharded.reduce_grads
sharded.reduce_grads = lambda grads, loss, aux, mesh, axes: (grads, loss,
                                                             aux)
try:
    out = T.run(T.parse_args(spec["control"]), group=group)
finally:
    sharded.reduce_grads = orig
res["control/loss"] = np.array([s["loss"] for s in out["steps"]])
res["control/gnorm"] = np.array([s["grad_norm"] for s in out["steps"]])

try:
    T.run(T.parse_args(spec["moe"]), group=group)
    meta["moe"] = "trained"
except NotImplementedError as e:
    meta["moe"] = str(e)

plain = T.run(T.parse_args(spec["drill_plain"]), group=group)
drill = T.run(T.parse_args(spec["drill"]), group=group)
meta["drill"] = {"restarts": drill["restarts"],
                 "losses": [s["loss"] for s in drill["steps"]],
                 "plain": [s["loss"] for s in plain["steps"]]}
final = flat(whole(drill))

# elastic: the (1, 2) drill's last checkpoint restored on a (2, 1) mesh
cfg = get_smoke_config("qwen1.5-0.5b")
tc = TrainConfig(seed=0)
mesh = make_test_mesh((2, 1), ("data", "model"), device="cpu", group=group)
state = init_train_state(cfg, tc, device="cpu")
specs = train_state_shardings(mesh, state)
like = sharded.local_blocks(state, specs, mesh)
back = restore_checkpoint(spec["drill_dir"], 10, like, specs=specs,
                          mesh=mesh)
again = flat(sharded.gather(back, specs, mesh))
meta["elastic"] = {
    "same": all(final[k].dtype == again[k].dtype and torch.equal(
        final[k].reshape(-1).view(torch.uint8),
        again[k].reshape(-1).view(torch.uint8)) for k in final),
    "keys": sorted(final) == sorted(again),
    "cut": sum(list(b.shape) != list(w.shape) for (_, b), (_, w) in
               zip(leaves_with_path(back), leaves_with_path(state)))}
for k, v in final.items():
    res["final/" + k] = (v.view(torch.int16) if v.dtype == torch.bfloat16
                         else v).numpy()
np.savez(sys.argv[4], **res)
json.dump(meta, open(sys.argv[5], "w"))
dist.destroy_process_group()
print("RANK_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything, once a module: the reference subprocess and the two
    ranks start together; the one-process runs go meanwhile here."""
    tmp = tmp_path_factory.mktemp("sharded")
    init_npz, init_dirs = {}, {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        rp = jax.tree.map(np.asarray, ref_lm.init_params(
            ref_smoke_config(arch), jax.random.PRNGKey(SEED)))
        flat = {"/".join(k.key for k in p): v
                for p, v in jax.tree_util.tree_leaves_with_path(rp)}
        init_npz[arch] = str(tmp / f"{arch}.npz")
        np.savez(init_npz[arch], **flat)
        params = interop.params_from_reference(rp, device="cpu")
        tc = TrainConfig()
        state = TrainState(params=params, opt=optimizer.adamw_init(
            params, tc.optimizer_state_dtype), step=torch.zeros(
                (), dtype=torch.int32))
        init_dirs[arch] = tmp / "init" / arch
        save_checkpoint(str(init_dirs[arch]), 0, state)
        assert state.step.item() == 0 and cfg.name
    ref_spec = {"cases": {_case(a, m, k): [a, list(m), k]
                          for a, m, k in CASES},
                "steps": STEPS, "seq": SEQ, "batch": BATCH, "seed": SEED,
                "init": init_npz}
    (tmp / "ref.json").write_text(json.dumps(ref_spec))
    rank_spec = {
        "cases": {_case(a, m, k): [a, list(m), k,
                                   _args(a, m, init_dirs[a], k)]
                  for a, m, k in CASES},
        "control": _args("qwen1.5-0.5b", (2, 1), init_dirs["qwen1.5-0.5b"]),
        "moe": _args("qwen2-moe-a2.7b", (2, 1),
                     init_dirs["qwen2-moe-a2.7b"]),
        "drill_plain": DRILL + ["--checkpoint-dir", str(tmp / "plain")],
        "drill": DRILL + ["--checkpoint-dir", str(tmp / "drill"),
                          "--inject-failure-at", "6"],
        "drill_dir": str(tmp / "drill")}
    (tmp / "ranks.json").write_text(json.dumps(rank_spec))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_PROG, str(tmp / "ref.json"),
         str(tmp / "ref.npz")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**env, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROG, str(r), str(tmp / "store"),
         str(tmp / "ranks.json"), str(tmp / f"rank{r}.npz"),
         str(tmp / f"rank{r}.json")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in (0, 1)]
    try:
        one = {}
        for arch, micro in sorted({(a, k) for a, _, k in CASES}):
            out = train_cli.run(train_cli.parse_args(
                _args(arch, (1, 1), init_dirs[arch], micro)))
            one[arch, micro] = {"loss": [s["loss"] for s in out["steps"]],
                         "gnorm": [s["grad_norm"] for s in out["steps"]],
                         "params": {k: v.numpy() for k, v in
                                    _flat(out["state"].params).items()}}
        logs = [p.communicate(timeout=600)[0] for p in ranks]
        ref_log = ref.communicate(timeout=600)[0]
    finally:
        for p in ranks + [ref]:
            p.kill()
    assert all(p.returncode == 0 and "RANK_OK" in log
               for p, log in zip(ranks, logs)), "\n".join(logs)
    assert "REFERENCE_OK" in ref_log, ref_log
    return {"one": one, "ref": dict(np.load(tmp / "ref.npz")),
            "ranks": [dict(np.load(tmp / f"rank{r}.npz")) for r in (0, 1)],
            "meta": [json.loads((tmp / f"rank{r}.json").read_text())
                     for r in (0, 1)],
            "logs": logs, "tmp": tmp}


def _within(got, want, rtol=LOSS_RTOL) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return got.shape == want.shape and bool(
        np.all(np.abs(got - want) <= rtol * np.abs(want)))


def _ref_params(ref, case):
    """The reference's stacked parameters under the port's paths."""
    out = {}
    prefix = case + "/p/"
    for key, arr in ref.items():
        if not key.startswith(prefix):
            continue
        path = key[len(prefix):]
        if path.startswith("layers/"):
            steps = arr.shape[0]
            for i in range(steps):
                out[f"layers/{i}/" + path[len("layers/"):]] = arr[i]
        else:
            out[path] = arr
    return out


@pytest.mark.parametrize("arch,mesh,micro", CASES,
                         ids=[_case(*c) for c in CASES])
def test_sharded_steps_match_one_process(runs, arch, mesh, micro):
    case = _case(arch, mesh, micro)
    one = runs["one"][arch, micro]
    for rank in runs["ranks"]:
        assert _within(rank[case + "/loss"], one["loss"]), (
            rank[case + "/loss"], one["loss"])
        assert _within(rank[case + "/gnorm"], one["gnorm"]), (
            rank[case + "/gnorm"], one["gnorm"])
    got = runs["ranks"][0]
    for k, want in one["params"].items():
        np.testing.assert_allclose(got[case + "/p/" + k], want, **PARAM_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch,mesh,micro", CASES,
                         ids=[_case(*c) for c in CASES])
def test_sharded_steps_match_the_reference(runs, arch, mesh, micro):
    case = _case(arch, mesh, micro)
    ref, got = runs["ref"], runs["ranks"][0]
    assert _within(got[case + "/loss"], ref[case + "/loss"]), (
        got[case + "/loss"], ref[case + "/loss"])
    assert _within(got[case + "/gnorm"], ref[case + "/gnorm"]), (
        got[case + "/gnorm"], ref[case + "/gnorm"])
    want = _ref_params(ref, case)
    have = {k[len(case) + 3:]: v for k, v in got.items()
            if k.startswith(case + "/p/")}
    assert have.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(have[k], w, **PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("arch,mesh,micro", CASES,
                         ids=[_case(*c) for c in CASES])
def test_blocks_have_their_specs_shapes_and_collectives_count(runs, arch,
                                                              mesh, micro):
    case = _case(arch, mesh, micro)
    for r, meta in enumerate(runs["meta"]):
        m = meta[case]
        assert m["shape"] == list(mesh)
        assert m["coords"] == dict(zip(("data", "model"),
                                       divmod(r, mesh[1])))
        ok, cut = m["blocks"]
        assert ok and cut > 0, m
        assert m["coll"] == m["want_coll"], m


def test_control_without_the_data_reduction_fails_the_gate(runs):
    one = runs["one"]["qwen1.5-0.5b", 1]
    ctrl = runs["ranks"][0]
    assert not _within(ctrl["control/loss"], one["loss"])
    assert not _within(ctrl["control/gnorm"], one["gnorm"])
    # the same gate passes the real (2, 1) run
    assert _within(ctrl[_case("qwen1.5-0.5b", (2, 1)) + "/loss"],
                   one["loss"])


def test_moe_on_a_data_axis_raises_naming_a10c(runs):
    for meta in runs["meta"]:
        assert "A10c" in meta["moe"] and "qwen2-moe" in meta["moe"]


def test_restart_drill_on_two_ranks(runs):
    """The reference drill's arguments (10 steps, a checkpoint every 3,
    the failure before step 6) at (1, 2): the resumed run ends on the
    uninterrupted run's loss."""
    for meta in runs["meta"]:
        d = meta["drill"]
        assert d["restarts"] == 1 and len(d["plain"]) == 10
        assert d["losses"] == d["plain"][6:]
    rank0, rank1 = runs["logs"]
    assert "FAILURE" in rank0 and "restart 1" in rank0
    assert "restored checkpoint @ step 6" in rank0
    assert "restored checkpoint" not in rank1   # rank 0 logs


def test_elastic_restore_at_2x1_and_in_one_process(runs):
    """The (1, 2) drill's checkpoint at step 10: cut to (2, 1) blocks and
    gathered, and restored whole in one process, equal to the drill's
    final state as integer views; its manifest holds the specs."""
    for meta in runs["meta"]:
        e = meta["elastic"]
        assert e["keys"] and e["same"] and e["cut"] > 0, e
    tmp = runs["tmp"]
    cfg = get_smoke_config("qwen1.5-0.5b")
    like = init_train_state(cfg, TrainConfig(seed=1), device="cpu")
    back = restore_checkpoint(str(tmp / "drill"), 10, like)
    final = {k[len("final/"):]: v for k, v in runs["ranks"][0].items()
             if k.startswith("final/")}
    got = {"/".join(map(str, p)): t for p, t in leaves_with_path(back)}
    assert got.keys() == final.keys()
    for k, t in got.items():
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert np.array_equal(bits.numpy().reshape(-1).view(np.uint8),
                              final[k].reshape(-1).view(np.uint8)), k
    manifest = json.loads((tmp / "drill" / "step_00000010" /
                           "manifest.json").read_text())
    specs = {e["path"]: e["logical_sharding"] for e in manifest["leaves"]}
    assert specs["params/embed/w"] == ["model", "data"]
    assert specs["params/layers/0/attn/q/w"] == ["data", "model"]
    assert specs["opt/m/layers/1/mlp/down/w"] == ["model", "data"]
    assert specs["step"] == [] and specs["opt/count"] == []

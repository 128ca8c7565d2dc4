"""The port's training path against the reference, on the CPU.

Losses, AdamW, the schedule, the synthetic dataset, one whole train step
on ``mamba2-smoke`` from the reference's parameters, the step's
equivalences (microbatching, remat), checkpoints, the failure drill and
the CLI.  Inputs come from numpy seeds.

Tolerances (stated per check): 1e-5 relative on losses and the grad norm
(float32 on both sides, sums in other orders); 1e-4 absolute and relative
on parameters after a step (AdamW's first step moves each weight by about
the learning rate times the sign of its gradient, so a last-ulp gradient
difference near zero can move a weight by a few 1e-6); the dataset bit
for bit.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.data.pipeline import SyntheticTokenDataset as RefDataset
from repro.models import lm as ref_lm
from repro.train import loss as ref_loss
from repro.train import optimizer as ref_opt
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import build_train_step as ref_build_train_step
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.data import SyntheticTokenDataset
from repro_torch.launch import train as train_cli
from repro_torch.models import interop
from repro_torch.train import loss, optimizer
from repro_torch.train.train_step import (
    TrainState,
    build_train_step,
    init_train_state,
    make_remat,
)
from repro_torch.train.tree import leaves_with_path

ARCH = "mamba2-1.3b"
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ref_params():
    return ref_lm.init_params(ref_smoke_config(ARCH), jax.random.PRNGKey(0))


def _state(ref_params, tc):
    params = interop.params_from_reference(
        jax.tree.map(np.asarray, ref_params), device="cpu")
    return TrainState(params=params,
                      opt=optimizer.adamw_init(params,
                                               tc.optimizer_state_dtype),
                      step=torch.zeros((), dtype=torch.int32))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _flat(params):
    return {"/".join(map(str, path)): t for path, t in
            leaves_with_path(params)}


def _ref_flat(ref_tree, num_layers):
    """The reference's stacked tree under the port's path strings."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_tree):
        keys = [k.key for k in path]
        arr = np.asarray(leaf)
        if keys[0] == "layers":
            for i in range(num_layers):
                out["/".join(["layers", str(i)] + keys[1:])] = arr[i]
        else:
            out["/".join(keys)] = arr
    return out


def test_train_config_is_the_references():
    assert (dataclasses.asdict(TrainConfig())
            == dataclasses.asdict(RefTrainConfig()))


def test_losses_match():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 37, 96)).astype(np.float32) * 3
    toks = rng.integers(0, 96, (2, 37)).astype(np.int32)
    want = ref_loss.next_token_loss(jnp.asarray(logits), jnp.asarray(toks))
    got = loss.next_token_loss(torch.from_numpy(logits),
                               torch.from_numpy(toks))
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)
    cfg = dataclasses.replace(get_smoke_config(ARCH), logit_softcap=5.0)
    rcfg = dataclasses.replace(ref_smoke_config(ARCH), logit_softcap=5.0)
    hidden = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    head = rng.standard_normal((cfg.padded_vocab, cfg.d_model)).astype(
        np.float32) * 0.1
    toks = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    want = ref_loss.chunked_next_token_loss(
        rcfg, {"embed": {"w": jnp.asarray(head)}}, jnp.asarray(hidden),
        jnp.asarray(toks), chunk=8)
    h = torch.from_numpy(hidden).requires_grad_(True)
    got = loss.chunked_next_token_loss(
        cfg, {"embed": {"w": torch.from_numpy(head)}}, h,
        torch.from_numpy(toks), chunk=8)
    assert float(got.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    # the chunked loss equals the loss over the full (softcapped) logits
    full = torch.from_numpy(hidden) @ torch.from_numpy(head).t()
    full = 5.0 * torch.tanh(full / 5.0)
    plain = loss.next_token_loss(full, torch.from_numpy(toks))
    assert float(got.detach()) == pytest.approx(float(plain), rel=LOSS_RTOL)
    got.backward()
    assert h.grad is not None and bool(torch.isfinite(h.grad).all())


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches(state_dtype):
    rng = np.random.default_rng(1)
    ref_params = {"layers": {"w": rng.standard_normal((2, 8, 4)),
                             "scale": rng.standard_normal((2, 4))},
                  "final": {"scale": rng.standard_normal(4)}}
    ref_params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                              ref_params)
    grads = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), ref_params)
    tc = TrainConfig(warmup_steps=2, total_steps=10, grad_clip=0.5,
                     weight_decay=0.3, optimizer_state_dtype=state_dtype)
    rtc = RefTrainConfig(**dataclasses.asdict(tc))

    def port(tree):
        out = {"layers": [{k: torch.from_numpy(np.array(v[i]))
                           for k, v in tree["layers"].items()}
                          for i in range(2)],
               "final": {"scale": torch.from_numpy(
                   np.array(tree["final"]["scale"]))}}
        return out

    rstate = ref_opt.adamw_init(ref_params, state_dtype)
    params, g = port(ref_params), port(grads)
    state = optimizer.adamw_init(params, state_dtype)
    assert state.m["layers"][0]["w"].dtype == getattr(torch, state_dtype)
    for _ in range(3):   # warm-up, then the cosine
        ref_params, rstate, rm = ref_opt.adamw_update(grads, rstate,
                                                      ref_params, rtc)
        params, state, m = optimizer.adamw_update(g, state, params, tc)
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                      rel=LOSS_RTOL)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert int(state.count) == int(rstate.count) == 3
    for name, got, want in [
            ("w", params["layers"][1]["w"], ref_params["layers"]["w"][1]),
            ("scale", params["layers"][0]["scale"],
             ref_params["layers"]["scale"][0]),
            ("final", params["final"]["scale"], ref_params["final"]["scale"]),
            ("m", state.m["layers"][1]["w"].float(),
             rstate.m["layers"]["w"][1].astype(jnp.float32)),
            ("v", state.v["layers"][0]["scale"].float(),
             rstate.v["layers"]["scale"][0].astype(jnp.float32))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **PARAM_TOL, err_msg=name)


def test_cosine_schedule_matches():
    tc = TrainConfig(warmup_steps=10, total_steps=100, learning_rate=1e-3)
    want = ref_opt.cosine_schedule(RefTrainConfig(**dataclasses.asdict(tc)))
    got = optimizer.cosine_schedule(tc)
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        assert float(got(torch.tensor(step))) == pytest.approx(
            float(want(jnp.asarray(step))), rel=1e-6, abs=1e-12), step


def test_dataset_batches_are_the_references_bit_for_bit():
    for kwargs in [dict(vocab_size=50280, seq_len=64, global_batch=4,
                        seed=3),
                   dict(vocab_size=256, seq_len=32, global_batch=8,
                        num_shards=2, shard_id=1, prefix_tokens=3,
                        d_model=16)]:
        ours, ref = SyntheticTokenDataset(**kwargs), RefDataset(**kwargs)
        for step in (0, 1, 17):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert ours.reshard(4, 3).shard_batch == ref.reshard(4, 3).shard_batch


def _ref_step(ref_params, rtc, toks):
    cfg = ref_smoke_config(ARCH)
    state = RefTrainState(params=ref_params,
                          opt=ref_opt.adamw_init(ref_params,
                                                 rtc.optimizer_state_dtype),
                          step=jnp.zeros((), jnp.int32))
    return jax.jit(ref_build_train_step(cfg, rtc))(
        state, {"tokens": jnp.asarray(toks)})


@pytest.mark.parametrize("changes", [
    dict(), dict(grad_allreduce_dtype="float32", loss_chunk=16)],
    ids=["bf16-grads", "f32-grads-chunked-loss"])
def test_one_train_step_matches_the_reference(ref_params, changes):
    """Loss, grad norm and every parameter after one step."""
    cfg = get_smoke_config(ARCH)
    tc = TrainConfig(warmup_steps=1, total_steps=10, remat_policy="full",
                     **changes)
    toks = _tokens(cfg, 2, 64, 5)
    rstate, rm = _ref_step(ref_params, RefTrainConfig(
        **dataclasses.asdict(tc)), toks)
    state, m = build_train_step(cfg, tc)(_state(ref_params, tc),
                                         {"tokens": torch.from_numpy(toks)})
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                             rel=LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=LOSS_RTOL)
    assert int(m["step"]) == int(state.step) == 1
    want = _ref_flat(rstate.params, cfg.num_layers)
    got = _flat(state.params)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k], **PARAM_TOL,
                                   err_msg=k)


def _step_once(ref_params, tc, toks):
    cfg = get_smoke_config(ARCH)
    return build_train_step(cfg, tc)(_state(ref_params, tc),
                                     {"tokens": torch.from_numpy(toks)})


def test_microbatches_equal_one_batch(ref_params):
    """Two microbatches of 2 equal one batch of 4 (float32 accumulation,
    as the reference's own test)."""
    toks = _tokens(get_smoke_config(ARCH), 4, 32, 6)
    base = TrainConfig(warmup_steps=1, grad_allreduce_dtype="float32",
                       remat_policy="none")
    s1, m1 = _step_once(ref_params, base, toks)
    s2, m2 = _step_once(ref_params, dataclasses.replace(base,
                                                        microbatches=2), toks)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]),
                                              rel=LOSS_RTOL)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-4)
    a, b = _flat(s1.params), _flat(s2.params)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), **PARAM_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("policy", ["full", "names", "minimal"])
def test_each_remat_policy_equals_none(ref_params, policy):
    """Remat changes memory, never numbers: the same loss, grad norm and
    parameters as no remat, to float32 rounding."""
    toks = _tokens(get_smoke_config(ARCH), 2, 64, 7)
    base = TrainConfig(warmup_steps=1, remat_policy="none",
                       grad_allreduce_dtype="float32")
    s0, m0 = _step_once(ref_params, base, toks)
    s1, m1 = _step_once(ref_params, dataclasses.replace(
        base, remat_policy=policy), toks)
    assert float(m1["loss"]) == float(m0["loss"])
    assert float(m1["grad_norm"]) == pytest.approx(float(m0["grad_norm"]),
                                                   rel=1e-6)
    a, b = _flat(s0.params), _flat(s1.params)
    for k in a:
        torch.testing.assert_close(b[k], a[k], atol=1e-6, rtol=1e-6)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        make_remat("everything")


def test_twenty_steps_lower_the_loss():
    """tests/test_train.py:69 on the port: one fixed batch, 20 steps."""
    cfg = get_smoke_config(ARCH)
    tc = TrainConfig(total_steps=30, warmup_steps=3)
    state = init_train_state(cfg, tc, device="cpu")
    step = build_train_step(cfg, tc)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 4, 32, 1))}
    losses = []
    for _ in range(20):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5


def test_checkpoint_round_trip(tmp_path):
    cfg = get_smoke_config(ARCH)
    tc = TrainConfig(optimizer_state_dtype="bfloat16")
    state = init_train_state(cfg, tc, seed=3, device="cpu")
    state.opt.m["layers"][0]["ssm"]["D"].fill_(0.3)
    path = save_checkpoint(str(tmp_path), 7, state, extra={"note": 1})
    assert os.path.exists(os.path.join(path, "manifest.json"))
    assert latest_step(str(tmp_path)) == 7
    like = init_train_state(cfg, tc, seed=4, device="cpu")
    back = restore_checkpoint(str(tmp_path), 7, like)
    a, b = _flat(state), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    mgr = CheckpointManager(str(tmp_path / "async"), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state)
    mgr.wait()
    mgr.close()
    assert sorted(os.listdir(tmp_path / "async")) == ["step_00000002",
                                                      "step_00000003"]
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 7, init_train_state(
            dataclasses.replace(cfg, d_model=32, ssm_heads=2), tc,
            device="cpu"))


def _cli(tmp_path, name, *extra):
    return ["--arch", ARCH, "--smoke", "--steps", "4", "--device", "cpu",
            "--seq-len", "32", "--global-batch", "4", "--log-every", "1",
            "--checkpoint-every", "1", "--checkpoint-dir",
            str(tmp_path / name), *extra]


def test_failure_drill_resumes_to_the_same_loss(tmp_path):
    plain = train_cli.run(train_cli.parse_args(_cli(tmp_path, "a")))
    drill = train_cli.run(train_cli.parse_args(
        _cli(tmp_path, "b", "--inject-failure-at", "2")))
    assert plain["restarts"] == 0 and drill["restarts"] == 1
    assert len(drill["losses"]) == 2   # steps 3 and 4, after the restore
    assert drill["losses"] == plain["losses"][2:]
    assert latest_step(str(tmp_path / "b")) == 4
    with pytest.raises(train_cli.SimulatedFailure):
        train_cli.run(train_cli.parse_args(_cli(
            tmp_path, "c", "--inject-failure-at", "1", "--max-restarts",
            "0")))


def test_cli_runs_and_refuses_a_mesh(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--steps", "4", "--device", "cpu", "--checkpoint-dir",
         str(tmp_path / "cli")],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout
    # one process is the (1, 1) mesh, the reference's rule on one device:
    # --model-parallel 2 trains as --model-parallel 1 does
    one = train_cli.run(train_cli.parse_args(_cli(tmp_path, "mp1")))
    two = train_cli.run(train_cli.parse_args(
        _cli(tmp_path, "mp2", "--model-parallel", "2")))
    assert two["mesh"].shape == {"data": 1, "model": 1}
    assert len(two["losses"]) == 4 and two["losses"] == one["losses"]

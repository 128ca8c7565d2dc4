"""Dense, hybrid and frontend training through ``launch/train.py``
against the reference, and the launch counts a card train step makes, on
the CPU.

``chip_smoke.py`` phases 26 (U) and 27 (V) train llama3.2-3b and
hymba-1.5b, phases 28 (W) and 29 (X) internvl2-2b and musicgen-medium,
on the card through the same CLI with remat ``full``.  Here their smoke
configs do it on the CPU:

* three steps of ``launch/train.py --remat full`` (4 x 64 tokens, one
  process) from the reference's initial parameters (carried across by
  ``repro_torch.models.interop`` into a step-0 checkpoint that
  restore-or-init picks up), held step by step to the reference's
  ``repro.launch.train.build_objects`` step on a (1, 1) mesh of one CPU
  device.  hymba-smoke's window (16) and chunk (16) are below the 64
  tokens, so its windowed layers, its global ones and the scan's carried
  state all reach the numbers.  internvl2-smoke and musicgen-smoke train
  on the CLI's prefix batches (16 and 8 positions of synthetic
  embeddings ahead of the 64 tokens, no loss on them), and the
  reference's dataset is built by the reference's own rule
  (``prefix_tokens=frontend_tokens`` for a frontend model); a control
  shows that the comparison sees the prefix: the reference's steps with
  the prefix zeroed stray from the port's;
* the launch-count contract U-X assert on the card, from the dry run
  (``launch/cells.py`` ``train_cell`` traced on fake tensors, B8 and B9
  on the card's route): with remat ``full`` a step launches B8 twice a
  layer (the forward and the recompute) and, for the hybrid, B9 twice a
  layer; without remat once each.

Tolerances, as ``tests/test_torch_train.py`` states them: 1e-5 relative
on losses and grad norms (``LOSS_RTOL``: float32 sums in other orders),
1e-4 absolute and relative on parameters after the steps
(``PARAM_TOL``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.data.pipeline import SyntheticTokenDataset as RefDataset
from repro.launch.train import build_objects
from repro.models import lm as ref_lm
from repro.train import optimizer as ref_opt
from repro.train.train_step import TrainState as RefTrainState
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.launch import cells
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import Mesh
from repro_torch.models import interop
from repro_torch.train import optimizer
from repro_torch.train.train_step import TrainState
from repro_torch.train.tree import leaves_with_path

ARCHS = ["llama3.2-3b", "hymba-1.5b", "internvl2-2b", "musicgen-medium"]
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
SEED = 0
STEPS, SEQ, BATCH = 3, 64, 4


def _flat(params):
    return {"/".join(map(str, p)): t for p, t in leaves_with_path(params)}


def _reference_run(arch, rparams, zero_prefix=False):
    """The reference's ``build_objects`` step, three steps on the CLI's
    train config, from ``rparams``: ``(metrics by step, final params)``.
    A frontend model's batches carry the prefix, as the reference's
    ``launch/train.py`` builds them; ``zero_prefix`` zeroes it (a
    control)."""
    rcfg = ref_smoke_config(arch)
    tc = RefTrainConfig(total_steps=STEPS, warmup_steps=1, seq_len=SEQ,
                        global_batch=BATCH, remat_policy="full", seed=SEED)
    # one device, whatever the process's device count
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    _, step, state_sh = build_objects(rcfg, tc, mesh)
    state = RefTrainState(params=rparams, opt=ref_opt.adamw_init(
        rparams, tc.optimizer_state_dtype), step=jnp.zeros((), jnp.int32))
    state = jax.device_put(state, state_sh)
    data = RefDataset(vocab_size=rcfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH, seed=SEED,
                      prefix_tokens=rcfg.frontend_tokens
                      if rcfg.frontend else 0,
                      d_model=rcfg.d_model)
    steps = []
    with mesh:
        for i in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
            if zero_prefix:
                batch["prefix"] = jnp.zeros_like(batch["prefix"])
            state, m = step(state, batch)
            steps.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return steps, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module", params=ARCHS)
def runs(request, tmp_path_factory):
    """The port's CLI and the reference's step over three steps, from the
    same initial parameters."""
    arch = request.param
    rparams = ref_lm.init_params(ref_smoke_config(arch),
                                 jax.random.PRNGKey(SEED))
    params = interop.params_from_reference(jax.tree.map(np.asarray,
                                                        rparams),
                                           device="cpu")
    ckpt = tmp_path_factory.mktemp(arch)
    save_checkpoint(str(ckpt), 0, TrainState(
        params=params, opt=optimizer.adamw_init(params, "float32"),
        step=torch.zeros((), dtype=torch.int32)))
    out = train_cli.run(train_cli.parse_args([
        "--arch", arch, "--smoke", "--steps", str(STEPS), "--seq-len",
        str(SEQ), "--global-batch", str(BATCH), "--remat", "full",
        "--checkpoint-every", "0", "--log-every", "1", "--seed", str(SEED),
        "--device", "cpu", "--checkpoint-dir", str(ckpt)]))
    want_steps, want_params = _reference_run(arch, rparams)
    return arch, out, want_steps, want_params


def test_steps_match_the_reference(runs):
    """Each step's loss and grad norm within 1e-5 relative."""
    _, out, want, _ = runs
    assert len(out["steps"]) == STEPS
    for got, ref in zip(out["steps"], want):
        assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
        assert got["grad_norm"] == pytest.approx(ref["grad_norm"],
                                                 rel=LOSS_RTOL)
        assert got["aux_loss"] == 0.0
    # the steps train: the loss moves
    assert out["steps"][0]["loss"] != out["steps"][-1]["loss"]


def test_parameters_match_the_reference(runs):
    """Every parameter after three steps within 1e-4."""
    _, out, _, want_params = runs
    got = _flat(out["state"].params)
    want = _flat(interop.params_from_reference(want_params, device="cpu"))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   **PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("runs", ["internvl2-2b"], indirect=True)
def test_prefix_reaches_the_comparison(runs):
    """Control: the reference's steps with the prefix zeroed stray from
    the port's steps with it by more than ``LOSS_RTOL``, so the parity
    above holds the prefix (W's and X's first prefix control on the
    card)."""
    arch, out, want, _ = runs
    rparams = ref_lm.init_params(ref_smoke_config(arch),
                                 jax.random.PRNGKey(SEED))
    bare, _ = _reference_run(arch, rparams, zero_prefix=True)
    got = out["steps"][0]
    assert got["loss"] == pytest.approx(want[0]["loss"], rel=LOSS_RTOL)
    assert got["loss"] != pytest.approx(bare[0]["loss"], rel=LOSS_RTOL)
    assert got["grad_norm"] != pytest.approx(bare[0]["grad_norm"],
                                             rel=LOSS_RTOL)


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_launches_per_step(arch, remat):
    """A traced train step of the smoke config launches B8 (and, for the
    hybrid, B9) twice a layer under remat ``full``, once without remat:
    the counts phases U-X assert on the card, 2 x layers a step."""
    cfg = get_smoke_config(arch)
    tc = TrainConfig(total_steps=STEPS, warmup_steps=1, seq_len=SEQ,
                     global_batch=BATCH, remat_policy=remat, seed=SEED)
    fn, args, _ = cells.train_cell(
        cfg, Mesh(("data", "model"), (1, 1), torch.device("meta")), SEQ,
        BATCH, tc=tc)
    per_layer = 2 if remat == "full" else 1
    want = {"flash_attention": per_layer * cfg.num_layers}
    if cfg.family == "hybrid":
        want["ssd_scan"] = per_layer * cfg.num_layers
    assert cells.trace(fn, args)["kernels"] == want


def test_hybrid_smoke_reaches_windowed_and_global_layers():
    """hymba-smoke at this test's length has both kinds of layer, so the
    parity above holds the windows (what V's all-global control
    removes on the card)."""
    from repro_torch.models.lm import layer_windows

    cfg = get_smoke_config("hymba-1.5b")
    windows = layer_windows(cfg, SEQ)
    assert cfg.sliding_window < SEQ and cfg.ssm_chunk < SEQ
    assert set(windows) == {cfg.sliding_window, SEQ + 1}
    every = dataclasses.replace(cfg, global_attn_every=1)
    assert layer_windows(every, SEQ) == [SEQ + 1] * cfg.num_layers

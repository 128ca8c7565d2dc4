"""The port's Mamba-2 block and the SSM family's forward against the
reference, on the CPU, in float32 (``mamba2-smoke``).

The reference's parameters are carried across with
``repro_torch.models.interop.params_from_reference``; inputs come from
numpy seeds.  Tolerance: 1e-4 absolute and relative, as for the dense
family (``tests/test_torch_lm.py``): float32 on both sides, sums in other
orders over three layers, while a wrong conv tap, gate, decay or state
slot moves values by O(1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import interop, lm, ssm
from repro_torch.train.tree import leaves_with_path

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "mamba2-1.3b"


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params)."""
    rcfg = ref_smoke_config(ARCH)
    rparams = ref_lm.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, rparams)
    return (rcfg, rparams, get_smoke_config(ARCH),
            interop.params_from_reference(tree, device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **TOL)


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _layer(rparams, i):
    return jax.tree.map(lambda a: a[i], rparams["layers"]["ssm"])


def test_interop_carries_ssm_layers(model):
    rcfg, rparams, cfg, params = model
    assert len(params["layers"]) == cfg.num_layers
    p = params["layers"][1]["ssm"]
    assert set(params["layers"][1]) == {"ln", "ssm"}
    assert p["conv_w"].dtype == torch.float32          # kept, cast at use
    assert p["conv_w"].shape == (cfg.ssm_conv, cfg.d_inner + 2 * cfg.ssm_state)
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        assert p[name].dim() == 1 and p[name].dtype == torch.float32
    np.testing.assert_array_equal(
        p["A_log"].numpy(), np.asarray(rparams["layers"]["ssm"]["A_log"][1]))
    bf = interop.params_from_reference(jax.tree.map(np.asarray, rparams),
                                       device="cpu", dtype=torch.bfloat16)
    assert bf["layers"][0]["ssm"]["conv_w"].dtype == torch.float32
    assert bf["layers"][0]["ssm"]["in_proj"]["w"].dtype == torch.bfloat16


def test_init_params_has_the_reference_layout():
    cfg = get_smoke_config(ARCH)
    ours = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    ref = ref_lm.init_params(ref_smoke_config(ARCH), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path): tuple(leaf.shape[1:])
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                ref["layers"])}
    got = {jax.tree_util.keystr(path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_leaves_with_path(
               ours["layers"][0])}
    assert got == want
    # the deterministic leaves equal the reference's
    np.testing.assert_allclose(ours["layers"][0]["ssm"]["A_log"].numpy(),
                               np.asarray(ref["layers"]["ssm"]["A_log"][0]),
                               rtol=1e-6)
    dt = torch.nn.functional.softplus(ours["layers"][0]["ssm"]["dt_bias"])
    assert bool(((dt > 9e-4) & (dt < 0.11)).all())


@pytest.mark.parametrize("s", [64, 50, 16])
def test_ssm_apply_matches(model, s):
    """s = 50 pads the scan to two chunks of 32; s = 16 is one short
    chunk."""
    rcfg, rparams, cfg, params = model
    x = _x(cfg, 2, s, s)
    want = ref_ssm.ssm_apply(_layer(rparams, 0), jnp.asarray(x), rcfg)
    got = ssm.ssm_apply(params["layers"][0]["ssm"], torch.from_numpy(x), cfg)
    _close(got, want)
    naive = ssm.ssm_apply(params["layers"][0]["ssm"], torch.from_numpy(x),
                          cfg, impl="ref")
    _close(naive, want)


def test_ssm_prefill_and_decode_match(model):
    rcfg, rparams, cfg, params = model
    rp, p = _layer(rparams, 1), params["layers"][1]["ssm"]
    x = _x(cfg, 2, 40, 3)
    want, rstate = ref_ssm.ssm_prefill(rp, jnp.asarray(x), rcfg)
    got, state = ssm.ssm_prefill(p, torch.from_numpy(x), cfg)
    _close(got, want)
    _close(state.ssd, rstate.ssd)
    _close(state.conv, rstate.conv)
    for i, xt in enumerate([_x(cfg, 2, 1, 10 + i) for i in range(3)]):
        want, rstate = ref_ssm.ssm_decode(rp, jnp.asarray(xt), rcfg, rstate)
        got, state = ssm.ssm_decode(p, torch.from_numpy(xt), cfg, state)
        _close(got, want)
        _close(state.ssd, rstate.ssd)
        _close(state.conv, rstate.conv)
    zero = ssm.ssm_zero_state(cfg, 2, device="cpu")
    rzero = ref_ssm.ssm_zero_state(rcfg, 2)
    assert tuple(zero.ssd.shape) == rzero.ssd.shape
    assert tuple(zero.conv.shape) == rzero.conv.shape


def test_decode_continues_prefill(model):
    """Prefill of 40 then one decode step equals the last position of a
    41-token pass (the state carries the whole prefix)."""
    _, _, cfg, params = model
    p = params["layers"][2]["ssm"]
    x = torch.from_numpy(_x(cfg, 1, 41, 5))
    full = ssm.ssm_apply(p, x, cfg)
    _, state = ssm.ssm_prefill(p, x[:, :40], cfg)
    step, _ = ssm.ssm_decode(p, x[:, 40:], cfg, state)
    torch.testing.assert_close(step[:, 0], full[:, 40], **TOL)


@pytest.mark.parametrize("s", [64, 37])
def test_forward_logits_and_hidden_match(model, s):
    rcfg, rparams, cfg, params = model
    toks = np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)
    rlogits, raux = ref_lm.forward(rcfg, rparams, jnp.asarray(toks))
    logits, aux = lm.forward(cfg, params, torch.from_numpy(toks))
    assert logits.dtype == torch.float32
    assert logits.shape == (2, s, cfg.padded_vocab)
    _close(logits, rlogits)
    assert float(aux) == float(raux) == 0.0
    rhidden, _ = ref_lm.forward(rcfg, rparams, jnp.asarray(toks),
                                return_hidden=True)
    hidden, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                           return_hidden=True)
    _close(hidden, rhidden)


def test_full_config_parameter_count():
    """mamba2-1.3b at full width: 1,344,052,224 parameters, as the
    reference's init_params counts them (jax.eval_shape)."""
    cfg = get_config(ARCH)
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    per_layer = (cfg.d_model                                 # ln
                 + cfg.d_model * (2 * di + 2 * n + h)        # in_proj
                 + (cfg.ssm_conv + 1) * (di + 2 * n)         # conv w, b
                 + 3 * h + di                                # A_log, D, dt, norm
                 + di * cfg.d_model)                         # out_proj
    total = (cfg.padded_vocab * cfg.d_model + cfg.num_layers * per_layer
             + cfg.d_model)
    assert total == 1_344_052_224
    ref = jax.eval_shape(lambda: ref_lm.init_params(
        ref_smoke_config(ARCH), jax.random.PRNGKey(0)))
    ours = lm.init_params(get_smoke_config(ARCH), device="cpu")
    count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    assert count == sum(t.numel() for _, t in leaves_with_path(ours))

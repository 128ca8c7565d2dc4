"""The port's hybrid family (hymba) against the reference, on the CPU, in
float32 (``hymba-smoke``: sliding window 16, every 2nd layer global).

The reference's parameters are carried across with
``repro_torch.models.interop.params_from_reference``; tokens come from
numpy seeds.  Tolerance: 1e-4 absolute and relative on logits, caches and
attention mass, as in ``tests/test_torch_lm.py`` and
``tests/test_torch_ssm.py``: float32 on both sides with sums in other
orders over four layers, while a wrong window, beta, state slot or conv
tap moves values by O(1e-2).  One train step's loss and grad norm are held
within 1e-5 relative, as in ``tests/test_torch_train.py``.  Tokens,
``final_pos``, ``evicted``, window lists, layouts and dtypes are compared
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServeConfig as RefServeConfig
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro.train import optimizer as ref_opt
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import build_train_step as ref_build_train_step
from repro_torch.configs import (
    ServeConfig,
    TrainConfig,
    get_config,
    get_smoke_config,
)
from repro_torch.models import interop, lm
from repro_torch.serve import engine
from repro_torch.train import optimizer
from repro_torch.train.train_step import TrainState, build_train_step
from repro_torch.train.tree import leaves_with_path

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
ARCH = "hymba-1.5b"
SERVE = dict(seq_len=48, batch=2, kv_cache_dtype="float32",
             eviction_enabled=True, eviction_budget=24, eviction_window=4,
             rmq_chunk=4, rmq_threshold=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CACHE_KEYS = ("k", "v", "ssd", "conv")


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params)."""
    rcfg = ref_smoke_config(ARCH)
    rparams = ref_lm.init_params(rcfg, jax.random.PRNGKey(0))
    return (rcfg, rparams, get_smoke_config(ARCH),
            interop.params_from_reference(jax.tree.map(np.asarray, rparams),
                                          device="cpu"))


def _tokens(cfg, batch, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, s)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _same_layout(cache, rcache):
    assert set(cache) == set(rcache) == set(CACHE_KEYS)
    for key, val in cache.items():
        assert tuple(val.shape) == rcache[key].shape, key
        assert str(val.dtype).split(".")[-1] == str(rcache[key].dtype), key


@pytest.mark.parametrize("arch,smoke", [(ARCH, True), (ARCH, False),
                                        ("llama3.2-3b", True)])
@pytest.mark.parametrize("seq_len", [40, 2048, 10 ** 9])
def test_layer_windows_match_reference(arch, smoke, seq_len):
    from repro.configs import get_config as ref_config

    rcfg = (ref_smoke_config if smoke else ref_config)(arch)
    cfg = (get_smoke_config if smoke else get_config)(arch)
    want = ref_lm.layer_windows(rcfg, seq_len)
    got = lm.layer_windows(cfg, seq_len)
    if want is None:
        assert got is None
        return
    assert got == np.asarray(want).tolist()
    assert all(type(w) is int for w in got)


def test_full_config_windows():
    """hymba-1.5b: every 8th layer global, SWA 1024 on the 28 others."""
    got = lm.layer_windows(get_config(ARCH), 2048)
    assert [i for i, w in enumerate(got) if w == 2049] == [0, 8, 16, 24]
    assert got.count(1024) == 28


def test_interop_carries_hybrid_layers(model):
    rcfg, rparams, cfg, params = model
    assert len(params["layers"]) == cfg.num_layers
    layer = params["layers"][1]
    assert set(layer) == {"ln1", "attn", "ssm", "norm_attn", "norm_ssm",
                          "beta_attn", "beta_ssm", "ln2", "mlp"}
    for name in ("beta_attn", "beta_ssm"):
        assert layer[name].dtype == torch.float32
        assert tuple(layer[name].shape) == (cfg.d_model,)
    ssm = layer["ssm"]
    assert ssm["conv_w"].shape == (cfg.ssm_conv, cfg.d_model
                                   + 2 * cfg.ssm_state)
    np.testing.assert_array_equal(
        layer["ssm"]["in_proj"]["w"].numpy(),
        np.asarray(rparams["layers"]["ssm"]["in_proj"]["w"][1]))
    bf = interop.params_from_reference(jax.tree.map(np.asarray, rparams),
                                       device="cpu", dtype=torch.bfloat16)
    b1 = bf["layers"][1]
    assert b1["beta_attn"].dtype == b1["beta_ssm"].dtype == torch.float32
    assert b1["ssm"]["conv_w"].dtype == torch.float32
    assert b1["ssm"]["A_log"].dtype == torch.float32
    assert b1["attn"]["q"]["w"].dtype == torch.bfloat16
    assert b1["ssm"]["in_proj"]["w"].dtype == torch.bfloat16
    assert b1["mlp"]["down"]["w"].dtype == torch.bfloat16


def test_init_params_has_the_reference_layout():
    cfg = get_smoke_config(ARCH)
    ours = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    ref = jax.eval_shape(lambda: ref_lm.init_params(
        ref_smoke_config(ARCH), jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(path): tuple(leaf.shape[1:])
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                ref["layers"])}
    got = {jax.tree_util.keystr(path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_leaves_with_path(
               ours["layers"][0])}
    assert got == want
    count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    assert count == sum(t.numel() for _, t in leaves_with_path(ours))
    bf = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    assert bf["layers"][0]["beta_ssm"].dtype == torch.float32
    assert bool((bf["layers"][0]["beta_ssm"] == 1).all())
    assert bf["layers"][0]["attn"]["k"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("s", [40, 16])
def test_forward_matches_reference(model, s):
    """S = 40 lets the 16-token window cut in on layers 1 and 3; with
    ``attn_impl="ref"`` too."""
    rcfg, rparams, cfg, params = model
    toks = _tokens(cfg, 2, s, s)
    want, raux = ref_lm.forward(rcfg, rparams, jnp.asarray(toks))
    got, aux = lm.forward(cfg, params, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and float(aux) == float(raux) == 0.0
    _close(got, want)
    plain, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                          attn_impl="ref")
    _close(plain, want)
    rhidden, _ = ref_lm.forward(rcfg, rparams, jnp.asarray(toks),
                                return_hidden=True)
    hidden, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                           return_hidden=True)
    _close(hidden, rhidden)


def test_forward_window_matters(model):
    """A control on the windows: the same model with every layer global
    leaves the reference at S = 40."""
    rcfg, rparams, cfg, params = model
    toks = _tokens(cfg, 2, 40, 40)
    want, _ = ref_lm.forward(rcfg, rparams, jnp.asarray(toks))
    wide = dataclasses.replace(cfg, sliding_window=None)
    got, _ = lm.forward(wide, params, torch.from_numpy(toks))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) > 1e-2


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_make_decode_cache_matches_reference(model, dtype):
    rcfg, _, cfg, _ = model
    jdt, tdt = DTYPES[dtype]
    rcache = ref_lm.make_decode_cache(rcfg, 2, 48, dtype=jdt)
    cache = lm.make_decode_cache(cfg, 2, 48, dtype=tdt, device="cpu")
    _same_layout(cache, rcache)
    assert cache["conv"].shape[-1] == cfg.d_model + 2 * cfg.ssm_state


def test_prefill_and_decode_match_reference(model):
    """Prefill logits and every cache entry, then decode steps past the
    16-token window: logits, k / v / ssd / conv, and the all-zero mass."""
    rcfg, rparams, cfg, params = model
    s, cache_len = 20, 32
    toks = _tokens(cfg, 2, s, 2)
    rlogits, rcache = ref_lm.prefill(rcfg, rparams, jnp.asarray(toks),
                                     cache_len, cache_dtype=jnp.float32)
    logits, cache = lm.prefill(cfg, params, torch.from_numpy(toks),
                               cache_len, cache_dtype=torch.float32)
    _close(logits, rlogits)
    _same_layout(cache, rcache)
    for key in CACHE_KEYS:
        _close(cache[key], rcache[key])
    token = np.argmax(np.asarray(rlogits), axis=-1).astype(np.int32)
    for pos in (s, s + 1, s + 2):
        rlogits, rcache, rmass = ref_lm.decode_step(
            rcfg, rparams, jnp.asarray(token), rcache, pos,
            return_attn_mass=True)
        logits, cache, mass = lm.decode_step(
            cfg, params, torch.from_numpy(token), cache, pos,
            return_attn_mass=True)
        _close(logits, rlogits)
        _same_layout(cache, rcache)
        for key in CACHE_KEYS:
            _close(cache[key], rcache[key])
        assert tuple(mass.shape) == rmass.shape == (2, cache_len)
        assert not bool(mass.any()) and not np.asarray(rmass).any()
        token = np.argmax(np.asarray(rlogits), axis=-1).astype(np.int32)
    _, _, none = lm.decode_step(cfg, params, torch.from_numpy(token), cache,
                                s + 3)
    assert none is None


def test_cache_dtypes_match_reference_with_a_bf16_cache(model):
    """k / v in the cache dtype, ``ssd`` float32, ``conv`` in the model's
    dtype after prefill and after a decode step, as in the reference."""
    rcfg, rparams, cfg, params = model
    toks = _tokens(cfg, 2, 20, 6)
    rlogits, rcache = ref_lm.prefill(rcfg, rparams, jnp.asarray(toks), 32,
                                     cache_dtype=jnp.bfloat16)
    logits, cache = lm.prefill(cfg, params, torch.from_numpy(toks), 32,
                               cache_dtype=torch.bfloat16)
    _same_layout(cache, rcache)
    assert cache["conv"].dtype == torch.float32
    token = np.argmax(np.asarray(rlogits), axis=-1).astype(np.int32)
    _, rcache, _ = ref_lm.decode_step(rcfg, rparams, jnp.asarray(token),
                                      rcache, 20)
    _, cache, _ = lm.decode_step(cfg, params, torch.from_numpy(token), cache,
                                 20)
    _same_layout(cache, rcache)


def test_decode_continues_prefill_past_the_window(model):
    """Prefill of 30 then decode at 30-33 equals a 34-token forward at
    those positions (the 16-token window on layers 1 and 3)."""
    _, _, cfg, params = model
    toks = torch.from_numpy(_tokens(cfg, 2, 34, 7))
    full, _ = lm.forward(cfg, params, toks)
    _, cache = lm.prefill(cfg, params, toks[:, :30], 40,
                          cache_dtype=torch.float32)
    for pos in range(30, 34):
        logits, cache, _ = lm.decode_step(cfg, params, toks[:, pos], cache,
                                          pos)
        torch.testing.assert_close(logits, full[:, pos], **TOL)


@pytest.mark.parametrize("evict", [True, False])
def test_generate_matches_reference(model, evict):
    """Tokens, final_pos and evicted.  The hybrid's mass is all zero (the
    reference's), so eviction picks by position: 24 / 11 here."""
    rcfg, rparams, cfg, params = model
    prompts = _tokens(cfg, 2, 20, 1)
    sc = dict(SERVE, eviction_enabled=evict)
    want = ref_engine.ServeEngine(rcfg, rparams, RefServeConfig(**sc)
                                  ).generate(jnp.asarray(prompts), 16)
    got = engine.ServeEngine(cfg, params, ServeConfig(**sc)).generate(
        torch.from_numpy(prompts), 16)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert got["final_pos"] == want["final_pos"]
    assert got["evicted"] == want["evicted"]
    if evict:
        assert (got["final_pos"], got["evicted"]) == (24, 11)
    else:
        assert (got["final_pos"], got["evicted"]) == (35, 0)


def test_eviction_leaves_the_ssm_state_bit_for_bit(model):
    """An eviction round on a hybrid cache permutes k / v along their
    position axis and leaves ``ssd`` and ``conv`` as they were."""
    _, _, cfg, params = model
    eng = engine.ServeEngine(cfg, params, ServeConfig(**SERVE))
    _, cache = lm.prefill(cfg, params,
                          torch.from_numpy(_tokens(cfg, 2, 30, 5)), 48,
                          cache_dtype=torch.float32)
    keep = {k: v.clone() for k, v in cache.items()}
    victims = torch.tensor([3, 9], dtype=torch.int32)
    new, _, live = eng._evict(cache, torch.rand((2, 48)), victims, 30)
    assert live == 28
    for key in ("ssd", "conv"):
        assert torch.equal(new[key].view(torch.int32),
                           keep[key].view(torch.int32))
    order = [i for i in range(30) if i not in (3, 9)] + list(range(30, 48))
    order += [3, 9]
    for key in ("k", "v"):
        assert torch.equal(new[key], keep[key][:, :, :, order])


def _ref_step(rparams, rtc, toks):
    rcfg = ref_smoke_config(ARCH)
    state = RefTrainState(params=rparams,
                          opt=ref_opt.adamw_init(rparams,
                                                 rtc.optimizer_state_dtype),
                          step=jnp.zeros((), jnp.int32))
    return jax.jit(ref_build_train_step(rcfg, rtc))(
        state, {"tokens": jnp.asarray(toks)})


def test_one_train_step_matches_the_reference(model):
    """Step 0 of ``build_train_step`` through the hybrid forward: loss and
    grad norm within 1e-5 relative, and the step counter."""
    rcfg, rparams, cfg, _ = model
    tc = TrainConfig(warmup_steps=1, total_steps=10, remat_policy="full",
                     grad_allreduce_dtype="float32")
    toks = _tokens(cfg, 2, 40, 5)
    _, rm = _ref_step(rparams, RefTrainConfig(**dataclasses.asdict(tc)),
                      toks)
    params = interop.params_from_reference(jax.tree.map(np.asarray,
                                                        rparams),
                                           device="cpu")
    state = TrainState(params=params,
                       opt=optimizer.adamw_init(params,
                                                tc.optimizer_state_dtype),
                       step=torch.zeros((), dtype=torch.int32))
    state, m = build_train_step(cfg, tc)(state,
                                         {"tokens": torch.from_numpy(toks)})
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                             rel=LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=LOSS_RTOL)
    assert int(state.step) == 1


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", ARCH, "--smoke", "--evict", "--device",
                       "cpu", "--max-new", "24"]) == 0
    out = capsys.readouterr().out
    assert "evicted=" in out and "final_pos=" in out

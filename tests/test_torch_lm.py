"""The port's dense LM against the reference, on the CPU, in float32.

The reference's parameters (``repro.models.lm.init_params``) are carried
across with ``repro_torch.models.interop.params_from_reference``, so both
packages compute from the same numbers; tokens come from numpy seeds.

Tolerance: 1e-4 absolute and relative on logits, caches and attention
mass.  Both sides compute in float32 throughout, but XLA and PyTorch sum
the matmuls, the softmax and the norms in other orders, and three layers
compound those last-ulp differences (about 1e-6 relative each op); 1e-4
keeps two orders of magnitude of room without hiding a wrong mask, rope
or cache slot, each of which moves values by O(1e-1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro_torch.configs import get_smoke_config
from repro_torch.models import interop, layers, lm

TOL = dict(atol=1e-4, rtol=1e-4)

VARIANTS = {
    "llama": ("llama3.2-3b", {}),
    "llama-window": ("llama3.2-3b", {"sliding_window": 8}),
    "llama-softcap": ("llama3.2-3b", {"logit_softcap": 2.0}),
    "qwen-bias-tied": ("qwen1.5-0.5b", {}),
    "command-r-parallel": ("command-r-plus-104b", {}),
}


def _configs(name):
    arch, changes = VARIANTS[name]
    return (dataclasses.replace(ref_smoke_config(arch), **changes),
            dataclasses.replace(get_smoke_config(arch), **changes))


@pytest.fixture(scope="module")
def models():
    """name -> (reference cfg, reference params, port cfg, port params)."""
    out = {}
    for name in VARIANTS:
        rcfg, cfg = _configs(name)
        rparams = ref_lm.init_params(rcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, rparams)
        out[name] = (rcfg, rparams, cfg,
                     interop.params_from_reference(tree, device="cpu"))
    return out


def _tokens(cfg, batch, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, s)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def test_config_copy_matches_reference():
    from repro.configs import base as ref_base
    from repro_torch.configs import base

    assert base.ARCH_IDS == ref_base.ARCH_IDS
    for arch in base.ARCH_IDS:
        for fn in ("get_config", "get_smoke_config"):
            assert (dataclasses.asdict(getattr(base, fn)(arch))
                    == dataclasses.asdict(getattr(ref_base, fn)(arch)))
    assert base.get_config("llama3.2-3b").padded_vocab == 128256
    assert dataclasses.asdict(base.ServeConfig()) == dataclasses.asdict(
        ref_base.ServeConfig())


def test_interop_layout(models):
    rcfg, rparams, cfg, params = models["llama"]
    assert len(params["layers"]) == cfg.num_layers
    w = params["layers"][1]["attn"]["q"]["w"]
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(rparams["layers"]["attn"]["q"]["w"][1]))
    assert params["final_norm"]["scale"].dtype == torch.float32
    bf = interop.params_from_reference(jax.tree.map(np.asarray, rparams),
                                       device="cpu", dtype=torch.bfloat16)
    assert bf["embed"]["w"].dtype == torch.bfloat16
    assert bf["layers"][0]["ln1"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_reference(models, name):
    rcfg, rparams, cfg, params = models[name]
    toks = _tokens(cfg, 2, 24, 1)
    want, _ = ref_lm.forward(rcfg, rparams, jnp.asarray(toks))
    got, aux = lm.forward(cfg, params, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_and_decode_match_reference(models, name):
    """Prefill logits and cache, then two decode steps: logits, the cache
    slot each writes and the per-slot attention mass."""
    rcfg, rparams, cfg, params = models[name]
    s, cache_len = 20, 32
    toks = _tokens(cfg, 2, s, 2)
    rlogits, rcache = ref_lm.prefill(rcfg, rparams, jnp.asarray(toks),
                                     cache_len, cache_dtype=jnp.float32)
    logits, cache = lm.prefill(cfg, params, torch.from_numpy(toks),
                               cache_len, cache_dtype=torch.float32)
    _close(logits, rlogits)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == rcache[key].shape
        _close(cache[key], rcache[key])
    token = np.argmax(np.asarray(rlogits), axis=-1).astype(np.int32)
    for pos in (s, s + 1):
        rlogits, rcache, rmass = ref_lm.decode_step(
            rcfg, rparams, jnp.asarray(token), rcache, pos,
            return_attn_mass=True)
        logits, cache, mass = lm.decode_step(
            cfg, params, torch.from_numpy(token), cache, pos,
            return_attn_mass=True)
        _close(logits, rlogits)
        _close(mass, rmass)
        for key in ("k", "v"):
            _close(cache[key], rcache[key])
        token = np.argmax(np.asarray(rlogits), axis=-1).astype(np.int32)
    _, _, none = lm.decode_step(cfg, params, torch.from_numpy(token), cache,
                                s + 2)
    assert none is None


def test_attention_mass_matches_reference(models):
    """The per-key attention mass of a full-sequence pass (the reference's
    ``return_probs_sum``), with and without a window."""
    from repro.models import layers as ref_layers

    rcfg, rparams, cfg, params = models["llama-window"]
    x = np.random.default_rng(3).standard_normal((2, 12, cfg.d_model))
    x = x.astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    rp = jax.tree.map(lambda a: a[0], rparams["layers"]["attn"])
    p = params["layers"][0]["attn"]
    for window in (None, 5):
        rout, _, want = ref_layers.gqa_attention(
            rp, jnp.asarray(x), rcfg, jnp.asarray(pos), window=window,
            return_probs_sum=True)
        out, _, got = layers.gqa_attention(
            p, torch.from_numpy(x), cfg, torch.from_numpy(pos),
            window=window, return_probs_sum=True)
        _close(got, want)
        _close(out, rout)


def test_init_params_is_seeded_and_shaped():
    cfg = get_smoke_config("llama3.2-3b")
    a = lm.init_params(cfg, seed=3, device="cpu")
    b = lm.init_params(cfg, seed=3, device="cpu")
    c = lm.init_params(cfg, seed=4, device="cpu")
    assert torch.equal(a["layers"][2]["mlp"]["down"]["w"],
                       b["layers"][2]["mlp"]["down"]["w"])
    assert not torch.equal(a["embed"]["w"], c["embed"]["w"])
    ref = jax.eval_shape(lambda: ref_lm.init_params(
        ref_smoke_config("llama3.2-3b"), jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(path): tuple(leaf.shape[1:])
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                ref["layers"])}
    got = {jax.tree_util.keystr(path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_leaves_with_path(
               a["layers"][0])}
    assert got == want
    assert a["embed"]["w"].shape == (cfg.padded_vocab, cfg.d_model)


def test_long_prefill_matches_reference(models):
    """S = 2048: both packages take their blocked attention off the TPU."""
    rcfg, rparams, cfg, params = models["llama"]
    toks = _tokens(cfg, 1, 2048, 4)
    rlogits, rcache = ref_lm.prefill(rcfg, rparams, jnp.asarray(toks), 2056,
                                     cache_dtype=jnp.float32)
    logits, cache = lm.prefill(cfg, params, torch.from_numpy(toks), 2056,
                               cache_dtype=torch.float32)
    _close(logits, rlogits)
    _close(cache["v"][:, :, :, 2000:2050], rcache["v"][:, :, :, 2000:2050])

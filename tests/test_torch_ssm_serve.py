"""The port's SSM serving path (mamba2) against the reference, on the CPU,
in float32 (``mamba2-smoke``).

The reference's parameters are carried across with
``repro_torch.models.interop.params_from_reference``; tokens come from
numpy seeds.  Tolerance: 1e-4 absolute and relative on logits and on the
cache (the float32 SSD state and conv tail), as in
``tests/test_torch_ssm.py``: float32 on both sides with sums in other
orders over three layers, while a wrong state slot, conv tap or decay
moves values by O(1e-2).  Tokens, ``final_pos`` and ``evicted`` of
``ServeEngine.generate`` are compared exactly, and cache dtypes and
shapes too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServeConfig as RefServeConfig
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.models import interop, lm
from repro_torch.serve import engine

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "mamba2-1.3b"
# eviction on: seq 48, budget 24, 4 protected, c 4, t 2; a 20-token
# prompt and 16 new tokens end at final_pos 24 with 11 evicted
SERVE = dict(seq_len=48, batch=2, kv_cache_dtype="float32",
             eviction_enabled=True, eviction_budget=24, eviction_window=4,
             rmq_chunk=4, rmq_threshold=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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
    """The same entries, shapes and dtypes as the reference's cache."""
    assert set(cache) == set(rcache)
    for key, val in cache.items():
        assert tuple(val.shape) == rcache[key].shape, key
        assert str(val.dtype).split(".")[-1] == str(rcache[key].dtype), key


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_make_decode_cache_matches_reference(model, dtype):
    rcfg, _, cfg, _ = model
    jdt, tdt = DTYPES[dtype]
    rcache = ref_lm.make_decode_cache(rcfg, 2, 48, dtype=jdt)
    cache = lm.make_decode_cache(cfg, 2, 48, dtype=tdt, device="cpu")
    _same_layout(cache, rcache)
    assert set(cache) == {"ssd", "conv"}
    assert cache["ssd"].shape == (cfg.num_layers, 2, cfg.ssm_heads,
                                  cfg.ssm_head_dim, cfg.ssm_state)
    assert not any(bool(v.any()) for v in cache.values())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_and_decode_match_reference(model, dtype):
    """Prefill logits and cache, then three decode steps: logits, the SSD
    state and conv tail, and no attention mass.  With a bf16 cache the
    reference keeps ``ssd`` float32 and ``conv`` in the model's dtype."""
    rcfg, rparams, cfg, params = model
    jdt, tdt = DTYPES[dtype]
    s, cache_len = 20, 32
    toks = _tokens(cfg, 2, s, 2)
    rlogits, rcache = ref_lm.prefill(rcfg, rparams, jnp.asarray(toks),
                                     cache_len, cache_dtype=jdt)
    logits, cache = lm.prefill(cfg, params, torch.from_numpy(toks),
                               cache_len, cache_dtype=tdt)
    _close(logits, rlogits)
    _same_layout(cache, rcache)
    for key in ("ssd", "conv"):
        _close(cache[key], rcache[key])
    token = np.argmax(np.asarray(rlogits), axis=-1).astype(np.int32)
    for pos in (s, s + 1, s + 2):
        rlogits, rcache, rmass = ref_lm.decode_step(
            rcfg, rparams, jnp.asarray(token), rcache, pos,
            return_attn_mass=True)
        logits, cache, mass = lm.decode_step(
            cfg, params, torch.from_numpy(token), cache, pos,
            return_attn_mass=True)
        assert mass is None and rmass is None
        _close(logits, rlogits)
        _same_layout(cache, rcache)
        for key in ("ssd", "conv"):
            _close(cache[key], rcache[key])
        token = np.argmax(np.asarray(rlogits), axis=-1).astype(np.int32)


def test_decode_continues_prefill(model):
    """Prefill of 24 tokens then decode of the 25th equals the last
    position of a 25-token forward: the state carries the whole prefix."""
    _, _, cfg, params = model
    toks = torch.from_numpy(_tokens(cfg, 2, 25, 3))
    full, _ = lm.forward(cfg, params, toks)
    _, cache = lm.prefill(cfg, params, toks[:, :24], 24,
                          cache_dtype=torch.float32)
    logits, _, _ = lm.decode_step(cfg, params, toks[:, 24], cache, 24)
    torch.testing.assert_close(logits, full[:, 24], **TOL)


@pytest.mark.parametrize("evict", [True, False])
def test_generate_matches_reference(model, evict):
    """Tokens, final_pos and evicted.  With eviction the SSM has no KV
    cache to compact, but each round still lowers the live count (the
    reference's ``_evict``): 24 / 11 in this setting."""
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


def test_prefill_longer_than_the_cache(model):
    """The SSM cache has no position axis: a prompt longer than
    ``cache_len`` is served, as in the reference."""
    rcfg, rparams, cfg, params = model
    toks = _tokens(cfg, 1, 20, 4)
    rlogits, _ = ref_lm.prefill(rcfg, rparams, jnp.asarray(toks), 8,
                                cache_dtype=jnp.float32)
    logits, cache = lm.prefill(cfg, params, torch.from_numpy(toks), 8,
                               cache_dtype=torch.float32)
    _close(logits, rlogits)
    assert "k" not in cache


def test_engine_eviction_permutes_nothing(model, monkeypatch):
    """An eviction round on an SSM cache leaves the state and the conv
    tail as they were, bit for bit, and lowers the live count."""
    _, _, cfg, params = model
    eng = engine.ServeEngine(cfg, params, ServeConfig(**SERVE))
    _, cache = lm.prefill(cfg, params, torch.from_numpy(_tokens(cfg, 2, 30,
                                                                 5)), 48,
                          cache_dtype=torch.float32)
    scores = torch.rand((2, 48))
    victims = torch.tensor([3, 9], dtype=torch.int32)
    new, _, live = eng._evict(cache, scores, victims, 30)
    assert live == 28 and set(new) == {"ssd", "conv"}
    for key in ("ssd", "conv"):
        assert torch.equal(new[key].view(torch.int32),
                           cache[key].view(torch.int32))


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", ARCH, "--smoke", "--evict", "--device",
                       "cpu", "--max-new", "24"]) == 0
    out = capsys.readouterr().out
    assert "evicted=" in out and "final_pos=" in out

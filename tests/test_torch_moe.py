"""The port's MoE family against the reference, on the CPU, in float32:
qwen2-moe-smoke (MoE every layer, top-2 of 6, renormalized, a shared
expert) and llama4-maverick-smoke (the period-2 interleave of a dense and
a MoE layer, top-1 of 8, a shared expert).

The reference's parameters are carried across with
``repro_torch.models.interop.params_from_reference``; tokens and
activations come from numpy seeds.  Tolerance: 1e-4 absolute and relative
on outputs, logits, caches, aux losses and attention mass, as in
``tests/test_torch_ssm_serve.py``: float32 on both sides with sums in
other orders, while a wrong expert, weight or dropped pair moves values by
O(1e-2).  One train step's loss and grad norm are held within 1e-5
relative, as in ``tests/test_torch_train.py``.  Tokens, ``final_pos``,
``evicted``, routing choices, capacities, layouts and dtypes are compared
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
from repro.models import moe as ref_moe
from repro.serve import engine as ref_engine
from repro.train import optimizer as ref_opt
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import build_train_step as ref_build_train_step
from repro_torch.configs import ServeConfig, TrainConfig, get_smoke_config
from repro_torch.models import interop, lm, moe
from repro_torch.serve import engine
from repro_torch.train import optimizer
from repro_torch.train.train_step import TrainState, build_train_step
from repro_torch.train.tree import leaves_with_path

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
ARCHS = ["qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"]
SERVE = dict(seq_len=48, batch=2, kv_cache_dtype="float32",
             eviction_enabled=True, eviction_budget=24, eviction_window=4,
             rmq_chunk=4, rmq_threshold=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, reference params, port cfg, port params)."""
    out = {}
    for arch in ARCHS:
        rcfg = ref_smoke_config(arch)
        rparams = ref_lm.init_params(rcfg, jax.random.PRNGKey(0))
        out[arch] = (rcfg, rparams, get_smoke_config(arch),
                     interop.params_from_reference(
                         jax.tree.map(np.asarray, rparams), device="cpu"))
    return out


def _moe_params(arch, rparams, params, layer=0):
    """One MoE layer's ``moe`` parameters in each package."""
    if arch.startswith("llama4"):
        return (jax.tree.map(lambda a: a[layer],
                             rparams["layers"]["moe"]["moe"]),
                params["layers"][layer]["moe"]["moe"])
    return (jax.tree.map(lambda a: a[layer], rparams["layers"]["moe"]),
            params["layers"][layer]["moe"])


def _tokens(cfg, batch, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, s)).astype(np.int32)


def _acts(cfg, t, seed):
    return np.random.default_rng(seed).standard_normal(
        (t, cfg.d_model)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("t", [40, 4096])
def test_moe_apply_matches_reference(models, arch, t):
    """Output and aux loss; at T = 4096 the capacity is a multiple of 128."""
    rcfg, rparams, cfg, params = models[arch]
    rp, p = _moe_params(arch, rparams, params)
    x = _acts(cfg, t, t)
    want, raux = ref_moe.moe_apply(rp, jnp.asarray(x), rcfg)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
    assert got.shape == (t, cfg.d_model) and aux.dtype == torch.float32
    _close(got, want)
    _close(aux, raux)
    assert moe.capacity(cfg, t) == ref_moe._capacity(rcfg, t)
    if t == 4096:
        assert moe.capacity(cfg, t) % 128 == 0


@pytest.mark.parametrize("t", [1, 4, 40, 4095, 4096, 8192, 70000])
def test_capacity_matches_reference(t):
    for arch in ARCHS:
        for cf in (0.25, 1.25, 15.0):
            rcfg = dataclasses.replace(ref_smoke_config(arch),
                                       capacity_factor=cf)
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      capacity_factor=cf)
            assert moe.capacity(cfg, t) == ref_moe._capacity(rcfg, t)


@pytest.mark.parametrize("arch", ARCHS)
def test_dropped_pairs_match_reference(models, arch):
    """``capacity_factor`` 0.25 on both sides: many pairs drop, and the
    output is the reference's only if the same pairs drop (the stable rank
    in (token, slot) order)."""
    rcfg, rparams, cfg, params = models[arch]
    rcfg = dataclasses.replace(rcfg, capacity_factor=0.25)
    cfg = dataclasses.replace(cfg, capacity_factor=0.25)
    rp, p = _moe_params(arch, rparams, params)
    x = _acts(cfg, 96, 3)
    want, _ = ref_moe.moe_apply(rp, jnp.asarray(x), rcfg)
    got, _ = moe.moe_apply(p, torch.from_numpy(x), cfg)
    _close(got, want)
    xt = torch.from_numpy(x)
    _, _, top_e = moe.route(p, xt, cfg)
    cap = moe.capacity(cfg, 96)
    _, dest, keep = moe.dispatch(xt, top_e, cap, cfg.num_experts)
    assert 0 < int((~keep).sum()) < keep.numel()
    # the kept pairs are each expert's first ``cap`` in (token, slot) order
    flat = top_e.reshape(-1)
    for e in range(cfg.num_experts):
        mine = torch.nonzero(flat == e).reshape(-1)
        assert bool(keep[mine[:cap]].all()) and not bool(
            keep[mine[cap:]].any())
        assert torch.equal(dest[mine[:cap]],
                           e * cap + torch.arange(len(mine[:cap])))
    assert bool((dest[~keep] == cfg.num_experts * cap - 1).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_go_to_the_lower_expert(models, arch):
    """Router columns made equal in pairs: every token's probabilities tie
    exactly, and the lower expert index wins, as ``jax.lax.top_k`` orders
    them.  ``torch.topk`` orders such ties otherwise on the CPU (the
    control)."""
    rcfg, rparams, cfg, params = models[arch]
    rp, p = _moe_params(arch, rparams, params)
    router = np.asarray(rp["router"]).copy()
    router[:, 1::2] = router[:, 0::2]
    rp = dict(rp, router=jnp.asarray(router))
    p = dict(p, router=torch.from_numpy(router))
    x = _acts(cfg, 64, 5)
    probs, _, top_e = moe.route(p, torch.from_numpy(x), cfg)
    logits = (jnp.asarray(x) @ rp["router"]).astype(jnp.float32)
    _, r_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                             cfg.num_experts_per_tok)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(r_e))
    assert bool((top_e[:, 0] % 2 == 0).all())
    if cfg.num_experts_per_tok > 1:
        assert torch.equal(top_e[:, 1], top_e[:, 0] + 1)
    assert not torch.equal(torch.topk(probs, 2).indices, torch.sort(
        probs, descending=True, stable=True).indices[:, :2])
    want, raux = ref_moe.moe_apply(rp, jnp.asarray(x), rcfg)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
    _close(got, want)
    _close(aux, raux)


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_carries_moe_layers(models, arch):
    _, rparams, cfg, params = models[arch]
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    period2 = arch.startswith("llama4")
    assert len(params["layers"]) == (cfg.num_layers // 2 if period2
                                     else cfg.num_layers)
    layer = params["layers"][1]
    if period2:
        assert set(layer) == {"dense", "moe"}
        assert set(layer["dense"]) == {"ln1", "attn", "mlp", "ln2"}
        layer = layer["moe"]
        rexp = rparams["layers"]["moe"]["moe"]
    else:
        rexp = rparams["layers"]["moe"]
    assert set(layer) == {"ln1", "attn", "ln2", "moe"}
    m = layer["moe"]
    assert set(m) == {"router", "w_gate", "w_up", "w_down", "shared",
                      "shared_gate"}
    assert m["router"].shape == (d, e)
    assert m["w_gate"].shape == m["w_up"].shape == (e, d, f)
    assert m["w_down"].shape == (e, f, d)
    assert m["shared_gate"].shape == (d, 1)
    assert m["shared"]["gate"]["w"].shape == (d, cfg.shared_expert_d_ff)
    np.testing.assert_array_equal(m["w_down"].numpy(),
                                  np.asarray(rexp["w_down"][1]))
    bf = interop.params_from_reference(jax.tree.map(np.asarray, rparams),
                                       device="cpu", dtype=torch.bfloat16)
    b1 = bf["layers"][1]["moe"] if period2 else bf["layers"][1]
    for name in ("router", "w_gate", "w_up", "w_down", "shared_gate"):
        assert b1["moe"][name].dtype == torch.bfloat16
    assert b1["ln2"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    cfg = get_smoke_config(arch)
    ours = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    ref = jax.eval_shape(lambda: ref_lm.init_params(
        ref_smoke_config(arch), jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(path): tuple(leaf.shape[1:])
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                ref["layers"])}
    got = {jax.tree_util.keystr(path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_leaves_with_path(
               ours["layers"][0])}
    assert got == want
    steps = jax.tree.leaves(ref["layers"])[0].shape[0]
    assert len(ours["layers"]) == steps
    count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    assert count == sum(t.numel() for _, t in leaves_with_path(ours))
    bf = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    m = bf["layers"][0]["moe"]
    m = m["moe"] if "moe" in m else m
    assert m["w_up"].dtype == m["router"].dtype == torch.bfloat16


def test_full_configs_count_as_published():
    """qwen2-moe-a2.7b: 14,315,487,232 parameters by ``num_params()``, the
    reference's count, and ``init_params`` makes that layout."""
    from repro.configs import get_config as ref_config
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-moe-a2.7b")
    assert cfg.num_params() == ref_config("qwen2-moe-a2.7b").num_params() \
        == 14_315_487_232
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_d_ff,
            cfg.shared_expert_d_ff) == (60, 4, 1408, 5632)
    assert moe.capacity(cfg, 4 * 2048) == 768
    assert moe.capacity(cfg, 4) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    """Logits, aux (the MoE layers' sum), hidden states, and the same with
    ``attn_impl="ref"``."""
    rcfg, rparams, cfg, params = models[arch]
    toks = _tokens(cfg, 2, 40, 1)
    want, raux = ref_lm.forward(rcfg, rparams, jnp.asarray(toks))
    got, aux = lm.forward(cfg, params, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and float(aux) > 0
    _close(got, want)
    _close(aux, raux)
    plain, paux = lm.forward(cfg, params, torch.from_numpy(toks),
                             attn_impl="ref")
    _close(plain, want)
    _close(paux, raux)
    rhidden, _ = ref_lm.forward(rcfg, rparams, jnp.asarray(toks),
                                return_hidden=True)
    hidden, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                           return_hidden=True)
    _close(hidden, rhidden)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_make_decode_cache_matches_reference(models, arch, dtype):
    rcfg, _, cfg, _ = models[arch]
    jdt, tdt = DTYPES[dtype]
    rcache = ref_lm.make_decode_cache(rcfg, 2, 48, dtype=jdt)
    cache = lm.make_decode_cache(cfg, 2, 48, dtype=tdt, device="cpu")
    assert set(cache) == set(rcache) == {"k", "v"}
    for key, val in cache.items():
        assert tuple(val.shape) == rcache[key].shape
        assert str(val.dtype).split(".")[-1] == str(rcache[key].dtype)
    assert cache["k"].shape[0] == cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(models, arch):
    """Prefill logits and cache, then three decode steps: logits, k / v,
    and the attention mass (qwen2's against the reference's; llama4's
    all zero, as the reference's period-2 step adds none)."""
    rcfg, rparams, cfg, params = models[arch]
    s, cache_len = 20, 32
    toks = _tokens(cfg, 2, s, 2)
    rlogits, rcache = ref_lm.prefill(rcfg, rparams, jnp.asarray(toks),
                                     cache_len, cache_dtype=jnp.float32)
    logits, cache = lm.prefill(cfg, params, torch.from_numpy(toks),
                               cache_len, cache_dtype=torch.float32)
    _close(logits, rlogits)
    for key in ("k", "v"):
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
        for key in ("k", "v"):
            _close(cache[key], rcache[key])
        assert tuple(mass.shape) == rmass.shape == (2, cache_len)
        _close(mass, rmass)
        if arch.startswith("llama4"):
            assert not bool(mass.any()) and not np.asarray(rmass).any()
        else:
            assert float(mass[:, :pos + 1].sum()) > 0
        token = np.argmax(np.asarray(rlogits), axis=-1).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_prefill(models, arch):
    """Prefill of 30 then decode at 30-33 equals a 34-token forward at
    those positions (no pair drops: capacity_factor E / k)."""
    _, _, cfg, params = models[arch]
    cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    toks = torch.from_numpy(_tokens(cfg, 2, 34, 7))
    full, _ = lm.forward(cfg, params, toks)
    _, cache = lm.prefill(cfg, params, toks[:, :30], 40,
                          cache_dtype=torch.float32)
    for pos in range(30, 34):
        logits, cache, _ = lm.decode_step(cfg, params, toks[:, pos], cache,
                                          pos)
        torch.testing.assert_close(logits, full[:, pos], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("evict", [True, False])
def test_generate_matches_reference(models, arch, evict):
    """Tokens, final_pos and evicted: 35 without eviction, 24 / 11 with
    (qwen2 by its attention mass, llama4 by position)."""
    rcfg, rparams, cfg, params = models[arch]
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
    assert (got["final_pos"], got["evicted"]) == ((24, 11) if evict
                                                  else (35, 0))


def test_eviction_permutes_a_period2_cache_along_its_positions(models):
    """A llama4 cache holds 2 x steps layers; eviction permutes axis 3."""
    _, _, cfg, params = models["llama4-maverick-400b-a17b"]
    eng = engine.ServeEngine(cfg, params, ServeConfig(**SERVE))
    _, cache = lm.prefill(cfg, params,
                          torch.from_numpy(_tokens(cfg, 2, 30, 5)), 48,
                          cache_dtype=torch.float32)
    keep = {k: v.clone() for k, v in cache.items()}
    victims = torch.tensor([3, 9], dtype=torch.int32)
    new, _, live = eng._evict(cache, torch.rand((2, 48)), victims, 30)
    assert live == 28 and new["k"].shape[0] == cfg.num_layers
    order = [i for i in range(30) if i not in (3, 9)] + list(range(30, 48))
    order += [3, 9]
    for key in ("k", "v"):
        assert torch.equal(new[key], keep[key][:, :, :, order])


def _ref_step(arch, rparams, rtc, toks):
    rcfg = ref_smoke_config(arch)
    state = RefTrainState(params=rparams,
                          opt=ref_opt.adamw_init(rparams,
                                                 rtc.optimizer_state_dtype),
                          step=jnp.zeros((), jnp.int32))
    return jax.jit(ref_build_train_step(rcfg, rtc))(
        state, {"tokens": jnp.asarray(toks)})


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_the_reference(models, arch):
    """Step 0 of ``build_train_step``: loss, aux loss and grad norm within
    1e-5 relative (the minimized loss is their sum), and the counter."""
    _, rparams, cfg, _ = models[arch]
    tc = TrainConfig(warmup_steps=1, total_steps=10, remat_policy="full",
                     grad_allreduce_dtype="float32")
    toks = _tokens(cfg, 2, 40, 5)
    _, rm = _ref_step(arch, rparams, RefTrainConfig(**dataclasses.asdict(tc)),
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
    for key in ("loss", "aux_loss", "grad_norm"):
        assert float(m[key]) == pytest.approx(float(rm[key]), rel=LOSS_RTOL)
    assert float(m["aux_loss"]) > 0
    assert int(state.step) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", arch, "--smoke", "--evict", "--device",
                       "cpu", "--max-new", "24"]) == 0
    out = capsys.readouterr().out
    assert "evicted=" in out and "final_pos=" in out

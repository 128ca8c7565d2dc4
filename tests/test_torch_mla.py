"""The port's MLA family (minicpm3) against the reference, on the CPU, in
float32 (``minicpm3-smoke``: 3 layers, d_model 64, 4 heads, q / kv ranks
32 / 16, head dims 16 + 8 / 16, tied embeddings).

The reference's parameters are carried across with
``repro_torch.models.interop.params_from_reference``; tokens, activations
and caches come from numpy seeds.  Tolerance: 1e-4 absolute and relative
on outputs, logits, caches and attention mass, ``TOL`` of
``tests/test_torch_lm.py``: float32 on both sides with sums in other
orders, while a wrong rope, scale, cache slot or latent product moves
values by O(1e-2).  One train step's loss and grad norm are held within
1e-5 relative, as in ``tests/test_torch_train.py``.  Tokens,
``final_pos``, ``evicted``, routes, layouts and dtypes are compared
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
from repro.kernels.flash_attention import ops as ref_attn_ops
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro.train import optimizer as ref_opt
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import build_train_step as ref_build_train_step
from repro_torch.configs import ServeConfig, TrainConfig, get_smoke_config
from repro_torch.models import interop, layers, lm
from repro_torch.serve import engine
from repro_torch.train import optimizer
from repro_torch.train.train_step import TrainState, build_train_step
from repro_torch.train.tree import leaves_with_path

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
ARCH = "minicpm3-4b"
SERVE = dict(seq_len=48, batch=2, kv_cache_dtype="float32",
             eviction_enabled=True, eviction_budget=24, eviction_window=4,
             rmq_chunk=4, rmq_threshold=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_KEYS = {"q_a", "q_a_norm", "q_b", "kv_a", "kv_a_norm", "kv_b", "o"}


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params)."""
    rcfg = ref_smoke_config(ARCH)
    rparams = ref_lm.init_params(rcfg, jax.random.PRNGKey(0))
    return (rcfg, rparams, get_smoke_config(ARCH),
            interop.params_from_reference(jax.tree.map(np.asarray, rparams),
                                          device="cpu"))


def _layer0(rparams, params):
    return (jax.tree.map(lambda a: a[0], rparams["layers"]["attn"]),
            params["layers"][0]["attn"])


def _tokens(cfg, batch, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, s)).astype(np.int32)


def _acts(cfg, batch, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, s, cfg.d_model)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


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
    assert set(ours["layers"][0]["attn"]) == ATTN_KEYS
    assert len(ours["layers"]) == cfg.num_layers
    assert "lm_head" not in ours and "lm_head" not in ref
    count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    assert count == sum(t.numel() for _, t in leaves_with_path(ours))
    attn = lm.init_params(cfg, seed=0, device="cpu",
                          dtype=torch.bfloat16)["layers"][0]["attn"]
    for name in ("q_a", "q_b", "kv_a", "kv_b", "o"):
        assert attn[name]["w"].dtype == torch.bfloat16
    for name in ("q_a_norm", "kv_a_norm"):
        assert attn[name]["scale"].dtype == torch.float32


def test_full_config_counts_as_published():
    """minicpm3-4b: 4,073,492,480 parameters by ``num_params()`` on both
    sides (no norm scales, the unpadded vocab); the reference's tree holds
    4,073,937,408 (the 62 x 6144 + 2560 norm scales and 24 padded vocab
    rows more), and the port's tree has its layout (the test above)."""
    from repro.configs import get_config as ref_config
    from repro_torch.configs import get_config

    cfg = get_config(ARCH)
    assert cfg.num_params() == ref_config(ARCH).num_params() \
        == 4_073_492_480
    tree = jax.eval_shape(lambda: ref_lm.init_params(
        ref_config(ARCH), jax.random.PRNGKey(0)))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree)) \
        == 4_073_937_408
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff,
            cfg.padded_vocab) == (62, 2560, 40, 6400, 73472)
    assert (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_head_dim,
            cfg.qk_rope_head_dim, cfg.v_head_dim) == (768, 256, 64, 32, 64)


def test_interop_carries_the_mla_tree(model):
    """Every MLA leaf carried value for value; matrices in the asked dtype,
    the two norm scales in float32."""
    _, rparams, cfg, params = model
    rp, p = _layer0(rparams, params)
    assert set(p) == ATTN_KEYS
    flat = {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(rp)}
    got = {jax.tree_util.keystr(path): leaf.numpy()
           for path, leaf in jax.tree_util.tree_leaves_with_path(p)}
    assert set(got) == set(flat)
    for key, want in flat.items():
        np.testing.assert_array_equal(got[key], want)
    bf = interop.params_from_reference(jax.tree.map(np.asarray, rparams),
                                       device="cpu", dtype=torch.bfloat16)
    attn = bf["layers"][2]["attn"]
    assert attn["kv_b"]["w"].dtype == attn["q_a"]["w"].dtype \
        == torch.bfloat16
    assert attn["q_a_norm"]["scale"].dtype == torch.float32
    assert attn["kv_a_norm"]["scale"].dtype == torch.float32
    assert attn["kv_b"]["w"].shape == (
        cfg.kv_lora_rank,
        cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim))


@pytest.fixture
def routes_taken(monkeypatch):
    """Records which plain attention each side calls (and that the
    reference never reaches its flash kernel)."""
    seen = {"reference": [], "port": []}

    def spy(side, name, fn):
        def wrapped(*args, **kwargs):
            seen[side].append(name)
            return fn(*args, **kwargs)
        return wrapped

    for name in ("blocked_attention", "attention_ref"):
        monkeypatch.setattr(ref_attn_ops, name, spy(
            "reference", name, getattr(ref_attn_ops, name)))
        monkeypatch.setattr(layers, name, spy("port", name,
                                              getattr(layers, name)))
    monkeypatch.setattr(ref_attn_ops.K, "flash_attention", spy(
        "reference", "flash_attention", ref_attn_ops.K.flash_attention))
    return seen


ROUTES = {"blocked": "blocked_attention", "ref": "attention_ref"}


@pytest.mark.parametrize("s,route", [(48, "ref"), (2048, "blocked")])
def test_mla_attention_matches_reference(model, routes_taken, s, route):
    """Output, the cache payload (latent, shared rope key) and the
    attention mass: S 48 takes the dense route on both sides, S 2048 the
    blocked one (read from the calls)."""
    rcfg, rparams, cfg, params = model
    rp, p = _layer0(rparams, params)
    x = _acts(cfg, 1, s, s)
    pos = np.arange(s, dtype=np.int32)
    want, (rlat, rrope), rmass = ref_layers.mla_attention(
        rp, jnp.asarray(x), rcfg, jnp.asarray(pos), return_probs_sum=True)
    got, (lat, rope), mass = layers.mla_attention(
        p, torch.from_numpy(x), cfg, torch.from_numpy(pos),
        return_probs_sum=True)
    assert routes_taken == {"reference": [ROUTES[route]],
                            "port": [ROUTES[route]]}
    assert layers.mla_route(s, on_card=False) == route
    assert lat.shape == (1, s, cfg.kv_lora_rank)
    assert rope.shape == (1, s, cfg.qk_rope_head_dim)
    _close(got, want)
    _close(lat, rlat)
    _close(rope, rrope)
    _close(mass, rmass)
    assert layers.mla_attention(p, torch.from_numpy(x), cfg,
                                torch.from_numpy(pos))[2] is None


@pytest.mark.parametrize("s,cpu,card", [
    (48, "ref", "ref"), (512, "ref", "blocked"), (2040, "ref", "ref"),
    (2048, "blocked", "blocked"), (4096, "blocked", "blocked")])
def test_mla_route_is_the_references(model, routes_taken, s, cpu, card):
    """The route by shape: the reference's ``attention`` with a query head
    dim (24) unlike the value's (16) calls the plain function that
    ``mla_route`` names, ``impl="auto"`` off its accelerator as the CPU,
    ``impl="pallas"`` (its accelerator's) as the card; it never reaches
    the flash kernel.  The port's ``mla_attention`` on the CPU calls the
    CPU's."""
    _, _, cfg, params = model
    assert layers.mla_route(s, on_card=False) == cpu
    assert layers.mla_route(s, on_card=True) == card
    dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    q = jnp.zeros((1, 1, s, dqk))
    v = jnp.zeros((1, 1, s, cfg.v_head_dim))
    ref_attn_ops.attention(q, q, v, scale=dqk ** -0.5)
    ref_attn_ops.attention(q, q, v, scale=dqk ** -0.5, impl="pallas",
                           interpret=True)
    layers.mla_attention(params["layers"][0]["attn"],
                         torch.from_numpy(_acts(cfg, 1, s, 3)), cfg,
                         torch.arange(s, dtype=torch.int32))
    assert routes_taken == {"reference": [ROUTES[cpu], ROUTES[card]],
                            "port": [ROUTES[cpu]]}


def test_mla_decode_matches_reference(model):
    """One absorbed decode step at position 29 of a 40-slot cache filled
    from a seed: output and both cache tensors."""
    rcfg, rparams, cfg, params = model
    rp, p = _layer0(rparams, params)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    lat = rng.standard_normal((2, 40, cfg.kv_lora_rank)).astype(np.float32)
    rope = rng.standard_normal((2, 40, cfg.qk_rope_head_dim)).astype(
        np.float32)
    want, (rlat, rrope) = ref_layers.mla_decode(
        rp, jnp.asarray(x), rcfg, (jnp.asarray(lat), jnp.asarray(rope)), 29)
    c_lat, c_rope = torch.from_numpy(lat.copy()), torch.from_numpy(
        rope.copy())
    got, (nlat, nrope) = layers.mla_decode(p, torch.from_numpy(x), cfg,
                                           (c_lat, c_rope), 29)
    assert nlat is c_lat and nrope is c_rope
    _close(got, want)
    _close(nlat, rlat)
    _close(nrope, rrope)
    assert not np.array_equal(nlat[:, 29].numpy(), lat[:, 29])
    np.testing.assert_array_equal(nlat[:, 30:].numpy(), lat[:, 30:])


def test_mla_decode_equals_the_materialized_attention(model):
    """The absorbed algebra: decode at positions 40-47 over the cache that
    ``mla_attention`` filled equals the materialized output's rows there;
    with the cache's rope keys zeroed (the control) it does not."""
    _, _, cfg, params = model
    p = params["layers"][1]["attn"]
    x = torch.from_numpy(_acts(cfg, 2, 48, 9))
    full, (lat, rope), _ = layers.mla_attention(
        p, x, cfg, torch.arange(48, dtype=torch.int32))
    scale = float(full.abs().max())
    for zero_rope in (False, True):
        c_lat, c_rope = torch.zeros((2, 56, cfg.kv_lora_rank)), torch.zeros(
            (2, 56, cfg.qk_rope_head_dim))
        c_lat[:, :40], c_rope[:, :40] = lat[:, :40], rope[:, :40]
        if zero_rope:
            c_rope.zero_()
        rows = [layers.mla_decode(p, x[:, pos:pos + 1], cfg, (c_lat, c_rope),
                                  pos)[0] for pos in range(40, 48)]
        err = float((torch.cat(rows, dim=1) - full[:, 40:]).abs().max())
        if zero_rope:
            assert err > 1e-2 * scale
        else:
            assert err <= 1e-5 * scale
            torch.testing.assert_close(c_lat[:, :48], lat, **TOL)
            torch.testing.assert_close(c_rope[:, :48], rope, **TOL)


def test_forward_matches_reference(model):
    """Logits and hidden states; ``attn_impl`` does not reach MLA."""
    rcfg, rparams, cfg, params = model
    toks = _tokens(cfg, 2, 40, 1)
    want, raux = ref_lm.forward(rcfg, rparams, jnp.asarray(toks))
    got, aux = lm.forward(cfg, params, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 40,
                                                         cfg.padded_vocab)
    _close(got, want)
    assert float(aux) == float(raux) == 0.0
    plain, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                          attn_impl="ref")
    assert torch.equal(plain, got)
    rhidden, _ = ref_lm.forward(rcfg, rparams, jnp.asarray(toks),
                                return_hidden=True)
    hidden, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                           return_hidden=True)
    _close(hidden, rhidden)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_make_decode_cache_matches_reference(model, dtype):
    rcfg, _, cfg, _ = model
    jdt, tdt = DTYPES[dtype]
    rcache = ref_lm.make_decode_cache(rcfg, 2, 48, dtype=jdt)
    cache = lm.make_decode_cache(cfg, 2, 48, dtype=tdt, device="cpu")
    assert set(cache) == set(rcache) == {"latent", "rope"}
    for key, val in cache.items():
        assert tuple(val.shape) == rcache[key].shape
        assert str(val.dtype).split(".")[-1] == str(rcache[key].dtype)
        assert not bool(val.any())
    assert cache["latent"].shape == (cfg.num_layers, 2, 48,
                                     cfg.kv_lora_rank)


def test_prefill_and_decode_match_reference(model):
    """Prefill logits and the latent cache (zero past S), then three
    decode steps: logits, ``latent`` / ``rope``, and no mass on either
    side."""
    rcfg, rparams, cfg, params = model
    s, cache_len = 20, 32
    toks = _tokens(cfg, 2, s, 2)
    rlogits, rcache = ref_lm.prefill(rcfg, rparams, jnp.asarray(toks),
                                     cache_len, cache_dtype=jnp.float32)
    logits, cache = lm.prefill(cfg, params, torch.from_numpy(toks),
                               cache_len, cache_dtype=torch.float32)
    assert set(cache) == set(rcache) == {"latent", "rope"}
    _close(logits, rlogits)
    for key in ("latent", "rope"):
        _close(cache[key], rcache[key])
        assert not bool(cache[key][:, :, s:].any())
        assert bool(cache[key][:, :, :s].any())
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
        for key in ("latent", "rope"):
            _close(cache[key], rcache[key])
        token = np.argmax(np.asarray(rlogits), axis=-1).astype(np.int32)


def test_decode_continues_prefill(model):
    """Prefill of 30 then decode at 30-33 equals a 34-token forward at
    those positions; a decode past the cache's last slot raises."""
    _, _, cfg, params = model
    toks = torch.from_numpy(_tokens(cfg, 2, 34, 7))
    full, _ = lm.forward(cfg, params, toks)
    _, cache = lm.prefill(cfg, params, toks[:, :30], 34,
                          cache_dtype=torch.float32)
    for pos in range(30, 34):
        logits, cache, _ = lm.decode_step(cfg, params, toks[:, pos], cache,
                                          pos)
        torch.testing.assert_close(logits, full[:, pos], **TOL)
    with pytest.raises(IndexError):
        lm.decode_step(cfg, params, toks[:, 0], cache, 34)


@pytest.mark.parametrize("evict", [True, False])
def test_generate_matches_reference(model, evict):
    """Tokens, final_pos and evicted: 35 without eviction, 24 / 11 with
    (by position: MLA adds no mass on either side)."""
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
    assert (got["final_pos"], got["evicted"]) == ((24, 11) if evict
                                                  else (35, 0))


def test_eviction_permutes_latent_and_rope_along_axis_2(model):
    """``_evict`` moves the latent cache's rows as the reference does: kept
    live rows, the old tail, then the victims."""
    rcfg, rparams, cfg, params = model
    eng = engine.ServeEngine(cfg, params, ServeConfig(**SERVE))
    _, cache = lm.prefill(cfg, params,
                          torch.from_numpy(_tokens(cfg, 2, 30, 5)), 48,
                          cache_dtype=torch.float32)
    keep = {k: v.clone() for k, v in cache.items()}
    scores = np.random.default_rng(6).random((2, 48)).astype(np.float32)
    victims = np.array([3, 9, 17], dtype=np.int32)
    new, new_scores, live = eng._evict(cache, torch.from_numpy(scores),
                                       torch.from_numpy(victims), 30)
    assert live == 27 and set(new) == {"latent", "rope"}
    order = [i for i in range(30) if i not in (3, 9, 17)]
    order += list(range(30, 48)) + [3, 9, 17]
    for key in ("latent", "rope"):
        assert torch.equal(new[key], keep[key][:, :, order])
    ref = ref_engine.ServeEngine(rcfg, rparams, RefServeConfig(**SERVE))
    rnew, rscores, rlive = ref._evict(
        {k: jnp.asarray(v.numpy()) for k, v in keep.items()},
        jnp.asarray(scores), jnp.asarray(victims), 30)
    assert rlive == live
    for key in ("latent", "rope"):
        np.testing.assert_array_equal(new[key].numpy(), np.asarray(rnew[key]))
    np.testing.assert_array_equal(new_scores.numpy(), np.asarray(rscores))


def _ref_step(rparams, rtc, toks):
    rcfg = ref_smoke_config(ARCH)
    state = RefTrainState(params=rparams,
                          opt=ref_opt.adamw_init(rparams,
                                                 rtc.optimizer_state_dtype),
                          step=jnp.zeros((), jnp.int32))
    return jax.jit(ref_build_train_step(rcfg, rtc))(
        state, {"tokens": jnp.asarray(toks)})


def _port_step(cfg, rparams, tc, toks):
    params = interop.params_from_reference(jax.tree.map(np.asarray,
                                                        rparams),
                                           device="cpu")
    state = TrainState(params=params,
                       opt=optimizer.adamw_init(params,
                                                tc.optimizer_state_dtype),
                       step=torch.zeros((), dtype=torch.int32))
    return build_train_step(cfg, tc)(state,
                                     {"tokens": torch.from_numpy(toks)})


def test_one_train_step_matches_the_reference(model):
    """Step 0 of ``build_train_step`` through MLA's plain attention: loss
    and grad norm within 1e-5 relative, and the step counter."""
    _, rparams, cfg, _ = model
    tc = TrainConfig(warmup_steps=1, total_steps=10, remat_policy="full",
                     grad_allreduce_dtype="float32")
    toks = _tokens(cfg, 2, 40, 5)
    _, rm = _ref_step(rparams, RefTrainConfig(**dataclasses.asdict(tc)),
                      toks)
    state, m = _port_step(cfg, rparams, tc, toks)
    for key in ("loss", "grad_norm"):
        assert float(m[key]) == pytest.approx(float(rm[key]),
                                              rel=LOSS_RTOL)
    assert int(state.step) == 1


@pytest.mark.parametrize("remat,chunk", [("names", 0), ("minimal", 0),
                                         ("full", 8), ("none", 8)])
def test_remat_policies_and_chunked_loss_take_mla(model, remat, chunk):
    """Each remat policy and the chunked loss give the step of
    ``remat="none"`` with the whole loss (1e-5 relative): MLA's attention
    is plain PyTorch, which autograd differentiates directly."""
    _, rparams, cfg, _ = model
    toks = _tokens(cfg, 2, 40, 8)
    base = dict(warmup_steps=1, total_steps=10,
                grad_allreduce_dtype="float32")
    _, want = _port_step(cfg, rparams, TrainConfig(remat_policy="none",
                                                   **base), toks)
    _, got = _port_step(cfg, rparams, TrainConfig(
        remat_policy=remat, loss_chunk=chunk, **base), toks)
    for key in ("loss", "grad_norm"):
        assert float(got[key]) == pytest.approx(float(want[key]),
                                                rel=LOSS_RTOL)


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", ARCH, "--smoke", "--evict", "--device",
                       "cpu", "--max-new", "24"]) == 0
    out = capsys.readouterr().out
    assert "evicted=" in out and "final_pos=" in out


def test_launch_train_on_the_cpu(tmp_path):
    """Two steps from ``SyntheticTokenDataset`` batches; finite losses;
    ``--model-parallel 2`` in one process (the (1, 1) mesh, the
    reference's rule on one device) trains with the same losses."""
    from repro_torch.launch import train

    args = ["--arch", ARCH, "--smoke", "--steps", "2", "--seq-len", "16",
            "--global-batch", "2", "--device", "cpu", "--checkpoint-every",
            "0", "--checkpoint-dir", str(tmp_path), "--log-every", "1"]
    out = train.run(train.parse_args(args))
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    mp = train.run(train.parse_args(args + ["--model-parallel", "2"]))
    assert mp["losses"] == out["losses"]

"""The port's frontend trunks against the reference, on the CPU, in
float32: internvl2-smoke (a 16-position vision prefix, GQA 4 over 2) and
musicgen-smoke (an 8-position conditioning prefix, MHA).

The prefix is the reference's ``synthetic_frontend_embeddings``, passed as
numpy into both packages (the port's own stand-ins come from a
``torch.Generator`` and cannot repeat ``jax.random``'s bits).  Parameters
are carried across with ``params_from_reference``; tokens come from numpy
seeds.  Tolerance: 1e-4 absolute and relative on logits, caches and
attention mass, as in ``tests/test_torch_ssm_serve.py``; one train step's
loss and grad norm within 1e-5 relative, as in
``tests/test_torch_train.py``.  Tokens, ``final_pos``, ``evicted``, shapes
and dtypes are compared exactly.  As in the reference, a frontend model's
first decode position is F past the prompt whether or not a prefix is
passed.
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
from repro.models import frontends as ref_frontends
from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro.train import optimizer as ref_opt
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import build_train_step as ref_build_train_step
from repro_torch.configs import ServeConfig, TrainConfig, get_smoke_config
from repro_torch.models import frontends, interop, lm
from repro_torch.serve import engine
from repro_torch.train import optimizer
from repro_torch.train.train_step import TrainState, build_train_step

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
ARCHS = ["internvl2-2b", "musicgen-medium"]
SERVE = dict(seq_len=48, batch=2, kv_cache_dtype="float32",
             eviction_enabled=True, eviction_budget=24, eviction_window=4,
             rmq_chunk=4, rmq_threshold=2)
# generate without eviction: F + 20 + 15 positions, the launcher's cache
# rule (F + prompt + new + 8) sizes the cache to hold them
NO_EVICT_LEN = 60
WANT = {  # (final_pos, evicted) without and with eviction
    "internvl2-2b": ((51, 0), (24, 27)),
    "musicgen-medium": ((43, 0), (24, 19)),
}


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, reference params, port cfg, port params,
    the reference's synthetic prefix for a batch of 2 as numpy)."""
    out = {}
    for arch in ARCHS:
        rcfg = ref_smoke_config(arch)
        rparams = ref_lm.init_params(rcfg, jax.random.PRNGKey(0))
        prefix = np.array(ref_frontends.synthetic_frontend_embeddings(
            rcfg, 2))
        out[arch] = (rcfg, rparams, get_smoke_config(arch),
                     interop.params_from_reference(
                         jax.tree.map(np.asarray, rparams), device="cpu"),
                     prefix)
    return out


def _tokens(cfg, batch, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, s)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("arch", ARCHS + ["llama3.2-3b", "mamba2-1.3b"])
@pytest.mark.parametrize("batch", [1, 3])
def test_frontend_embeddings_match_the_reference_shape(arch, batch):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    want = ref_frontends.frontend_embedding_shape(rcfg, batch)
    assert frontends.frontend_embedding_shape(cfg, batch) == want
    emb = frontends.synthetic_frontend_embeddings(cfg, batch, seed=3,
                                                  device="cpu")
    if want is None:
        assert emb is None
        return
    assert tuple(emb.shape) == want and emb.dtype == torch.float32
    again = frontends.synthetic_frontend_embeddings(cfg, batch, seed=3,
                                                    device="cpu")
    assert torch.equal(emb, again)
    assert 0.01 < float(emb.std()) < 0.03


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_prefix_matches_reference(models, arch):
    """Logits over F + S positions with the prefix (and with
    ``attn_impl="ref"``), over S without it; aux 0."""
    rcfg, rparams, cfg, params, prefix = models[arch]
    toks = _tokens(cfg, 2, 24, 1)
    want, raux = ref_lm.forward(rcfg, rparams, jnp.asarray(toks),
                                prefix_embeddings=jnp.asarray(prefix))
    got, aux = lm.forward(cfg, params, torch.from_numpy(toks),
                          prefix_embeddings=torch.from_numpy(prefix))
    assert tuple(got.shape) == (2, cfg.frontend_tokens + 24,
                                cfg.padded_vocab)
    assert float(aux) == float(raux) == 0.0
    _close(got, want)
    plain, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                          attn_impl="ref",
                          prefix_embeddings=torch.from_numpy(prefix))
    _close(plain, want)
    bare, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    rbare, _ = ref_lm.forward(rcfg, rparams, jnp.asarray(toks))
    assert tuple(bare.shape) == (2, 24, cfg.padded_vocab)
    _close(bare, rbare)
    # the prefix matters: zeroed, the token positions leave the reference
    zeroed, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                           prefix_embeddings=torch.zeros(prefix.shape))
    f = cfg.frontend_tokens
    assert float(np.abs(zeroed[:, f:].numpy()
                        - np.asarray(want)[:, f:]).max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_with_prefix_match_reference(models, arch):
    """Prefill of F + 20 positions, then three decode steps from F + 20:
    logits, k / v and the attention mass."""
    rcfg, rparams, cfg, params, prefix = models[arch]
    s, cache_len = 20, 48
    f = cfg.frontend_tokens
    toks = _tokens(cfg, 2, s, 2)
    rlogits, rcache = ref_lm.prefill(rcfg, rparams, jnp.asarray(toks),
                                     cache_len,
                                     prefix_embeddings=jnp.asarray(prefix),
                                     cache_dtype=jnp.float32)
    logits, cache = lm.prefill(cfg, params, torch.from_numpy(toks),
                               cache_len, cache_dtype=torch.float32,
                               prefix_embeddings=torch.from_numpy(prefix))
    _close(logits, rlogits)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == rcache[key].shape
        _close(cache[key], rcache[key])
    assert float(cache["k"][:, :, :, f + s:].abs().max()) == 0.0
    token = np.argmax(np.asarray(rlogits), axis=-1).astype(np.int32)
    for pos in (f + s, f + s + 1, f + s + 2):
        rlogits, rcache, rmass = ref_lm.decode_step(
            rcfg, rparams, jnp.asarray(token), rcache, pos,
            return_attn_mass=True)
        logits, cache, mass = lm.decode_step(
            cfg, params, torch.from_numpy(token), cache, pos,
            return_attn_mass=True)
        _close(logits, rlogits)
        for key in ("k", "v"):
            _close(cache[key], rcache[key])
        _close(mass, rmass)
        token = np.argmax(np.asarray(rlogits), axis=-1).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_refuses_a_cache_without_room_for_the_prefix(models, arch):
    _, _, cfg, params, prefix = models[arch]
    toks = torch.from_numpy(_tokens(cfg, 2, 20, 2))
    with pytest.raises(ValueError, match="exceeds cache_len"):
        lm.prefill(cfg, params, toks, 20 + cfg.frontend_tokens - 1,
                   prefix_embeddings=torch.from_numpy(prefix))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_a_prefixed_prefill(models, arch):
    """Prefill of F + 30 then decode at F + 30..F + 33 equals a forward of
    F + 34 positions at those positions."""
    _, _, cfg, params, prefix = models[arch]
    f = cfg.frontend_tokens
    toks = torch.from_numpy(_tokens(cfg, 2, 34, 7))
    pre = torch.from_numpy(prefix)
    full, _ = lm.forward(cfg, params, toks, prefix_embeddings=pre)
    _, cache = lm.prefill(cfg, params, toks[:, :30], f + 40,
                          cache_dtype=torch.float32, prefix_embeddings=pre)
    for i in range(30, 34):
        logits, cache, _ = lm.decode_step(cfg, params, toks[:, i], cache,
                                          f + i)
        torch.testing.assert_close(logits, full[:, f + i], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("evict", [True, False])
@pytest.mark.parametrize("with_prefix", [True, False])
def test_generate_matches_reference(models, arch, evict, with_prefix):
    """Tokens, final_pos and evicted, with and without the prefix; the
    first position is F + 20 either way."""
    rcfg, rparams, cfg, params, prefix = models[arch]
    prompts = _tokens(cfg, 2, 20, 1)
    sc = dict(SERVE, eviction_enabled=evict,
              seq_len=SERVE["seq_len"] if evict else NO_EVICT_LEN)
    want = ref_engine.ServeEngine(rcfg, rparams, RefServeConfig(**sc)
                                  ).generate(
        jnp.asarray(prompts), 16,
        prefix_embeddings=jnp.asarray(prefix) if with_prefix else None)
    got = engine.ServeEngine(cfg, params, ServeConfig(**sc)).generate(
        torch.from_numpy(prompts), 16,
        prefix_embeddings=torch.from_numpy(prefix) if with_prefix else None)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert (got["final_pos"], got["evicted"]) == (want["final_pos"],
                                                  want["evicted"])
    assert (got["final_pos"], got["evicted"]) == WANT[arch][evict]


def _ref_step(arch, rparams, rtc, toks, prefix):
    rcfg = ref_smoke_config(arch)
    state = RefTrainState(params=rparams,
                          opt=ref_opt.adamw_init(rparams,
                                                 rtc.optimizer_state_dtype),
                          step=jnp.zeros((), jnp.int32))
    return jax.jit(ref_build_train_step(rcfg, rtc))(
        state, {"tokens": jnp.asarray(toks), "prefix": jnp.asarray(prefix)})


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("microbatches", [1, 2])
def test_one_train_step_with_a_prefix_matches_the_reference(
        models, arch, microbatches):
    """Step 0 on a ``{"tokens", "prefix"}`` batch: the loss skips the F
    prefix positions; loss and grad norm within 1e-5 relative."""
    _, rparams, cfg, _, _ = models[arch]
    tc = TrainConfig(warmup_steps=1, total_steps=10, remat_policy="full",
                     grad_allreduce_dtype="float32",
                     microbatches=microbatches)
    toks = _tokens(cfg, 2, 24, 5)
    prefix = np.random.default_rng(6).standard_normal(
        (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32) * 0.02
    _, rm = _ref_step(arch, rparams, RefTrainConfig(**dataclasses.asdict(tc)),
                      toks, prefix)
    params = interop.params_from_reference(jax.tree.map(np.asarray,
                                                        rparams),
                                           device="cpu")
    state = TrainState(params=params,
                       opt=optimizer.adamw_init(params,
                                                tc.optimizer_state_dtype),
                       step=torch.zeros((), dtype=torch.int32))
    state, m = build_train_step(cfg, tc)(
        state, {"tokens": torch.from_numpy(toks),
                "prefix": torch.from_numpy(prefix)})
    for key in ("loss", "grad_norm"):
        assert float(m[key]) == pytest.approx(float(rm[key]), rel=LOSS_RTOL)
    assert float(m["aux_loss"]) == 0.0
    assert int(state.step) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", arch, "--smoke", "--evict", "--device",
                       "cpu", "--max-new", "24"]) == 0
    out = capsys.readouterr().out
    assert "evicted=" in out and "final_pos=" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_on_the_cpu(arch, tmp_path):
    """Two steps from ``SyntheticTokenDataset`` batches with a prefix;
    finite losses."""
    from repro_torch.launch import train

    out = train.run(train.parse_args([
        "--arch", arch, "--smoke", "--steps", "2", "--seq-len", "16",
        "--global-batch", "2", "--device", "cpu", "--checkpoint-every", "0",
        "--checkpoint-dir", str(tmp_path), "--log-every", "1"]))
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()

"""The port's serving path against the reference, on the CPU.

Mirrors ``tests/test_serve.py`` (``TestEvictionManager``,
``TestStreamingEviction``, the eviction engine): every victim set must be
equal to the reference's on the same scores (argmin is exact, tolerance
0), and ``ServeEngine.generate`` with eviction on ``llama3.2-smoke``
(parameters carried across) must give the reference's tokens,
``final_pos`` and ``evicted`` with the same victims in every round.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServeConfig as RefServeConfig
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import init_params as ref_init_params
from repro.serve import engine as ref_engine_mod
from repro.serve.eviction import RMQEvictionManager as RefManager
from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.models import interop
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.eviction import RMQEvictionManager

MANAGERS = [  # (budget, protected_window, c, t): tests/test_serve.py's
    (40, 8, 8, 4),
    (92, 4, 8, 4),
    (43, 40, 8, 4),
    (30, 4, 8, 4),
    (48, 16, 16, 4),
]


def _both(budget, protected, c, t):
    kw = dict(budget=budget, protected_window=protected, c=c, t=t)
    return RefManager(**kw), RMQEvictionManager(**kw)


def _victims(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("budget,protected,c,t", MANAGERS)
@pytest.mark.parametrize("live", [45, 50, 100])
def test_one_shot_victims_equal_reference(budget, protected, c, t, live):
    ref, port = _both(budget, protected, c, t)
    rng = np.random.default_rng(live + budget)
    scores = rng.random(live).astype(np.float32)
    scores[rng.integers(0, live, live // 4)] = 0.25   # ties: leftmost wins
    want = np.asarray(ref.plan_evictions(jnp.asarray(scores), live))
    got = port.plan_evictions(torch.from_numpy(scores), live)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_victims(got), want)


def test_keeps_high_scores_evicts_low():
    mgr = RMQEvictionManager(budget=40, protected_window=8, c=8, t=4)
    scores = np.random.default_rng(0).random(50).astype(np.float32)
    scores[[3, 17, 29]] = 10.0
    victims = _victims(mgr.plan_evictions(torch.from_numpy(scores), 50))
    assert len(victims) == 10
    assert not set(victims.tolist()) & {3, 17, 29}
    assert victims.max() < 50 - 8


def test_windowed_argmin_spreads_evictions():
    mgr = RMQEvictionManager(budget=92, protected_window=4, c=8, t=4)
    scores = np.ones(100, dtype=np.float32)
    scores[:20] = 0.01
    victims = _victims(mgr.plan_evictions(torch.from_numpy(scores), 100))
    assert len(victims) == 8 and victims.max() > 50


def test_apply_evictions_compacts():
    mgr = RMQEvictionManager(budget=6, protected_window=2)
    scores = torch.arange(8, dtype=torch.float32)
    cache = torch.arange(8 * 3).reshape(8, 3)
    new_scores, (new_cache,), live = mgr.apply_evictions(
        torch.tensor([0, 1], dtype=torch.int32), scores, 8, cache)
    assert live == 6
    np.testing.assert_array_equal(new_scores.numpy(),
                                  np.arange(2, 8, dtype=np.float32))
    np.testing.assert_array_equal(new_cache[0].numpy(), cache[2].numpy())


def test_no_eviction_below_budget():
    mgr = RMQEvictionManager(budget=100, protected_window=4)
    assert not mgr.needs_eviction(50)
    assert mgr.plan_evictions(torch.zeros(50), 50).shape[0] == 0


def test_tiny_non_pow2_evictable_region():
    mgr = RMQEvictionManager(budget=43, protected_window=40, c=8, t=4)
    scores = np.ones(45, dtype=np.float32)
    scores[2] = 0.0
    victims = _victims(mgr.plan_evictions(torch.from_numpy(scores), 45))
    assert len(victims) == 2 and 2 in victims.tolist()
    assert victims.max() < 5


@pytest.mark.parametrize("evictable,count", [
    (1, 1), (7, 3), (33, 33), (1209, 1188), (2065, 1449), (2970, 220),
    (728, 312), (2033, 459), (1575, 1), (4999, 4097)])
def test_windows_equal_reference(evictable, count):
    """The float32 linspace bounds, including cases where a plain
    ``evictable * (i / count)`` would truncate differently."""
    want = RefManager._windows(evictable, count)
    got = RMQEvictionManager._windows(evictable, count)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def _slot_scores(scores, cap):
    live = scores.shape[0]
    padded = np.full(cap, np.inf, np.float32)
    padded[:live] = scores
    return padded


@pytest.mark.parametrize("backend", ["auto", "eager"])
def test_streaming_matches_one_shot_and_reference(backend):
    ref = RefManager(budget=40, protected_window=8, c=8, t=4)
    mgr = RMQEvictionManager(budget=40, protected_window=8, c=8, t=4,
                             backend=backend)
    rng = np.random.default_rng(7)
    for live in (46, 50):
        scores = rng.random(live).astype(np.float32)
        want = np.asarray(ref.plan_evictions(jnp.asarray(scores), live))
        cap = 64
        index = mgr.make_index(cap, device="cpu")
        index, got = mgr.plan_evictions_streaming(
            index, torch.from_numpy(_slot_scores(scores, cap)), live)
        np.testing.assert_array_equal(_victims(got), want)
        np.testing.assert_array_equal(
            _victims(mgr.plan_evictions(torch.from_numpy(scores), live)),
            want)


def test_streaming_index_reuses_across_rounds():
    mgr = RMQEvictionManager(budget=30, protected_window=4, c=8, t=4)
    ref = RefManager(budget=30, protected_window=4, c=8, t=4)
    cap = 64
    index = mgr.make_index(cap, device="cpu")
    rindex = ref.make_index(cap)
    rng = np.random.default_rng(1)
    plan0 = index.plan
    for live in (34, 38, 33):
        s = rng.random(cap).astype(np.float32)
        s[live:] = np.inf
        index, victims = mgr.plan_evictions_streaming(
            index, torch.from_numpy(s), live)
        rindex, want = ref.plan_evictions_streaming(rindex, jnp.asarray(s),
                                                    live)
        assert victims.shape[0] == live - 30
        assert index.plan is plan0
        np.testing.assert_array_equal(_victims(victims), np.asarray(want))


def test_serving_tier_is_refused(models):
    _, _, cfg, params = models
    sc = ServeConfig(seq_len=64, batch=2, kv_cache_dtype="float32",
                     eviction_enabled=True, eviction_budget=32)
    with pytest.raises(NotImplementedError, match="A8"):
        engine_mod.ServeEngine(cfg, params, sc, serving_tier=object())
    with pytest.raises(NotImplementedError, match="A8"):
        RMQEvictionManager(budget=4).attach_serving(object())


# ---------------------------------------------------------------------------
# ServeEngine.generate with eviction, against the reference
# ---------------------------------------------------------------------------
SERVE = dict(seq_len=96, batch=2, kv_cache_dtype="float32",
             eviction_enabled=True, eviction_budget=48, eviction_window=16,
             rmq_chunk=16, rmq_threshold=4)


@pytest.fixture(scope="module")
def models():
    rcfg = ref_smoke_config("llama3.2-3b")
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(0))
    params = interop.params_from_reference(
        jax.tree.map(np.asarray, rparams), device="cpu")
    return rcfg, rparams, get_smoke_config("llama3.2-3b"), params


def _record_rounds(monkeypatch, cls):
    """Wrap ``cls.plan_evictions_streaming`` to keep (scores, live,
    victims) of every round."""
    rounds = []
    orig = cls.plan_evictions_streaming

    def wrapped(self, index, slot_scores, live_tokens):
        index, victims = orig(self, index, slot_scores, live_tokens)
        rounds.append((np.asarray(slot_scores, np.float32).copy(),
                       live_tokens, _victims(victims).copy()))
        return index, victims

    monkeypatch.setattr(cls, "plan_evictions_streaming", wrapped)
    return rounds


def test_generate_with_eviction_matches_reference(models, monkeypatch):
    rcfg, rparams, cfg, params = models
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    ref_rounds = _record_rounds(monkeypatch, RefManager)
    rounds = _record_rounds(monkeypatch, RMQEvictionManager)
    want = ref_engine_mod.ServeEngine(
        rcfg, rparams, RefServeConfig(**SERVE)).generate(
            jnp.asarray(prompts), 48)
    got = engine_mod.ServeEngine(cfg, params, ServeConfig(**SERVE)).generate(
        torch.from_numpy(prompts), 48)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert got["final_pos"] == want["final_pos"] <= 48 + 1
    assert got["evicted"] == want["evicted"] > 0
    assert len(rounds) == len(ref_rounds) > 1
    for (s, live, v), (rs, rlive, rv) in zip(rounds, ref_rounds):
        assert live == rlive
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_allclose(s, rs, atol=1e-5, rtol=1e-5)
    # the same scores give the same victims, bit for bit
    mgr = RMQEvictionManager(budget=48, protected_window=16, c=16, t=4)
    index = mgr.make_index(96, device="cpu")
    for rs, rlive, rv in ref_rounds:
        index, v = mgr.plan_evictions_streaming(index, torch.from_numpy(rs),
                                                rlive)
        np.testing.assert_array_equal(_victims(v), rv)


def test_engine_eviction_never_rebuilds_per_round(models, monkeypatch):
    import repro_torch.core.protocol as protocol_mod
    from repro_torch.core.api import RMQ

    builds = {"n": 0}
    orig = protocol_mod.build_hierarchy_with_backend

    def counting(*args, **kwargs):
        builds["n"] += 1
        return orig(*args, **kwargs)

    def forbid(*args, **kwargs):
        raise AssertionError("an eviction round called RMQ.build")

    monkeypatch.setattr(protocol_mod, "build_hierarchy_with_backend",
                        counting)
    monkeypatch.setattr(RMQ, "build", staticmethod(forbid))
    _, _, cfg, params = models
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)))
    out = engine_mod.ServeEngine(cfg, params, ServeConfig(**SERVE)).generate(
        prompts, 48)
    assert out["evicted"] > 0 and out["final_pos"] <= 48 + 1
    assert builds["n"] == 1


def test_generate_without_eviction_is_deterministic(models):
    _, _, cfg, params = models
    sc = dataclasses.replace(ServeConfig(**SERVE), eviction_enabled=False)
    eng = engine_mod.ServeEngine(cfg, params, sc)
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))
    a, b = eng.generate(prompts, 8), eng.generate(prompts, 8)
    assert a["tokens"].shape == (2, 8) and a["evicted"] == 0
    assert torch.equal(a["tokens"], b["tokens"])


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "llama3.2-3b", "--smoke", "--evict",
                       "--device", "cpu", "--max-new", "24"]) == 0
    out = capsys.readouterr().out
    assert "evicted=" in out and "final_pos=" in out

"""The port's examples (``examples/torch_*.py``) at reduced sizes on the
CPU; the counterpart of ``tests/test_examples.py``, which stays with the
reference.  Each example runs on the card by default and here takes
``device="cpu"``.  RMQ answers are exact (tolerance 0)."""

import asyncio
import math
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks at the top; JAX stays on the CPU)
import numpy as np
import pytest

from repro_torch.checkpoint import latest_step

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(scope="module")
def examples():
    sys.path.insert(0, str(EXAMPLES))
    try:
        import chaining
        import query_engine
        import torch_chaining
        import torch_distributed_rmq
        import torch_query_engine
        import torch_quickstart
        import torch_serve_lm
        import torch_serving_async
        import torch_streaming
        import torch_train_lm
    finally:
        sys.path.remove(str(EXAMPLES))
    return dict(chaining=chaining, query_engine=query_engine,
                torch_chaining=torch_chaining,
                torch_distributed_rmq=torch_distributed_rmq,
                torch_query_engine=torch_query_engine,
                torch_quickstart=torch_quickstart,
                torch_serve_lm=torch_serve_lm,
                torch_serving_async=torch_serving_async,
                torch_streaming=torch_streaming,
                torch_train_lm=torch_train_lm)


def test_quickstart_answers_equal_the_naive_scan(examples):
    x, ls, rs, vals, idxs, rmq = examples["torch_quickstart"].run(
        n=1 << 14, m=256, device="cpu")
    # the committed cache is keyed by the card: the CPU build misses
    assert (rmq.plan.c, rmq.plan.t, rmq.backend) == (128, 64, "eager")
    for i in range(len(ls)):
        span = x[ls[i]:rs[i] + 1]
        assert vals[i] == span.min()
        assert idxs[i] == ls[i] + int(np.argmin(span))


def test_quickstart_main(examples, capsys):
    examples["torch_quickstart"].main(["--n", "16384", "--device", "cpu"])
    assert "every answer equals the naive scan: OK" in capsys.readouterr().out


def test_streaming_matches_a_rebuild(examples, capsys):
    s, x = examples["torch_streaming"].run(1 << 14, 1 << 15, device="cpu")
    assert (s.start, s.length) == (1024, (1 << 14) + 4096)
    assert s.generation == 3
    examples["torch_streaming"].main(["--n", "8192", "--device", "cpu"])
    assert "incremental index == rebuild" in capsys.readouterr().out


def test_distributed_rmq_routes_and_spot_checks(examples, capsys):
    d, cc = examples["torch_distributed_rmq"].run(
        n=1 << 14, m=512, device="cpu")
    assert d.num_segments == 4 and d.generation == 2
    assert cc["seg_local"] > 0 and cc["crossing"] > 0
    examples["torch_distributed_rmq"].main(["--n", "16384", "--device",
                                           "cpu"])
    assert "spot checks OK" in capsys.readouterr().out


def test_chaining_equals_the_reference(examples):
    ref, port = examples["chaining"], examples["torch_chaining"]
    x = port.make_anchors(n=512)
    np.testing.assert_array_equal(x, ref.make_anchors(n=512))
    score, pred, nq = port.chain_scores_rmq(x, block=128, device="cpu")
    jscore, jpred, jnq = ref.chain_scores_rmq(x, block=128)
    assert nq == jnq > 0
    np.testing.assert_array_equal(score.view(np.int32),
                                  jscore.view(np.int32))
    np.testing.assert_array_equal(pred, jpred)
    naive = port.chain_scores_naive(x)
    assert score.max() > 5 * 20
    assert score.max() >= 0.6 * naive.max()


def test_train_lm_small(examples, tmp_path):
    ex = examples["torch_train_lm"]
    cfg = ex.lm_small()
    assert ex.lm_100m().family == cfg.family == "dense"
    first, last = ex.run(cfg, steps=100, seq_len=16, batch=4,
                         ckpt_dir=str(tmp_path), device="cpu",
                         log=lambda msg: None)
    assert math.isfinite(first) and math.isfinite(last)
    # random tokens: the loss starts near ln(vocab)
    assert abs(first - math.log(cfg.vocab_size)) < 1.0
    assert latest_step(str(tmp_path)) == 100


def test_query_engine_walkthrough(examples):
    ex = examples["torch_query_engine"]
    ref = examples["query_engine"]
    # the same workload generator as the reference's example
    for n in (1 << 16, 1 << 18):
        got = ex.mixed_workload(np.random.default_rng(3), n, 128, 999)
        want = ref.mixed_workload(np.random.default_rng(3), n, 128, 999)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    out = ex.run(1 << 16, device="cpu", log=lambda msg: None)
    assert out["register_many_launches"] == {"hierarchy_fused": 1}
    assert out["mixed_launches"] == {"rmq_fused": 1}
    assert out["generation"] == 1 and out["coalesced_batches"] >= 1
    assert out["dedup_saved"] >= 299 and out["cache_hits"] > 0
    assert all(out["class_counts"][k] > 0 for k in ("short", "mid", "long"))


def test_serving_async_two_tenants(examples):
    ex = examples["torch_serving_async"]
    out = asyncio.run(ex.run(n=4096, rounds=10, device="cpu"))
    assert out["trading_checked"] == 40
    assert out["analytics_requests"] == 10
    s = out["stats"]
    assert s["flusher_errors"] == 0
    assert s["tenants"]["analytics"]["snapshot_swaps"] > 0
    assert s["tenants"]["trading"]["snapshot_swaps"] == 0
    assert s["tenants"]["trading"]["failed_requests"] == 0


def test_serve_lm_three_modes(examples):
    ex = examples["torch_serve_lm"]
    outs = ex.run(ex.tiny_lm(), batch=2, prompt_len=16, max_new=40,
                  budget=32, device="cpu", log=lambda msg: None)
    assert outs["off"]["evicted"] == 0
    assert outs["engine"]["evicted"] == outs["serving-tier"]["evicted"] > 0
    t = outs["tenant"]
    # one swap a round after the first (each round submits once); the
    # running flusher may take a round's staged index in a mutation
    # flush of its own, so flushes can exceed rounds
    assert t["snapshot_swaps"] == t["submits"] - 1
    assert t["flushes"] >= t["submits"]
    assert t["rejected_queue_full"] == t["failed_requests"] == 0

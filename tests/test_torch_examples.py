"""The port's examples (``examples/torch_*.py``) at reduced sizes on the
CPU; the counterpart of ``tests/test_examples.py``, which stays with the
reference.  Each example runs on the card by default and here takes
``device="cpu"``.  RMQ answers are exact (tolerance 0)."""

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
        import torch_chaining
        import torch_quickstart
        import torch_streaming
        import torch_train_lm
    finally:
        sys.path.remove(str(EXAMPLES))
    return dict(chaining=chaining, torch_chaining=torch_chaining,
                torch_quickstart=torch_quickstart,
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

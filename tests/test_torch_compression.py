"""The port's int8 gradient compression against the JAX package's.

Codes and scales as integer views, bit for bit, on seeded numpy inputs
(normal, all zero, tiny, huge, and values on exact half steps, which
round half to even); three rounds of error feedback over a small tree,
every restored gradient and accumulator bit for bit; and the port's
version of ``tests/test_train.py``'s convergence test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as ref
from repro_torch.configs import TrainConfig
from repro_torch.distributed import compression as port
from repro_torch.train.optimizer import adamw_init, adamw_update
from repro_torch.train.tree import leaves_with_path


def _input(kind: str, rng) -> np.ndarray:
    if kind == "normal":
        return rng.standard_normal(4099).astype(np.float32)
    if kind == "zeros":
        return np.zeros(257, np.float32)
    if kind == "tiny":   # the 1e-12 floor of the scale dominates
        return (rng.standard_normal(513) * 1e-20).astype(np.float32)
    if kind == "huge":
        return (rng.standard_normal((17, 31)) * 1e37).astype(np.float32)
    if kind == "half_steps":
        # amax 127 gives scale exactly 1.0 (the 1e-12 is below its ulp),
        # so every k + 0.5 is a tie: half to even
        halves = np.arange(-126, 126, dtype=np.float32) + 0.5
        return np.concatenate([[127.0, -127.0], halves]).astype(np.float32)
    raise ValueError(kind)


KINDS = ["normal", "zeros", "tiny", "huge", "half_steps"]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.int8, 4: np.int32}[a.dtype.itemsize])


@pytest.mark.parametrize("kind", KINDS)
def test_codes_and_scales_match_the_reference(kind):
    g = _input(kind, np.random.default_rng(KINDS.index(kind)))
    rq, rs = ref.quantize_int8(jnp.asarray(g))
    q, s = port.quantize_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(_bits(q.numpy()), _bits(rq))
    assert np.array_equal(_bits(s.numpy()), _bits(rs))
    back = port.dequantize_int8(q, s)
    assert np.array_equal(_bits(back.numpy()),
                          _bits(ref.dequantize_int8(rq, rs)))
    if kind == "half_steps":
        assert float(s) == 1.0
        assert q[2:].tolist() == [int(np.round(v)) for v in g[2:]]
        assert 2 * (q[2:].numpy() // 2).sum() == q[2:].numpy().sum()


def test_error_feedback_rounds_match_the_reference():
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5), "b": (5,), "layers": [{"k": (3, 4)},
                                                 {"k": (3, 4)}]}

    def draw(spec):
        if isinstance(spec, dict):
            return {k: draw(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [draw(v) for v in spec]
        return rng.standard_normal(spec).astype(np.float32)

    params = draw(shapes)
    ef = port.init_error_feedback(_tree(params, torch.from_numpy))
    ref_ef = ref.init_error_feedback(_tree(params, jnp.asarray))
    for _ in range(3):
        grads = draw(shapes)
        got, ef = port.compress_grads_with_ef(
            _tree(grads, torch.from_numpy), ef)
        want, ref_ef = ref.compress_grads_with_ef(
            _tree(grads, jnp.asarray), ref_ef)
        for tree, ref_tree in ((got, want), (ef, ref_ef)):
            flat = dict(leaves_with_path(tree))
            ref_flat = dict(leaves_with_path(_tree(ref_tree, np.asarray)))
            assert flat.keys() == ref_flat.keys()
            for k in flat:
                assert flat[k].dtype == torch.float32
                assert np.array_equal(_bits(flat[k].numpy()),
                                      _bits(ref_flat[k])), k
    assert any(bool(e.abs().max() > 0) for _, e in leaves_with_path(ef))


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree(v, fn) for v in t]
    return fn(t)


def test_int8_error_feedback_preserves_convergence():
    """EF-compressed quadratic descent reaches the optimum (the port's
    version of the reference's test)."""
    tc = TrainConfig(learning_rate=0.05, warmup_steps=1, total_steps=200,
                     weight_decay=0.0)
    params = {"w": torch.tensor([4.0, -2.0, 1.5])}
    state = adamw_init(params)
    ef = port.init_error_feedback(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        grads, ef = port.compress_grads_with_ef(grads, ef)
        params, state, _ = adamw_update(grads, state, params, tc)
    assert float(params["w"].abs().max()) < 0.5


def test_quantize_roundtrip_error_is_half_a_step():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    q, s = port.quantize_int8(g)
    assert float((port.dequantize_int8(q, s) - g).abs().max()) <= \
        float(s) / 2 + 1e-6

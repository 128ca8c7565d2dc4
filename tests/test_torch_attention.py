"""The port's attention (B8's plain version and wrapper) against the
reference's, on the CPU.

Inputs are made with numpy from seeds and handed to both packages.  The
reference's Pallas kernel runs in interpret mode, as
``tests/test_kernels.py::TestFlashAttentionKernel`` runs it, at that
class's shapes, windows and first-token case.  Tolerances: 2e-5 in
float32 (the same softmax in another summation order) and 2e-2 in
bfloat16 (inputs and outputs rounded to 8 bits of mantissa), the
reference test's own.
"""

import jax  # noqa: F401  (both frameworks at the top; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention.kernel import flash_attention
from repro.kernels.flash_attention.ref import (
    attention_ref as jax_attention_ref,
    blocked_attention as jax_blocked,
)
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    blocked_attention,
)
from repro_torch.kernels.profiling import count_launches

SHAPES = [                 # (batch, hq, hkv, s, d): TestFlashAttentionKernel
    (2, 4, 2, 256, 64),
    (1, 8, 8, 128, 128),   # MHA
    (1, 8, 1, 256, 64),    # MQA
    (2, 2, 2, 512, 32),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, b, hq, hkv, s, d, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]
    jx = [jnp.asarray(a, jdt) for a in arrs]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("batch,hq,hkv,s,d", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_reference_kernel_and_ref(batch, hq, hkv, s, d, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(hq * s, batch, hq, hkv, s, d, dtype)
    tol = DTYPES[dtype][2]
    got = attention_ref(q, k, v)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, flash_attention(jq, jk, jv, interpret=True), tol)
    _close(got, jax_attention_ref(jq, jk, jv), tol)
    _close(ops.attention(q, k, v), ref_ops.attention(jq, jk, jv), tol)


@pytest.mark.parametrize("window", [128, 256, 1024])
def test_sliding_window(window):
    (jq, jk, jv), (q, k, v) = _qkv(window, 1, 2, 2, 512, 64, "float32")
    got = attention_ref(q, k, v, window=window)
    _close(got, flash_attention(jq, jk, jv, window=window, interpret=True),
           2e-5)
    _close(blocked_attention(q, k, v, window=window),
           jax_blocked(jq, jk, jv, window=window), 2e-5)


def test_first_token_attends_only_to_itself():
    (_, _, _), (q, k, v) = _qkv(0, 1, 1, 1, 128, 64, "float32")
    out = ops.attention(q, k, v)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), v[0, 0, 0].numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("s,window", [(2048, None), (2048, 300), (96, None)])
def test_cpu_routing_matches_reference_auto(s, window):
    """``impl="auto"`` off the card: blocked at S = 2048, dense below."""
    (jq, jk, jv), (q, k, v) = _qkv(s, 1, 2, 1, s, 16, "float32")
    _close(ops.attention(q, k, v, window=window),
           ref_ops.attention(jq, jk, jv, window=window), 2e-5)
    for impl in ("ref", "blocked"):
        _close(ops.attention(q, k, v, window=window, impl=impl),
               ref_ops.attention(jq, jk, jv, window=window, impl=impl), 2e-5)


def test_decode_alignment_and_non_causal():
    """Sk > S aligns the query rows to the end, as in the reference."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 4, 3, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 1, 2, 40, 32)).astype(np.float32)
    for causal in (True, False):
        want = jax_attention_ref(jnp.asarray(q), jnp.asarray(kv[0]),
                                 jnp.asarray(kv[1]), causal=causal)
        got = attention_ref(torch.from_numpy(q), torch.from_numpy(kv[0]),
                            torch.from_numpy(kv[1]), causal=causal)
        _close(got, want, 2e-5)


def _refused(fn, match):
    launches = ops.LAUNCHES.launches
    with count_launches() as counts:
        with pytest.raises(ValueError, match=match):
            fn()
    assert counts == {}
    assert ops.LAUNCHES.launches == launches


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case,match", [
    (lambda: ops.flash_attention_cuda(_t(1, 2, 8, 16), _t(1, 1, 8, 16),
                                      _t(1, 1, 8, 16)), "CUDA device"),
    (lambda: ops.flash_attention_cuda(
        _t(1, 2, 8, 16, dtype=torch.float16), _t(1, 1, 8, 16),
        _t(1, 1, 8, 16)), "float32 or bfloat16"),
    (lambda: ops.flash_attention_cuda(_t(1, 2, 8, 48), _t(1, 1, 8, 48),
                                      _t(1, 1, 8, 48)), "head_dim 48"),
    (lambda: ops.flash_attention_cuda(_t(1, 3, 8, 16), _t(1, 2, 8, 16),
                                      _t(1, 2, 8, 16)), "multiple of KV"),
    (lambda: ops.flash_attention_cuda(_t(1, 2, 8, 16), _t(1, 1, 9, 16),
                                      _t(1, 1, 9, 16)), "equal query"),
    (lambda: ops.flash_attention_cuda(_t(1, 2, 8, 16), _t(1, 1, 8, 16),
                                      _t(1, 1, 8, 32)), "do not fit"),
    (lambda: ops.flash_attention_cuda(_t(1, 2, 8, 16), _t(1, 1, 8, 16),
                                      _t(1, 1, 8, 16), window=0), "window"),
    (lambda: ops.flash_attention_cuda(_t(1, 2, 8, 16), _t(1, 1, 8, 16),
                                      _t(1, 1, 8, 16), window=2.5), "window"),
    (lambda: ops.flash_attention_cuda(_t(2, 8, 16), _t(1, 1, 8, 16),
                                      _t(1, 1, 8, 16)), r"\(B, H, S, D\)"),
    (lambda: ops.attention(_t(1, 2, 8, 16), _t(1, 1, 8, 16),
                           _t(1, 1, 8, 16), impl="cuda"), "CUDA tensors"),
    (lambda: ops.attention(_t(1, 2, 8, 16), _t(1, 1, 8, 16),
                           _t(1, 1, 8, 16), impl="pallas"), "unknown impl"),
], ids=["cpu-operands", "float16", "head-dim", "gqa-ratio", "lengths",
        "v-shape", "window-0", "window-float", "rank", "cuda-on-cpu",
        "unknown-impl"])
def test_wrapper_refusals_count_nothing(case, match):
    _refused(case, match)


# The card's bf16 gate on B8 (chip_smoke.py's ``bf16_gate``): allclose at
# 2e-2 and max|diff| / rms(plain) <= BF16_RMS_LIMIT.
BF16_RMS_LIMIT = 0.3


def _emulate_bf16_kernel(q, k, v, window, keys_per_tile=64):
    """The bf16 tensor-core kernel's rounding, in plain float32: bf16 q / k
    / v enter the products exactly, the scale (folded with log2 e) is
    applied to the float32 scores, the online softmax runs per tile of 64
    keys from the diagonal down, P is rounded to bf16 before P v, o is
    summed in float32 and rounded to bf16 once."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale_log2 = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32) * \
        torch.tensor(np.log2(np.e), dtype=torch.float32)
    rows = torch.arange(s)[:, None]
    m = torch.full((b, hq, s, 1), -1e30)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    for j in reversed(range(-(-s // keys_per_tile))):
        keys = torch.arange(j * keys_per_tile,
                            min((j + 1) * keys_per_tile, s))[None, :]
        sc = qf @ kf[:, :, keys[0]].transpose(-1, -2) * scale_log2
        hidden = keys > rows
        if window is not None:
            hidden |= keys <= rows - window
        sc = sc.masked_fill(hidden, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, keys[0]]
        m = m_new
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).to(
        torch.bfloat16)


@pytest.mark.parametrize("window", [None, 128])
def test_bf16_kernel_rounding_passes_the_card_gate(window):
    """Rounding P to bf16 before P v, as the tensor-core kernel does, stays
    inside the card's bf16 gate against the plain attention."""
    _, (q, k, v) = _qkv(1024 + (window or 0), 1, 6, 2, 1024, 128,
                        "bfloat16")
    got = _emulate_bf16_kernel(q, k, v, window).float()
    want = attention_ref(q, k, v, window=window).float()
    assert torch.isfinite(got).all()
    close = torch.allclose(got, want, atol=2e-2, rtol=2e-2)
    ratio = float((got - want).abs().max() / want.pow(2).mean().sqrt())
    assert close and ratio <= BF16_RMS_LIMIT, (close, ratio)

"""The port's SSD scan (B9's plain versions and wrapper) against the
reference, on the CPU.

Inputs come from numpy seeds and go to both packages.  Tolerance: 1e-4
absolute and relative, the reference's own SSD test tolerance
(``tests/test_kernels.py``): both sides compute in float32, but XLA's and
PyTorch's einsums and cumulative sums add in other orders, and a wrong
mask, decay or carried state moves values by O(1e-2).  The card-side
kernel tests are in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import kernel as ref_kernel
from repro.kernels.ssd_scan import ref as ref_ssd
from repro_torch.kernels.profiling import count_launches
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_ref

TOL = dict(atol=1e-4, rtol=1e-4)

# tests/test_kernels.py:361-365
GEOMETRIES = [
    (2, 256, 4, 64, 128),   # mamba2 geometry
    (1, 128, 2, 64, 16),    # hymba geometry
    (1, 512, 1, 32, 64),
]


def _inputs(seed, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((b, l, h, p)) * 0.1).astype(np.float32),
        (-np.abs(rng.standard_normal((b, l, h))) * 0.1).astype(np.float32),
        (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32),
        (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32),
    )


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("b,l,h,p,n", GEOMETRIES)
def test_plain_versions_match_the_reference(b, l, h, p, n):
    arrs = _inputs(l * h, b, l, h, p, n)
    ry0, rs0 = ref_ssd.ssd_ref(*_j(arrs))
    ry1, rs1 = ref_ssd.ssd_chunked_ref(*_j(arrs), chunk=128)
    y0, s0 = ssd_ref(*_t(arrs))
    y1, s1 = ssd_chunked_ref(*_t(arrs), chunk=128)
    for got, want in ((y0, ry0), (s0, rs0), (y1, ry1), (s1, rs1), (y1, ry0),
                      (s1, rs0)):
        _close(got, want)


@pytest.mark.parametrize("b,l,h,p,n", GEOMETRIES)
def test_chunked_matches_the_tpu_kernel_in_interpret_mode(b, l, h, p, n):
    arrs = _inputs(l * h + 1, b, l, h, p, n)
    want = ref_kernel.ssd_scan(*_j(arrs), chunk=128, interpret=True)
    got, _ = ssd_chunked_ref(*_t(arrs), chunk=128)
    _close(got, want)


def test_state_continuity_across_calls():
    """tests/test_kernels.py:386: chunked with init_state == one long
    recurrence, on both sides."""
    b, l, h, p, n = 1, 256, 2, 32, 64
    arrs = _inputs(7, b, l, h, p, n)
    half = l // 2
    first = [a[:, :half] for a in arrs]
    second = [a[:, half:] for a in arrs]
    ry, rs = ref_ssd.ssd_ref(*_j(arrs))
    y_a, s_a = ssd_chunked_ref(*_t(first), chunk=64)
    y_b, s_b = ssd_chunked_ref(*_t(second), chunk=64, init_state=s_a)
    _close(torch.cat([y_a, y_b], dim=1), ry)
    _close(s_b, rs)
    ry_b, rs_b = ref_ssd.ssd_chunked_ref(
        *_j(second), chunk=64, init_state=jnp.asarray(s_a.numpy()))
    _close(y_b, ry_b)
    _close(s_b, rs_b)


@pytest.mark.parametrize("which", ["chunked", "naive"])
def test_gradients_match_jax(which):
    b, l, h, p, n = 1, 128, 2, 32, 16
    arrs = _inputs(3, b, l, h, p, n)
    rng = np.random.default_rng(4)
    init = (rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    wy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    ws = rng.standard_normal((b, h, p, n)).astype(np.float32)
    ref_fn = {"chunked": lambda *a: ref_ssd.ssd_chunked_ref(
        *a[:4], chunk=32, init_state=a[4]),
        "naive": lambda *a: ref_ssd.ssd_ref(*a[:4], init_state=a[4])}[which]
    fn = {"chunked": lambda *a: ssd_chunked_ref(*a[:4], chunk=32,
                                                init_state=a[4]),
          "naive": lambda *a: ssd_ref(*a[:4], init_state=a[4])}[which]

    def ref_loss(*a):
        y, s = ref_fn(*a)
        return jnp.sum(y * wy) + jnp.sum(s * ws)

    want = jax.grad(ref_loss, argnums=tuple(range(5)))(
        *_j(list(arrs) + [init]))
    xs = [t.requires_grad_(True) for t in _t(list(arrs) + [init])]
    y, s = fn(*xs)
    got = torch.autograd.grad((y * torch.from_numpy(wy)).sum()
                              + (s * torch.from_numpy(ws)).sum(), xs)
    for g, w in zip(got, want):
        _close(g, w)


def test_cpu_routing_follows_the_reference():
    """``auto`` takes the chunked version with chunk = min(chunk, L), as
    the reference's ``ssd`` off the TPU; ``ref`` the recurrence; the
    kernel path needs CUDA tensors; nothing is counted."""
    arrs = _inputs(5, 2, 48, 3, 32, 16)
    ry = ref_ssd.ssd_chunked_ref(*_j(arrs), chunk=48)[0]
    before = ops.LAUNCHES.launches
    with count_launches() as counts:
        _close(ops.ssd(*_t(arrs), chunk=128), ry)
        _close(ops.ssd(*_t(arrs), chunk=16, impl="chunked_ref"), ry)
        _close(ops.ssd(*_t(arrs), impl="ref"), ry)
        y, s = ops.ssd_with_state(*_t(arrs), chunk=128)
        _close(y, ry)
        _close(s, ref_ssd.ssd_chunked_ref(*_j(arrs), chunk=48)[1])
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.ssd(*_t(arrs), impl="cuda")
        with pytest.raises(ValueError, match="unknown impl"):
            ops.ssd(*_t(arrs), impl="pallas")
        with pytest.raises(ValueError, match="CUDA device"):
            ops.ssd_scan_cuda(*_t(arrs), chunk=16)
        with pytest.raises(ValueError, match="multiple of the chunk"):
            ssd_chunked_ref(*_t(arrs), chunk=40)
    assert counts == {}
    assert ops.LAUNCHES.launches == before


@pytest.mark.parametrize("bad,match", [
    (dict(chunk=96), "L % chunk"),
    (dict(chunk=256), "chunk <= 128"),
    (dict(dtype=torch.bfloat16), "float32"),
    (dict(p=160), "head dim"),
    (dict(n=256, p=128), "shared memory"),
    (dict(init=(1, 2, 3, 4)), "init_state"),
])
def test_kernel_refusals_are_checked_before_the_device(bad, match):
    """The wrapper refuses what the kernel does not take before it looks
    for a card, and counts nothing."""
    p, n = bad.get("p", 64), bad.get("n", 128)
    dtype = bad.get("dtype", torch.float32)
    dtx = torch.zeros((1, 256, 2, p), dtype=dtype)
    la, bm = torch.zeros((1, 256, 2)), torch.zeros((1, 256, n))
    init = torch.zeros(bad["init"]) if "init" in bad else None
    before = ops.LAUNCHES.launches
    with count_launches() as counts:
        with pytest.raises(ValueError, match=match):
            ops.ssd_scan_cuda(dtx, la, bm, bm, chunk=bad.get("chunk", 128),
                              init_state=init)
    assert counts == {} and ops.LAUNCHES.launches == before


def _stand_in_kernel(calls):
    """A CPU stand-in for the CUDA launch: the plain version, counted."""
    def run(dtx, log_a, Bm, Cm, chunk=128, init_state=None,
            return_state=False):
        calls.append(chunk)
        y, s = ssd_chunked_ref(dtx, log_a, Bm, Cm, chunk=chunk,
                               init_state=init_state)
        return y, (s if return_state else None)
    return run


@pytest.mark.parametrize("return_state", [False, True])
def test_ssdscan_backward_is_the_plain_gradient(monkeypatch, return_state):
    """SSDScan's forward calls the launch once; its backward differentiates
    the plain chunked version and launches nothing."""
    calls = []
    monkeypatch.setattr(ops, "ssd_scan_cuda", _stand_in_kernel(calls))
    arrs = list(_inputs(9, 2, 64, 2, 32, 16))
    rng = np.random.default_rng(10)
    arrs.append((rng.standard_normal((2, 2, 32, 16)) * 0.5)
                .astype(np.float32))
    wy = torch.from_numpy(rng.standard_normal((2, 64, 2, 32))
                          .astype(np.float32))
    ws = torch.from_numpy(rng.standard_normal((2, 2, 32, 16))
                          .astype(np.float32))

    def loss(out):
        y, s = out if return_state else (out, None)
        return (y * wy).sum() + ((s * ws).sum() if s is not None else 0.0)

    xs = [t.requires_grad_(True) for t in _t(arrs)]
    got = torch.autograd.grad(loss(ops.SSDScan.apply(*xs, 32, return_state)),
                              xs)
    assert calls == [32]
    ys = [t.detach().requires_grad_(True) for t in xs]
    y, s = ssd_chunked_ref(*ys[:4], chunk=32, init_state=ys[4])
    want = torch.autograd.grad(loss((y, s) if return_state else y), ys)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("policy,launches", [
    ("none", 1), ("full", 2), ("names", 2), ("minimal", 2)])
def test_ssdscan_under_each_remat_policy(monkeypatch, policy, launches):
    """A checkpointed block re-runs the launch in the backward (2 per
    step); its gradient equals the un-checkpointed one."""
    from repro_torch.train.train_step import make_remat

    calls = []
    monkeypatch.setattr(ops, "ssd_scan_cuda", _stand_in_kernel(calls))
    arrs = _t(_inputs(12, 1, 64, 2, 32, 16))
    w = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (32, 32)).astype(np.float32))

    def block(dtx):
        # a matmul before the scan, so "minimal" has a product to save
        x = (dtx @ w).contiguous()
        return ops.SSDScan.apply(x, *arrs[1:], None, 32, False)

    remat = make_remat(policy)
    fn = remat(block) if remat else block
    x = arrs[0].clone().requires_grad_(True)
    got = torch.autograd.grad(fn(x).square().sum(), x)[0]
    assert len(calls) == launches
    x2 = arrs[0].clone().requires_grad_(True)
    want = torch.autograd.grad(block(x2).square().sum(), x2)[0]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# The CUDA kernel's arithmetic, rehearsed on the CPU: the SSD form in four
# steps (Gram, chunk states, state passing, chunk scan) with every product
# split 3xTF32 as the tensor cores take it (hi = tf32(a) to nearest, ties
# away, as cvt.rna; lo = tf32(a - hi) to nearest even, as cvt.rn; a b ~
# hi_a hi_b + hi_a lo_b + lo_a hi_b in float32).  Held within 1e-4 of
# max|ref| (the card's gate for the kernel): the split keeps float32
# accuracy, so the reading is about 1e-6; one TF32 pass reads about 5e-4.
# ---------------------------------------------------------------------------
SPLIT_REL = 1e-4


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` does: add half of the 13 dropped bits to
    the magnitude, then clear them."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _tf32_even(x):
    """Round float32 to TF32 to nearest, ties to even, as
    ``cvt.rn.tf32.f32`` does: add just under half of the dropped bits, plus
    the kept last bit, then clear them."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x0FFF + ((b >> 13) & 1)) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32_even(x - hi)


def _mm3(a, b):
    """``a @ b`` from TF32 halves: the three products, lo x lo dropped."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def ssd_split_tf32(dtx, log_a, Bm, Cm, chunk, init_state=None, mm=_mm3):
    """The kernel's four steps in plain float32 with every product taken
    by ``mm`` (3xTF32 unless a test asks otherwise):
    ``(y, final_state)``."""
    b, l, h, p = dtx.shape
    n = Bm.shape[-1]
    q, nc = chunk, l // chunk
    x = dtx.float().reshape(b, nc, q, h, p).permute(0, 1, 3, 2, 4)
    cum = torch.cumsum(log_a.float().reshape(b, nc, q, h), 2)
    cum = cum.permute(0, 1, 3, 2)                           # (B, NC, H, Q)
    total = cum[..., -1]                                    # (B, NC, H)
    bm = Bm.float().reshape(b, nc, 1, q, n)
    cm = Cm.float().reshape(b, nc, 1, q, n)
    # 1. Gram, once per (b, chunk)
    gram = mm(cm, bm.transpose(-1, -2))                   # (B, NC, 1, Q, Q)
    # 2. chunk states (w * dtx)^T B, w_j = exp(total - cum_j)
    w = torch.exp(total[..., None] - cum)
    s = mm((w[..., None] * x).transpose(-1, -2), bm)      # (B, NC, H, P, N)
    # 3. state passing from init_state
    state = (torch.zeros((b, h, p, n)) if init_state is None
             else init_state.float())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = torch.exp(total[:, c])[..., None, None] * state + s[:, c]
    prev = torch.stack(entering, 1)
    # 4. chunk scan: exp(cum) (C S^T) + M dtx, M masked before the exp
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool))
    diff = cum[..., :, None] - cum[..., None, :]
    decay = torch.exp(torch.where(tril, diff, torch.full_like(diff,
                                                              -torch.inf)))
    y = (torch.exp(cum)[..., None] * mm(cm, prev.transpose(-1, -2))
         + mm(gram * decay, x))                           # (B, NC, H, Q, P)
    return y.permute(0, 1, 3, 2, 4).reshape(b, l, h, p), state


def _rel(got, want):
    want = torch.from_numpy(np.array(want))
    return float((got - want).abs().max() / want.abs().max())


def test_tf32_rounding_is_nearest_ties_away():
    """Ties round away from zero, a carry crosses a power of two, and the
    halves of a split are TF32 values that add back to the input."""
    one = 2.0 ** -10                     # one TF32 ulp at 1
    x = torch.tensor([
        1 + one / 2,                     # a tie: away, up to 1 + ulp
        -(1 + one / 2),                  # a negative tie: away, down
        1 + 3 * one / 2,                 # a tie above an odd mantissa
        1 + one / 2 - 2.0 ** -23,        # just below the tie: down to 1
        2 - 2.0 ** -23,                  # rounds up across 2
        2 - one,                         # exact, the largest below 2
        0.5 - 2.0 ** -25,                # rounds up to the power 0.5
        3.0, 0.0, -0.0,
    ], dtype=torch.float32)
    want = [1 + one, -(1 + one), 1 + 2 * one, 1.0, 2.0, 2 - one, 0.5, 3.0,
            0.0, -0.0]
    got = _tf32(x)
    assert got.tolist() == want
    assert torch.equal(torch.signbit(got), torch.signbit(torch.tensor(want)))
    # to nearest even: the same ties go to the even mantissa
    want_even = [1.0, -1.0, 1 + 2 * one, 1.0, 2.0, 2 - one, 0.5, 3.0, 0.0,
                 -0.0]
    assert _tf32_even(x).tolist() == want_even
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = _split(v)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32_even(lo), lo)
    assert float(((hi + lo - v).abs() / v.abs()).max()) < 2.0 ** -21
    assert float(((hi - v).abs() / v.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("b,l,h,p,n", GEOMETRIES)
def test_split_tf32_matches_the_tpu_kernel_in_interpret_mode(b, l, h, p, n):
    arrs = _inputs(l * h + 2, b, l, h, p, n)
    want = ref_kernel.ssd_scan(*_j(arrs), chunk=128, interpret=True)
    got, _ = ssd_split_tf32(*_t(arrs), chunk=128)
    assert _rel(got, want) < SPLIT_REL


SPLIT_GEOMETRIES = [
    # (batch, L, H, P, N, chunk)
    (2, 256, 4, 64, 128, 128),   # mamba2 geometry, two chunks
    (2, 96, 4, 32, 16, 32),      # mamba2-smoke (P 32, N 16, Q 32)
    (2, 256, 3, 32, 16, 128),    # P 32, N 16 (hymba's state size)
    (1, 60, 2, 24, 10, 20),      # ragged: Q, P, N off the MMA tile
    (1, 80, 3, 12, 16, 16),      # five chunks; H * P = 36
]


@pytest.mark.parametrize("b,l,h,p,n,q", SPLIT_GEOMETRIES)
@pytest.mark.parametrize("with_init", [False, True])
def test_split_tf32_matches_the_recurrence(b, l, h, p, n, q, with_init):
    """y and the final state against the reference's recurrence and the
    port's, with and without an initial state."""
    arrs = _inputs(q * h + p + n, b, l, h, p, n)
    rng = np.random.default_rng(q + l)
    init = ((rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
            if with_init else None)
    ry, rs = ref_ssd.ssd_ref(*_j(arrs), init_state=(
        None if init is None else jnp.asarray(init)))
    ty = _t(arrs)
    tinit = None if init is None else torch.from_numpy(init)
    y, s = ssd_split_tf32(*ty, chunk=q, init_state=tinit)
    assert _rel(y, ry) < SPLIT_REL and _rel(s, rs) < SPLIT_REL
    y0, s0 = ssd_ref(*ty, init_state=tinit)
    assert _rel(y, y0) < SPLIT_REL and _rel(s, s0) < SPLIT_REL


def test_one_tf32_pass_would_fail_the_gate():
    """The control for the split: the same four steps with every product
    taken from the hi halves alone (one TF32 pass) stray beyond the 1e-4
    gate at the mamba2 geometry, so the gate tells the two apart."""
    arrs = _t(_inputs(21, 2, 256, 4, 64, 128))
    want, want_s = ssd_ref(*arrs)
    y, s = ssd_split_tf32(*arrs, chunk=128,
                          mm=lambda a, b: _tf32(a) @ _tf32(b))
    assert max(_rel(y, want), _rel(s, want_s)) > SPLIT_REL

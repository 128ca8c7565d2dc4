"""Dispatching wrapper of B8: the CUDA flash kernel on the card, the plain
version on the CPU.

The port of ``repro.kernels.flash_attention.ops``.  On a CUDA tensor
:func:`attention` launches ``csrc/flash_attention.cu`` or raises
``ValueError`` for what the kernel does not take; there is no fallback.
On a CPU tensor it routes as the reference's ``impl="auto"`` does off the
TPU: :func:`blocked_attention` for ``S >= 2048`` with ``S % 512 == 0``,
:func:`attention_ref` otherwise.  The reference's ``"pallas"`` is this
port's ``"cuda"``.

The kernel takes float32 and bfloat16, head dims 16 / 32 / 64 / 128, any
S (the reference sends ``S % 128 != 0`` to its jnp path), equal query and
key lengths, causal attention and a static ``window`` (an int >= 1 or
None).  bfloat16 runs on the tensor cores (``wgmma``, P rounded to bf16
before P v), float32 on the CUDA cores (float32 throughout); both are
hand-written kernels of ``csrc/flash_attention.cu``, chosen by dtype.
The launch counter and ``record_launch("flash_attention")`` move only
after a launch succeeded: a refused call counts nothing.

Gradient: :func:`flash_attention_cuda` goes through :class:`FlashAttention`,
whose forward launches the kernel and whose backward recomputes the plain
:func:`attention_ref` on detached copies of q, k, v and returns
``torch.autograd.grad`` of it (the JAX package differentiates its own
graph; the TPU kernel has no backward kernel).  The backward launches no
kernel.  Inside :func:`repro_torch.kernels.profiling.dry_launches` every
tensor takes the card's route and a launch is traced, not made.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, profiling
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    blocked_attention,
)

__all__ = [
    "BLOCKED_MIN_SEQ",
    "FlashAttention",
    "HEAD_DIMS",
    "LAUNCHES",
    "attention",
    "flash_attention_cuda",
    "operation_count",
]

BLOCKED_MIN_SEQ = 2048  # below this the dense reference is cheaper
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = profiling.KernelCounter("flash_attention")

_SIGNATURES = {
    "flash_attention_fwd": (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ),
}


def _check_window(window) -> int:
    """The kernel's window argument: 0 for none, else an int >= 1."""
    if window is None:
        return 0
    if isinstance(window, bool) or not isinstance(window, int) or window < 1:
        raise ValueError(
            f"flash_attention: window must be None or an int >= 1, got "
            f"{window!r}")
    return window


def _check_operands(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, D)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q, k, v must all be float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} do "
            f"not fit q {tuple(q.shape)}")
    if k.shape[2] != s:
        raise ValueError(
            f"flash_attention: the kernel needs equal query and key lengths, "
            f"got {s} and {k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head_dim {d} is not one of {HEAD_DIMS}")
    hkv = k.shape[1]
    if hkv == 0 or hq % hkv:
        raise ValueError(
            f"flash_attention: query heads {hq} are not a multiple of KV "
            f"heads {hkv}")
    if s == 0 or b == 0 or hq == 0:
        raise ValueError("flash_attention: empty operands")
    if b > 65535 or hq > 65535:
        raise ValueError("flash_attention: batch and heads must be < 65536")


def operation_count(b: int, hq: int, s: int, sk: int, d: int) -> int:
    """Floating-point operations of one launch as its plain version
    computes them: q k^T and p v over every (query, key) pair, masked ones
    too (the kernel skips the tiles a causal mask or a window empties, so
    this is an upper figure on its work)."""
    return 4 * b * hq * s * sk * d


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: Optional[float], window: Optional[int]) -> torch.Tensor:
    _check_operands(q, k, v)
    win = _check_window(window)
    dry = profiling.dry_run()
    if dry is not None:
        out = torch.empty_like(q)
        b, hq, s, d = q.shape
        dry.add("flash_attention", operation_count(b, hq, s, k.shape[2], d),
                profiling.operand_bytes(q, k, v, out))
        return out
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _build.require_cuda("flash_attention", q, k, v)
    # the kernels copy 16 bytes at a time: a view at an odd offset is copied
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    b, hq, s, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            _DTYPES[q.dtype], b, hq, k.shape[1], s, d, float(scale), win,
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _build.stream_of(q.device))
    _build.check(lib, rc, "flash_attention")
    LAUNCHES.hit()
    profiling.record_launch(
        "flash_attention", lowering="cuda", shape=tuple(q.shape),
        kv_heads=int(k.shape[1]), window=window, dtype=str(q.dtype),
        operand_bytes=profiling.operand_bytes(q, k, v, out))
    return out


class FlashAttention(torch.autograd.Function):
    """B8 with a gradient: the kernel forward, the plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window):
        out = _launch(q, k, v, scale, window)
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.window = scale, window
        return out

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = attention_ref(*inputs, scale=ctx.scale, window=ctx.window)
            wanted = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad_out))
        grads = [next(got) if t.requires_grad else None for t in inputs]
        return (*grads, None, None)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One launch of the CUDA kernel: causal attention ``(B, Hq, S, D)``,
    differentiable through :class:`FlashAttention`."""
    return FlashAttention.apply(q, k, v, scale, window)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    causal: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    """impl: ``"auto"`` | ``"cuda"`` | ``"ref"`` | ``"blocked"``.

    A CUDA ``q`` takes the kernel (``"auto"`` or ``"cuda"``; anything the
    kernel does not take raises).  A CPU ``q`` takes the plain version:
    ``"auto"`` blocked for long sequences and the dense reference
    otherwise, ``"blocked"`` blocked where ``S % 512 == 0`` and causal.
    """
    if impl not in ("auto", "cuda", "ref", "blocked"):
        raise ValueError(f"attention: unknown impl {impl!r}")
    if q.is_cuda or (profiling.dry_run() is not None
                     and impl in ("auto", "cuda")):
        if impl not in ("auto", "cuda"):
            raise ValueError(
                f"attention: a CUDA tensor launches the kernel (impl 'auto' "
                f"or 'cuda'), got impl={impl!r}; call "
                f"flash_attention.ref.attention_ref for the plain version")
        if not causal:
            raise ValueError("flash_attention: the kernel is causal only")
        return flash_attention_cuda(q, k, v, scale=scale, window=window)
    if impl == "cuda":
        raise ValueError("flash_attention: the kernel needs CUDA tensors")
    s = q.shape[2]
    if impl == "auto":
        impl = "blocked" if s >= BLOCKED_MIN_SEQ and s % 512 == 0 else "ref"
    if impl == "blocked" and s % 512 == 0 and causal:
        return blocked_attention(q, k, v, scale=scale, window=window,
                                 causal=causal)
    return attention_ref(q, k, v, scale=scale, window=window, causal=causal)


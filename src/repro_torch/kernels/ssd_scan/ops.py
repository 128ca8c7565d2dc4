"""Dispatching wrapper of B9: the CUDA SSD chunk scan on the card, the plain
chunked version on the CPU.

The port of ``repro.kernels.ssd_scan.ops``, with the reference's ``impl``
names (its ``"pallas"`` is this port's ``"cuda"``).  On a CUDA tensor
:func:`ssd` with ``impl="auto"`` or ``"cuda"`` launches
``csrc/ssd_scan.cu`` through :class:`SSDScan`, or raises ``ValueError``
for what the kernel does not take (``L % chunk != 0``, a chunk or head dim
above 128, tiles beyond 227 KB of shared memory, another dtype than
float32, non-contiguous or mixed-device operands); there is no fallback.
The plain versions run on the card only when asked for (``impl="ref"`` or
``"chunked_ref"``).  On a CPU tensor ``"auto"`` takes
:func:`ssd_chunked_ref`, as the reference does off the TPU.

Unlike the reference, the kernel takes an initial state and returns the
final one, so :func:`ssd_with_state` launches it on the card too (the
reference sends both to its jnp path).

Gradient: :class:`SSDScan`'s forward launches the kernel; its backward
recomputes :func:`ssd_chunked_ref` on detached copies of the inputs and
returns ``torch.autograd.grad`` of it, as the JAX package differentiates
its plain graph (the TPU kernel has no backward kernel either).  The
backward launches no kernel.  The launch counter and
``record_launch("ssd_scan")`` move only after a launch succeeded.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, profiling
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_ref

__all__ = [
    "LAUNCHES",
    "MAX_CHUNK",
    "MAX_HEAD_DIM",
    "SSDScan",
    "operation_count",
    "ssd",
    "ssd_scan_cuda",
    "ssd_with_state",
]

DEFAULT_CHUNK = 128
MAX_CHUNK = 128
MAX_HEAD_DIM = 128
_MAX_SMEM = 232448  # bytes of shared memory one block may use on an H100

LAUNCHES = profiling.KernelCounter("ssd_scan")

_SIGNATURES = {
    "ssd_scan_fwd": (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, *([ctypes.c_void_p] * 12),
    ),
}


def smem_bytes(q: int, p: int, n: int) -> int:
    """Shared memory of the largest of the kernel's three blocks at chunk
    ``q``, state ``n`` (the layout of ``csrc/ssd_scan.cu``; the head dim
    ``p`` is tiled by 64 and does not enter): the prep block stages C and
    B whole, the state block two stages of hi and lo planes of its two
    operands, the chunk block cum and then S or dtx as (hi, lo) words."""
    del p
    qr = -(-q // 16) * 16
    prep = 2 * qr * (-(-n // 8) * 8 + 4)
    state = 2 * 2 * (32 * 72 + 16 * 136)
    chunk = qr + max(64 * (2 * (-(-n // 16) * 16) + 16), qr // 2 * 66 * 4)
    return 4 * max(prep, state, chunk)


def _check_operands(dtx, log_a, Bm, Cm, chunk, init_state) -> None:
    if dtx.dim() != 4 or log_a.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError("ssd_scan: dtx must be (B, L, H, P), log_a (B, L, H) "
                         "and Bm / Cm (B, L, N)")
    b, l, h, p = dtx.shape
    n = Bm.shape[-1]
    if (tuple(log_a.shape) != (b, l, h) or tuple(Bm.shape) != (b, l, n)
            or tuple(Cm.shape) != (b, l, n)):
        raise ValueError(
            f"ssd_scan: log_a {tuple(log_a.shape)}, Bm {tuple(Bm.shape)} and "
            f"Cm {tuple(Cm.shape)} do not fit dtx {tuple(dtx.shape)}")
    ops = [dtx, log_a, Bm, Cm] + ([] if init_state is None else [init_state])
    if any(t.dtype != torch.float32 for t in ops):
        raise ValueError(
            f"ssd_scan: the kernel takes float32 operands, got "
            f"{[str(t.dtype) for t in ops]}")
    if init_state is not None and tuple(init_state.shape) != (b, h, p, n):
        raise ValueError(
            f"ssd_scan: init_state {tuple(init_state.shape)} is not "
            f"(B, H, P, N) = {(b, h, p, n)}")
    if min(b, l, h, p, n) == 0:
        raise ValueError("ssd_scan: empty operands")
    if not 1 <= chunk <= MAX_CHUNK or l % chunk:
        raise ValueError(
            f"ssd_scan: the kernel needs 1 <= chunk <= {MAX_CHUNK} and L % "
            f"chunk == 0, got L {l}, chunk {chunk} (ssm_apply pads L first)")
    if p > MAX_HEAD_DIM:
        raise ValueError(f"ssd_scan: head dim {p} exceeds {MAX_HEAD_DIM}")
    if smem_bytes(chunk, p, n) > _MAX_SMEM:
        raise ValueError(
            f"ssd_scan: chunk {chunk}, head dim {p}, state {n} need "
            f"{smem_bytes(chunk, p, n)} bytes of shared memory, more than "
            f"{_MAX_SMEM}")
    if b > 65535 or l // chunk > 65535 or h > 65535:
        raise ValueError("ssd_scan: batch, heads and L / chunk must be < "
                         "65536")


def ssd_scan_cuda(
    dtx: torch.Tensor,
    log_a: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    chunk: int = DEFAULT_CHUNK,
    init_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One counted launch of the CUDA kernel (three CUDA kernels: the Gram
    matrices C B^T, cum and B split per chunk, the chunk states walked per
    head, the chunk scan): ``(y, final_state or None)``."""
    _check_operands(dtx, log_a, Bm, Cm, chunk, init_state)
    dry = profiling.dry_run()
    if dry is None:
        _build.require_cuda("ssd_scan", dtx, log_a, Bm, Cm, init_state)
    b, l, h, p = dtx.shape
    n = Bm.shape[-1]
    y = torch.empty_like(dtx)
    final = (torch.empty((b, h, p, n), dtype=torch.float32,
                         device=dtx.device) if return_state else None)
    # scratch: the Gram matrices, cum per head, B split for the state walk
    # (16 MB) and the state entering each chunk (268 MB at mamba2-1.3b's
    # training shape)
    nc = l // chunk
    scratch = dict(dtype=torch.float32, device=dtx.device)
    gram = torch.empty((b, nc, chunk, chunk), **scratch)
    cum = torch.empty((b, nc, h, chunk), **scratch)
    bfrag = torch.empty((b, nc, -(-chunk // 32), -(-n // 64), 4096), **scratch)
    states = torch.empty((b, nc, h, p, n), **scratch)
    if dry is not None:
        dry.add("ssd_scan", operation_count(b, l, h, p, n, chunk),
                profiling.operand_bytes(dtx, log_a, Bm, Cm, init_state, y,
                                        final))
        return y, final
    lib = _build.load("ssd_scan", _SIGNATURES)
    with torch.cuda.device(dtx.device):
        rc = lib.ssd_scan_fwd(
            b, l, h, p, n, chunk, _build.ptr(dtx), _build.ptr(log_a),
            _build.ptr(Bm), _build.ptr(Cm), _build.ptr(gram),
            _build.ptr(cum), _build.ptr(bfrag), _build.ptr(states),
            _build.ptr(init_state),
            _build.ptr(y), _build.ptr(final), _build.stream_of(dtx.device))
    _build.check(lib, rc, "ssd_scan")
    LAUNCHES.hit()
    profiling.record_launch(
        "ssd_scan", lowering="cuda", shape=tuple(dtx.shape), state=n,
        chunk=chunk, init_state=init_state is not None,
        operand_bytes=profiling.operand_bytes(dtx, log_a, Bm, Cm, init_state,
                                              y, final))
    return y, final


class SSDScan(torch.autograd.Function):
    """B9 with a gradient: the kernel forward, the plain chunked backward.

    ``SSDScan.apply(dtx, log_a, Bm, Cm, init_state, chunk, return_state)``
    returns ``y``, or ``(y, final_state)`` with ``return_state``.
    """

    @staticmethod
    def forward(ctx, dtx, log_a, Bm, Cm, init_state, chunk, return_state):
        y, final = ssd_scan_cuda(dtx, log_a, Bm, Cm, chunk=chunk,
                                 init_state=init_state,
                                 return_state=return_state)
        ctx.save_for_backward(dtx, log_a, Bm, Cm, init_state)
        ctx.chunk = chunk
        ctx.return_state = return_state
        return (y, final) if return_state else y

    @staticmethod
    def backward(ctx, grad_y, grad_state=None):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        inputs = [None if t is None else t.detach().requires_grad_(want)
                  for t, want in zip(saved, need)]
        with torch.enable_grad():
            y, final = ssd_chunked_ref(*inputs[:4], chunk=ctx.chunk,
                                       init_state=inputs[4])
            outs, grads = [y], [grad_y]
            if ctx.return_state and grad_state is not None:
                outs.append(final)
                grads.append(grad_state)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(outs, wanted, grads,
                                           allow_unused=True))
        out = [next(got) if t is not None and t.requires_grad else None
               for t in inputs]
        return (*out, None, None)


def operation_count(b: int, l: int, h: int, p: int, n: int,
                    chunk: int) -> int:
    """Floating-point operations of one launch: twice the multiply-adds of
    its four products, C B^T once per (batch row, chunk), the causal
    in-chunk product, the carried-state term and the state update."""
    nc = l // chunk
    tri = chunk * (chunk + 1) // 2        # the causal pairs j <= i
    macs = (b * nc * tri * n
            + b * nc * h * tri * p
            + b * nc * h * chunk * n * p
            + b * nc * h * chunk * p * n)
    return 2 * macs


def _on_card(*tensors) -> bool:
    """A CUDA operand, or any operand inside a dry run (the card's route)."""
    return profiling.dry_run() is not None or any(
        t is not None and t.is_cuda for t in tensors)


def ssd(dtx, log_a, Bm, Cm, chunk: int = DEFAULT_CHUNK, impl: str = "auto",
        init_state=None):
    """``y`` of the SSD scan.  impl: ``"auto"`` | ``"cuda"`` | ``"ref"`` |
    ``"chunked_ref"``.

    A CUDA ``dtx`` takes the kernel for ``"auto"`` / ``"cuda"`` (anything
    it does not take raises) and the plain versions only when named.  A
    CPU ``dtx`` takes :func:`ssd_chunked_ref` for ``"auto"`` (with
    ``chunk = min(chunk, L)``, as the reference) and :func:`ssd_ref` for
    ``"ref"``; ``"cuda"`` raises.
    """
    if impl not in ("auto", "cuda", "ref", "chunked_ref"):
        raise ValueError(f"ssd: unknown impl {impl!r}")
    if impl in ("auto", "cuda"):
        if _on_card(dtx, log_a, Bm, Cm, init_state):
            return SSDScan.apply(dtx, log_a, Bm, Cm, init_state, chunk, False)
        if impl == "cuda":
            raise ValueError("ssd_scan: the kernel needs CUDA tensors")
    if impl == "ref":
        return ssd_ref(dtx, log_a, Bm, Cm, init_state=init_state)[0]
    return ssd_chunked_ref(dtx, log_a, Bm, Cm, chunk=min(chunk, dtx.shape[1]),
                           init_state=init_state)[0]


def ssd_with_state(dtx, log_a, Bm, Cm, chunk: int = DEFAULT_CHUNK,
                   init_state=None):
    """``(y, final_state)`` with ``chunk = min(chunk, L)``: the kernel on
    the card (it raises for what it does not take),
    :func:`ssd_chunked_ref` on the CPU."""
    chunk = min(chunk, dtx.shape[1])
    if _on_card(dtx, log_a, Bm, Cm, init_state):
        return SSDScan.apply(dtx, log_a, Bm, Cm, init_state, chunk, True)
    return ssd_chunked_ref(dtx, log_a, Bm, Cm, chunk=chunk,
                           init_state=init_state)

"""Gradient compression: int8 quantization with error feedback.

The port of ``repro.distributed.compression`` on tensors, over trees
through :mod:`repro_torch.train.tree`.  Per-tensor symmetric int8: the
scale is the float32 ``amax(|g|) / 127 + 1e-12`` and the codes are
``clip(round(g / scale), -127, 127)``, rounded half to even
(``torch.round``, ``jnp.round``'s rule).  The quantization error is
carried in an error-feedback accumulator and added back the next step
(Seide et al. / EF-SGD), which keeps convergence.  Neither launcher
exposes it as a flag; the bf16 gradient dtype
(``TrainConfig.grad_allreduce_dtype``) is the always-on compression.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.train.tree import tree_map

__all__ = ["compress_grads_with_ef", "dequantize_int8", "init_error_feedback",
           "quantize_int8"]


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes int8, scale float32 0-d)`` of ``g``."""
    g = g.float()
    f32 = dict(dtype=torch.float32, device=g.device)
    # float32 tensors on both sides: a Python float would be added in the
    # operation's wider accumulation type, not rounded to float32 first
    scale = (g.abs().amax() / torch.tensor(127.0, **f32)
             + torch.tensor(1e-12, **f32))
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Any) -> Any:
    """A float32 zero accumulator shaped like every leaf of ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads_with_ef(grads: Any, ef: Any) -> Tuple[Any, Any]:
    """``(the gradients as they would survive the wire, the new error
    feedback)``: each leaf's ``g + e`` quantized and restored, and what the
    rounding lost.  One leaf's temporaries live at a time."""
    errors = []

    def one(g, e):
        corrected = g.float() + e
        restored = dequantize_int8(*quantize_int8(corrected))
        errors.append(corrected - restored)
        return restored

    restored = tree_map(one, grads, ef)
    it = iter(errors)
    return restored, tree_map(lambda _: next(it), grads)

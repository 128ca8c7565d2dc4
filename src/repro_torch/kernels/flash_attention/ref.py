"""Plain PyTorch attention: the oracle of B8 and the CPU path.

The port of ``repro.kernels.flash_attention.ref``, in the reference's
layout: q ``(B, Hq, S, D)``, k / v ``(B, Hkv, Sk, D)``, causal with an
optional sliding window, hidden scores set to ``-1e30``, softmax in
float32, the output in q's dtype.  GQA folds the query heads into
``(Hkv, group)`` and broadcasts k / v over the group instead of repeating
them; the products are the same.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_ref", "blocked_attention"]

_NEG_INF = -1e30


def _grouped_scores(q, k, scale):
    """float32 scores ``(B, Hkv, group, Sq, Sk)`` of q against its KV head."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"query heads {hq} are not a multiple of KV heads "
                         f"{hkv}")
    qg = q.float().reshape(b, hkv, hq // hkv, s, d)
    return torch.matmul(qg, k.float().unsqueeze(2).transpose(-1, -2)) * scale


def _mask(rows, cols, causal: bool, window):
    mask = torch.ones(rows.shape[0], cols.shape[1], dtype=torch.bool,
                      device=rows.device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    return mask


def _softmax_values(scores, mask, v, out_dtype):
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p, v.float().unsqueeze(2))
    b, hkv, g, s, dv = out.shape
    return out.reshape(b, hkv * g, s, dv).to(out_dtype)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Reference causal / sliding-window attention with GQA."""
    s, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    scores = _grouped_scores(q, k, scale)
    rows = torch.arange(s, device=q.device)[:, None] + (sk - s)
    cols = torch.arange(sk, device=q.device)[None, :]
    return _softmax_values(scores, _mask(rows, cols, causal, window), v,
                           q.dtype)


def blocked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    causal: bool = True,
    block_q: int = 512,
) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: O(block_q * Sk) live scores.

    The reference maps over query blocks of ``block_q`` rows; this is the
    same loop written out.
    """
    b, hq, s, d = q.shape
    sk = k.shape[2]
    if s % block_q:
        raise ValueError(f"sequence {s} is not a multiple of block_q "
                         f"{block_q}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    offset = sk - s  # decode-style alignment (s == sk in train / prefill)
    cols = torch.arange(sk, device=q.device)[None, :]
    outs = []
    for i in range(s // block_q):
        qi = q[:, :, i * block_q:(i + 1) * block_q]
        rows = (i * block_q + torch.arange(block_q, device=q.device)[:, None]
                + offset)
        outs.append(_softmax_values(
            _grouped_scores(qi, k, scale), _mask(rows, cols, causal, window),
            v, q.dtype))
    return torch.cat(outs, dim=2)

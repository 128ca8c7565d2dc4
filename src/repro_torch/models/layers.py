"""Shared functional layers: norms, RoPE, dense projections, SwiGLU, GQA.

The port of ``repro.models.layers`` for the GQA families.  Every layer
is an ``*_init`` plus an apply-style function over plain dicts of tensors.
The reference keeps float32 master weights and casts them to the compute
dtype at use; the port holds matrices in the compute dtype already (bf16
on the card), vectors (norm scales, biases) in float32, and casts at use
as the reference does, so the products are the same.

Attention has two modes sharing one set of weights: full-sequence
(:func:`gqa_attention`, train / prefill, through the B8 kernel on the
card) and single-token decode against a cache (:func:`gqa_decode`, plain
PyTorch: the reference computes it with einsums, outside any Pallas
kernel).  MLA waits for ROADMAP A12d.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import attention as attention_op
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = [
    "apply_rope", "cast", "cdtype", "dense", "dense_init", "gqa_attention",
    "gqa_decode", "gqa_init", "mla_init", "mlp", "mlp_init", "rmsnorm",
    "rmsnorm_init", "rope_freqs",
]

_NEG_INF = -1e30
_MLA_REFUSAL = "MLA attention is not ported yet (ROADMAP A12d)"


def cdtype(cfg: ModelConfig) -> torch.dtype:
    """The compute dtype named by ``cfg.dtype``."""
    return getattr(torch, cfg.dtype)


def cast(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x.to(cdtype(cfg))


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               bias: bool = False, scale: Optional[float] = None):
    """``w ~ N(0, 1) * scale`` (default ``1 / sqrt(in_dim)``), made in
    float32 on the generator's device and held in ``dtype``."""
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=torch.float32,
                             device=gen.device)
    return p


def dense(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = x @ cast(p["w"], cfg)
    if "b" in p:
        y = y + cast(p["b"], cfg)
    return y


def rmsnorm_init(dim: int, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"]).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: (S,) or (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, cfg: ModelConfig, dtype,
             d_ff: Optional[int] = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    return {
        "gate": dense_init(gen, cfg.d_model, d_ff, dtype),
        "up": dense_init(gen, cfg.d_model, d_ff, dtype),
        "down": dense_init(gen, d_ff, cfg.d_model, dtype),
    }


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return dense(p["down"], F.silu(dense(p["gate"], x, cfg))
                 * dense(p["up"], x, cfg), cfg)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    h, hkv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "q": dense_init(gen, d, h * hd, dtype, bias=cfg.qkv_bias),
        "k": dense_init(gen, d, hkv * hd, dtype, bias=cfg.qkv_bias),
        "v": dense_init(gen, d, hkv * hd, dtype, bias=cfg.qkv_bias),
        "o": dense_init(gen, h * hd, d, dtype),
    }


def mla_init(*args, **kwargs):
    raise NotImplementedError(_MLA_REFUSAL)


def _split_heads(x: torch.Tensor, num_heads: int, head_dim: int):
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Hq, S, D) -> (B, Hkv, group, S, D): query heads over their KV
    head, so K / V broadcast instead of being repeated."""
    b, h, s, d = q.shape
    return q.reshape(b, hkv, h // hkv, s, d)


def gqa_attention(
    p,
    x: torch.Tensor,                # (B, S, D)
    cfg: ModelConfig,
    positions: torch.Tensor,        # (S,)
    window: Optional[int] = None,
    attn_impl: str = "auto",
    return_probs_sum: bool = False,
):
    """Full-sequence causal attention (train / prefill).

    ``attn_impl="ref"`` takes the plain :func:`attention_ref` on any
    device (the card's whole-model check compares against it); every
    other value goes to the B8 wrapper, which launches the kernel on a
    CUDA tensor.  Returns ``(out, (k, v), probs_sum)``; ``probs_sum`` is
    the per-key attention mass (``None`` unless requested).
    """
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(dense(p["q"], x, cfg), h, hd)
    k = _split_heads(dense(p["k"], x, cfg), hkv, hd)
    v = _split_heads(dense(p["v"], x, cfg), hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if attn_impl == "ref":
        out = attention_ref(q, k, v, window=window)
    else:
        out = attention_op(q, k, v, window=window, impl=attn_impl)
    probs_sum = _attention_mass(q, k, window) if return_probs_sum else None
    return dense(p["o"], _merge_heads(out), cfg), (k, v), probs_sum


def _attention_mass(q: torch.Tensor, k: torch.Tensor, window=None):
    """Per-key cumulative attention mass (B, S): eviction scores."""
    hd, s = q.shape[3], q.shape[2]
    scores = torch.matmul(_grouped(q.float(), k.shape[1]),
                          k.float().unsqueeze(2).transpose(-1, -2))
    scores = scores / math.sqrt(hd)
    row = torch.arange(s, device=q.device)[:, None]
    col = torch.arange(s, device=q.device)[None, :]
    mask = col <= row
    if window is not None:
        mask = mask & (col > row - window)
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return probs.sum(dim=(1, 2, 3))


def gqa_decode(
    p,
    x: torch.Tensor,                # (B, 1, D)
    cfg: ModelConfig,
    cache: Tuple[torch.Tensor, torch.Tensor],   # k, v: (B, Hkv, S, hd)
    pos: int,                       # index of the new token
    window: Optional[int] = None,
):
    """Single-token decode against a KV cache; returns ``(out, cache)``.

    The new token's k / v are written into the cache tensors in place
    (the reference returns updated copies); the same tensors come back.
    The contractions take cache-dtype operands with float32 accumulation,
    as the reference's ``preferred_element_type=float32`` einsums: the
    operands are widened to float32 (exact) before the product.
    """
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ck, cv = cache
    s_cache = ck.shape[2]
    b = x.shape[0]
    q = _split_heads(dense(p["q"], x, cfg), h, hd)
    k = _split_heads(dense(p["k"], x, cfg), hkv, hd)
    v = _split_heads(dense(p["v"], x, cfg), hkv, hd)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    ck[:, :, pos] = k[:, :, 0].to(ck.dtype)
    cv[:, :, pos] = v[:, :, 0].to(cv.dtype)

    qg = q.reshape(b, hkv, h // hkv, hd).to(ck.dtype).float()
    scores = torch.matmul(qg, ck.float().transpose(-1, -2)) / math.sqrt(hd)
    col = torch.arange(s_cache, device=x.device)[None, None, None, :]
    mask = col <= pos
    if window is not None:
        mask = mask & (col > pos - window)
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(cv.dtype).float(), cv.float())
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    return dense(p["o"], out, cfg), (ck, cv)

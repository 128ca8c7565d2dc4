"""Shared functional layers: norms, RoPE, dense projections, SwiGLU, GQA
and MLA.

The port of ``repro.models.layers``.  Every layer is an ``*_init`` plus
an apply-style function over plain dicts of tensors.  The reference
keeps float32 master weights and casts them to the compute dtype at use;
the port holds matrices in the compute dtype already (bf16 on the card),
vectors (norm scales, biases) in float32, and casts at use as the
reference does, so the products are the same.

Attention has two modes sharing one set of weights: full-sequence
(:func:`gqa_attention`, train / prefill, through the B8 kernel on the
card) and single-token decode against a cache (:func:`gqa_decode`, plain
PyTorch: the reference computes it with einsums, outside any Pallas
kernel).

MLA (multi-head latent attention, minicpm3) has the same two modes:
:func:`mla_attention` materializes per-head K / V from the latent and
takes the reference's route for a query head dim that differs from the
value's (:func:`mla_route`: the blocked or the dense plain attention, never
B8), and :func:`mla_decode` scores in latent space against a cache of the
latent and one shared rope key a position (the absorbed products).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import BLOCKED_MIN_SEQ
from repro_torch.kernels.flash_attention.ops import attention as attention_op
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    blocked_attention,
)

__all__ = [
    "apply_rope", "cast", "cdtype", "dense", "dense_init", "gqa_attention",
    "gqa_decode", "gqa_init", "mla_attention", "mla_decode", "mla_init",
    "mla_route", "mlp", "mlp_init", "rmsnorm", "rmsnorm_init", "rope_freqs",
]

_NEG_INF = -1e30


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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek style)
# ---------------------------------------------------------------------------
def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, h, dev = cfg.d_model, cfg.num_heads, gen.device
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "q_a": dense_init(gen, d, cfg.q_lora_rank, dtype),
        "q_a_norm": rmsnorm_init(cfg.q_lora_rank, dev),
        "q_b": dense_init(gen, cfg.q_lora_rank, h * qk, dtype),
        "kv_a": dense_init(gen, d, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                           dtype),
        "kv_a_norm": rmsnorm_init(cfg.kv_lora_rank, dev),
        "kv_b": dense_init(gen, cfg.kv_lora_rank,
                           h * (cfg.qk_nope_head_dim + cfg.v_head_dim), dtype),
        "o": dense_init(gen, h * cfg.v_head_dim, d, dtype),
    }


def _mla_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Materialized (train / prefill) MLA projections: ``(q (B, H, S, dn +
    dr), k (B, H, S, dn + dr), v (B, H, S, dv), latent (B, S, R), k_rope
    (B, 1, S, dr))``; the rope key is shared by the heads."""
    b, s, _ = x.shape
    h, rank = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = dense(p["q_b"], rmsnorm(p["q_a_norm"], dense(p["q_a"], x, cfg),
                                cfg.norm_eps), cfg)
    q = q.reshape(b, s, h, dn + dr).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = dense(p["kv_a"], x, cfg)
    latent = rmsnorm(p["kv_a_norm"], kv[..., :rank], cfg.norm_eps)
    k_rope = apply_rope(kv[..., rank:][:, None], positions, cfg.rope_theta)
    kvu = dense(p["kv_b"], latent, cfg).reshape(b, s, h, dn + dv)
    kvu = kvu.transpose(1, 2)
    k_nope, v = kvu[..., :dn], kvu[..., dn:]
    k = torch.cat([k_nope, k_rope.expand(b, h, s, dr).to(k_nope.dtype)],
                  dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k, v, latent, k_rope


def mla_route(s: int, on_card: bool) -> str:
    """The reference's route for causal attention whose query head dim
    differs from the value's (``repro/kernels/flash_attention/ops.py``
    :44-53), ``"blocked"`` or ``"ref"``.

    The flash kernel needs equal head dims, so the reference's ``"auto"``
    never reaches it for MLA (96 against 64 on minicpm3).  On its
    accelerator ``"auto"`` is ``"pallas"``, which falls to the blocked
    attention where ``S % 512 == 0`` and to the dense one otherwise; the
    card takes that route.  Off the accelerator ``"auto"`` is blocked for
    ``S >= 2048`` with ``S % 512 == 0``, else dense; the CPU takes that
    one.
    """
    if s % 512:
        return "ref"
    return "blocked" if on_card or s >= BLOCKED_MIN_SEQ else "ref"


def mla_attention(p, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, return_probs_sum: bool = False):
    """Full-sequence MLA (train / prefill): ``(out, (latent (B, S, R),
    k_rope (B, S, dr)), probs_sum)``, the cache payload being the latent
    and the shared rope key.  The attention is plain PyTorch on the route
    :func:`mla_route` picks by shape, at scale ``1 / sqrt(dn + dr)``;
    ``probs_sum`` is the per-key attention mass (``None`` unless
    requested)."""
    q, k, v, latent, k_rope = _mla_qkv(p, x, cfg, positions)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if mla_route(q.shape[2], q.is_cuda) == "blocked":
        out = blocked_attention(q, k, v, scale=scale)
    else:
        out = attention_ref(q, k, v, scale=scale)
    probs_sum = _attention_mass(q, k) if return_probs_sum else None
    return (dense(p["o"], _merge_heads(out), cfg), (latent, k_rope[:, 0]),
            probs_sum)


def mla_decode(
    p,
    x: torch.Tensor,                # (B, 1, D)
    cfg: ModelConfig,
    cache: Tuple[torch.Tensor, torch.Tensor],  # (B, S, R), (B, S, dr)
    pos: int,                       # index of the new token
):
    """Single-token decode against the latent cache; returns ``(out,
    cache)``.

    The absorbed products: the K-half of ``kv_b`` is folded into the query
    (``q_lat``, formed in the compute dtype), the scores are float32 over
    the widened latent and rope rows at scale ``1 / sqrt(dn + dr)``, the
    output stays in latent space until the V-half up-projects it (in the
    compute dtype), so per-head K / V are never formed for cached
    positions.  The new token's latent and rope key are written into the
    cache tensors in place at ``pos`` (the reference returns updated
    copies) and the same tensors come back.
    """
    b, h, rank = x.shape[0], cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    c_lat, c_rope = cache
    s_cache = c_lat.shape[1]
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = dense(p["q_b"], rmsnorm(p["q_a_norm"], dense(p["q_a"], x, cfg),
                                cfg.norm_eps), cfg)
    q = q.reshape(b, 1, h, dn + dr).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, posv, cfg.rope_theta)

    kv = dense(p["kv_a"], x, cfg)
    latent = rmsnorm(p["kv_a_norm"], kv[..., :rank], cfg.norm_eps)
    k_rope = apply_rope(kv[..., rank:][:, None], posv, cfg.rope_theta)[:, 0]
    c_lat[:, pos] = latent[:, 0].to(c_lat.dtype)
    c_rope[:, pos] = k_rope[:, 0].to(c_rope.dtype)

    w_kv = cast(p["kv_b"]["w"], cfg).reshape(rank, h, dn + dv)
    w_k, w_v = w_kv[..., :dn], w_kv[..., dn:]
    q_lat = torch.einsum("bhqd,rhd->bhqr", q_nope, w_k)
    lat = c_lat.float()
    scores = (torch.einsum("bhqr,bsr->bhqs", q_lat.float(), lat)
              + torch.einsum("bhqd,bsd->bhqs", q_rope.float(),
                             c_rope.float())) / math.sqrt(dn + dr)
    col = torch.arange(s_cache, device=x.device)
    scores = torch.where(col <= pos, scores, torch.full_like(scores,
                                                             _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bhqr", probs, lat)
    out = torch.einsum("bhqr,rhd->bhqd", o_lat.to(cdtype(cfg)), w_v)
    return dense(p["o"], _merge_heads(out), cfg), (c_lat, c_rope)

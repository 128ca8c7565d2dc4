"""LM assembly: init / forward / prefill / decode for the ported families.

The port of ``repro.models.lm`` for two families:

* ``dense`` with GQA attention (llama3.2-3b, qwen1.5-0.5b,
  command-r-plus-104b): RMSNorm, SwiGLU, RoPE, optional ``qkv_bias``,
  ``parallel_block``, ``sliding_window`` and ``logit_softcap`` where the
  reference has them; every entry point.
* ``ssm`` (mamba2-1.3b): Mamba-2 blocks only, attention-free, through
  :mod:`repro_torch.models.ssm` and the SSD scan B9.  :func:`init_params`
  and :func:`forward` (the train path) take it; :func:`prefill`,
  :func:`decode_step` and :func:`make_decode_cache` still refuse it.

The reference's ``lax.scan`` over stacked layer parameters becomes a
Python loop over a list of per-layer dicts; its ``remat`` wrapper of the
scan body becomes a wrapper of each block (``train.train_step.make_remat``).
MoE, hybrid, MLA and the modality frontends raise ``NotImplementedError``
(ROADMAP A12).

Parameters: ``{"embed": {"w"}, "layers": [layer, ...], "final_norm":
{"scale"}, "lm_head": {"w"}}`` (no ``lm_head`` with tied embeddings); a
dense layer is ``{"ln1", "attn", "mlp"[, "ln2"]}``, an SSM layer
``{"ln", "ssm"}``.  :func:`init_params` draws them from a seeded
``torch.Generator`` on the target device;
:func:`repro_torch.models.interop.params_from_reference` carries the
reference's parameters across.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

__all__ = [
    "check_supported",
    "decode_step",
    "forward",
    "init_params",
    "make_decode_cache",
    "prefill",
]


def check_supported(cfg: ModelConfig, serving: bool = False) -> None:
    """Refuse what is not ported (ROADMAP A12): every family but dense GQA
    and, for the train path (``serving=False``), the SSM family."""
    if cfg.family == "hybrid":
        what = "hybrid models"
    elif cfg.is_attention_free:
        if not serving:
            return
        what = "SSM models in prefill / decode"
    elif cfg.uses_moe:
        what = "MoE models"
    elif cfg.attention_type == "mla":
        what = "MLA attention"
    elif cfg.frontend or cfg.family != "dense":
        what = f"the {cfg.family} family (modality frontends)"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: {what} are not ported yet (ROADMAP A12); the port "
        f"serves the dense GQA family and trains it and the SSM family")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_dense_layer(gen: torch.Generator, cfg: ModelConfig, dtype):
    p = {
        "ln1": L.rmsnorm_init(cfg.d_model, gen.device),
        "attn": L.gqa_init(gen, cfg, dtype),
        "mlp": L.mlp_init(gen, cfg, dtype),
    }
    if not cfg.parallel_block:
        p["ln2"] = L.rmsnorm_init(cfg.d_model, gen.device)
    return p


def _init_ssm_layer(gen: torch.Generator, cfg: ModelConfig, dtype):
    return {
        "ln": L.rmsnorm_init(cfg.d_model, gen.device),
        "ssm": SSM.ssm_init(gen, cfg, dtype),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``.

    Matrices are held in ``dtype`` (default: the compute dtype; the train
    path asks for float32 masters), vectors and the SSM's ``conv_w`` in
    float32.  The draws differ from the reference's ``jax.random``.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or L.cdtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    init_layer = (_init_ssm_layer if cfg.is_attention_free
                  else _init_dense_layer)
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                        device=dev, dtype=torch.float32) * 0.02
    params = {
        "embed": {"w": embed.to(dtype)},
        "layers": [init_layer(gen, cfg, dtype)
                   for _ in range(cfg.num_layers)],
        "final_norm": L.rmsnorm_init(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                         dtype)
    return params


def _head_w(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["w"].t()
    return params["lm_head"]["w"]


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return L.cast(params["embed"]["w"][tokens.long()], cfg)


# ---------------------------------------------------------------------------
# Block body (full-sequence)
# ---------------------------------------------------------------------------
def _dense_block(cfg: ModelConfig, p, x: torch.Tensor, positions,
                 attn_impl: str):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, kv, _ = L.gqa_attention(p["attn"], h, cfg, positions,
                               window=cfg.sliding_window, attn_impl=attn_impl)
    if cfg.parallel_block:
        return x + a + L.mlp(p["mlp"], h, cfg), kv
    x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, cfg), kv


def _ssm_block(cfg: ModelConfig, p, x: torch.Tensor):
    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    return x + SSM.ssm_apply(p["ssm"], h, cfg)


# ---------------------------------------------------------------------------
# Forward (train path): logits
# ---------------------------------------------------------------------------
def forward(
    cfg: ModelConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,                    # (B, S)
    attn_impl: str = "auto",
    remat: Optional[Callable] = None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(logits (B, S, V) float32, aux)``; ``aux`` is the MoE
    auxiliary loss of the reference, 0 for the ported families.

    ``remat`` wraps each block's function (the reference wraps its scan
    body), e.g. in ``torch.utils.checkpoint``; ``return_hidden=True``
    skips the LM head and returns the final-normed hidden states (the
    chunked loss applies the head per sequence chunk).  ``attn_impl`` goes
    to the attention of dense blocks.
    """
    check_supported(cfg)
    x = _embed(params, tokens, cfg)
    if cfg.is_attention_free:
        def block(x, p):
            return _ssm_block(cfg, p, x)
    else:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)

        def block(x, p):
            return _dense_block(cfg, p, x, positions, attn_impl)[0]
    if remat is not None:
        block = remat(block)
    for p in params["layers"]:
        x = block(x, p)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    logits = x @ L.cast(_head_w(params, cfg), cfg)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits.float(), aux


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------
def make_decode_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zero-initialized decode cache sized for ``seq_len`` positions:
    ``k`` and ``v`` of shape (layers, B, Hkv, seq_len, head_dim)."""
    check_supported(cfg, serving=True)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, seq_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def prefill(
    cfg: ModelConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,                  # (B, S)
    cache_len: int,
    cache_dtype=torch.bfloat16,
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence pass that fills a decode cache of ``cache_len`` slots.

    Returns (last-position logits (B, V) float32, cache).  As in the
    reference, prefill applies no ``logit_softcap``.
    """
    check_supported(cfg, serving=True)
    x = _embed(params, tokens, cfg)
    s = x.shape[1]
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens exceeds cache_len "
                         f"{cache_len}")
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    cache = make_decode_cache(cfg, tokens.shape[0], cache_len, cache_dtype,
                              x.device)
    for i, p in enumerate(params["layers"]):
        x, (k, v) = _dense_block(cfg, p, x, positions, attn_impl)
        cache["k"][i, :, :, :s] = k.to(cache_dtype)
        cache["v"][i, :, :, :s] = v.to(cache_dtype)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = (x[:, -1] @ L.cast(_head_w(params, cfg), cfg)).float()
    return logits, cache


def _attn_probs_mass(q: torch.Tensor, kk: torch.Tensor, pos: int):
    """(B, S) attention probability mass of one decode query, summed over
    heads, against the whole cache (columns past ``pos`` hidden)."""
    s_cache = kk.shape[2]
    scores = torch.matmul(L._grouped(q.float(), kk.shape[1]),
                          kk.float().unsqueeze(2).transpose(-1, -2))
    scores = scores / (q.shape[-1] ** 0.5)
    col = torch.arange(s_cache, device=q.device)
    scores = torch.where(col <= pos, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return probs.sum(dim=(1, 2, 3))


def decode_step(
    cfg: ModelConfig,
    params: Dict[str, Any],
    token: torch.Tensor,             # (B,) newest token
    cache: Dict[str, Any],
    pos: int,                        # write position
    return_attn_mass: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any], Optional[torch.Tensor]]:
    """One decode step. Returns (logits (B, V), cache, attn_mass (B, S)|None).

    ``attn_mass`` is the per-cache-position attention probability mass
    summed over heads and averaged over layers: the importance score the
    RMQ eviction manager indexes.  The cache is written in place (the
    new token's k / v at ``pos``) and returned.
    """
    check_supported(cfg, serving=True)
    x = _embed(params, token[:, None], cfg)
    s_cache = cache["k"].shape[-2]
    mass = torch.zeros((token.shape[0], max(s_cache, 1)),
                       dtype=torch.float32, device=x.device)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for i, p in enumerate(params["layers"]):
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, (nk, _) = L.gqa_decode(p["attn"], h, cfg,
                                  (cache["k"][i], cache["v"][i]), pos,
                                  window=cfg.sliding_window)
        if return_attn_mass:
            # recompute q for the mass (cheap: one token), as the
            # reference does
            q = L._split_heads(L.dense(p["attn"]["q"], h, cfg),
                               cfg.num_heads, cfg.head_dim)
            q = L.apply_rope(q, posv, cfg.rope_theta)
            mass = mass + _attn_probs_mass(q, nk, pos)
        if cfg.parallel_block:
            x = x + a + L.mlp(p["mlp"], h, cfg)
        else:
            x = x + a
            x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                          cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = (x[:, 0] @ L.cast(_head_w(params, cfg), cfg)).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if return_attn_mass and s_cache:
        return logits, cache, mass / cfg.num_layers
    return logits, cache, None

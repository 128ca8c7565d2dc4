"""LM assembly: init / forward / prefill / decode for the ported families.

The port of ``repro.models.lm`` for these families:

* ``dense`` with GQA attention (llama3.2-3b, qwen1.5-0.5b,
  command-r-plus-104b): RMSNorm, SwiGLU, RoPE, optional ``qkv_bias``,
  ``parallel_block``, ``sliding_window`` and ``logit_softcap`` where the
  reference has them; or with MLA (minicpm3-4b: latent attention on the
  plain route the reference takes for it, an absorbed decode over a cache
  of the latent and one shared rope key a position);
* ``ssm`` (mamba2-1.3b): Mamba-2 blocks only, attention-free, through
  :mod:`repro_torch.models.ssm` and the SSD scan B9;
* ``hybrid`` (hymba-1.5b): attention and a Mamba-2 block at ``d_inner =
  d_model`` read the same normed input; their outputs are RMSNormed,
  scaled by float32 beta vectors and averaged.  Each layer has its own
  attention window (:func:`layer_windows`: global every
  ``global_attn_every``-th layer, ``sliding_window`` elsewhere);
* ``moe`` (qwen2-moe-a2.7b): GQA attention and a routed FFN
  (:mod:`repro_torch.models.moe`) in every layer; with
  ``moe_layer_period == 2`` (llama4) a step of two layers, a dense one
  then a MoE one (``{"dense", "moe"}``, ``num_layers // 2`` steps, the
  reference's scan steps);
* ``vlm`` / ``audio`` (internvl2-2b, musicgen-medium): dense trunks that
  take an optional prefix of frontend embeddings
  (:mod:`repro_torch.models.frontends`), concatenated ahead of the token
  embeddings.

Every entry point (:func:`init_params`, :func:`forward`,
:func:`make_decode_cache`, :func:`prefill`, :func:`decode_step`) takes
them all.  On the card a prefill launches B8 once a GQA attention layer
and B9 once an SSM block; decode launches neither (einsums and the
one-step recurrence, as in the reference), and neither MLA's attention
nor the MoE dispatch has a kernel in either package.  The reference
carries the hybrid's windows as scanned data; here they are Python ints,
so B8 takes every hybrid layer, windowed or global.

The reference's ``lax.scan`` over stacked layer parameters becomes a
Python loop over a list of per-layer dicts; its ``remat`` wrapper of the
scan body becomes a wrapper of each block (``train.train_step.make_remat``).

Parameters: ``{"embed": {"w"}, "layers": [layer, ...], "final_norm":
{"scale"}, "lm_head": {"w"}}`` (no ``lm_head`` with tied embeddings); a
dense layer is ``{"ln1", "attn", "mlp"[, "ln2"]}`` (an MLA ``attn`` is
``{"q_a", "q_a_norm", "q_b", "kv_a", "kv_a_norm", "kv_b", "o"}``), a MoE
layer ``{"ln1", "attn", "ln2", "moe"}``, a period-2 step ``{"dense",
"moe"}``, an SSM layer ``{"ln", "ssm"}``, a hybrid layer ``{"ln1",
"attn", "ssm", "norm_attn", "norm_ssm", "beta_attn", "beta_ssm", "ln2",
"mlp"}``.
:func:`init_params` draws them from a seeded ``torch.Generator`` on the
target device;
:func:`repro_torch.models.interop.params_from_reference` carries the
reference's parameters across.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

__all__ = [
    "decode_step",
    "forward",
    "init_params",
    "layer_windows",
    "make_decode_cache",
    "prefill",
]


def _layer_kind(cfg: ModelConfig) -> str:
    if cfg.family == "hybrid":
        return "hybrid"
    if cfg.is_attention_free:
        return "ssm"
    if cfg.uses_moe and cfg.moe_layer_period == 2:
        return "moe_period2"
    if cfg.uses_moe:
        return "moe"
    return "dense"


def _num_steps(cfg: ModelConfig) -> int:
    """Entries of ``params["layers"]``: the reference's scan steps (two
    layers a step for ``moe_period2``)."""
    if _layer_kind(cfg) == "moe_period2":
        if cfg.num_layers % 2:
            raise ValueError(f"{cfg.name}: a period-2 interleave needs an "
                             f"even layer count, not {cfg.num_layers}")
        return cfg.num_layers // 2
    return cfg.num_layers


def layer_windows(cfg: ModelConfig, seq_len: int) -> Optional[List[int]]:
    """Per-layer attention windows of a hybrid model (None for the other
    families): ``seq_len + 1`` on global layers (every
    ``global_attn_every``-th, from layer 0), ``sliding_window`` elsewhere.
    Python ints, as the B8 wrapper takes them."""
    if cfg.family != "hybrid":
        return None
    full = seq_len + 1
    every = cfg.global_attn_every
    return [full if every and i % every == 0 else (cfg.sliding_window or full)
            for i in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_dense_layer(gen: torch.Generator, cfg: ModelConfig, dtype):
    init_attn = L.mla_init if cfg.attention_type == "mla" else L.gqa_init
    p = {
        "ln1": L.rmsnorm_init(cfg.d_model, gen.device),
        "attn": init_attn(gen, cfg, dtype),
        "mlp": L.mlp_init(gen, cfg, dtype),
    }
    if not cfg.parallel_block:
        p["ln2"] = L.rmsnorm_init(cfg.d_model, gen.device)
    return p


def _init_moe_layer(gen: torch.Generator, cfg: ModelConfig, dtype):
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, gen.device),
        "attn": L.gqa_init(gen, cfg, dtype),
        "ln2": L.rmsnorm_init(cfg.d_model, gen.device),
        "moe": MOE.moe_init(gen, cfg, dtype),
    }


def _init_period2_step(gen: torch.Generator, cfg: ModelConfig, dtype):
    return {"dense": _init_dense_layer(gen, cfg, dtype),
            "moe": _init_moe_layer(gen, cfg, dtype)}


def _init_ssm_layer(gen: torch.Generator, cfg: ModelConfig, dtype):
    return {
        "ln": L.rmsnorm_init(cfg.d_model, gen.device),
        "ssm": SSM.ssm_init(gen, cfg, dtype),
    }


def _init_hybrid_layer(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, dev = cfg.d_model, gen.device
    return {
        "ln1": L.rmsnorm_init(d, dev),
        "attn": L.gqa_init(gen, cfg, dtype),
        # the SSM path mirrors the attention width (expand 1)
        "ssm": SSM.ssm_init(gen, cfg, dtype, d_inner=d),
        "norm_attn": L.rmsnorm_init(d, dev),
        "norm_ssm": L.rmsnorm_init(d, dev),
        "beta_attn": torch.ones((d,), dtype=torch.float32, device=dev),
        "beta_ssm": torch.ones((d,), dtype=torch.float32, device=dev),
        "ln2": L.rmsnorm_init(d, dev),
        "mlp": L.mlp_init(gen, cfg, dtype),
    }


_INIT_LAYER = {"dense": _init_dense_layer, "moe": _init_moe_layer,
               "moe_period2": _init_period2_step, "ssm": _init_ssm_layer,
               "hybrid": _init_hybrid_layer}


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``.

    Matrices (the MoE router, expert stacks and shared gate included) are
    held in ``dtype`` (default: the compute dtype; the train path asks for
    float32 masters), vectors (norm scales, the hybrid's betas) and the
    SSM's ``conv_w`` in float32.  The draws differ from the
    reference's ``jax.random``.  ``device="meta"`` gives meta tensors of
    the same shapes and dtypes, at any width.
    """
    init_layer = _INIT_LAYER[_layer_kind(cfg)]
    dev = resolve_device(device)
    dtype = dtype or L.cdtype(cfg)
    if dev.type == "meta":
        # shapes and dtypes only (the sharding rules at full width): a
        # generator cannot live on the meta device, so trace the CPU init
        # with fake tensors and hand back meta tensors
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.train.tree import tree_map

        with FakeTensorMode():
            fake = init_params(cfg, seed, "cpu", dtype)
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=dev), fake)
    gen = torch.Generator(device=dev).manual_seed(seed)
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                        device=dev, dtype=torch.float32) * 0.02
    params = {
        "embed": {"w": embed.to(dtype)},
        "layers": [init_layer(gen, cfg, dtype)
                   for _ in range(_num_steps(cfg))],
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


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           prefix_embeddings=None) -> torch.Tensor:
    """Token embeddings in the compute dtype, behind the frontend prefix
    (B, F, D) where one is given."""
    x = L.cast(params["embed"]["w"][tokens.long()], cfg)
    if prefix_embeddings is None:
        return x
    prefix = torch.as_tensor(prefix_embeddings, device=x.device)
    return torch.cat([L.cast(prefix, cfg), x], dim=1)


# ---------------------------------------------------------------------------
# Block bodies (full-sequence)
# ---------------------------------------------------------------------------
def _dense_block(cfg: ModelConfig, p, x: torch.Tensor, positions,
                 attn_impl: str):
    """A dense layer: ``(x, cache payload)``, the payload ``(k, v)`` for
    GQA and ``(latent, k_rope)`` for MLA (whose attention takes no
    ``attn_impl``, as in the reference)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.attention_type == "mla":
        a, kv, _ = L.mla_attention(p["attn"], h, cfg, positions)
    else:
        a, kv, _ = L.gqa_attention(p["attn"], h, cfg, positions,
                                   window=cfg.sliding_window,
                                   attn_impl=attn_impl)
    if cfg.parallel_block:
        return x + a + L.mlp(p["mlp"], h, cfg), kv
    x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, cfg), kv


def _moe_block(cfg: ModelConfig, p, x: torch.Tensor, positions,
               attn_impl: str, mesh=None, batch_axes=()):
    """A MoE layer: ``(x, (k, v), aux)``; ``mesh`` and ``batch_axes`` go
    to :func:`repro_torch.models.moe.moe_apply`."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, kv, _ = L.gqa_attention(p["attn"], h, cfg, positions,
                               window=cfg.sliding_window, attn_impl=attn_impl)
    x = x + a
    y, aux = MOE.moe_apply(p["moe"], L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                           cfg, mesh=mesh, batch_axes=batch_axes)
    return x + y, kv, aux


def _ssm_block(cfg: ModelConfig, p, x: torch.Tensor):
    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    return x + SSM.ssm_apply(p["ssm"], h, cfg)


def _hybrid_out(cfg: ModelConfig, p, x, a, s):
    """The hybrid layer after its two heads: each output RMSNormed and
    scaled by its float32 beta, the sum halved (float32) and cast to
    ``x``'s dtype, then the MLP."""
    fused = (p["beta_attn"] * L.rmsnorm(p["norm_attn"], a, cfg.norm_eps)
             + p["beta_ssm"] * L.rmsnorm(p["norm_ssm"], s, cfg.norm_eps)
             ) * 0.5
    x = x + fused.to(x.dtype)
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)


def _hybrid_block(cfg: ModelConfig, p, x: torch.Tensor, positions,
                  window: int, attn_impl: str):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, kv, _ = L.gqa_attention(p["attn"], h, cfg, positions, window=window,
                               attn_impl=attn_impl)
    s = SSM.ssm_apply(p["ssm"], h, cfg, d_inner=cfg.d_model)
    return _hybrid_out(cfg, p, x, a, s), kv


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
    prefix_embeddings: Optional[torch.Tensor] = None,   # (B, F, D)
    mesh=None,
    batch_axes: Tuple[str, ...] = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(logits (B, F + S, V) float32, aux)``; ``aux`` is the sum
    of the MoE layers' auxiliary losses (0 without MoE layers).

    ``tokens`` are this rank's rows of a micro-batch split over the
    ``batch_axes`` of ``mesh`` (None: one process, the whole batch); the
    MoE layers route over the whole micro-batch
    (:func:`repro_torch.models.moe.moe_apply`).

    ``prefix_embeddings`` (a frontend's) go ahead of the token embeddings,
    cast to the compute dtype.  ``remat`` wraps each block's function (the
    reference wraps its scan body; here a period-2 step, both of its
    layers), e.g. in ``torch.utils.checkpoint``; ``return_hidden=True``
    skips the LM head and returns the final-normed hidden states (the
    chunked loss applies the head per sequence chunk).  ``attn_impl`` goes
    to the attention of every block.
    """
    kind = _layer_kind(cfg)
    x = _embed(params, tokens, cfg, prefix_embeddings)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    routed = kind in ("moe", "moe_period2")
    if kind == "ssm":
        def block(x, p, w):
            return _ssm_block(cfg, p, x)
    elif kind == "hybrid":
        def block(x, p, w):
            return _hybrid_block(cfg, p, x, positions, w, attn_impl)[0]
    elif kind == "moe":
        def block(x, p, w):
            x, _, aux = _moe_block(cfg, p, x, positions, attn_impl, mesh,
                                   batch_axes)
            return x, aux
    elif kind == "moe_period2":
        def block(x, p, w):
            x, _ = _dense_block(cfg, p["dense"], x, positions, attn_impl)
            x, _, aux = _moe_block(cfg, p["moe"], x, positions, attn_impl,
                                   mesh, batch_axes)
            return x, aux
    else:
        def block(x, p, w):
            return _dense_block(cfg, p, x, positions, attn_impl)[0]
    if remat is not None:
        block = remat(block)
    windows = layer_windows(cfg, s) or [None] * len(params["layers"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, w in zip(params["layers"], windows):
        if routed:
            x, a = block(x, p, w)
            aux = aux + a
        else:
            x = block(x, p, w)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
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
    """Zero-initialized decode cache sized for ``seq_len`` positions.

    GQA attention families (dense, MoE, frontend trunks, hybrid): ``k`` and
    ``v`` (layers, B, Hkv, seq_len, head_dim) in ``dtype``; a period-2
    model's layers in layer order (dense, MoE, dense, MoE, ...), as the
    reference's reshape of its (steps, 2) stack leaves them.  MLA:
    ``latent`` (layers, B, seq_len, kv_lora_rank) and ``rope`` (layers, B,
    seq_len, qk_rope_head_dim) in ``dtype``, and no ``k`` / ``v``.  SSM and
    hybrid: ``ssd`` (layers, B, H, P, N) float32 and ``conv`` (layers, B,
    conv - 1, d_inner + 2N) in ``dtype`` (a prefill or decode step leaves
    ``conv`` in the compute dtype, as the reference does)."""
    kind = _layer_kind(cfg)
    dev = resolve_device(device)
    nl = cfg.num_layers
    cache: Dict[str, Any] = {}
    if cfg.attention_type == "mla":
        cache["latent"] = torch.zeros((nl, batch, seq_len, cfg.kv_lora_rank),
                                      dtype=dtype, device=dev)
        cache["rope"] = torch.zeros(
            (nl, batch, seq_len, cfg.qk_rope_head_dim), dtype=dtype,
            device=dev)
    elif kind != "ssm":
        shape = (nl, batch, cfg.num_kv_heads, seq_len, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if kind in ("ssm", "hybrid"):
        di = cfg.d_model if kind == "hybrid" else cfg.d_inner
        n = cfg.ssm_state
        cache["ssd"] = torch.zeros(
            (nl, batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
            dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros((nl, batch, cfg.ssm_conv - 1, di + 2 * n),
                                    dtype=dtype, device=dev)
    return cache


def prefill(
    cfg: ModelConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,                  # (B, S)
    cache_len: int,
    cache_dtype=torch.bfloat16,
    attn_impl: str = "auto",
    prefix_embeddings: Optional[torch.Tensor] = None,   # (B, F, D)
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence pass that fills a decode cache of ``cache_len`` slots.

    Returns (last-position logits (B, V) float32, cache).  As in the
    reference, prefill applies no ``logit_softcap``.  A frontend prefix
    takes the first F slots, so ``cache_len`` must hold F + S.  The SSM
    blocks run ``ssm_prefill`` (B9 with the final state, once a block on
    the card); ``attn_impl`` goes to every GQA attention.  An MLA model
    fills ``latent`` / ``rope`` up to S and leaves the rest zero.
    """
    kind = _layer_kind(cfg)
    x = _embed(params, tokens, cfg, prefix_embeddings)
    s = x.shape[1]
    if kind != "ssm" and s > cache_len:
        raise ValueError(f"prompt of {s} positions exceeds cache_len "
                         f"{cache_len}")
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    windows = layer_windows(cfg, s) or [None] * len(params["layers"])
    cache = make_decode_cache(cfg, tokens.shape[0], cache_len, cache_dtype,
                              x.device)

    def put(i, kv):
        if cfg.attention_type == "mla":
            cache["latent"][i, :, :s] = kv[0].to(cache_dtype)
            cache["rope"][i, :, :s] = kv[1].to(cache_dtype)
            return
        cache["k"][i, :, :, :s] = kv[0].to(cache_dtype)
        cache["v"][i, :, :, :s] = kv[1].to(cache_dtype)

    states = []
    for i, (p, w) in enumerate(zip(params["layers"], windows)):
        if kind == "ssm":
            h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
            out, state = SSM.ssm_prefill(p["ssm"], h, cfg)
            x = x + out
            states.append(state)
            continue
        if kind == "hybrid":
            h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
            a, kv, _ = L.gqa_attention(p["attn"], h, cfg, positions,
                                       window=w, attn_impl=attn_impl)
            out, state = SSM.ssm_prefill(p["ssm"], h, cfg,
                                         d_inner=cfg.d_model)
            x = _hybrid_out(cfg, p, x, a, out)
            states.append(state)
        elif kind == "moe":
            x, kv, _ = _moe_block(cfg, p, x, positions, attn_impl)
        elif kind == "moe_period2":
            x, kv = _dense_block(cfg, p["dense"], x, positions, attn_impl)
            put(2 * i, kv)
            x, kv, _ = _moe_block(cfg, p["moe"], x, positions, attn_impl)
            put(2 * i + 1, kv)
            continue
        else:
            x, kv = _dense_block(cfg, p, x, positions, attn_impl)
        put(i, kv)
    if states:
        cache["ssd"] = torch.stack([st.ssd for st in states])
        cache["conv"] = torch.stack([st.conv for st in states])
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


def _decode_attention(cfg: ModelConfig, p, x, cache, i: int, pos: int,
                      window, mass: Optional[torch.Tensor]):
    """The attention half of a dense or MoE layer at one decode step:
    ``(h, a, mass)``, the layer's cache rows written in place; the layer's
    attention mass is added to ``mass`` unless it is None."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, (nk, _) = L.gqa_decode(p["attn"], h, cfg,
                              (cache["k"][i], cache["v"][i]), pos,
                              window=window)
    if mass is not None:
        # recompute q for the mass (cheap: one token), as the reference
        # does
        q = L._split_heads(L.dense(p["attn"]["q"], h, cfg), cfg.num_heads,
                           cfg.head_dim)
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = L.apply_rope(q, posv, cfg.rope_theta)
        mass = mass + _attn_probs_mass(q, nk, pos)
    return h, a, mass


def _decode_ffn(cfg: ModelConfig, p, x, h, a):
    """The rest of a dense or MoE layer after its attention output ``a``."""
    if "moe" in p:
        x = x + a
        y, _ = MOE.moe_apply(p["moe"], L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                             cfg)
        return x + y
    if cfg.parallel_block:
        return x + a + L.mlp(p["mlp"], h, cfg)
    x = x + a
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)


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
    summed over heads and averaged over the reference's scan steps: the
    importance score the RMQ eviction manager indexes.  As in the
    reference, only dense GQA and MoE layers add to it: a period-2 (llama4)
    or hybrid model returns zeros of shape (B, S), and an SSM model (no KV
    cache) or an MLA one (its cache has no ``k``) None.  The new token's
    k / v (MLA: latent / rope) are written into the cache in place at
    ``pos`` and the same dict comes back; with SSM blocks a new
    dict comes back, holding the same ``k`` / ``v`` and the new state and
    conv tail as new tensors (``ssd`` float32, ``conv`` in the compute
    dtype).
    """
    kind = _layer_kind(cfg)
    x = _embed(params, token[:, None], cfg)
    s_cache = cache["k"].shape[-2] if "k" in cache else 0
    mass = torch.zeros((token.shape[0], max(s_cache, 1)),
                       dtype=torch.float32, device=x.device)
    windows = layer_windows(cfg, 10 ** 9) or [cfg.sliding_window] * len(
        params["layers"])
    states = []
    for i, (p, w) in enumerate(zip(params["layers"], windows)):
        if kind in ("ssm", "hybrid"):
            h = L.rmsnorm(p["ln" if kind == "ssm" else "ln1"], x,
                          cfg.norm_eps)
            out, state = SSM.ssm_decode(
                p["ssm"], h, cfg,
                SSM.SSMState(ssd=cache["ssd"][i], conv=cache["conv"][i]),
                d_inner=cfg.d_model if kind == "hybrid" else None)
            states.append(state)
            if kind == "ssm":
                x = x + out
                continue
            a, _ = L.gqa_decode(p["attn"], h, cfg,
                                (cache["k"][i], cache["v"][i]), pos,
                                window=w)
            x = _hybrid_out(cfg, p, x, a, out)
            continue
        if kind == "moe_period2":
            # the reference adds no mass for either half of the step
            for j, half in enumerate((p["dense"], p["moe"])):
                h, a, _ = _decode_attention(cfg, half, x, cache, 2 * i + j,
                                            pos, None, None)
                x = _decode_ffn(cfg, half, x, h, a)
            continue
        if cfg.attention_type == "mla":
            h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
            a, _ = L.mla_decode(p["attn"], h, cfg,
                                (cache["latent"][i], cache["rope"][i]), pos)
        else:
            h, a, mass = _decode_attention(
                cfg, p, x, cache, i, pos, w,
                mass if return_attn_mass else None)
        x = _decode_ffn(cfg, p, x, h, a)
    if states:
        cache = dict(cache)
        cache["ssd"] = torch.stack([st.ssd for st in states])
        cache["conv"] = torch.stack([st.conv for st in states])
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = (x[:, 0] @ L.cast(_head_w(params, cfg), cfg)).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if return_attn_mass and s_cache:
        return logits, cache, mass / _num_steps(cfg)
    return logits, cache, None

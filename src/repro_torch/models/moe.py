"""Mixture-of-Experts layer: top-k routing, capacity dispatch, shared expert.

The port of ``repro.models.moe``, over the whole micro-batch on each rank:
one device, or a mesh whose ``model`` axis alone is > 1, where every rank
holds every row and the reference's per-data-shard ``shard_map`` dispatch
computes the same layer.  On a data axis > 1 the reference routes, counts
capacity and takes the aux loss over the whole micro-batch, which a rank
holding its own rows cannot; ``launch/train.py`` refuses it (ROADMAP
A10c).  The reference computes the layer with gathers, a scatter-add and einsums, outside any
Pallas kernel; here the same steps are PyTorch operations and the expert
FFNs batched products over the expert axis (``torch.bmm``).  What the
code does, where the reference's docstring says otherwise:

* the router is a float32 softmax over ``x @ router`` (the product in the
  compute dtype), its top k renormalized only when k > 1, so llama4
  (k = 1) weighs its expert by the softmax probability;
* the top k come from a stable descending sort: on equal probabilities
  the lower expert index comes first, as ``jax.lax.top_k`` orders them
  (``torch.topk`` promises no order on ties);
* the dispatch ranks each (token, slot) pair within its expert by a
  stable argsort of the flat expert ids, in (token, slot) order; pairs of
  rank >= capacity drop (their weight is 0).  Only kept pairs are written
  into the (E * C, D) buffer: the reference parks dropped pairs, as
  zeros, in slot E * C - 1, which leaves the same numbers;
* the shared expert is gated by ``sigmoid(x @ shared_gate)`` in float32,
  cast to the output's dtype;
* the aux loss is ``coef * E * sum(mean(probs) * counts / T)``.

:func:`moe_apply` is :func:`route`, :func:`dispatch`, :func:`experts` and
:func:`combine` in turn, so a caller can time each step.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import cast, mlp, mlp_init

__all__ = ["capacity", "combine", "dispatch", "experts", "moe_apply",
           "moe_init", "route"]


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """Router (D, E), ``w_gate`` / ``w_up`` (E, D, F), ``w_down`` (E, F, D),
    and with ``shared_expert_d_ff`` a SwiGLU ``shared`` expert and its
    ``shared_gate`` (D, 1); drawn in float32, held in ``dtype``."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    dev = gen.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    scale = 1.0 / math.sqrt(d)
    p = {
        "router": normal((d, e), scale),
        "w_gate": normal((e, d, f), scale),
        "w_up": normal((e, d, f), scale),
        "w_down": normal((e, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.shared_expert_d_ff:
        p["shared"] = mlp_init(gen, cfg, dtype, d_ff=cfg.shared_expert_d_ff)
        p["shared_gate"] = normal((d, 1), scale)
    return p


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert: ``ceil(T * k * capacity_factor / E)``, rounded up to
    a multiple of 128 (at least 128) from 4096 tokens, else of 8 (at least
    8)."""
    c = math.ceil(tokens * cfg.num_experts_per_tok * cfg.capacity_factor
                  / cfg.num_experts)
    if tokens >= 4096:
        return max(128, -(-c // 128) * 128)
    return max(8, -(-c // 8) * 8)


def route(p, xt: torch.Tensor, cfg: ModelConfig):
    """``(probs (T, E) float32, top_p (T, k) float32, top_e (T, k) int64)``."""
    k = cfg.num_experts_per_tok
    logits = (xt @ cast(p["router"], cfg)).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = vals[:, :k], idx[:, :k]
    if k > 1:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_e


def _counts(top_e: torch.Tensor, e: int) -> torch.Tensor:
    flat = top_e.reshape(-1)
    return torch.zeros((e,), dtype=flat.dtype, device=flat.device
                       ).scatter_add_(0, flat, torch.ones_like(flat))


def dispatch(xt: torch.Tensor, top_e: torch.Tensor, cap: int, e: int):
    """The (E, cap, D) expert buffer, each pair's slot ``dest`` (T * k,)
    and ``keep`` (T * k,) bool.  ``dest`` of a dropped pair is E * cap - 1,
    the reference's parking slot, which the buffer never receives."""
    d = xt.shape[1]
    k = top_e.shape[1]
    flat_e = top_e.reshape(-1)
    n = flat_e.shape[0]
    counts = _counts(top_e, e)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=order.device, dtype=order.dtype))
    offsets = torch.cumsum(counts, 0) - counts
    rank = inv - offsets[flat_e]
    keep = rank < cap
    slot = flat_e * cap + rank
    dest = torch.where(keep, slot, torch.full_like(slot, e * cap - 1))
    # kept pairs only: a dropped pair goes to one scratch row past the end
    buf = xt.new_zeros((e * cap + 1, d))
    buf.index_copy_(0, torch.where(keep, slot, torch.full_like(slot, e * cap)),
                    xt.repeat_interleave(k, dim=0))
    return buf[:e * cap].view(e, cap, d), dest, keep


def experts(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert's slots: (E, C, D) -> (E, C, D)."""
    return torch.bmm(F.silu(torch.bmm(h, w_gate)) * torch.bmm(h, w_up),
                     w_down)


def combine(o: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
            top_p: torch.Tensor) -> torch.Tensor:
    """Each token's kept slots weighted by their routing probability and
    summed: (E, C, D) -> (T, D)."""
    t, k = top_p.shape
    d = o.shape[-1]
    per_tk = o.reshape(-1, d)[dest]                              # (T*k, D)
    w = (top_p.reshape(-1) * keep.float()).to(per_tk.dtype)
    return (per_tk * w[:, None]).reshape(t, k, d).sum(dim=1)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(output with x's shape, aux loss () float32)`` for ``x`` (B, S, D)
    or (T, D)."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    t, e = xt.shape[0], cfg.num_experts
    probs, top_p, top_e = route(p, xt, cfg)
    counts = _counts(top_e, e)
    aux = cfg.router_aux_loss_coef * e * torch.sum(
        probs.mean(dim=0) * (counts.float() / t))
    h, dest, keep = dispatch(xt, top_e, capacity(cfg, t), e)
    o = experts(h, cast(p["w_gate"], cfg), cast(p["w_up"], cfg),
                cast(p["w_down"], cfg))
    y = combine(o, dest, keep, top_p)
    if "shared" in p:
        gate = torch.sigmoid((xt @ cast(p["shared_gate"], cfg)).float()
                             ).to(y.dtype)
        y = y + gate * mlp(p["shared"], xt, cfg)
    return y.reshape(x.shape), aux

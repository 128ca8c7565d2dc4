"""Mixture-of-Experts layer: top-k routing, capacity dispatch, shared expert.

The port of ``repro.models.moe``.  The reference computes the layer with
gathers, a scatter-add and einsums, outside any Pallas kernel; here the
same steps are PyTorch operations and the expert FFNs batched products
over the expert axis (``torch.bmm``).

Under GSPMD the reference sees the whole micro-batch of ``T`` tokens.  A
rank of the port holds its rows of it, ``t = T / n_dp`` tokens, where
``n_dp`` is the product of the data axes the rows are split over (the
``mesh`` and ``batch_axes`` that ``models.lm.forward`` passes down; a
micro-batch they do not divide goes whole to every rank, and ``n_dp`` is
then 1).  Each rank routes its own rows, and only these numbers need the
other ranks:

* the aux loss is the whole micro-batch's: the counts are summed over the
  data axes, and the local term is ``coef * E * sum(probs_sum * n_dp / T
  * counts_total / T)``, so that the mean over the data ranks, which
  :func:`repro_torch.distributed.sharded.reduce_grads` takes of the aux
  loss and of the gradients, is the reference's value and its router
  gradient (the counts carry no gradient);
* below 4096 tokens, or on a mesh without a ``model`` axis, the dispatch
  is global: capacity ``capacity(cfg, T)``, and a (token, slot) pair is
  kept when its rank within its expert in the whole micro-batch's
  (token, slot) order is below it.  That rank is the local rank plus the
  pairs of the same expert on the rows of the data coordinates before
  this rank's (an exclusive prefix of the gathered counts: rows are split
  in data-coordinate order, and ranks that differ on ``model`` alone hold
  the same rows).  Every row's expert output depends on that row alone,
  so the products stay local;
* from 4096 tokens on a mesh with a ``model`` axis, each data shard
  dispatches alone with capacity ``capacity(cfg, T // n_dp)``, as the
  reference's ``shard_map`` does; the aux loss stays global.

The counts move in one collective a data axis of size > 1 (an
``all_gather`` for the global dispatch, an ``all_reduce`` for the
per-shard one; nothing on an axis of size 1), counted in
``sharded.COLLECTIVES``; under remat the block's recomputed forward makes
them again, in the same order on every rank.  Without a mesh the layer
is the one-device layer.  What the code does, where the reference's
docstring says otherwise:

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
from typing import Optional, Sequence, Tuple

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


def dispatch(xt: torch.Tensor, top_e: torch.Tensor, cap: int, e: int,
             before: Optional[torch.Tensor] = None):
    """The (E, cap, D) expert buffer, each pair's slot ``dest`` (T * k,)
    and ``keep`` (T * k,) bool.  ``dest`` of a dropped pair is E * cap - 1,
    the reference's parking slot, which the buffer never receives.
    ``before`` (E,), where given, counts each expert's pairs ahead of these
    rows: a pair is kept when its rank plus that count is below ``cap``."""
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
    keep = rank < cap if before is None else rank + before[flat_e] < cap
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


def _prefix_and_total(counts: torch.Tensor, mesh, axes: Sequence[str]):
    """``(before, total)``: each expert's pairs on the data coordinates
    before this rank's, and on all of them; one ``all_gather`` an axis,
    the fastest axis first."""
    from repro_torch.distributed import sharded

    before, total = torch.zeros_like(counts), counts
    for a in reversed(axes):
        rows = sharded.all_gather_rows(total, mesh, a)          # (n, E)
        before = before + rows[:sharded.coordinate(mesh, a)].sum(dim=0)
        total = rows.sum(dim=0)
    return before, total


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, mesh=None,
              batch_axes: Sequence[str] = ()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(output with x's shape, aux loss () float32)`` for ``x`` (B, S, D)
    or (T, D), this rank's rows of a micro-batch split over ``batch_axes``
    of ``mesh`` (see the module doc; without a mesh, the whole of it)."""
    from repro_torch.distributed import sharded

    d = x.shape[-1]
    xt = x.reshape(-1, d)
    t, e = xt.shape[0], cfg.num_experts
    probs, top_p, top_e = route(p, xt, cfg)
    counts = _counts(top_e, e)
    axes = sharded.data_axes(mesh, batch_axes)
    n_dp = math.prod(mesh.shape[a] for a in axes) if axes else 1
    big_t = t * n_dp
    before, total = None, counts
    if mesh is not None and "model" in mesh.shape and big_t >= 4096:
        cap = capacity(cfg, big_t // n_dp)           # each data shard alone
        if axes:
            total = sharded.all_reduce_sum(counts.clone(), mesh, axes)
    else:
        cap = capacity(cfg, big_t)                   # the whole micro-batch
        if axes:
            before, total = _prefix_and_total(counts, mesh, axes)
    if axes:
        aux = cfg.router_aux_loss_coef * e * torch.sum(
            probs.sum(dim=0) * (n_dp / big_t) * (total.float() / big_t))
    else:
        aux = cfg.router_aux_loss_coef * e * torch.sum(
            probs.mean(dim=0) * (counts.float() / t))
    h, dest, keep = dispatch(xt, top_e, cap, e, before)
    o = experts(h, cast(p["w_gate"], cfg), cast(p["w_up"], cfg),
                cast(p["w_down"], cfg))
    y = combine(o, dest, keep, top_p)
    if "shared" in p:
        gate = torch.sigmoid((xt @ cast(p["shared_gate"], cfg)).float()
                             ).to(y.dtype)
        y = y + gate * mlp(p["shared"], xt, cfg)
    return y.reshape(x.shape), aux

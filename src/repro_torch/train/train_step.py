"""The train step: remat, microbatched gradient accumulation, AdamW.

The port of ``repro.train.train_step``.  The returned function is
``train_step(state, batch) -> (state, metrics)``; PyTorch runs it eagerly
on the device the state lives on.

* **Masters** are float32 (:func:`init_train_state`).  Inside the loss the
  weights of rank >= 2 (by the reference's stacked rank,
  :func:`repro_torch.train.tree.stacked_ndim`) are cast to ``cfg.dtype``,
  as the reference's ``cast_params`` does, so the cast is differentiated
  and the gradients arrive in float32.
* **Gradients** go to ``grad_allreduce_dtype`` (bf16 by default) before
  AdamW; with ``microbatches > 1`` they are accumulated in that dtype in a
  Python loop (the reference's ``lax.scan``) and divided by the count.
* **Remat** (:func:`make_remat`) wraps each block of ``models.lm.forward``;
  it changes memory, never numbers:

  - ``none``: autograd keeps every activation;
  - ``full``: ``torch.utils.checkpoint`` (non-reentrant) around each block,
    which keeps only the block's input (the reference's
    ``nothing_saveable``);
  - ``names``: the same per-block checkpoint.  The reference saves the
    block outputs tagged ``blk_ssm`` / ``blk_attn`` / ``blk_ffn``; a
    block's output is the next block's input, which the checkpoint keeps;
  - ``minimal``: selective activation checkpointing that saves the outputs
    of matrix products (``aten.mm`` / ``aten.addmm``, the reference's
    ``dots_with_no_batch_dims_saveable``) and recomputes the rest.

  Under ``full``, ``names`` and ``minimal`` the backward re-runs each
  block's forward, so a CUDA kernel in a block (B8, B9) launches twice a
  step; under ``none`` once.

AdamW updates the masters and moments in place (see
:mod:`repro_torch.train.optimizer`); the returned state shares them.

A step is the gradient (:func:`build_grad_fn`) and then the update.
:func:`build_train_step` runs both in one process, or on a mesh of ranks,
each holding its blocks of the state and its rows of the batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.layers import cdtype
from repro_torch.models.lm import forward, init_params
from repro_torch.train.loss import chunked_next_token_loss, next_token_loss
from repro_torch.train.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.train.tree import leaves_with_path, stacked_ndim, tree_map

__all__ = ["TrainState", "build_grad_fn", "build_train_step",
           "init_train_state", "make_remat"]

REMAT_POLICIES = ("none", "minimal", "full", "names")


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState
    step: torch.Tensor           # () int32


def init_train_state(cfg: ModelConfig, tc: TrainConfig, seed: Optional[int]
                     = None, device=None,
                     blocks: Optional[Callable] = None) -> TrainState:
    """float32 masters from ``init_params(seed)`` (default ``tc.seed``) and
    zeroed AdamW moments in ``tc.optimizer_state_dtype``.  ``blocks``,
    where given, cuts the whole masters to this rank's blocks before the
    moments are made, so the moments are never whole."""
    params = init_params(cfg, seed=tc.seed if seed is None else seed,
                         device=device, dtype=torch.float32)
    if blocks is not None:
        params = blocks(params)
    return TrainState(
        params=params,
        opt=adamw_init(params, tc.optimizer_state_dtype),
        step=torch.zeros((), dtype=torch.int32,
                         device=params["embed"]["w"].device),
    )


def _checkpointed(fn: Callable, **kwargs) -> Callable:
    @functools.wraps(fn)
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return run


def _save_matmuls():
    """``context_fn`` of selective checkpointing that saves matrix products."""
    try:
        from torch.utils.checkpoint import (
            CheckpointPolicy,
            create_selective_checkpoint_contexts,
        )
    except ImportError as exc:  # selective checkpointing needs torch >= 2.4
        raise NotImplementedError(
            "remat policy 'minimal' needs torch.utils.checkpoint's selective "
            "checkpointing, which this torch lacks (ROADMAP A12)") from exc
    saved = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def make_remat(policy: str) -> Optional[Callable]:
    """A wrapper of a block's function, or None (see the module doc)."""
    if policy == "none":
        return None
    if policy in ("full", "names"):
        return _checkpointed
    if policy == "minimal":
        context_fn = _save_matmuls()
        return functools.partial(_checkpointed, context_fn=context_fn)
    raise ValueError(f"unknown remat policy {policy!r}; one of "
                     f"{REMAT_POLICIES}")


def cast_params(params, dtype: torch.dtype):
    """float32 weights of the reference's rank >= 2 in ``dtype`` (the
    reference's ``cast_params``); everything else as it is."""
    def one(path, p):
        if stacked_ndim(path, p) < 2 or p.dtype != torch.float32:
            return p
        return p.to(dtype)
    return tree_map(one, params, with_path=True)


def build_grad_fn(cfg: ModelConfig, tc: TrainConfig,
                  attn_impl: str = "auto", mesh=None,
                  batch_axes: Tuple[str, ...] = ()) -> Callable:
    """Returns ``grads_of(params, tokens, prefix, reduce=None) -> (grads,
    loss, aux)``: the gradients of the minimized loss (the next-token loss
    plus the MoE aux loss) in ``grad_allreduce_dtype``, a tree like
    ``params``, over ``microbatches`` micro-batches of the rows.
    ``mesh`` and ``batch_axes`` (the axes the rows are split over) go to
    ``forward``, whose MoE layers route over the whole micro-batch.

    ``reduce(grads, loss, aux)``, where given, runs on each micro-batch's
    float32 gradients (a list, in leaf order) and losses before the cast
    (see :mod:`repro_torch.distributed.sharded`), and returns them."""
    remat = make_remat(tc.remat_policy)
    prefix_len = cfg.frontend_tokens if cfg.frontend else 0
    acc_dtype = getattr(torch, tc.grad_allreduce_dtype)
    compute = cdtype(cfg)

    def loss_fn(params, tokens, prefix):
        params = cast_params(params, compute)
        out, aux = forward(cfg, params, tokens, attn_impl=attn_impl,
                           remat=remat, return_hidden=tc.loss_chunk > 0,
                           prefix_embeddings=prefix, mesh=mesh,
                           batch_axes=batch_axes)
        if tc.loss_chunk > 0:
            loss = chunked_next_token_loss(cfg, params, out, tokens,
                                           prefix_len=prefix_len,
                                           chunk=tc.loss_chunk)
        else:
            loss = next_token_loss(out, tokens, prefix_len=prefix_len)
        return loss + aux, loss, aux

    def single_micro(params, tokens, prefix, reduce):
        """Gradients in ``acc_dtype`` (a tree like ``params``), loss, aux."""
        with torch.enable_grad():
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            total, loss, aux = loss_fn(leaves, tokens, prefix)
            flat = [t for _, t in leaves_with_path(leaves)]
            grads = list(torch.autograd.grad(total, flat))
        loss, aux = loss.detach(), aux.detach()
        if reduce is not None:
            grads, loss, aux = reduce(grads, loss, aux)
        it = iter(grads)
        grads = tree_map(lambda _: next(it).to(acc_dtype), params)
        return grads, loss, aux

    def grads_of(params, tokens, prefix=None, reduce=None):
        k = tc.microbatches
        if k == 1:
            return single_micro(params, tokens, prefix, reduce)
        b = tokens.shape[0]
        if b % k:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"{k} microbatches")
        grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=acc_dtype, device=p.device), params)
        loss = aux = torch.zeros((), dtype=torch.float32,
                                 device=tokens.device)
        parts = (prefix.reshape(k, b // k, *prefix.shape[1:])
                 if prefix is not None else [None] * k)
        for t, pre in zip(tokens.reshape(k, b // k, *tokens.shape[1:]),
                          parts):
            g, l_i, a_i = single_micro(params, t, pre, reduce)
            grads = tree_map(torch.add, grads, g)
            loss, aux = loss + l_i, aux + a_i
        grads = tree_map(lambda g: g / k, grads)
        return grads, loss / k, aux / k

    return grads_of


def build_train_step(cfg: ModelConfig, tc: TrainConfig,
                     attn_impl: str = "auto", mesh=None, param_specs=None,
                     batch_axes: Tuple[str, ...] = ()):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: ``{"tokens": (B, S) integer tensor}`` on the state's device,
    and for a frontend model an optional ``"prefix"`` (B, F, D) of
    embeddings.  A frontend model's loss skips its F prefix positions
    (``prefix_len``), as the reference's does.  The minimized loss is the
    next-token loss plus the MoE aux loss; the metrics report both.
    ``attn_impl`` goes to ``forward``.

    On a ``mesh`` with a process group the state holds this rank's blocks
    (``param_specs``: the parameters' specs, which m and v share) and the
    batch this rank's rows (split over ``batch_axes``).  A step then:

    1. gathers the whole parameters;
    2. takes the gradients on this rank's rows;
    3. reduces them over ``batch_axes`` in float32, before the cast to
       ``grad_allreduce_dtype``, as the reference's cross-shard sum runs
       inside its gradient;
    4. clips by the global norm of the whole reduced gradients;
    5. runs AdamW on this rank's blocks of the parameters, m and v; the
       step and the count are replicated.

    The loss, aux loss and grad norm are the whole batch's, as the
    one-process step reports them.  Without a group every leaf is whole
    and these steps move nothing.
    """
    from repro_torch.distributed import sharded

    grads_of = build_grad_fn(cfg, tc, attn_impl, mesh=mesh,
                             batch_axes=batch_axes)

    def reduce(grads, loss, aux):
        return sharded.reduce_grads(grads, loss, aux, mesh, batch_axes)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = sharded.gather(state.params, param_specs, mesh)
        grads, loss, aux = grads_of(params, batch["tokens"],
                                    batch.get("prefix"), reduce=reduce)
        del params
        gnorm = global_norm(grads)      # of the whole gradients
        grads = sharded.local_blocks(grads, param_specs, mesh)
        params, opt, opt_metrics = adamw_update(grads, state.opt,
                                                state.params, tc,
                                                grad_norm=gnorm)
        metrics = {"loss": loss, "aux_loss": aux, "step": state.step + 1,
                   **opt_metrics}
        return TrainState(params=params, opt=opt, step=state.step + 1), metrics

    return train_step

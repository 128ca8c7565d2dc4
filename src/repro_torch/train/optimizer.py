"""AdamW with a dtype-configurable state, global-norm clipping and a cosine
schedule with warm-up.

The port of ``repro.train.optimizer``: plain functions over trees of
tensors that repeat the reference's arithmetic step for step (not
``torch.optim.AdamW``, which has no bfloat16 state and orders the update
differently):

* ``state_dtype="bfloat16"`` stores m / v in bf16; the update runs in
  float32 and the masters stay float32;
* decoupled weight decay, skipped for 1-D parameters by the reference's
  rank (:func:`repro_torch.train.tree.stacked_ndim`: a per-layer vector is
  a row of a stacked matrix there, so it is decayed; ``final_norm`` is
  not);
* bias correction ``1 - beta ** count`` in float32.

:func:`adamw_update` writes the new parameters and moments into the given
tensors (the reference returns new arrays): at mamba2-1.3b's size a
functional update would hold a second 16 GB copy of masters and moments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.train.tree import leaves_with_path, stacked_ndim, tree_map

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
]


@dataclasses.dataclass
class AdamWState:
    m: Any
    v: Any
    count: torch.Tensor          # () int32


def adamw_init(params, state_dtype: str = "float32") -> AdamWState:
    dt = getattr(torch, state_dtype)
    device = next(leaves_with_path(params))[1].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in leaves_with_path(tree)))


def cosine_schedule(tc: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``learning_rate``, then a cosine to a tenth of it."""
    def lr_at(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = tc.learning_rate * step / max(tc.warmup_steps, 1)
        prog = torch.clamp(
            (step - tc.warmup_steps)
            / max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
        cos = 0.1 * tc.learning_rate + 0.9 * tc.learning_rate * 0.5 * (
            1.0 + torch.cos(math.pi * prog))
        return torch.where(step < tc.warmup_steps, warm, cos)

    return lr_at


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, tc: TrainConfig,
                 grad_norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns ``(params, state, metrics)``:
    the same parameter and moment tensors, updated, and a new count.
    ``grad_norm`` is the norm to clip by where ``grads`` are one rank's
    blocks of the whole gradients (default: the norm of ``grads``)."""
    count = state.count + 1
    lr = cosine_schedule(tc)(count)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(tc.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = tc.beta1, tc.beta2
    cf = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=cf.device), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=cf.device), cf)

    leaves = zip(leaves_with_path(params), leaves_with_path(grads),
                 leaves_with_path(state.m), leaves_with_path(state.v))
    for (path, p), (_, g), (_, m), (_, v) in leaves:
        g = g.float() * clip
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * g * g
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + tc.eps)
        wd = tc.weight_decay if stacked_ndim(path, p) >= 2 else 0.0
        p32 = p.float()
        p.copy_(p32 - lr * (update + wd * p32))
        m.copy_(m32)
        v.copy_(v32)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(m=state.m, v=state.v, count=count), metrics

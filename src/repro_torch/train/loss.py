"""Next-token cross-entropy with the reference's z-loss.

The port of ``repro.train.loss``: :func:`next_token_loss` over full logits
and :func:`chunked_next_token_loss`, which applies the LM head one
sequence chunk at a time under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint``), so the (B, S, V) float32 logits never
exist at once and the backward recomputes each chunk's logits.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L

__all__ = ["chunked_next_token_loss", "next_token_loss"]


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    prefix_len: int = 0,
                    z_loss_coef: float = 1e-4) -> torch.Tensor:
    """Mean NLL of ``tokens[:, 1:]`` given the positions predicting them;
    with a frontend prefix of length F, ``logits[:, F + i]`` predicts
    ``tokens[:, i + 1]``."""
    s = tokens.shape[1]
    pred = logits[:, prefix_len:prefix_len + s - 1]          # (B, S-1, V)
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(pred, dim=-1)
    gold = torch.gather(pred, -1, targets[..., None])[..., 0]
    nll = (logz - gold).mean()
    if z_loss_coef:
        nll = nll + z_loss_coef * torch.square(logz).mean()
    return nll


def chunked_next_token_loss(cfg, params, hidden: torch.Tensor,
                            tokens: torch.Tensor, prefix_len: int = 0,
                            chunk: int = 512,
                            z_loss_coef: float = 1e-4) -> torch.Tensor:
    """The same loss from the final-normed ``hidden (B, S_total, D)``, the
    head applied per chunk of ``chunk`` positions."""
    s = tokens.shape[1]
    head_w = (params["embed"]["w"].t() if cfg.tie_embeddings
              else params["lm_head"]["w"])
    head_w = L.cast(head_w, cfg)
    pred_h = hidden[:, prefix_len:prefix_len + s - 1]
    targets = tokens[:, 1:].long()
    n = pred_h.shape[1]
    pad = (-n) % chunk
    if pad:
        pred_h = torch.nn.functional.pad(pred_h, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
    nc = pred_h.shape[1] // chunk
    valid = (torch.arange(nc * chunk, device=hidden.device)
             .reshape(nc, chunk) < n).float()

    def one(h_i, t_i, v_i):
        logits = (h_i @ head_w).float()                      # (B, chunk, V)
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(
                logits / cfg.logit_softcap)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t_i[..., None])[..., 0]
        return ((logz - gold) * v_i[None]).sum(), (
            torch.square(logz) * v_i[None]).sum()

    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    zl = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        a, b = checkpoint(one, pred_h[:, sl], targets[:, sl], valid[i],
                          use_reentrant=False)
        nll = nll + a
        zl = zl + b
    denom = hidden.shape[0] * n
    return nll / denom + z_loss_coef * zl / denom

"""Mamba-2 (SSD) block: the SSM layer of the ``ssm`` family.

The port of ``repro.models.ssm`` (the Mamba-2 layer recipe,
arXiv:2405.21060): one fused input projection producing (z, x, B, C, dt);
a short depthwise causal conv over [x; B; C]; the SSD scan over heads;
gated RMSNorm; output projection.  The scan is B9
(:mod:`repro_torch.kernels.ssd_scan`): the CUDA kernel on the card, the
plain chunked version on the CPU.

Decode keeps two carries per layer: the (B, H, P, N) float32 SSM state and
the (B, conv - 1, channels) conv tail, both O(1) in sequence length.
Parameters follow the reference: ``conv_w`` (K, C) is kept in float32 and
cast at use, like the vectors ``conv_b``, ``A_log``, ``D`` and
``dt_bias``; the two projections are matrices in the caller's dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd, ssd_with_state
from repro_torch.models.layers import (
    cast,
    cdtype,
    dense,
    dense_init,
    rmsnorm,
    rmsnorm_init,
)

__all__ = [
    "SSMState",
    "ssm_apply",
    "ssm_decode",
    "ssm_init",
    "ssm_prefill",
    "ssm_zero_state",
]


def _dims(cfg: ModelConfig, d_inner: Optional[int] = None):
    di = d_inner if d_inner is not None else cfg.ssm_expand * cfg.d_model
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    if h * p != di:
        raise ValueError(f"{cfg.name}: ssm_heads {h} x ssm_head_dim {p} != "
                         f"d_inner {di}")
    return di, h, p, n


def ssm_init(gen: torch.Generator, cfg: ModelConfig, dtype,
             d_inner: Optional[int] = None) -> dict:
    """Random SSM parameters on the generator's device (the reference's
    distributions; the draws differ from ``jax.random``'s)."""
    di, h, _, n = _dims(cfg, d_inner)
    d, dev = cfg.d_model, gen.device
    conv_ch = di + 2 * n
    f32 = dict(dtype=torch.float32, device=dev)
    in_proj = dense_init(gen, d, 2 * di + 2 * n + h, dtype)
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=gen, **f32) * (
        1.0 / math.sqrt(cfg.ssm_conv))
    u = torch.rand((h,), generator=gen, **f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        # fused in_proj -> [z (di), x (di), B (n), C (n), dt (h)]
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm": rmsnorm_init(di, dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv. u: (B, L, C); w: (K, C); tail: (B, K-1, C)."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                           device=u.device)
    padded = torch.cat([tail, u], dim=1)
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + padded[:, i:i + u.shape[1], :] * w[i]
    new_tail = padded[:, padded.shape[1] - (k - 1):, :] if k > 1 else tail
    return out + b, new_tail


class SSMState(NamedTuple):
    ssd: torch.Tensor        # (B, H, P, N) float32
    conv: torch.Tensor       # (B, K-1, d_inner + 2N)


def ssm_zero_state(cfg: ModelConfig, batch: int,
                   d_inner: Optional[int] = None, device=None) -> SSMState:
    di, h, p, n = _dims(cfg, d_inner)
    return SSMState(
        ssd=torch.zeros((batch, h, p, n), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n),
                         dtype=cdtype(cfg), device=device),
    )


def _project(p, x, cfg, di, n):
    zxbcdt = dense(p["in_proj"], x, cfg)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * n]
    dt_raw = zxbcdt[..., 2 * di + 2 * n:]
    return z, xbc, dt_raw


def _ssd_inputs(p, xbc, dt_raw, di, h, pd, n):
    """The scan's float32 operands, each contiguous (the kernel's layout)."""
    b, l, _ = xbc.shape
    xs = xbc[..., :di]
    bm = xbc[..., di:di + n].float().contiguous()
    cm = xbc[..., di + n:].float().contiguous()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])             # (B, L, H)
    a = -torch.exp(p["A_log"])                                 # (H,)
    log_a = a * dt                                             # (B, L, H)
    xh = xs.float().reshape(b, l, h, pd)
    dtx = xh * dt[..., None]
    return xh, dtx, log_a, bm, cm


def _pad_ssd(arrs, l: int, chunk: int):
    """Right-pad the time axis (dim 1) to a multiple of ``chunk``.

    Zero padding is state-neutral: log_a = 0 gives decay 1 and dtx = 0
    injects nothing, so padded steps leave the recurrence as it was.
    """
    lp = -(-l // chunk) * chunk
    if lp == l:
        return arrs
    return [F.pad(a, [0, 0] * (a.dim() - 2) + [0, lp - l]) for a in arrs]


def _gated_out(p, y, xh, z, x, cfg, di):
    y = y + p["D"][None, None, :, None] * xh                   # skip
    y = y.reshape(x.shape[0], x.shape[1], di).to(cdtype(cfg))
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return dense(p["out_proj"], y, cfg)


def ssm_apply(p, x: torch.Tensor, cfg: ModelConfig,
              d_inner: Optional[int] = None, impl: str = "auto"):
    """Full-sequence SSD block (train / prefill without state).  ``impl``
    goes to :func:`repro_torch.kernels.ssd_scan.ops.ssd`."""
    di, h, pd, n = _dims(cfg, d_inner)
    z, xbc, dt_raw = _project(p, x, cfg, di, n)
    xbc, _ = _causal_conv(xbc, cast(p["conv_w"], cfg), cast(p["conv_b"], cfg))
    xbc = F.silu(xbc)
    xh, dtx, log_a, bm, cm = _ssd_inputs(p, xbc, dt_raw, di, h, pd, n)
    l = x.shape[1]
    chunk = min(cfg.ssm_chunk, l)
    dtx, log_a, bm, cm = _pad_ssd([dtx, log_a, bm, cm], l, chunk)
    y = ssd(dtx, log_a, bm, cm, chunk=chunk, impl=impl)[:, :l]
    return _gated_out(p, y, xh, z, x, cfg, di)


def ssm_prefill(p, x: torch.Tensor, cfg: ModelConfig,
                d_inner: Optional[int] = None):
    """Full-sequence pass that also returns the decode state."""
    di, h, pd, n = _dims(cfg, d_inner)
    z, xbc, dt_raw = _project(p, x, cfg, di, n)
    xbc, conv_tail = _causal_conv(xbc, cast(p["conv_w"], cfg),
                                  cast(p["conv_b"], cfg))
    xbc = F.silu(xbc)
    xh, dtx, log_a, bm, cm = _ssd_inputs(p, xbc, dt_raw, di, h, pd, n)
    l = x.shape[1]
    chunk = min(cfg.ssm_chunk, l)
    dtx, log_a, bm, cm = _pad_ssd([dtx, log_a, bm, cm], l, chunk)
    y, final_state = ssd_with_state(dtx, log_a, bm, cm, chunk=chunk)
    out = _gated_out(p, y[:, :l], xh, z, x, cfg, di)
    return out, SSMState(ssd=final_state, conv=conv_tail.to(cdtype(cfg)))


def ssm_decode(p, x: torch.Tensor, cfg: ModelConfig, state: SSMState,
               d_inner: Optional[int] = None):
    """One-token recurrent step. x: (B, 1, D)."""
    di, h, pd, n = _dims(cfg, d_inner)
    z, xbc, dt_raw = _project(p, x, cfg, di, n)
    xbc, conv_tail = _causal_conv(xbc, cast(p["conv_w"], cfg),
                                  cast(p["conv_b"], cfg),
                                  tail=state.conv.to(cdtype(cfg)))
    xbc = F.silu(xbc)
    xh, dtx, log_a, bm, cm = _ssd_inputs(p, xbc, dt_raw, di, h, pd, n)
    # one recurrence step: S = exp(log_a) S + dtx (x) B ; y = S @ C
    a = torch.exp(log_a[:, 0])[:, :, None, None]               # (B, H, 1, 1)
    s = a * state.ssd + dtx[:, 0, :, :, None] * bm[:, 0, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", s, cm[:, 0])[:, None]     # (B, 1, H, P)
    out = _gated_out(p, y, xh, z, x, cfg, di)
    return out, SSMState(ssd=s, conv=conv_tail.to(cdtype(cfg)))

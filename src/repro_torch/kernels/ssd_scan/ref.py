"""Plain PyTorch versions of the SSD (state-space duality) chunk scan.

The port of ``repro.kernels.ssd_scan.ref``: the oracle of B9, the CPU
path, and the graph the kernel's backward differentiates.

* :func:`ssd_ref`: the literal per-step recurrence (slow, unambiguous)::

      S_t = exp(log_a_t) * S_{t-1} + dtx_t (x) B_t
      y_t = S_t @ C_t

* :func:`ssd_chunked_ref`: the chunked SSD algorithm in einsum form, the
  same chunk algebra the kernel computes tile by tile.

Shapes (ngroups = 1, B / C shared by every head, as in Mamba-2):
``dtx (B, L, H, P)``, ``log_a (B, L, H)`` (<= 0, already dt-scaled),
``Bm`` / ``Cm`` ``(B, L, N)``, ``y (B, L, H, P)`` in dtx's dtype, state
``(B, H, P, N)`` in float32.  Both compute in float32 and return
``(y, final_state)``.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_chunked_ref", "ssd_ref"]


def _zero_state(dtx: torch.Tensor, n: int) -> torch.Tensor:
    b, _, h, p = dtx.shape
    return torch.zeros((b, h, p, n), dtype=torch.float32, device=dtx.device)


def ssd_ref(dtx, log_a, Bm, Cm, init_state=None):
    """The recurrence, one step at a time.  Returns ``(y, final_state)``."""
    n = Bm.shape[-1]
    s = _zero_state(dtx, n) if init_state is None else init_state.float()
    x, la = dtx.float(), log_a.float()
    bm, cm = Bm.float(), Cm.float()
    ys = []
    for t in range(dtx.shape[1]):
        a = torch.exp(la[:, t])[:, :, None, None]             # (B, H, 1, 1)
        s = a * s + x[:, t, :, :, None] * bm[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", s, cm[:, t]))
    return torch.stack(ys, dim=1).to(dtx.dtype), s


def ssd_chunked_ref(dtx, log_a, Bm, Cm, chunk: int = 128, init_state=None):
    """Chunked SSD: the in-chunk quadratic part plus the state carried
    across chunks.  The same math as :func:`ssd_ref` in ``L / chunk``
    sequential steps.  Returns ``(y, final_state)``."""
    b, l, h, p = dtx.shape
    n = Bm.shape[-1]
    if chunk < 1 or l % chunk:
        raise ValueError(f"ssd_chunked_ref: L {l} is not a multiple of the "
                         f"chunk {chunk}")
    q, nc = chunk, l // chunk

    dtx_c = dtx.float().reshape(b, nc, q, h, p)
    la_c = log_a.float().reshape(b, nc, q, h)
    B_c = Bm.float().reshape(b, nc, q, n)
    C_c = Cm.float().reshape(b, nc, q, n)

    cum = torch.cumsum(la_c, dim=2)                         # (B, NC, Q, H)
    total = cum[:, :, -1, :]                                # (B, NC, H)

    # in-chunk (the "duality" matmul form)
    g = torch.einsum("bcin,bcjn->bcij", C_c, B_c)           # (B, NC, Q, Q)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B, NC, Q, Q, H)
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=dtx.device))
    decay = torch.exp(torch.where(tril[None, None, :, :, None], diff,
                                  torch.full_like(diff, float("-inf"))))
    m = g[..., None] * decay                                # (B, NC, Q, Q, H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, dtx_c)

    # across chunks: chunk c adds Z_c = sum_j exp(total - cum_j) dtx_j B_j
    w = torch.exp(total[:, :, None, :] - cum)               # (B, NC, Q, H)
    z = torch.einsum("bcjh,bcjhp,bcjn->bchpn", w, dtx_c, B_c)
    s = _zero_state(dtx, n) if init_state is None else init_state.float()
    entering = []
    for c in range(nc):
        entering.append(s)
        s = torch.exp(total[:, c])[:, :, None, None] * s + z[:, c]
    s_prev = torch.stack(entering, dim=1)                   # (B, NC, H, P, N)
    y_inter = torch.einsum("bcih,bcin,bchpn->bcihp", torch.exp(cum), C_c,
                           s_prev)

    y = (y_intra + y_inter).reshape(b, l, h, p).to(dtx.dtype)
    return y, s

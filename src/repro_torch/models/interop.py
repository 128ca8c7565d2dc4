"""Carry the reference's parameters across to the port.

The reference (``repro.models.lm.init_params``) returns a pytree of float32
master weights with the layer stack stacked on a leading axis.  Given that
pytree as numpy arrays (``jax.tree.map(np.asarray, params)`` on the
caller's side; this module imports no JAX), :func:`params_from_reference`
returns the port's parameters on ``device``: one dict per layer, matrices
in ``dtype`` (default float32), vectors (norm scales, biases, the SSM's
``A_log`` / ``D`` / ``dt_bias`` / ``conv_b``) and the SSM's ``conv_w``
(a (K, C) matrix the reference keeps in float32 and casts at use) in
float32, so both packages compute the same thing from the same numbers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.api import resolve_device

__all__ = ["params_from_reference"]


def _leaf(a, device, dtype, name) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    keep = t.dim() < 2 or name == "conv_w"
    return t.to(device=device, dtype=torch.float32 if keep else dtype)


def _tree(node, device, dtype, name=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, dtype, k) for k, v in node.items()}
    return _leaf(node, device, dtype, name)


def _num_layers(node) -> int:
    """The stacked layer count: the leading axis of any leaf."""
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return int(np.asarray(node).shape[0])


def _layer(node, i: int):
    if isinstance(node, dict):
        return {k: _layer(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def params_from_reference(tree: Dict[str, Any], device=None,
                          dtype: Optional[torch.dtype] = None
                          ) -> Dict[str, Any]:
    """The port's parameters from the reference's (numpy) pytree."""
    dev = resolve_device(device)
    dtype = dtype or torch.float32
    layers = tree["layers"]
    num_layers = _num_layers(layers)
    out = {k: _tree(v, dev, dtype) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_tree(_layer(layers, i), dev, dtype)
                     for i in range(num_layers)]
    return out

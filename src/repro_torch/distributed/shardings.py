"""MaxText-style logical sharding rules for parameters, batches and caches.

The port of ``repro.distributed.shardings``, as logical specs over the
port's :class:`repro_torch.launch.mesh.Mesh`.  A spec is a
:class:`PartitionSpec`: a tuple with one entry a dimension, each ``None``,
an axis name or a tuple of names, normalized as JAX normalizes its
``PartitionSpec`` (a one-name tuple is the name, an empty one ``None``).

Logical axes:

* ``fsdp``: weight sharding across the data-parallel axes (``("pod",
  "data")`` on the multi-pod mesh, ``("data",)`` otherwise); optimizer
  state takes its parameter's spec (ZeRO-3).
* ``tensor``: the ``model`` axis: attention heads, FFN width, MoE expert
  width, vocabulary.
* ``dp``: the batch dimension across ``("pod", "data")``.
* Decode caches shard their sequence axis over ``model``.

Rules match on the suffix of the parameter's path in the reference's
layout, where the layers are stacked on a leading axis and the path has
no layer index (``layers/attn/q/w``).  The port keeps its layers as a
list of per-layer dicts (``layers/3/attn/q/w``), so a per-layer leaf is
decided on its stacked shape, ``(steps,) + shape`` with ``steps`` the
length of ``params["layers"]`` (``num_layers``, or half of it for a
period-2 stack), and by the stacked rank
(:func:`repro_torch.train.tree.stacked_ndim`), and its spec is the
stacked leaf's: its first entry is the layer axis.
:func:`repro_torch.distributed.sharded.leaf_spec` drops that entry for
the stored leaf.  The ``fsdp`` layout's largest-dimension rule can shard
the layer axis, as the reference's does; storing such a spec raises
(training uses ``tp_sp``).

The port has no GSPMD: :func:`make_sharder` returns an identity callable
that carries the mesh and the specs the reference would pin.
"""

from __future__ import annotations

import math
import re
from typing import Any, Optional, Sequence, Tuple

from repro_torch.train.tree import path_str, stacked_ndim, tree_map

__all__ = [
    "PartitionSpec",
    "all_axes",
    "batch_shardings",
    "cache_shardings",
    "dp_axes",
    "fsdp_axes",
    "make_sharder",
    "param_shardings",
    "train_state_shardings",
]


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class PartitionSpec(tuple):
    """A logical spec: one entry a dimension (``None``, an axis name or a
    tuple of names).  Trees of tensors treat it as one leaf."""

    tree_leaf = True

    def __new__(cls, *parts):
        return super().__new__(cls, (_entry(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_size(mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in entry_axes(entry))


def guard(spec: Sequence, shape: Sequence[int], mesh) -> PartitionSpec:
    """``spec`` with every entry that does not divide its dimension
    dropped (the reference's divisibility guard)."""
    parts = list(spec)
    for i, entry in enumerate(parts):
        if entry is not None and shape[i] % entry_size(mesh, entry):
            parts[i] = None
    return P(*parts)


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def dp_axes(mesh) -> Tuple[str, ...]:
    return fsdp_axes(mesh)


def all_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data", "model") if a in mesh.shape)


# (path-suffix regex, spec) -- first match wins.  ``F`` = fsdp axes.
def _rules(F):
    T = "model"
    return [
        # embeddings / head
        (r"embed/w$",               P(T, F)),
        (r"lm_head/w$",             P(F, T)),
        # attention (GQA)
        (r"attn/(q|k|v)/w$",        P(F, T)),
        (r"attn/(q|k|v)/b$",        P(T)),
        (r"attn/o/w$",              P(T, F)),
        # attention (MLA)
        (r"attn/q_a/w$",            P(F, None)),
        (r"attn/q_b/w$",            P(None, T)),
        (r"attn/kv_a/w$",           P(F, None)),
        (r"attn/kv_b/w$",           P(None, T)),
        # dense mlp
        (r"mlp/(gate|up)/w$",       P(F, T)),
        (r"mlp/down/w$",            P(T, F)),
        # moe
        (r"moe/router$",            P(F, None)),
        (r"moe/w_(gate|up)$",       P(None, F, T)),
        (r"moe/w_down$",            P(None, T, F)),
        (r"moe/shared/(gate|up)/w$", P(F, T)),
        (r"moe/shared/down/w$",     P(T, F)),
        (r"moe/shared_gate$",       P(F, None)),
        # ssm (FSDP only)
        (r"ssm/in_proj/w$",         P(F, None)),
        (r"ssm/out_proj/w$",        P(None, F)),
        (r"ssm/conv_w$",            P(None, None)),
        # everything 1-D (norms, biases, scalars) replicated
        (r".*",                     P()),
    ]


def _spec_for(path: str, ndim: int, rules) -> PartitionSpec:
    for pat, spec in rules:
        if re.search(pat, path):
            parts = tuple(spec)
            if path.startswith("layers/") and len(parts) < ndim:
                parts = (None,) * (ndim - len(parts)) + parts
            if len(parts) < ndim:
                parts = parts + (None,) * (ndim - len(parts))
            if len(parts) > ndim:
                # a rule written for unstacked weights; trim leading Nones
                parts = parts[len(parts) - ndim:]
            return P(*parts)
    return P()


def _stacked(path, leaf, steps: int) -> Tuple[str, Tuple[int, ...]]:
    """The reference's path string and shape of a port leaf."""
    shape = tuple(leaf.shape)
    if stacked_ndim(path, leaf) > len(shape):   # layers/<i>/...
        return path_str((path[0],) + tuple(path[2:])), (steps,) + shape
    return path_str(path), shape


def param_shardings(mesh, params_like: Any, layout: str = "tp_sp") -> Any:
    """A tree of specs like ``params_like`` (stacked specs for the
    per-layer leaves).

    layout:
    * ``tp_sp``: tensor parallelism over ``model`` and FSDP over the data
      axes;
    * ``fsdp``: pure ZeRO-3: every leaf of rank >= 2 (the MoE expert
      stacks aside) sharded over all axes on its largest dimension.
    """
    if layout not in ("tp_sp", "fsdp"):
        raise ValueError(f"unknown layout {layout!r}; one of tp_sp, fsdp")
    rules = _rules(fsdp_axes(mesh))
    combined = all_axes(mesh)
    steps = len(params_like.get("layers", ()))

    def assign(path, leaf):
        ps, shape = _stacked(path, leaf, steps)
        nd = len(shape)
        if layout == "fsdp" and nd >= 2 and "moe/w_" not in ps:
            big = max(range(nd), key=lambda i: shape[i])
            parts = [None] * nd
            parts[big] = combined
            spec = P(*parts)
        else:
            spec = _spec_for(ps, nd, rules)
        return guard(spec, shape, mesh)

    return tree_map(assign, params_like, with_path=True)


def train_state_shardings(mesh, state_like: Any,
                          layout: str = "tp_sp") -> Any:
    """ZeRO-3: m / v take their parameters' specs; the step and the
    optimizer's count are replicated."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState

    return TrainState(
        params=param_shardings(mesh, state_like.params, layout),
        opt=AdamWState(m=param_shardings(mesh, state_like.opt.m, layout),
                       v=param_shardings(mesh, state_like.opt.v, layout),
                       count=P()),
        step=P(),
    )


def batch_shardings(mesh, batch_like: Any, layout: str = "tp_sp") -> Any:
    """The batch dimension over the data axes (all axes under ``fsdp``);
    where that does not divide it, over the data axes."""
    dp = all_axes(mesh) if layout == "fsdp" else dp_axes(mesh)

    def assign(leaf):
        parts = [dp] + [None] * (len(leaf.shape) - 1)
        if leaf.shape[0] % math.prod(mesh.shape[a] for a in dp):
            parts[0] = dp_axes(mesh)  # fall back (e.g. batch < devices)
        return P(*parts)

    return tree_map(assign, batch_like)


def cache_shardings(mesh, cache_like: Any) -> Any:
    """Decode caches: batch over dp, sequence over ``model``."""
    dp = dp_axes(mesh)

    def assign(path, leaf):
        name = path[-1]
        nd = len(leaf.shape)
        if name in ("k", "v"):             # (L, B, Hkv, S, hd)
            spec = P(None, dp, None, "model", None)
        elif name in ("latent", "rope"):   # (L, B, S, R)
            spec = P(None, dp, "model", None)
        elif name in ("ssd", "conv"):      # (L, B, ...): batch only
            spec = P(*((None, dp) + (None,) * (nd - 2)))
        else:
            spec = P(*((None,) * nd))
        return guard(spec, leaf.shape, mesh)

    return tree_map(assign, cache_like, with_path=True)


def make_sharder(mesh, sequence_sharding: bool = False,
                 layout: str = "tp_sp"):
    """The reference's activation-constraint callback, as an identity.

    ``sharder(x, name)`` returns ``x``: without GSPMD a constraint has
    nothing to do.  ``sharder.mesh`` is the mesh, ``sharder.specs`` the
    table by name, and ``sharder.spec_for(shape, name)`` the spec the
    reference would pin on an activation of ``shape``, or None where it
    pins nothing (an unknown name, or an entry that does not divide its
    dimension: the reference then skips the whole constraint)."""
    dp = all_axes(mesh) if layout == "fsdp" else dp_axes(mesh)
    if layout == "fsdp":
        sequence_sharding = False
    seq = "model" if sequence_sharding else None
    specs = {
        "act_embed": P(dp, seq, None),
        "act_resid": P(dp, seq, None),
        "logits": (P(dp, None, None) if layout == "fsdp"
                   else P(dp, None, "model")),
        "moe_dispatch": P(dp, None),          # (T*k, D)
        "moe_expert_in": P(None, dp, None),   # (E, cap, D)
        "loss_head_w": (P(None, None) if layout == "fsdp"
                        else P(None, "model")),
    }

    def spec_for(shape: Sequence[int], name: str) -> Optional[PartitionSpec]:
        spec = specs.get(name)
        if spec is None:
            return None
        parts = list(spec)[:len(shape)]
        for i, entry in enumerate(parts):
            if entry is not None and shape[i] % entry_size(mesh, entry):
                return None
        return P(*parts)

    def sharder(x, name):
        return x

    sharder.mesh = mesh
    sharder.specs = specs
    sharder.spec_for = spec_for
    return sharder

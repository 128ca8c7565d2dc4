"""Trees of tensors: nested dicts, lists, tuples and dataclasses.

The port's stand-in for the ``jax.tree`` functions the train path uses.
Dict entries keep their insertion order (JAX sorts dict keys; the port's
leaf order changes only the order of sums such as the global norm).  A
tuple whose class sets ``tree_leaf`` (a sharding spec) is one leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple

__all__ = ["leaves_with_path", "path_str", "stacked_ndim", "tree_map"]

Path = Tuple[Any, ...]


def _is_leaf(tree) -> bool:
    return getattr(tree, "tree_leaf", False)


def leaves_with_path(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """``(path, leaf)`` for every leaf, depth first."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves_with_path(getattr(tree, f.name), path + (f.name,))
    else:
        yield path, tree


def tree_map(fn: Callable, tree: Any, *rest: Any, with_path: bool = False,
             path: Path = ()) -> Any:
    """``fn(leaf, *other_leaves)`` (``fn(path, leaf, ...)`` with
    ``with_path``) over trees of one structure, in a tree of that
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest),
                            with_path=with_path, path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        out = [tree_map(fn, v, *(r[i] for r in rest), with_path=with_path,
                        path=path + (i,))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest),
                             with_path=with_path, path=path + (f.name,))
            for f in dataclasses.fields(tree)})
    return fn(path, tree, *rest) if with_path else fn(tree, *rest)


def path_str(path: Path) -> str:
    return "/".join(str(k) for k in path)


def stacked_ndim(path: Path, leaf) -> int:
    """A parameter's rank in the reference's layout, where the layers are
    stacked on a leading axis: one more than the port's for a leaf under
    ``params["layers"]``.  The reference decides by this rank which leaves
    take weight decay and which are cast to the compute dtype, so a
    per-layer vector counts as a matrix there and here."""
    return leaf.dim() + (1 if "layers" in path else 0)

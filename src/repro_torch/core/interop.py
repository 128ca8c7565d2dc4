"""Carry a hierarchy between the JAX package and the port, as numpy.

The port never imports the JAX package: both directions go through
plain numpy arrays and a mapping of plan fields
(``dataclasses.asdict(plan)`` of either package's ``HierarchyPlan``).
The layouts are the same entry for entry, so no array is rewritten.
numpy has no bfloat16 of its own: a bf16 plane leaves the port as its
int16 bits (view them as the reference's bfloat16) and enters it from a
numpy array of a ``bfloat16`` extension dtype (the reference's
``np.asarray``), by its bits too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.hierarchy import Hierarchy, value_bits
from repro_torch.core.plan import HierarchyPlan, LevelSplit

__all__ = [
    "hierarchy_from_reference",
    "hierarchy_to_reference",
    "plan_from_reference",
]

_PLAN_FIELDS = tuple(f.name for f in dataclasses.fields(HierarchyPlan))


def plan_from_reference(plan_fields) -> HierarchyPlan:
    """The port's plan from a plan's fields (a mapping or a plan object)."""
    if not isinstance(plan_fields, Mapping):
        plan_fields = dataclasses.asdict(plan_fields)
    fields = {k: plan_fields[k] for k in _PLAN_FIELDS if k in plan_fields}
    for key in ("level_lens", "padded_lens", "offsets"):
        fields[key] = tuple(int(v) for v in fields[key])
    split = fields.get("level_split")
    if split is not None and not isinstance(split, LevelSplit):
        if not isinstance(split, Mapping):
            split = dataclasses.asdict(split)
        fields["level_split"] = LevelSplit(**split)
    return HierarchyPlan(**fields)


def hierarchy_from_reference(
    base: np.ndarray,
    upper: np.ndarray,
    upper_pos: Optional[np.ndarray],
    plan_fields,
    device,
) -> Hierarchy:
    """The port's ``Hierarchy`` from a reference hierarchy's planes."""
    def tensor(a):
        a = np.array(a)  # a writable copy
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).to(device).view(
                torch.bfloat16)
        return torch.from_numpy(a).to(device)

    return Hierarchy(
        base=tensor(base),
        upper=tensor(upper),
        upper_pos=None if upper_pos is None else tensor(upper_pos),
        plan=plan_from_reference(plan_fields),
    )


def hierarchy_to_reference(h: Hierarchy) -> Dict[str, Any]:
    """The planes as numpy arrays and the plan as a field mapping, ready
    for the reference's ``Hierarchy`` and ``HierarchyPlan`` (bf16 planes
    as their int16 bits)."""
    def array(t):
        return None if t is None else value_bits(t).cpu().numpy()

    return {
        "base": array(h.base),
        "upper": array(h.upper),
        "upper_pos": array(h.upper_pos),
        "plan_fields": dataclasses.asdict(h.plan),
    }

"""Carry a hierarchy between the JAX package and the port, as numpy.

The port never imports the JAX package: both directions go through
plain numpy arrays and a mapping of plan fields
(``dataclasses.asdict(plan)`` of either package's ``HierarchyPlan``).
The layouts are the same entry for entry, so no array is rewritten.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.hierarchy import Hierarchy
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
        return torch.from_numpy(np.array(a)).to(device)  # a writable copy

    return Hierarchy(
        base=tensor(base),
        upper=tensor(upper),
        upper_pos=None if upper_pos is None else tensor(upper_pos),
        plan=plan_from_reference(plan_fields),
    )


def hierarchy_to_reference(h: Hierarchy) -> Dict[str, Any]:
    """The planes as numpy arrays and the plan as a field mapping, ready
    for the reference's ``Hierarchy`` and ``HierarchyPlan``."""
    return {
        "base": h.base.cpu().numpy(),
        "upper": h.upper.cpu().numpy(),
        "upper_pos": None if h.upper_pos is None else h.upper_pos.cpu().numpy(),
        "plan_fields": dataclasses.asdict(h.plan),
    }

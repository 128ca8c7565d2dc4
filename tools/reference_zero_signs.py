#!/usr/bin/env python3
"""Count, on the CPU, the upper entries where each of the JAX package's
builds and its update kernel differ in bits from its jnp build on
zero-heavy input (``ROADMAP.md`` C6).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/reference_zero_signs.py

Input: n = 4096 float32, 30% of the entries -0.0 or +0.0 (the rest in
[0.5, 1.5)), c = 8, t = 4, seed 0 (``tests/_torch_cases.zero_heavy``).
The jnp build (``repro.core.hierarchy.build_hierarchy``: argmin, then a
gather) keeps the bits of each chunk's leftmost minimal entry; the Pallas
kernels run in interpret mode, as the package's own tests run them off
the TPU.  The update row applies one zero-heavy batch of 512 indices to
the jnp build through the Pallas update and through the jnp update.
Prints one JSON line: ``{build: [entries that differ, upper entries]}``.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> int:
    import jax.numpy as jnp
    import numpy as np

    from _torch_cases import zero_heavy
    from repro.core.hierarchy import build_hierarchy
    from repro.core.plan import make_plan
    from repro.kernels.hierarchy_build.ops import build_hierarchy_pallas
    from repro.kernels.hierarchy_fused.ops import build_hierarchy_fused
    from repro.kernels.hierarchy_update.ops import update_hierarchy_pallas
    from repro.streaming import update_hierarchy

    n, c, t = 4096, 8, 4
    rng = np.random.default_rng(0)
    x = jnp.asarray(zero_heavy(rng, n))
    plan = make_plan(n, c=c, t=t)

    def bits(a):
        return np.asarray(a).view(np.int32)

    out = {}
    for pos in (False, True):
        ref = bits(build_hierarchy(x, plan, with_positions=pos).upper)
        label = "positions" if pos else "value-only"
        for name, build in (("fused", build_hierarchy_fused),
                            ("per-level", build_hierarchy_pallas)):
            got = bits(build(x, plan, with_positions=pos,
                             interpret=True).upper)
            out[f"{name} {label}"] = [int((got != ref).sum()), ref.size]
    h = build_hierarchy(x, plan, with_positions=True)
    idxs = jnp.asarray(rng.integers(0, n, 512), jnp.int32)
    vals = jnp.asarray(zero_heavy(rng, 512, share=0.5))
    want = bits(update_hierarchy(h, idxs, vals).upper)
    got = bits(update_hierarchy_pallas(h, idxs, vals, interpret=True).upper)
    out["update positions"] = [int((got != want).sum()), want.size]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

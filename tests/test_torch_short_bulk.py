"""Short-span (B5) and bulk (B7) answers, the hybrid top and the baselines,
held against the reference bit for bit.

The port's CPU paths (each kernel module's plain version) against the
reference's ``rmq_short_pallas`` and ``rmq_bulk_pallas`` in interpret
mode, their jnp lowerings, and the reference's ``HybridRMQ`` /
``SparseTable`` / ``FullScan`` / ``TwoLevelBlocks`` on the same numpy
inputs: values and leftmost positions at tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import GEOMETRIES, brute_force, query_batch, tied_input
from repro.core import baselines as jbase
from repro.core.hierarchy import build_hierarchy as jbuild
from repro.core.hybrid import HybridRMQ as JHybrid
from repro.core.plan import make_plan as jmake_plan
from repro.kernels.rmq_bulk.ops import rmq_bulk_batch as jbulk
from repro.kernels.rmq_short.ops import (
    rmq_short_index_batch,
    rmq_short_index_batch_pallas,
    rmq_short_value_batch,
    rmq_short_value_batch_pallas,
)
from repro_torch.core import baselines
from repro_torch.core.hierarchy import build_hierarchy
from repro_torch.core.hybrid import HybridRMQ
from repro_torch.core.plan import make_plan
from repro_torch.kernels.profiling import count_launches
from repro_torch.kernels.rmq_bulk import ops as bulk_ops
from repro_torch.kernels.rmq_short import ops as short_ops

SHORT_GEOMETRIES = GEOMETRIES + [
    (100_000, 128, 4, None),
    (777, 128, 4, None),     # unaligned tail
    (100, 64, 4, None),      # capacity < 2c: the reference falls back
    (3, 128, 64, 64),        # n and capacity below c
]


def _short_spans(rng, n, c, m=300):
    """Spans with r // c - l // c <= 1 (the engine's SHORT class)."""
    ls = rng.integers(0, n, m)
    rs = np.minimum(ls + rng.integers(1, 2 * c + 1, m) - 1, n - 1)
    keep = (rs // c) - (ls // c) <= 1
    ls, rs = ls[keep], rs[keep]
    pts = rng.integers(0, n, 8)
    return (np.concatenate([ls, pts, [0, n - 1]]).astype(np.int32),
            np.concatenate([rs, pts, [min(c - 1, n - 1), n - 1]]).astype(
                np.int32))


def _pair(x, n, c, t, cap, with_pos=True):
    jh = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t, capacity=cap),
                with_positions=with_pos)
    h = build_hierarchy(torch.from_numpy(x),
                        make_plan(n, c=c, t=t, capacity=cap), with_pos)
    return h, jh


class TestShortSpans:
    @pytest.mark.parametrize("n,c,t,cap", SHORT_GEOMETRIES)
    def test_matches_reference_kernel_and_ref(self, n, c, t, cap):
        rng = np.random.default_rng(n + c)
        x = tied_input(rng, n)
        ls, rs = _short_spans(rng, n, c)
        lj, rj = jnp.asarray(ls), jnp.asarray(rs)
        bv, bp = brute_force(x, ls, rs)
        for with_pos in (False, True):  # positions come from level 0
            h, jh = _pair(x, n, c, t, cap, with_pos)
            with count_launches() as counts:
                gv, gp = short_ops.rmq_short_batch(h, ls, rs, track_pos=True)
            assert counts == {"rmq_short": 1}
            refs = {
                "kernel": (rmq_short_value_batch_pallas(
                    jh, lj, rj, qb=16, interpret=True),
                    rmq_short_index_batch_pallas(
                        jh, lj, rj, qb=16, interpret=True)),
                "ref": (rmq_short_value_batch(jh, lj, rj),
                        rmq_short_index_batch(jh, lj, rj)),
            }
            for name, (wv, wp) in refs.items():
                np.testing.assert_array_equal(gv.numpy(), np.asarray(wv),
                                              err_msg=name)
                np.testing.assert_array_equal(gp.numpy(), np.asarray(wp),
                                              err_msg=name)
                assert gp.numpy().dtype == np.asarray(wp).dtype
            np.testing.assert_array_equal(gv.numpy(), bv)
            np.testing.assert_array_equal(gp.numpy(), bp)
            np.testing.assert_array_equal(
                short_ops.rmq_short_value_batch(h, ls, rs).numpy(), bv)

    def test_f64(self):
        n, c = 1000, 8
        x = tied_input(np.random.default_rng(4), n, np.float64)
        ls, rs = _short_spans(np.random.default_rng(5), n, c)
        with jax.enable_x64(True):
            jh = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=2))
            wv = np.asarray(rmq_short_value_batch(jh, jnp.asarray(ls),
                                                  jnp.asarray(rs)))
        h = build_hierarchy(torch.from_numpy(x), make_plan(n, c=c, t=2))
        got = short_ops.rmq_short_value_batch(h, ls, rs)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), wv)

    def test_plain_slices_large_batches(self, monkeypatch):
        from repro_torch.kernels.rmq_short import ref

        n, c = 5000, 16
        x = tied_input(np.random.default_rng(6), n)
        h = build_hierarchy(torch.from_numpy(x), make_plan(n, c=c, t=4))
        ls, rs = _short_spans(np.random.default_rng(7), n, c)
        whole = short_ops.rmq_short_batch(h, ls, rs, True)
        monkeypatch.setattr(ref, "_WINDOW_ELEMS", 64)
        sliced = short_ops.rmq_short_batch(h, ls, rs, True)
        assert torch.equal(whole[0], sliced[0])
        assert torch.equal(whole[1], sliced[1])


class TestBulk:
    @pytest.mark.parametrize("n,c,t,cap", GEOMETRIES + [(257, 8, 2, 400)])
    @pytest.mark.parametrize("ordered", [False, True])
    def test_matches_reference_kernel_and_lowering(self, n, c, t, cap,
                                                   ordered):
        rng = np.random.default_rng(2 * n + c)
        x = tied_input(rng, n)
        h, jh = _pair(x, n, c, t, cap)
        ls, rs = query_batch(rng, n, c, m=160)
        if ordered:
            order = np.lexsort((rs // c, ls // c))
            ls, rs = ls[order], rs[order]
        # the bulk executor's (0, 0) sentinels
        ls = np.concatenate([ls, np.zeros(11, np.int32)])
        rs = np.concatenate([rs, np.zeros(11, np.int32)])
        lj, rj = jnp.asarray(ls), jnp.asarray(rs)
        with count_launches() as counts:
            gv, gp = bulk_ops.rmq_bulk_batch(h, ls, rs, track_pos=True)
        assert counts == {"rmq_bulk": 1}
        refs = {"lowering": jbulk(jh, lj, rj, track_pos=True)}
        if jh.plan.num_levels >= 2 and jh.plan.capacity >= c:
            refs["kernel"] = jbulk(jh, lj, rj, track_pos=True, qb=16,
                                   interpret=True)
        for name, (wv, wp) in refs.items():
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv),
                                          err_msg=name)
            np.testing.assert_array_equal(gp.numpy(), np.asarray(wp),
                                          err_msg=name)
        bv, bp = brute_force(x, ls, rs)
        np.testing.assert_array_equal(gv.numpy(), bv)
        np.testing.assert_array_equal(gp.numpy(), bp)
        np.testing.assert_array_equal(
            bulk_ops.rmq_bulk_value_batch(h, ls, rs).numpy(), bv)

    def test_value_only_build(self):
        n, c = 3000, 8
        x = tied_input(np.random.default_rng(8), n)
        h, jh = _pair(x, n, c, 4, None, with_pos=False)
        ls, rs = query_batch(np.random.default_rng(9), n, c)
        want, _ = jbulk(jh, jnp.asarray(ls), jnp.asarray(rs))
        np.testing.assert_array_equal(
            bulk_ops.rmq_bulk_value_batch(h, ls, rs).numpy(),
            np.asarray(want))
        with pytest.raises(ValueError, match="without positions"):
            bulk_ops.rmq_bulk_index_batch(h, ls, rs)


class TestHybrid:
    @pytest.mark.parametrize("n,c,t", [
        (4097, 16, 8), (100_000, 128, 1024), (513, 4, 2), (50_000, 128, 2),
        (999, 8, 2), (600, 1024, 64),  # the last: a single-level plan
    ])
    def test_matches_reference(self, n, c, t):
        rng = np.random.default_rng(n + 7)
        x = tied_input(rng, n)
        got = HybridRMQ.build(x, c=c, t=t, with_positions=True,
                              device="cpu")
        want = JHybrid.build(x, c=c, t=t, with_positions=True)
        assert got.plan.level_lens == want.plan.level_lens
        ls, rs = query_batch(rng, n, c)
        bv, bp = brute_force(x, ls, rs)
        for g, w, b in ((got.query(ls, rs), want.query(ls, rs), bv),
                        (got.query_index(ls, rs), want.query_index(ls, rs),
                         bp)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), b)
        np.testing.assert_array_equal(got.top_table.table.numpy(),
                                      np.asarray(want.top_table.table))
        np.testing.assert_array_equal(got.top_table.pos.numpy(),
                                      np.asarray(want.top_table.pos))

    def test_from_hierarchy_reuses_levels(self):
        n = 30_000
        x = tied_input(np.random.default_rng(3), n)
        h = build_hierarchy(torch.from_numpy(x), make_plan(n, c=64, t=4),
                            True)
        hyb = HybridRMQ.from_hierarchy(h)
        assert hyb.hierarchy is h and hyb.with_positions
        ls, rs = query_batch(np.random.default_rng(4), n, 64)
        np.testing.assert_array_equal(hyb.query(ls, rs).numpy(),
                                      brute_force(x, ls, rs)[0])

    def test_value_only_query_index_raises(self):
        x = np.random.default_rng(0).random(5000).astype(np.float32)
        h = HybridRMQ.build(x, c=16, t=8, device="cpu")
        with pytest.raises(ValueError, match="value-only"):
            h.query_index(np.array([0]), np.array([10]))


class TestBaselines:
    @pytest.mark.parametrize("n", [2, 9, 513, 4097])
    def test_match_reference(self, n):
        rng = np.random.default_rng(n)
        x = tied_input(rng, n)
        ls, rs = query_batch(rng, n, 8)
        lj, rj = jnp.asarray(ls), jnp.asarray(rs)
        bv, bp = brute_force(x, ls, rs)
        pos = np.arange(n, dtype=np.int32)
        st = baselines.SparseTable.build(x, positions=pos, device="cpu")
        jst = jbase.SparseTable.build(jnp.asarray(x),
                                      positions=jnp.asarray(pos))
        np.testing.assert_array_equal(st.table.numpy(),
                                      np.asarray(jst.table))
        np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jst.pos))
        pairs = [
            (st.query_batch(ls, rs), jst.query_batch(lj, rj)),
            (baselines.FullScan.build(x, device="cpu").query_batch(ls, rs),
             jbase.FullScan.build(jnp.asarray(x)).query_batch(lj, rj)),
            (baselines.TwoLevelBlocks.build(x, c=16, device="cpu")
             .query_batch(ls, rs),
             jbase.TwoLevelBlocks.build(jnp.asarray(x), c=16)
             .query_batch(lj, rj)),
        ]
        for got, want in pairs:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(got.numpy(), bv)
        np.testing.assert_array_equal(st.query_index_batch(ls, rs).numpy(),
                                      np.asarray(jst.query_index_batch(lj,
                                                                       rj)))
        np.testing.assert_array_equal(st.query_index_batch(ls, rs).numpy(),
                                      bp)

    def test_memory_accounting_matches_reference(self):
        x = tied_input(np.random.default_rng(1), 5000)
        st = baselines.SparseTable.build(x, device="cpu")
        jst = jbase.SparseTable.build(jnp.asarray(x))
        assert st.memory_bytes() == jst.memory_bytes()
        assert st.auxiliary_bytes() == jst.auxiliary_bytes()
        tl = baselines.TwoLevelBlocks.build(x, c=64, device="cpu")
        jtl = jbase.TwoLevelBlocks.build(jnp.asarray(x), c=64)
        assert tl.auxiliary_bytes() == jtl.auxiliary_bytes()
        assert tl.hierarchy.plan.num_levels == 2
        with pytest.raises(ValueError, match="value-only"):
            st.query_index_batch([0], [1])

"""The port's bit-packed position planes against the reference's, bit for
bit.

Every function of ``repro_torch.core.bitpack`` against
``repro.core.bitpack`` on the same numpy input, at c in {2, 8, 128, 1024}
(1, 3, 7 and 10 bits a field: at 3, 7 and 10 bits fields straddle two
words): packed words compared as uint32 word for word, offsets and
positions as integers.  ``scatter_offsets`` is held with neighbouring
entries that share words and with a ``live`` mask over duplicate ids; the
plane functions over hierarchies the reference built.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbp
from repro.core.hierarchy import build_hierarchy as jbuild
from repro.core.plan import make_plan as jmake_plan
from repro_torch.core import bitpack as bp
from repro_torch.core import build_hierarchy, make_plan

CHUNKS = [2, 8, 128, 1024]
# (n, c, t): at least three levels where c allows it
PLANES = [(999, 2, 1), (5000, 8, 2), (70_000, 128, 4), (5000, 1024, 1)]


def _words(rng, n, bits):
    """Random offsets and their packed words, from the reference."""
    local = rng.integers(0, 1 << bits, n).astype(np.int32)
    return local, np.array(jbp.pack_offsets(jnp.asarray(local), bits))


def test_pos_bits_and_packed_words():
    for c in [2, 4, 8, 16, 128, 1000, 1024, 4096]:
        assert bp.pos_bits(c) == jbp.pos_bits(c)
    for n in [0, 1, 31, 32, 33, 1000]:
        for bits in [1, 3, 7, 10, 31]:
            assert bp.packed_words(n, bits) == jbp.packed_words(n, bits)


@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("n", [1, 31, 32, 1000, 4099])
def test_pack_offsets(c, n):
    bits = bp.pos_bits(c)
    local, want = _words(np.random.default_rng(n + c), n, bits)
    got = bp.pack_offsets(torch.from_numpy(local), bits)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c", CHUNKS)
def test_gather_and_unpack_offsets(c):
    bits = bp.pos_bits(c)
    rng = np.random.default_rng(c)
    n = 3001
    local, words = _words(rng, n, bits)
    wt = torch.from_numpy(words)
    ids = rng.integers(0, n, (7, 33))
    got = bp.gather_offsets(wt, torch.from_numpy(ids), bits)
    assert got.dtype == torch.int32 and got.shape == (7, 33)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbp.gather_offsets(jnp.asarray(words),
                                                   jnp.asarray(ids), bits)))
    np.testing.assert_array_equal(got.numpy(), local[ids])
    un = bp.unpack_offsets(wt, n, bits)
    np.testing.assert_array_equal(un.numpy(), local)
    np.testing.assert_array_equal(
        un.numpy(), np.asarray(jbp.unpack_offsets(jnp.asarray(words), n,
                                                  bits)))


@pytest.mark.parametrize("c", CHUNKS)
def test_scatter_offsets_shared_words(c):
    """Distinct neighbouring entries (sharing words, straddling fields)
    overwritten in one call: the reference's words, and the words of the
    offsets written one by one."""
    bits = bp.pos_bits(c)
    rng = np.random.default_rng(10 + c)
    n = 2000
    local, words = _words(rng, n, bits)
    ids = np.unique(np.concatenate([np.arange(100, 140),
                                    rng.integers(0, n, 200), [0, n - 1]]))
    new = rng.integers(0, 1 << bits, ids.size).astype(np.int32)
    got = bp.scatter_offsets(torch.from_numpy(words), torch.from_numpy(ids),
                             torch.from_numpy(new), bits)
    want = np.asarray(jbp.scatter_offsets(jnp.asarray(words),
                                          jnp.asarray(ids),
                                          jnp.asarray(new), bits))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    local[ids] = new
    np.testing.assert_array_equal(
        got.numpy(), bp.pack_offsets(torch.from_numpy(local), bits).numpy())
    np.testing.assert_array_equal(words, _words(
        np.random.default_rng(10 + c), n, bits)[1])  # input untouched


@pytest.mark.parametrize("c", CHUNKS)
def test_scatter_offsets_live_mask(c):
    """Duplicate ids (as the reference's static-size dedupe pads with):
    with ``live`` marking the first of each, the delta applies once."""
    bits = bp.pos_bits(c)
    rng = np.random.default_rng(20 + c)
    n = 777
    local, words = _words(rng, n, bits)
    ids = np.array([0, 0, 0, 5, 6, 7, 7, 300, 776, 776], np.int32)
    live = np.array([1, 0, 0, 1, 1, 1, 0, 1, 1, 0], bool)
    new = rng.integers(0, 1 << bits, ids.size).astype(np.int32)
    got = bp.scatter_offsets(torch.from_numpy(words), torch.from_numpy(ids),
                             torch.from_numpy(new), bits,
                             live=torch.from_numpy(live))
    want = np.asarray(jbp.scatter_offsets(
        jnp.asarray(words), jnp.asarray(ids), jnp.asarray(new), bits,
        live=jnp.asarray(live)))
    np.testing.assert_array_equal(got.numpy(), want)
    local[ids[live]] = new[live]
    np.testing.assert_array_equal(bp.unpack_offsets(got, n, bits).numpy(),
                                  local)
    # control: without the mask the repeated deltas land twice
    bad = bp.scatter_offsets(torch.from_numpy(words), torch.from_numpy(ids),
                             torch.from_numpy(new), bits)
    assert not np.array_equal(bp.unpack_offsets(bad, n, bits).numpy(), local)


def _pair(n, c, t):
    x = np.random.default_rng(n + c).integers(-8, 8, n).astype(np.float32)
    jh = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t), with_positions=True)
    jp = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t, packed_pos=True),
                with_positions=True)
    plan = make_plan(n, c=c, t=t, packed_pos=True)
    return x, plan, np.array(jh.upper_pos), np.array(jp.upper_pos), jp


@pytest.mark.parametrize("n,c,t", PLANES)
def test_plane_round_trip(n, c, t):
    """``unpack_to_absolute`` of the reference's packed plane is its
    classic plane; ``pack_plane_from_absolute`` of the classic plane is
    its packed plane; ``resolve_positions`` unpacks once and passes
    absolute planes and ``None`` through."""
    x, plan, classic, packed, _ = _pair(n, c, t)
    assert plan.num_levels >= 2
    got = bp.unpack_to_absolute(torch.from_numpy(packed), plan)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), classic)
    words = bp.pack_plane_from_absolute(torch.from_numpy(classic), plan)
    assert words.dtype == torch.uint32
    np.testing.assert_array_equal(words.numpy(), packed)
    res = bp.resolve_positions(torch.from_numpy(packed), plan)
    np.testing.assert_array_equal(res.numpy(), classic)
    assert bp.resolve_positions(res, plan) is res
    assert bp.resolve_positions(None, plan) is None
    # the port's own packed build stores the same words
    h = build_hierarchy(torch.from_numpy(x), plan, with_positions=True)
    np.testing.assert_array_equal(h.upper_pos.numpy(), packed)


@pytest.mark.parametrize("n,c,t", PLANES)
def test_gather_absolute(n, c, t):
    """Every level's entries through the offset chains: the reference's
    positions, and the classic plane's."""
    x, plan, classic, packed, jp = _pair(n, c, t)
    wt = torch.from_numpy(packed)
    for level in range(1, plan.num_levels):
        off = plan.offsets[level - 1]
        ids = np.arange(plan.level_lens[level])
        got = bp.gather_absolute(wt, plan, level, torch.from_numpy(ids),
                                 torch.int32)
        want = jbp.gather_absolute(jnp.asarray(packed), jp.plan, level,
                                   jnp.asarray(ids), jnp.int32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), classic[off + ids])

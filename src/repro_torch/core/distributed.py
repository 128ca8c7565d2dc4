"""Distributed RMQ: segment-sharded hierarchies and a keyed min combine.

The port of ``repro.core.distributed``.  The input is cut into
contiguous segments along one mesh axis (default ``"model"``); each
segment keeps its own minima hierarchy, so a device holds ``n / S``
entries and their ``n / (S (c - 1))`` summaries, and the paper's
single-device memory ceiling lifts with the number of segments.
Element ``g`` lives in segment ``g // segment_capacity``; each segment
reserves ``ceil(capacity / S)`` +inf-padded slots, so appends land on
the tail segments.

A :class:`repro_torch.launch.mesh.Mesh` without a process group holds
every segment in this process (the reference's fake CPU devices); with a
group of ``W`` processes each rank holds ``S / W`` contiguous segments.
A rank's segments are the rows of one ``(S_local, segment_capacity)``
tensor at build time:

* ``fused`` builds them in ONE ``hierarchy_fused`` launch (B1, its row
  axis: :func:`repro_torch.core.hierarchy.build_many`); ``cuda`` runs
  ``hierarchy_build`` (B3) once a level a segment; ``eager`` the plain
  build.  A kernel backend refuses a segment whose extent reaches 2^31
  (the kernels index in int32); the global capacity is not limited.
* Queries (the monolithic path): every local segment answers its clipped
  intersection of the batch, through ``rmq_fused`` (B2, one launch a
  segment), ``rmq_scan`` (B4, one a plane a segment) or the plain walk,
  and one combine picks each span's winner.  Global coordinates are
  int64 from 2^31 up (``pos_dtype_for(capacity)``), with no x64 switch,
  and a bound is clipped in them before it narrows to a segment's.
* The grouped path (:meth:`DistributedRMQ._query_grouped`, the engine's
  segment-local class): each segment answers its own row of local
  bounds, and no combine runs.
* Mutations replicate the batch to every local segment, localize it in
  the global dtype (indices another segment owns become
  ``segment_capacity``, which the update drops) and re-reduce each
  segment, through ``hierarchy_update`` (B6) on a card; no collective
  runs.  An append goes to the segments its range covers.

The combine.  The port's rule (NaN is the least value; the answer is the
leftmost minimal entry with its own bits, a zero's sign and a NaN's
payload included) cannot ride on a float MIN all-reduce, which defines
neither NaN nor which zero wins.  So each segment's answer gets an int64
order key (:func:`order_key`: NaN least, -0.0 equal to +0.0; a segment
the span misses gets the largest key and never wins), and the winner is
the least key, then the least global position (the least segment for a
value-only batch); its bits come from its owner.  Within a process that
is an argmin over the ``(S_local, m)`` stack; across ranks, three int64
``all_reduce(MIN)`` calls on the group (key, tie-break, bits).  Every
collective call counts in :data:`COLLECTIVES` and every combine in
:data:`COMBINES`: one combine a monolithic batch, none on the grouped
path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import protocol as px
from repro_torch.core.hierarchy import (
    Hierarchy,
    build_many,
    gather_bits,
    pos_dtype_for,
)
from repro_torch.core.plan import HierarchyPlan, make_plan
from repro_torch.core.query import check_query_args, rmq_walk_batch
from repro_torch.kernels import profiling

__all__ = ["COLLECTIVES", "COMBINES", "DistributedRMQ", "order_key"]

# Calls, counted where they are made: every collective the index makes,
# and every combine of a monolithic batch (with or without a group).
COLLECTIVES = profiling.KernelCounter("collectives")
COMBINES = profiling.KernelCounter("combines")

_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64,
         torch.bfloat16: torch.int16}


def order_key(v: torch.Tensor) -> torch.Tensor:
    """int64 keys that order values as the port does: NaN least (every
    NaN alike), -0.0 equal to +0.0, then by value.  The float64 bits of a
    value, negatives' magnitude bits flipped, are monotone in it."""
    d = v.to(torch.float64)
    d = torch.where(d == 0, torch.zeros_like(d), d)
    b = d.view(torch.int64)
    k = torch.where(b < 0, b ^ _I64_MAX, b)
    return torch.where(v.isnan(), _I64_MIN, k)


def _bits(v: torch.Tensor) -> torch.Tensor:
    return v.view(_BITS[v.dtype])


def _reduce_min(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    COLLECTIVES.hit()
    return t


def _local_rmq(h: Hierarchy, ls, rs, track: bool, backend: str):
    """One segment's ``(values, local positions or None)``: B2 on
    ``fused`` (both planes, one launch), B4 on ``cuda`` (one launch a
    plane), the plain walk on ``eager``."""
    if backend == "fused":
        from repro_torch.kernels.rmq_fused import ops as fused_ops

        return fused_ops.rmq_fused_batch(h, ls, rs, track)
    if backend == "cuda":
        from repro_torch.kernels.rmq_scan import ops as scan_ops

        vals = scan_ops.rmq_value_batch_cuda(h, ls, rs)
        return vals, (scan_ops.rmq_index_batch_cuda(h, ls, rs)
                      if track else None)
    return rmq_walk_batch(h, ls, rs, track)


def _local_rows(x: torch.Tensor, first: int, count: int,
                cap: int) -> torch.Tensor:
    """Segments ``[first, first + count)`` of ``x`` as the rows of one
    ``(count, cap)`` tensor, +inf past ``len(x)``; a view of ``x`` where
    it fills them exactly."""
    n = x.shape[0]
    start, stop = first * cap, (first + count) * cap
    if start == 0 and stop == n:
        return x.view(count, cap)
    rows = x.new_full((count * cap,), float("inf"))
    live = x[start:min(stop, n)]
    rows[:live.shape[0]] = live
    return rows.view(count, cap)


def _row(h: Hierarchy, i: int) -> Hierarchy:
    return Hierarchy(
        base=h.base[i], upper=h.upper[i],
        upper_pos=None if h.upper_pos is None else h.upper_pos[i],
        plan=h.plan)


@dataclasses.dataclass(frozen=True)
class DistributedRMQ:
    """Segment-sharded RMQ index on a :class:`~repro_torch.launch.mesh.
    Mesh`: this process's segments, in order, and the shared plan."""

    segments: Tuple[Hierarchy, ...]
    local_plan: HierarchyPlan
    mesh: object             # repro_torch.launch.mesh.Mesh
    segment_axis: str
    query_axes: Tuple[str, ...]
    n: int                   # logical (unpadded) live length
    # Monotonic mutation counter: update / append return a successor with
    # generation + 1, so the engine's cache keys never go stale.
    generation: int = 0
    backend: str = "eager"

    # protocol marker: the engine routes a distributed index through the
    # segment-local / crossing executor instead of the span executors
    distributed = True

    # -- construction -----------------------------------------------------
    @staticmethod
    def build(
        x,
        mesh,
        segment_axis: str = "model",
        query_axes: Tuple[str, ...] = ("data",),
        c: int = 128,
        t: int = 64,
        with_positions: bool = False,
        capacity: Optional[int] = None,
        backend: str = "auto",
        packed_pos: Optional[bool] = None,
        summary_dtype: Optional[str] = None,
    ) -> "DistributedRMQ":
        """Build over ``x`` (the whole array, on every rank) on
        ``mesh.device``; ``capacity > len(x)`` reserves room to append.

        ``capacity`` is the global reservation: each segment reserves
        ``ceil(capacity / S)`` +inf-padded slots and its plan comes from
        that.  ``backend`` picks the segments' build and query lowering
        (``"auto"``: ``cuda`` on a card, ``eager`` on the CPU);
        ``packed_pos`` / ``summary_dtype`` the compact per-segment planes,
        as in ``make_plan``."""
        x = px.coerce_values(x, mesh.device)
        n = int(x.shape[0])
        s = mesh.shape[segment_axis]
        for a in query_axes:
            if a not in mesh.shape:
                raise ValueError(f"query axis {a!r} is not on the mesh "
                                 f"{mesh.axis_names}")
        first, last = mesh.local_block(segment_axis)
        if capacity is None:
            capacity = n
        if capacity < n:
            raise ValueError(f"capacity {capacity} < n {n}")
        cap_local = -(-capacity // s)
        local_plan = make_plan(cap_local, c=c, t=t, packed_pos=packed_pos,
                               summary_dtype=summary_dtype)
        backend = px.resolve_backend(backend, mesh.device)
        if backend != "eager":
            px.check_capacity_limit(px.kernel_index_extent(local_plan))
        rows = _local_rows(x, first, last - first, cap_local)
        if backend == "fused":
            h = build_many(rows, local_plan, with_positions)
            segments = tuple(_row(h, i) for i in range(last - first))
        else:
            segments = tuple(
                px.build_hierarchy_with_backend(row, local_plan,
                                                with_positions, backend)
                for row in rows)
        return DistributedRMQ(
            segments=segments, local_plan=local_plan, mesh=mesh,
            segment_axis=segment_axis, query_axes=tuple(query_axes), n=n,
            backend=backend)

    # -- incremental maintenance ------------------------------------------
    def _mutate(self, idxs: torch.Tensor, vals) -> Tuple[Hierarchy, ...]:
        """Every local segment's successor after the replicated batch."""
        cap = self.segment_capacity
        lcoord = pos_dtype_for(cap)
        idxs = idxs.to(device=self.device, dtype=torch.int64)
        vals = torch.as_tensor(vals, device=self.device)
        out = []
        for i, h in enumerate(self.segments):
            loc = idxs - self.segment_start(i)
            loc = torch.where((loc >= 0) & (loc < cap), loc, cap)
            out.append(px.dispatch_update(h, loc.to(lcoord), vals,
                                          self.backend))
        return tuple(out)

    def update(self, idxs, vals) -> "DistributedRMQ":
        """Batched point updates ``a[idxs] = vals`` (last wins on
        duplicates), global indices; each segment re-reduces its own."""
        idxs, vals = px.validate_update_batch(idxs, vals, n=self.n)
        if idxs.shape[0] == 0:
            return self
        return dataclasses.replace(self, segments=self._mutate(idxs, vals),
                                   generation=self.generation + 1)

    def append(self, vals) -> "DistributedRMQ":
        """Grow the array with ``vals`` inside the reserved capacity; a
        batch may straddle a segment boundary, and each segment it covers
        appends its part."""
        vals = px.validate_append_batch(vals, length=self.n,
                                        capacity=self.capacity)
        b = int(vals.shape[0])
        if b == 0:
            return self
        vals = vals.to(self.device)
        cap = self.segment_capacity
        segments = list(self.segments)
        for i, h in enumerate(segments):
            start = self.segment_start(i)
            lo, hi = max(self.n, start), min(self.n + b, start + cap)
            if lo < hi:
                segments[i] = px.dispatch_append(
                    h, vals[lo - self.n:hi - self.n], lo - start,
                    self.backend)
        return dataclasses.replace(self, segments=tuple(segments),
                                   n=self.n + b,
                                   generation=self.generation + 1)

    # -- queries ----------------------------------------------------------
    def query(self, ls, rs) -> torch.Tensor:
        """Batched ``RMQ_value`` over global inclusive ranges."""
        return self._query(ls, rs, track_pos=False)[0]

    def query_index(self, ls, rs) -> torch.Tensor:
        """Batched ``RMQ_index`` (leftmost minimum), global positions in
        ``pos_dtype_for(capacity)``."""
        if not self.with_positions:
            raise ValueError("built without positions")
        return self._query(ls, rs, track_pos=True)[1]

    # protocol spellings (RMQIndex): same entry points, canonical names
    query_value_batch = query
    query_index_batch = query_index

    def _query(self, ls, rs, track_pos: bool):
        ls, rs = check_query_args(ls, rs, self.n, device=self.device)
        shape = ls.shape
        coord = pos_dtype_for(self.capacity)
        ls = ls.reshape(-1).to(coord)
        rs = rs.reshape(-1).to(coord)
        # The reference shards the batch over the query axes, so it pads
        # it to a multiple of their size with (0, 0) spans (valid on any
        # non-empty array); one process answers the whole padded batch.
        m = ls.shape[0]
        q = 1
        for a in self.query_axes:
            q *= self.mesh.shape[a]
        pad = (-m) % q
        if pad:
            ls = torch.cat([ls, ls.new_zeros(pad)])
            rs = torch.cat([rs, rs.new_zeros(pad)])
        if m == 0:
            vals = torch.empty(0, dtype=self.value_dtype, device=self.device)
            pos = torch.empty(0, dtype=coord, device=self.device)
        else:
            vals, pos = self._combine(
                *self._segment_answers(ls, rs, track_pos))
        vals = vals[:m].reshape(shape)
        return vals, (pos[:m].to(coord).reshape(shape) if track_pos
                      else None)

    def _segment_answers(self, ls, rs, track: bool):
        """``(values, keys, positions or None)``, each ``(S_local, m)``:
        every local segment's answer to its clipped intersection of the
        global bounds ``ls`` / ``rs`` (in ``pos_dtype_for(capacity)``),
        its order key (the largest where the span misses it) and its
        int64 global leftmost position."""
        cap = self.segment_capacity
        lcoord = pos_dtype_for(cap)
        vals, keys, poss = [], [], []
        for i, h in enumerate(self.segments):
            start = self.segment_start(i)
            # clip in the global dtype, then narrow: a bare cast could
            # wrap a far bound back into this segment's range
            ll = (ls - start).clamp(0, cap - 1).to(lcoord)
            rr = (rs - start).clamp(0, cap - 1).to(lcoord)
            hit = (rs >= start) & (ls < start + cap)
            v, p = _local_rmq(h, ll, rr, track, self.backend)
            vals.append(v)
            keys.append(torch.where(hit, order_key(v), _I64_MAX))
            if track:
                poss.append(p.to(torch.int64) + start)
        return (torch.stack(vals), torch.stack(keys),
                torch.stack(poss) if track else None)

    def _combine(self, vals, keys, pos):
        """Each span's winner over the segments: the least key, then the
        least global position (``pos``) or, value-only, the least
        segment; its own bits.  ``(values, int64 positions or None)``;
        with a process group, three ``all_reduce(MIN)`` calls."""
        COMBINES.hit()
        win = torch.argmin(keys, dim=0, keepdim=True)  # first: leftmost
        key = keys.gather(0, win)[0]
        v = gather_bits(vals, 0, win)[0]
        tie = (pos.gather(0, win)[0] if pos is not None
               else win[0] + self.mesh.local_block(self.segment_axis)[0])
        group = self.mesh.group
        if group is not None:
            least = _reduce_min(key.clone(), group)
            held = key == least
            tie_g = _reduce_min(torch.where(held, tie, _I64_MAX), group)
            mine = held & (tie == tie_g)
            bits = _reduce_min(
                torch.where(mine, _bits(v).to(torch.int64), _I64_MAX), group)
            v = bits.to(_BITS[v.dtype]).view(v.dtype)
            tie = tie_g
        return v, (tie if pos is not None else None)

    def _query_grouped(self, ls_local, rs_local, track_pos: bool):
        """Answer pre-grouped segment-local queries without a combine.

        ``ls_local`` / ``rs_local`` are ``(S, k)`` segment-local inclusive
        bounds: row ``i`` holds only spans inside segment ``i`` (unused
        slots ``(0, 0)``, their answers dropped by the caller).  Returns
        ``(S, k)`` values and global leftmost positions (int32 zeros
        value-only).  In one process no collective runs; on a group of
        several ranks each answers its own rows and one ``all_gather``
        brings the others' (the reference's answers stay sharded on its
        devices)."""
        if track_pos and not self.with_positions:
            raise ValueError("built without positions")
        s, cap = self.num_segments, self.segment_capacity
        lcoord = pos_dtype_for(cap)
        ls_local = torch.as_tensor(ls_local, device=self.device).to(lcoord)
        rs_local = torch.as_tensor(rs_local, device=self.device).to(lcoord)
        if ls_local.ndim != 2 or ls_local.shape[0] != s:
            raise ValueError(
                f"grouped bounds must be (num_segments={s}, k), got "
                f"{tuple(ls_local.shape)}")
        first = self.mesh.local_block(self.segment_axis)[0]
        coord = pos_dtype_for(self.capacity)
        vals, poss = [], []
        for i, h in enumerate(self.segments):
            g = first + i
            v, p = _local_rmq(h, ls_local[g].contiguous(),
                              rs_local[g].contiguous(), track_pos,
                              self.backend)
            vals.append(v)
            poss.append(p.to(coord) + self.segment_start(i) if track_pos
                        else torch.zeros_like(ls_local[g], dtype=torch.int32))
        vals, poss = torch.stack(vals), torch.stack(poss)
        if self.mesh.world > 1:
            vals, poss = self._gather_rows(vals, poss)
        return vals, poss

    def _gather_rows(self, vals, poss):
        """Every rank's ``(S_local, k)`` rows, in segment order: one
        ``all_gather`` of the values' bits and the positions as int64."""
        import torch.distributed as dist

        mine = torch.stack([_bits(vals).to(torch.int64),
                            poss.to(torch.int64)])
        parts = [torch.empty_like(mine) for _ in range(self.mesh.world)]
        dist.all_gather(parts, mine, group=self.mesh.group)
        COLLECTIVES.hit()
        full = torch.cat(parts, dim=1)
        return (full[0].to(_BITS[vals.dtype]).view(vals.dtype),
                full[1].to(poss.dtype))

    # -- adaptive batched engine -------------------------------------------
    def engine(self, **kwargs):
        """A :class:`repro_torch.qe.QueryEngine` routed over this index:
        spans inside one segment answered segment-locally (no combine),
        crossing spans through the combine; bit-identical to
        :meth:`query` / :meth:`query_index`.  Re-attach after
        ``update`` / ``append``."""
        return px.make_engine(self, **kwargs)

    # -- introspection ------------------------------------------------------
    def segment_start(self, i: int) -> int:
        """Global index of local segment ``i``'s first slot."""
        first = self.mesh.local_block(self.segment_axis)[0]
        return (first + i) * self.segment_capacity

    @property
    def plan(self) -> HierarchyPlan:
        """The per-segment plan (``capacity`` is the global space)."""
        return self.local_plan

    @property
    def length(self) -> int:
        return self.n

    @property
    def num_segments(self) -> int:
        return self.mesh.shape[self.segment_axis]

    @property
    def segment_capacity(self) -> int:
        """Slots a segment; element ``g`` lives in segment
        ``g // segment_capacity``."""
        return self.local_plan.capacity

    @property
    def capacity(self) -> int:
        """Total reserved (appendable) index space across segments."""
        return self.segment_capacity * self.num_segments

    @property
    def with_positions(self) -> bool:
        return self.segments[0].with_positions

    @property
    def value_dtype(self) -> torch.dtype:
        return self.segments[0].base.dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def memory_bytes_per_device(self) -> int:
        """Bytes of one segment (its level 0 and summaries): what each
        device of the mesh's segment axis holds."""
        return sum(h.memory_bytes() for h in self.segments) // len(
            self.segments)

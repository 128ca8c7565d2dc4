"""Bit-packed chunk-local position planes (the compact position layout).

The port of ``repro.core.bitpack``.  A position-tracking hierarchy stores
one absolute int32 (int64 past 2^31) a summary entry, but an entry's
minimum always comes from one of the ``c`` children it summarizes, so
its *chunk-local offset*, ``log2(c)`` bits, names the absolute position
once the level below is known:

* level 1: ``abs(e) = e*c + local(e)`` (children are level-0 indices);
* level k: ``abs(e) = abs_{k-1}[e*c + local(e)]``, resolved bottom-up.

The offsets are packed into a ``torch.uint32`` word array: entry ``e``
owns bits ``[e*bits, (e+1)*bits)`` of the stream, little-endian within
each word, so a field may straddle two words.  At ``c = 128`` the
position plane shrinks from 32 to 7 bits an entry.  The packed words
live in ``Hierarchy.upper_pos`` when ``plan.packed_pos`` is set; a query
resolves them to the absolute plane once a batch
(:func:`resolve_positions`), bit-identical to the classic build's plane
(leftmost ties and ``PAD_POS`` padding included).

Updates rewrite fields with a wrapping-delta scatter-add
(:func:`scatter_offsets`): a field's bits hold exactly its old value, so
adding ``(new - old) << shift`` (mod 2^32, split across the at most two
words it straddles) replaces it without a carry into a neighbour, even
when several entries share a word.

``torch.uint32`` has views and casts but no shifts, sums or
scatter-adds (and no indexing on the card), so the words are read
through their int32 view, the arithmetic is done in int64 (widen, shift,
add, mask with ``0xFFFFFFFF``) and the words are stored as uint32.  The
dtype is the layout's tag: :func:`resolve_positions` tells a packed
plane (uint32) from an absolute one (int32 / int64) by it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.constants import PAD_POS

__all__ = [
    "gather_absolute",
    "gather_offsets",
    "pack_offsets",
    "pack_plane_from_absolute",
    "packed_words",
    "pos_bits",
    "resolve_positions",
    "scatter_offsets",
    "unpack_offsets",
    "unpack_to_absolute",
]

_WORD = 32
_WORD_MASK = 0xFFFFFFFF


def pos_bits(c: int) -> int:
    """Bits per packed entry: a chunk-local offset in ``[0, c)``."""
    return max(1, (c - 1).bit_length())


def packed_words(n_entries: int, bits: int) -> int:
    """uint32 words needed for ``n_entries`` fields of ``bits`` each."""
    return (n_entries * bits + _WORD - 1) // _WORD


def _field_coords(entry_ids: torch.Tensor, bits: int):
    """(word index, in-word shift) of each entry's field start, int64.

    Exact for any entry id (the reference computes the bit offset in
    uint32, exact below ``2**32 / bits`` entries: the same numbers there).
    """
    bitpos = entry_ids.to(torch.int64) * bits
    return bitpos >> 5, bitpos & (_WORD - 1)


def _split_contrib(value: torch.Tensor, sh: torch.Tensor):
    """A field value (int64, ``< 2**bits``) as its (low word, straddling
    high word) contributions; the high part is 0 where the field fits."""
    return (value << sh) & _WORD_MASK, value >> (_WORD - sh)


def _widen(words: torch.Tensor, at=None) -> torch.Tensor:
    """Packed words (at ``at``, else all) as int64 in ``[0, 2**32)``,
    read through their int32 view."""
    w = words.view(torch.int32)
    if at is not None:
        w = w[at]
    return w.to(torch.int64) & _WORD_MASK


def _words_add(words64: torch.Tensor, w0, lo, hi) -> torch.Tensor:
    """``words64`` (one spare slot at the end) plus ``lo`` at ``w0`` and
    ``hi`` at ``w0 + 1``, as uint32 words without the spare slot: a high
    part past the last word lands in the spare slot and is dropped."""
    words64.index_add_(0, w0, lo)
    words64.index_add_(0, w0 + 1, hi)
    return (words64[:-1] & _WORD_MASK).to(torch.uint32)


def pack_offsets(local: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack per-entry chunk-local offsets (< 2**bits) into uint32 words.

    Fields of distinct entries are disjoint bit ranges, so the sum over
    shared words is a bitwise or.
    """
    n = local.shape[0]
    e = torch.arange(n, device=local.device)
    v = local.to(torch.int64) & ((1 << bits) - 1)
    w0, sh = _field_coords(e, bits)
    lo, hi = _split_contrib(v, sh)
    words = torch.zeros(packed_words(n, bits) + 1, dtype=torch.int64,
                        device=local.device)
    return _words_add(words, w0, lo, hi)


def gather_offsets(words: torch.Tensor, entry_ids: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """The packed fields at ``entry_ids`` (any shape) as int32."""
    nwords = words.shape[0]
    w0, sh = _field_coords(entry_ids, bits)
    lo = _widen(words, w0) >> sh
    # sh == 0 shifts the next word by 32: its bits all land above the
    # field's, and the mask drops them
    hi = _widen(words, torch.clamp(w0 + 1, max=nwords - 1)) << (_WORD - sh)
    return ((lo | hi) & ((1 << bits) - 1)).to(torch.int32)


def unpack_offsets(words: torch.Tensor, n_entries: int,
                   bits: int) -> torch.Tensor:
    """All ``n_entries`` packed fields, in entry order, as int32."""
    return gather_offsets(
        words, torch.arange(n_entries, device=words.device), bits)


def scatter_offsets(
    words: torch.Tensor,
    entry_ids: torch.Tensor,
    new_local: torch.Tensor,
    bits: int,
    live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``words`` with the fields at ``entry_ids`` set to ``new_local``.

    ``live`` (optional bool mask) turns lanes into no-ops: the
    reference's static-size dedupe emits duplicate fill ids whose deltas
    would otherwise apply twice.  (The port dedupes with
    ``torch.unique``, which emits none, so its update passes no mask.)
    Distinct live entries may share words: each delta moves only its own
    field's bits, and the sums are exact mod 2^32.  Returns new words;
    ``words`` is not written.
    """
    mask = (1 << bits) - 1
    old = gather_offsets(words, entry_ids, bits).to(torch.int64)
    new = new_local.to(torch.int64) & mask
    if live is not None:
        new = torch.where(live, new, old)
    w0, sh = _field_coords(entry_ids, bits)
    new_lo, new_hi = _split_contrib(new, sh)
    old_lo, old_hi = _split_contrib(old, sh)
    words64 = torch.cat([_widen(words), words.new_zeros(
        1, dtype=torch.int64)])
    return _words_add(words64, w0.reshape(-1), (new_lo - old_lo).reshape(-1),
                      (new_hi - old_hi).reshape(-1))


def gather_absolute(words: torch.Tensor, plan, level: int,
                    entry_ids: torch.Tensor,
                    pos_dtype: torch.dtype) -> torch.Tensor:
    """Absolute level-0 positions of ``entry_ids`` within ``level``.

    One gather a level down: an entry's field names the child holding
    its minimum, the child's field the grandchild, down to level 0.
    ``entry_ids`` must be live entries (below ``plan.level_lens[level]``):
    a live entry's chain reads only live entries, but a padding entry's
    field is 0 and its chain can run past the word array, which raises
    (the reference's gathers clamp instead; the port's do not).
    """
    bits = pos_bits(plan.c)
    e = entry_ids.to(pos_dtype)
    for lvl in range(level, 0, -1):
        loc = gather_offsets(words, plan.offsets[lvl - 1] + e, bits)
        e = e * plan.c + loc.to(pos_dtype)
    return e


def _plane_dtype(plan) -> torch.dtype:
    from repro_torch.core.hierarchy import pos_dtype_for

    return pos_dtype_for(plan.capacity)


def unpack_to_absolute(words: torch.Tensor, plan) -> torch.Tensor:
    """The full absolute-position plane from a packed word array.

    Bit-identical to the plane a classic build stores: live entries are
    rebuilt level by level (the selected child of a live entry is live,
    so a chain never reads padding), padding entries are ``PAD_POS``.
    """
    c = plan.c
    bits = pos_bits(c)
    dtype = _plane_dtype(plan)
    dev = words.device
    out = torch.full((plan.upper_size,), PAD_POS, dtype=dtype, device=dev)
    prev = None
    for k in range(1, plan.num_levels):
        off, padded = plan.level_slice(k)
        e = torch.arange(padded, dtype=dtype, device=dev)
        child = e * c + gather_offsets(words, off + e, bits).to(dtype)
        if k == 1:
            abs_k = child
        else:
            abs_k = prev[torch.clamp(child, max=prev.shape[0] - 1)]
        abs_k = torch.where(e < plan.level_lens[k], abs_k, PAD_POS)
        out[off:off + padded] = abs_k
        prev = abs_k
    return out


def pack_plane_from_absolute(abs_plane: torch.Tensor, plan) -> torch.Tensor:
    """Packed words from an absolute-position plane (any backend's build).

    Level 1's offsets are ``abs - e*c``; at level k the selected child is
    the one child whose absolute position equals the parent's (chunk
    minima summarize disjoint ranges, so the positions of a parent's live
    children are distinct).  Padding entries pack as 0; they unpack to
    ``PAD_POS``.
    """
    c = plan.c
    bits = pos_bits(c)
    dev = abs_plane.device
    lane = torch.arange(c, device=dev)
    locals_ = torch.zeros(plan.upper_size, dtype=torch.int32, device=dev)
    for k in range(1, plan.num_levels):
        off, padded = plan.level_slice(k)
        cur = abs_plane[off:off + padded]
        e = torch.arange(padded, device=dev)
        if k == 1:
            loc = cur.to(torch.int64) - e * c
        else:
            poff, ppadded = plan.level_slice(k - 1)
            child = abs_plane[poff:poff + ppadded]
            win = child[torch.clamp(e[:, None] * c + lane, max=ppadded - 1)]
            # the first lane whose position matches (argmax: first max)
            loc = torch.argmax((win == cur[:, None]).to(torch.uint8), dim=1)
        loc = torch.where(e < plan.level_lens[k], loc, 0)
        locals_[off:off + padded] = loc.to(torch.int32)
    return pack_offsets(locals_, bits)


def resolve_positions(upper_pos: Optional[torch.Tensor], plan):
    """The absolute-position plane a query should read.

    Passes classic planes and ``None`` through; unpacks a packed plane.
    Idempotent: packed words are uint32 and absolute planes signed, so an
    already-resolved plane passes through unchanged.
    """
    if (upper_pos is not None and getattr(plan, "packed_pos", False)
            and upper_pos.dtype == torch.uint32):
        return unpack_to_absolute(upper_pos, plan)
    return upper_pos

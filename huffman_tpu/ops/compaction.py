"""Per-lane stable stream compaction with no per-lane scatters.

Both codec kernels stage variable-rate results densely — one slot per step
per lane, with a validity mask — because lanes produce output at different,
data-dependent rates (a decode step emits 1-2 symbols; an encode step emits
0-1 words).  Compaction then moves every valid entry to the front of its
lane, preserving order.

The reference sidesteps this with per-stream scalar pointers and masked
scatters (codec/huffman.cpp:1611-1613); this XLA route has no per-lane
scatter, so instead we compact with ``log2(T)`` rounds of
*shift-by-2^j + select*, all dense elementwise work:

Each valid element must move left by ``d = index - rank`` slots, where
``rank`` counts valid elements before it.  ``d`` is non-decreasing along the
lane, so applying the binary decomposition of ``d`` low-bit-first never
collides: in round ``j`` an element moves left by ``2^j`` iff bit ``j`` of
its remaining displacement is set, and the slot it lands on either held an
invalid entry or an element that is itself moving.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def compact_lanes(values, valid, out_len: int | None = None):
    """Stably move valid entries to the front of axis 0, per lane.

    Args:
      values: (T, ...) array or tuple/list of same-shape arrays moved together.
      valid: (T, ...) bool, which slots hold real entries.
      out_len: trim the result to this many leading rows (static).

    Returns:
      (compacted_values, counts) where counts[...] = number of valid entries
      per lane; rows >= counts hold unspecified values.
    """
    multi = isinstance(values, (tuple, list))
    vals = list(values) if multi else [values]
    T = vals[0].shape[0]

    v = valid
    counts = jnp.sum(v.astype(jnp.int32), axis=0)
    rank = jnp.cumsum(v.astype(jnp.int32), axis=0) - 1  # rank among valid
    idx = jax.lax.broadcasted_iota(jnp.int32, v.shape, 0)
    # Displacement toward the front; meaningless (but harmless) when invalid.
    d = jnp.where(v, idx - rank, 0)

    shift = 1
    while shift < T:
        def mv(x):
            return jax.lax.slice_in_dim(
                jnp.concatenate([x, jnp.zeros((shift,) + x.shape[1:], x.dtype)], axis=0),
                shift, shift + T, axis=0)

        vs, ds = mv(v), mv(d)
        arrive = vs & ((ds & shift) != 0)
        stay = v & ((d & shift) == 0)
        vals = [jnp.where(arrive, mv(x), x) for x in vals]
        d = jnp.where(arrive, ds - shift, d)
        v = arrive | stay
        shift <<= 1

    if out_len is not None:
        vals = [jax.lax.slice_in_dim(x, 0, out_len, axis=0) for x in vals]
    return (tuple(vals) if multi else vals[0]), counts


def compact_packed(values, valid, vbits: int, out_len: int | None = None, max_disp: int | None = None):
    """Single-array packed variant of `compact_lanes` — the hot-path version.

    Packs ``value+1`` (must fit in ``vbits`` bits) and the remaining leftward
    displacement into one int32 per slot (0 = empty slot), so each of the
    log2(T) rounds runs ~6 elementwise ops on ONE array instead of ~18 on
    three.  This matters because compaction is the dominant cost of the
    staged-emission kernels (see ops/decode_bits.py).

    Args:
      values: (T, ...) int32/uint-like, each value < 2**vbits - 1.
      valid: (T, ...) bool.
      vbits: static; bits reserved for value+1.  Requires
        ``vbits + ceil(log2(T)) <= 31``.
      out_len: static; trim result rows.

    Returns:
      (vals, counts): vals (out_len or T, ...) int32 with original values
      (rows >= counts are garbage), counts = valid entries per lane.
    """
    T = values.shape[0]
    bound = T - 1 if max_disp is None else min(max_disp, T - 1)
    rounds = max(1, bound).bit_length()
    assert vbits + rounds <= 31, (vbits, T)

    counts = jnp.sum(valid.astype(jnp.int32), axis=0)
    rank = jnp.cumsum(valid.astype(jnp.int32), axis=0) - 1
    idx = jax.lax.broadcasted_iota(jnp.int32, valid.shape, 0)
    d = idx - rank
    packed = jnp.where(
        valid, (d << vbits) | (values.astype(jnp.int32) + 1), 0
    )

    shift = 1
    zeros_cache = {}
    while shift <= bound:
        pad = zeros_cache.get(shift)
        if pad is None:
            pad = jnp.zeros((shift,) + packed.shape[1:], packed.dtype)
            zeros_cache[shift] = pad
        xs = jax.lax.slice_in_dim(
            jnp.concatenate([packed, pad], axis=0), shift, shift + T, axis=0
        )
        arrive = ((xs >> vbits) & shift) != 0  # implies xs != 0
        stay = (packed != 0) & (((packed >> vbits) & shift) == 0)
        packed = jnp.where(arrive, xs - (shift << vbits), jnp.where(stay, packed, 0))
        shift <<= 1

    if out_len is not None:
        packed = jax.lax.slice_in_dim(packed, 0, out_len, axis=0)
    return (packed & ((1 << vbits) - 1)) - 1, counts

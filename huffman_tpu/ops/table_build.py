"""Jittable on-device canonical Huffman table construction.

The host builder (:mod:`huffman_tpu.coding`) mirrors the reference's scalar
``MakeCanonicalCoding`` (codec/huffman.cpp:339-437).  This module is the
device-resident equivalent: a pure-JAX, fully jittable histogram -> tables
pipeline, so the complete compress step (histogram, table build, encode) can
run as ONE compiled program with zero host syncs — something the reference
cannot express at all (its table build is interleaved host code).

That matters for two reasons:
  * a sharded pipeline can ``psum`` per-shard histograms and build the shared
    table *inside* the same ``shard_map`` step (the distributed analog of the
    reference's histogram-merge loop, huffman.cpp:762-766);
  * streaming/batched compression never bounces to the host between blocks.

Algorithm notes
---------------
Tree build uses the Moffat–Katajainen in-place two-queue construction over
weights sorted ascending; its tie rule (pop a leaf when weights are equal)
matches the reference's ``sym_count[sym] <= tree_count[next]``
(huffman.cpp:379) and the host builder, so all three produce identical
``len_count`` — verified against the host oracle in
tests/test_table_build.py.

Leaf depths are never collected by traversal: with ``I[d]`` = number of
*internal* nodes at depth ``d`` (from pointer-doubled parent depths),
``len_count[d] = 2*I[d-1] - I[d]`` — each internal node at ``d-1`` has two
children, and the non-internal ones are exactly the leaves.

Length limiting is the same "MiniZ" Kraft repair as the host/reference
(huffman.cpp:294-327), as a ``lax.while_loop``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# The device builder serves the tpu format profile only, so it limits to
# the deeper TPU_MAX_CODE_LEN (15): the profile's decoder is table-free and
# its header mask has room, so the reference's 12-bit cap (nibble packing
# + 2^12 host tables) does not bind — and 15 cuts the limiting loss (see
# constants.py).  The module-local name keeps the algebra readable.
from ..constants import TPU_MAX_CODE_LEN as MAX_CODE_LEN
from ..constants import NUM_SYMBOLS

_I32 = jnp.int32
_N = NUM_SYMBOLS
# Upper bound on unlimited code depth: int32 weights (< 2^30) keep optimal
# depth far below 64 (Fibonacci growth); 64 buckets is safely conservative.
_MAX_DEPTH = 64
# Weight sentinel for empty queue slots.  All arithmetic is int32 (x64 is
# disabled under jit), so total input size per table must stay < 2^30
# bytes — far above any realistic block.
_BIG = jnp.int32(1) << 30


def _sort_by_freq(hist):
    """(present-first symbol order, counts in that order, num_syms).

    Deterministic tie-break identical to the host builder
    (coding.make_canonical_coding): frequency descending, symbol ascending.
    Absent symbols sort after all present ones, by symbol value.  A stable
    argsort over ``-count`` gives exactly this, since the input index order
    IS symbol order.
    """
    h = hist.astype(_I32)
    key = jnp.where(h > 0, -h, jnp.int32(1))
    # ONE stable sort carries both payloads (counts and the identity iota,
    # which sorted stably IS the argsort): avoids a second sort, and
    # carrying values avoids a post-sort gather (which would serialize
    # under vmap in the batched builder).
    iota = jnp.arange(_N, dtype=_I32)
    _, counts_desc, syms_by_freq = jax.lax.sort(
        (key, h, iota), dimension=-1, num_keys=1, is_stable=True
    )
    num_syms = jnp.sum((h > 0).astype(_I32))
    return syms_by_freq, counts_desc, num_syms


def _huffman_len_count(counts_desc, num_syms):
    """len_count (unlimited) from counts sorted descending.

    Moffat–Katajainen in-place algorithm, phases 1-2, then the I[d]
    recurrence above instead of phase 3.
    """
    n = num_syms
    # Ascending weights, active leaves in a[0:n]; inactive slots get +inf
    # sentinels so static-shape code never picks them.
    big = _BIG
    asc = counts_desc[::-1]  # absent symbols (count 0) land at the front
    a0 = jnp.roll(asc, -(_N - n))  # a0[0:n] ascending actives
    a0 = jnp.where(jnp.arange(_N) < n, a0, big)

    # All element reads/writes below are one-hot compare-selects, NOT
    # dynamic indexing: under jax.vmap (the batched block codec) they stay
    # dense vector ops, where gathers/scatters would serialize.
    idx = jnp.arange(_N, dtype=_I32)

    def get(arr, i):
        return jnp.sum(jnp.where(idx == i, arr, 0))

    def put(arr, i, val, pred=True):
        return jnp.where((idx == i) & pred, val, arr)

    # Phase 1: a[i] becomes (weight then parent-index) of internal node i;
    # n-1 internal nodes total.  leaf/root are queue cursors.  The loop
    # runs two merges per iteration (predicated) to halve loop overhead —
    # this serial 255-step build is the dominant fixed cost per block.
    def pop(state, nxt, active):
        a, leaf, root = state
        leaf_w = jnp.where(leaf < n, get(a, leaf), _BIG)
        root_w = get(a, root)
        take_tree = active & (root < nxt) & (root_w < leaf_w)
        take_leaf = active & ~take_tree
        w = jnp.where(take_tree, root_w, leaf_w)
        # Consumed internal nodes are overwritten with their parent index.
        a = put(a, root, nxt, take_tree)
        leaf = leaf + take_leaf.astype(_I32)
        root = root + take_tree.astype(_I32)
        return (a, leaf, root), w

    def merge(st, i, active):
        a, leaf, root = st
        (a, leaf, root), w1 = pop((a, leaf, root), i, active)
        (a, leaf, root), w2 = pop((a, leaf, root), i, active)
        a = put(a, i, w1 + w2, active)
        return (a, leaf, root)

    n_internal = jnp.maximum(n - 1, 0)

    def phase1_pair(j, st):
        i = 2 * j
        st = merge(st, i, i < n_internal)
        st = merge(st, i + 1, i + 1 < n_internal)
        return st

    # Queue-cursor carries start at zero *derived from n* (not a literal):
    # under shard_map vma checking a literal is axis-invariant while the
    # loop body makes the carry varying, which would reject the loop.
    zero = n * 0
    a, _, _ = jax.lax.fori_loop(
        0, (n_internal + 1) // 2, phase1_pair, (a0, zero, zero)
    )

    # Phase 2: internal-node depths, in place (Moffat): root slot n-2 gets
    # depth 0; descending slots read their (already-depth) parent slot.
    # Two slots per iteration: slot nxt-1's parent is strictly above nxt-1,
    # so it may read the freshly written nxt — sequence the two gets.
    a = put(a, n_internal - 1, 0, n_internal >= 1)

    def phase2_pair(j, a):
        nxt = n_internal - 2 - 2 * j
        pd = get(a, get(a, nxt))
        a = put(a, nxt, pd + 1, nxt >= 0)
        pd2 = get(a, get(a, nxt - 1))
        return put(a, nxt - 1, pd2 + 1, nxt - 1 >= 0)

    a = jax.lax.fori_loop(0, jnp.maximum(n_internal, 1) // 2, phase2_pair, a)
    depth = a.astype(_I32)

    # I[d] = # internal nodes at depth d (root included at d=0).
    is_internal = idx < n_internal
    i_of_d = jnp.sum(
        jnp.where(
            is_internal[None, :],
            (depth[None, :] == jnp.arange(_MAX_DEPTH)[:, None]).astype(_I32),
            0,
        ),
        axis=1,
    )
    len_count = jnp.concatenate(
        [jnp.zeros(1, _I32), 2 * i_of_d[:-1] - i_of_d[1:]]
    )
    len_count = jnp.maximum(len_count, 0)
    # Degenerate cases: n == 1 -> one zero-length code; n == 0 -> nothing.
    one_hot0 = (jnp.arange(_MAX_DEPTH) == 0).astype(_I32)
    len_count = jnp.where(n == 1, one_hot0, len_count)
    len_count = jnp.where(n == 0, 0, len_count)
    return len_count  # (_MAX_DEPTH,) int32


def _limit_len_count(len_count):
    """Kraft repair capping lengths at MAX_CODE_LEN (huffman.cpp:294-327)."""
    lc = len_count.astype(_I32)
    over = jnp.sum(jnp.where(jnp.arange(_MAX_DEPTH) > MAX_CODE_LEN, lc, 0))
    lc = lc.at[MAX_CODE_LEN].add(over)
    lc = jnp.where(jnp.arange(_MAX_DEPTH) <= MAX_CODE_LEN, lc, 0)[
        : MAX_CODE_LEN + 1
    ]
    ls = jnp.arange(MAX_CODE_LEN + 1)
    one = jnp.int32(1) << MAX_CODE_LEN
    kraft = jnp.sum(lc << (MAX_CODE_LEN - ls))

    def cond(st):
        lc, kraft = st
        return kraft > one

    def body(st):
        lc, kraft = st
        lc = lc.at[MAX_CODE_LEN].add(-1)
        # Largest j < MAX_CODE_LEN with lc[j] > 0.
        j = jnp.max(jnp.where((lc > 0) & (ls < MAX_CODE_LEN), ls, -1))
        j = jnp.clip(j, 0, MAX_CODE_LEN - 1)
        # One-hot updates (vmap-dense; see _huffman_len_count).
        lc = lc + jnp.where(ls == j, -1, 0) + jnp.where(ls == j + 1, 2, 0)
        return lc, kraft - 1

    lc, _ = jax.lax.while_loop(cond, body, (lc, kraft))
    return lc.astype(_I32)  # (MAX_CODE_LEN+1,)


@jax.jit
def build_coding_device(hist):
    """Histogram -> full coding state, entirely on device.

    Args:
      hist: (256,) integer byte counts.  Contract: TOTAL count < 2^30
        (weight sums run in int32) — always true for per-block histograms,
        which is what this builder is for.  The host builder handles
        arbitrary 64-bit histograms.

    Returns dict of device arrays:
      enc_table: (256,) int32 ``code<<4 | len`` (code left-aligned in
        MAX_CODE_LEN bits) — input for ops.encode.encode_lanes.
      len_count: (MAX_CODE_LEN+1,) int32.
      sorted_syms: (256,) int32; first num_syms entries meaningful
        (length asc, freq desc, symbol asc — wire order).
      num_syms: () int32.
      e_bound: (MAX_CODE_LEN+2,) int32 and g_rank: (MAX_CODE_LEN+1,) int32
        — the bit-serial decode constants (ops.decode_bits).
      l_min: () int32 — shortest code length (1 if empty/degenerate).
    """
    # Count clamp (mirrors coding.clamp_hist): a symbol with probability
    # below 2^-MAX_CODE_LEN sits at depth MAX_CODE_LEN in any limited
    # code anyway, so raising its count to that floor loses nothing —
    # and the tree then lands within the limit on its own, leaving the
    # Kraft repair (whose cascading demotions cost up to 5% compressed
    # size on smoothed sampled histograms) with nothing to do.  Measured
    # equal to the package-merge optimum on every corpus tried
    # (tests/test_coding_limits.py).
    h = hist.astype(_I32)
    floor = jnp.maximum(jnp.sum(h) >> MAX_CODE_LEN, 1)
    hist = jnp.where(h > 0, jnp.maximum(h, floor), 0)
    syms_by_freq, counts_desc, num_syms = _sort_by_freq(hist)
    len_count = _limit_len_count(_huffman_len_count(counts_desc, num_syms))

    # After limiting, lengths still ascend as frequency descends, so the
    # freq-sorted symbol order IS the canonical wire order (see
    # coding.make_canonical_coding).
    ls = jnp.arange(MAX_CODE_LEN + 1, dtype=_I32)
    cum = jnp.cumsum(len_count)  # codes with length <= l
    # Rank i (0-based among num_syms) gets length: 1 + #{l : cum[l] <= i}.
    i = jnp.arange(_N, dtype=_I32)
    lens_ranked = jnp.sum((i[:, None] >= cum[None, :]).astype(_I32), axis=1)
    lens_ranked = jnp.clip(lens_ranked, 0, MAX_CODE_LEN)

    # E[l] = sum_{j<=l} len_count[j] << (MAX-j), the canonical boundary.
    e = jnp.cumsum(len_count << (MAX_CODE_LEN - ls))
    e_prev_of = jnp.concatenate([jnp.zeros(1, _I32), e])  # E[l-1] at index l
    base_of = jnp.concatenate([jnp.zeros(1, _I32), cum])  # #shorter at l

    lr = lens_ranked
    # 14-entry table lookups by one-hot select (vmap-dense).
    l_iota = jnp.arange(MAX_CODE_LEN + 2, dtype=_I32)
    e_prev_lr = jnp.sum(
        jnp.where(lr[:, None] == l_iota[None, :], e_prev_of[None, :], 0), axis=1
    )
    base_lr = jnp.sum(
        jnp.where(lr[:, None] == l_iota[None, :], base_of[None, :], 0), axis=1
    )
    code_ranked = e_prev_lr + ((i - base_lr) << (MAX_CODE_LEN - lr))
    valid = i < num_syms
    entry_ranked = jnp.where(
        valid, (code_ranked << 4) | lens_ranked, 0
    ).astype(_I32)

    # Permutation apply via one-hot sum instead of a scatter.
    sym_iota = jnp.arange(_N, dtype=_I32)
    enc_table = jnp.sum(
        jnp.where(
            syms_by_freq[:, None] == sym_iota[None, :], entry_ranked[:, None], 0
        ),
        axis=0,
    )

    # Bit-serial decode constants (mirrors ops.decode_bits.decode_tables_*).
    e_bound = jnp.concatenate([e, e[-1:]]).astype(_I32)
    e_full = jnp.concatenate([jnp.zeros(1, _I32), e_bound[:-1]])  # E[l-1]
    g_rank = (
        base_of[: MAX_CODE_LEN + 1]
        - (e_prev_of[: MAX_CODE_LEN + 1] >> (MAX_CODE_LEN - ls))
    ).astype(_I32)
    del e_full

    has_l = len_count[1:] > 0
    l_min = jnp.min(
        jnp.where(has_l, jnp.arange(1, MAX_CODE_LEN + 1, dtype=_I32), 99)
    )
    l_min = jnp.where(l_min == 99, 1, l_min)

    return {
        "enc_table": enc_table,
        "len_count": len_count,
        "sorted_syms": syms_by_freq,
        "num_syms": num_syms,
        "e_bound": e_bound,
        "g_rank": g_rank,
        "l_min": l_min,
    }

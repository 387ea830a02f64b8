"""Canonical Huffman code construction (host side).

Builds the shared code table from a byte histogram.  This is the
framework's equivalent of the reference's ``MakeCanonicalCoding`` pipeline
(reference: codec/huffman.cpp:339-437): two-queue O(n) tree build, "MiniZ"
length limiting to :data:`MAX_CODE_LEN`, then canonical code assignment.

Like the reference, table construction stays scalar on the host: it is
O(256 log 256) work per block and never shows up in profiles.  Only the
per-byte encode/decode loops move onto the device.

Determinism note: the reference sorts symbols by frequency with an
*unstable* sort (codec/huffman.cpp:353-354), so its exact compressed bytes
are libstdc++-defined among equal-frequency symbols.  We define the
tie-break explicitly — frequency descending, then symbol value ascending —
so every implementation in this repo produces identical bytes.  Decoders of
either project accept both orders because the header carries the actual
symbol order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import MAX_CODE_LEN, MAX_OPTIMAL_CODE_LEN, NUM_SYMBOLS


def histogram(data: bytes | np.ndarray) -> np.ndarray:
    """Counts of each byte value.  Returns uint32[256].

    Host-side equivalent of the reference's ``MakeHistogram``
    (codec/histogram.cpp:193-201).  The banked-accumulator SIMD variants of
    the reference exist to dodge store-forwarding stalls on x86; on the host
    side NumPy's bincount is already memory-bound, and the on-device
    histogram lives in :mod:`huffman_tpu.ops.histogram`.
    """
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    return np.bincount(arr.ravel(), minlength=NUM_SYMBOLS).astype(np.uint32)


@dataclasses.dataclass
class CanonicalCoding:
    """Code table state (reference: ``struct CanonicalCoding`` huffman.cpp:286-292).

    Attributes:
      code_bits: uint16[256]; the prefix code stored left-aligned within the
        low MAX_CODE_LEN bits — first (most-significant) code bit at bit
        position MAX_CODE_LEN-1.  Zero for unused symbols.
      code_lens: uint8[256]; code length in bits, 0 for unused symbols.
        NOTE: a degenerate single-symbol alphabet legitimately gets length 0.
      sorted_syms: uint8[num_syms]; symbols sorted by (code length asc,
        frequency desc, symbol asc) — the order codes are enumerated in and
        the order the header stores symbols in.
      len_count: uint16[MAX_CODE_LEN+1]; number of codes of each length.
      len_mask: bitmask of lengths present.
      num_syms: number of distinct symbols.
    """

    code_bits: np.ndarray
    code_lens: np.ndarray
    sorted_syms: np.ndarray
    len_count: np.ndarray
    len_mask: int
    num_syms: int
    #: The build's length limit — ALSO the code_bits alignment width
    #: (codes are left-aligned in max_len bits, so consumers re-aligning
    #: to another width must shift by the difference; not inferable from
    #: realized lengths).  12 = ref profile, 15 = tpu profile.
    max_len: int = MAX_CODE_LEN


def _huffman_code_lengths(counts_desc: np.ndarray) -> np.ndarray:
    """Optimal code length per symbol given counts sorted descending.

    Two-queue construction over pre-sorted leaves (reference:
    huffman.cpp:362-417): leaves are consumed from smallest to largest while
    internal nodes, which are created in nondecreasing weight order, form the
    second queue.  On ties the leaf is popped first, matching the reference's
    ``sym_count[sym] <= tree_count[next]`` comparison (huffman.cpp:379).

    Returns the depth of each leaf (uint32, same order as ``counts_desc``).
    Lengths are *unlimited* here; the caller applies `limit_code_lengths`.
    """
    n = len(counts_desc)
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    if n == 1:
        # A single leaf is the root: depth 0 (a zero-bit code).  The
        # reference produces the same (CollectCodeLen(root=-1, len=0)).
        return np.zeros(1, dtype=np.uint32)

    counts = counts_desc.astype(np.int64)
    next_sym = n - 1  # leaves popped from the small end
    tree_count = np.zeros(n, dtype=np.int64)
    children = np.full((n, 2), -1, dtype=np.int64)
    next_tree = 0
    tree_size = 0

    def pop_min():
        nonlocal next_sym, next_tree
        pop_leaf = False
        if next_sym >= 0:
            if next_tree == tree_size:
                pop_leaf = True
            else:
                pop_leaf = counts[next_sym] <= tree_count[next_tree]
        if pop_leaf:
            node = -1
            w = counts[next_sym]
            next_sym -= 1
        else:
            node = next_tree
            w = tree_count[node]
            next_tree += 1
        return w, node

    def heap_size():
        return (tree_size - next_tree) + (next_sym + 1)

    while heap_size() > 1:
        wa, na = pop_min()
        wb, nb = pop_min()
        children[tree_size, 0] = na
        children[tree_size, 1] = nb
        tree_count[tree_size] = wa + wb
        tree_size += 1

    _, root = pop_min()

    # Iterative depth collection (the reference recurses, huffman.cpp:329-337).
    # We only need len_count, but per-leaf depths are handy for tests; since
    # canonical coding only uses len_count + sort order, collect counts.
    len_count = np.zeros(MAX_OPTIMAL_CODE_LEN + 1, dtype=np.int64)
    stack = [(root, 0)]
    while stack:
        node, depth = stack.pop()
        if node < 0:
            len_count[depth] += 1
        else:
            stack.append((children[node, 0], depth + 1))
            stack.append((children[node, 1], depth + 1))

    # Convert counts back to per-leaf lengths: in a Huffman tree built over
    # descending-frequency leaves, less frequent symbols never get shorter
    # codes, so lengths ascend as frequency descends.
    lens = np.repeat(
        np.arange(MAX_OPTIMAL_CODE_LEN + 1, dtype=np.uint32), len_count
    )
    assert len(lens) == n
    return lens


def limit_code_lengths(
    len_count: np.ndarray, max_len: int = MAX_CODE_LEN
) -> np.ndarray:
    """Cap code lengths at ``max_len``, repairing the Kraft sum.

    The "MiniZ" method (reference: huffman.cpp:294-327): fold all
    over-length counts into the max_len bucket, then while the Kraft
    sum exceeds 1, remove one max-length code and split one shorter code
    into two codes one bit longer.

    The repair demotes the DEEPEST available shorter code, which is far
    from cost-optimal when many codes fold (each unit of Kraft excess
    cascades another demotion).  Feed `clamp_hist`-ed counts to keep the
    repair from running at all — the clamped tree is then the
    package-merge optimum on every corpus we measured (RESULTS.md).
    """
    lc = len_count.astype(np.int64).copy()
    lc[max_len] += lc[max_len + 1 :].sum()
    lc[max_len + 1 :] = 0
    one = 1 << max_len
    kraft = int((lc[: max_len + 1] << (max_len - np.arange(max_len + 1))).sum())
    while kraft > one:
        lc[max_len] -= 1
        for j in range(max_len - 1, -1, -1):
            if lc[j] > 0:
                lc[j] -= 1
                lc[j + 1] += 2
                break
        kraft -= 1
    assert kraft == one or lc.sum() == 0
    return lc[: max_len + 1].astype(np.uint16)


def clamp_hist(hist: np.ndarray, max_len: int) -> np.ndarray:
    """Raise every nonzero count to at least ``total >> max_len``.

    A symbol with probability below 2^-max_len must sit at depth max_len
    in any length-limited code anyway, so pre-clamping its count to that
    floor loses nothing — and the unlimited Huffman tree over clamped
    counts lands (near-)within max_len on its own, so `limit_code_lengths`
    has (almost) nothing to repair.  Measured on the benchmark corpora the
    result matches the package-merge optimum exactly (repair iterations
    drop ~200 -> 0); without the clamp the MiniZ repair's cascading
    demotions cost up to 5% compressed size on full-alphabet (smoothed
    sampled-histogram) inputs.  The threshold uses the PRE-clamp total,
    keeping the transform a pure elementwise function of (hist, total).
    """
    h = np.asarray(hist, dtype=np.int64)
    floor = max(1, int(h.sum()) >> max_len)
    return np.where(h > 0, np.maximum(h, floor), 0)


def assign_canonical_codes(
    len_count: np.ndarray, sorted_syms: np.ndarray, max_len: int = MAX_CODE_LEN
):
    """Enumerate canonical codes (reference: ``ForallCodes`` huffman.cpp:260-284).

    Codes are assigned in `sorted_syms` order grouped by ascending length:
    ``code += 1 << (max_len - len)`` after each symbol.  The code value
    is stored left-aligned in a max_len-bit field.

    Returns (code_bits uint16[256], code_lens uint8[256]).
    """
    code_bits = np.zeros(NUM_SYMBOLS, dtype=np.uint16)
    code_lens = np.zeros(NUM_SYMBOLS, dtype=np.uint8)
    current = 0
    i = 0
    for ln in range(max_len + 1):
        inc = 1 << (max_len - ln)
        for _ in range(int(len_count[ln])):
            s = int(sorted_syms[i])
            code_bits[s] = current
            code_lens[s] = ln
            current += inc
            i += 1
    if i:
        assert current == (1 << max_len), (current, len_count)
    return code_bits, code_lens


def make_canonical_coding(
    hist: np.ndarray, max_len: int = MAX_CODE_LEN, clamp: bool = False
) -> CanonicalCoding:
    """Histogram -> canonical coding (reference: huffman.cpp:339-437).

    Defaults reproduce the reference byte-for-byte (``ref`` profile).  The
    TPU profile passes ``max_len=TPU_MAX_CODE_LEN, clamp=True`` for the
    deeper, repair-free construction (see `clamp_hist`).
    """
    hist = np.asarray(hist, dtype=np.uint64)
    if clamp:
        hist = clamp_hist(hist, max_len).astype(np.uint64)
    present = np.nonzero(hist)[0]
    num_syms = len(present)
    if num_syms == 0:
        return CanonicalCoding(
            code_bits=np.zeros(NUM_SYMBOLS, dtype=np.uint16),
            code_lens=np.zeros(NUM_SYMBOLS, dtype=np.uint8),
            sorted_syms=np.zeros(0, dtype=np.uint8),
            len_count=np.zeros(max_len + 1, dtype=np.uint16),
            len_mask=0,
            num_syms=0,
            max_len=max_len,
        )

    # Deterministic order: frequency descending, symbol ascending on ties.
    order = np.lexsort((present, -hist[present].astype(np.int64)))
    syms_by_freq = present[order].astype(np.uint8)
    counts_desc = hist[present][order]

    lens_by_freq = _huffman_code_lengths(counts_desc)
    len_count_raw = np.bincount(lens_by_freq, minlength=MAX_OPTIMAL_CODE_LEN + 1)
    len_count = limit_code_lengths(len_count_raw, max_len)

    # After limiting, re-derive per-symbol lengths: lengths still ascend in
    # freq-descending order, so symbols keep their rank; only lengths change.
    # sorted_syms grouped by (length asc) preserves within-group freq order,
    # which for an ascending length assignment over freq-sorted symbols is
    # exactly syms_by_freq itself.
    sorted_syms = syms_by_freq
    code_bits, code_lens = assign_canonical_codes(len_count, sorted_syms, max_len)

    len_mask = 0
    for ln in range(max_len + 1):
        if len_count[ln]:
            len_mask |= 1 << ln
    return CanonicalCoding(
        code_bits=code_bits,
        code_lens=code_lens,
        sorted_syms=sorted_syms,
        len_count=len_count,
        len_mask=len_mask,
        num_syms=num_syms,
        max_len=max_len,
    )


def decode_tables_1x(len_count: np.ndarray, sorted_syms: np.ndarray):
    """Flat 2^MAX_CODE_LEN one-symbol decode table.

    Equivalent of the reference's ``Decoder1x`` (huffman.cpp:588-632): entry
    ``t[c]`` for every MAX_CODE_LEN-bit window ``c`` gives (code_len, sym).

    Returns (lens uint8[4096], syms uint8[4096]).
    """
    size = 1 << MAX_CODE_LEN
    t_len = np.zeros(size, dtype=np.uint8)
    t_sym = np.zeros(size, dtype=np.uint8)
    current = 0
    i = 0
    for ln in range(MAX_CODE_LEN + 1):
        inc = 1 << (MAX_CODE_LEN - ln)
        for _ in range(int(len_count[ln])):
            t_len[current : current + inc] = ln
            t_sym[current : current + inc] = sorted_syms[i]
            current += inc
            i += 1
    return t_len, t_sym


def decode_tables_2x(len_count: np.ndarray, sorted_syms: np.ndarray):
    """Two-symbol decode table (reference: ``Decoder2x`` huffman.cpp:634-704).

    For every 12-bit window: decode up to two symbols if both codes fit in
    the window, else one.  Returns (nbits uint8[4096], sym0, sym1,
    nsyms uint8[4096]).
    """
    size = 1 << MAX_CODE_LEN
    t_bits = np.zeros(size, dtype=np.uint8)
    t_s0 = np.zeros(size, dtype=np.uint8)
    t_s1 = np.zeros(size, dtype=np.uint8)
    t_n = np.zeros(size, dtype=np.uint8)

    # Enumerate codes once.
    codes = []  # (sym, bits, len)
    current = 0
    i = 0
    for ln in range(MAX_CODE_LEN + 1):
        inc = 1 << (MAX_CODE_LEN - ln)
        for _ in range(int(len_count[ln])):
            codes.append((int(sorted_syms[i]), current, ln))
            current += inc
            i += 1

    for sym1, bits1, len1 in codes:
        last = bits1
        for sym2, bits2, len2 in codes:
            if len1 + len2 > MAX_CODE_LEN:
                break  # codes enumerate in ascending length
            c = bits1 | (bits2 >> len1)
            inc = 1 << (MAX_CODE_LEN - len1 - len2)
            t_bits[c : c + inc] = len1 + len2
            t_s0[c : c + inc] = sym1
            t_s1[c : c + inc] = sym2
            t_n[c : c + inc] = 2
            last = c + inc
        end1 = bits1 + (1 << (MAX_CODE_LEN - len1))
        if last < end1:
            t_bits[last:end1] = len1
            t_s0[last:end1] = sym1
            t_s1[last:end1] = 0
            t_n[last:end1] = 1
    return t_bits, t_s0, t_s1, t_n

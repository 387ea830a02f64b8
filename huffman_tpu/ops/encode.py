"""Lane-parallel encode kernel (pure XLA, gather-free, scan-free): the
route every non-GPU backend takes (ops/route.py).

K independent streams encode in lockstep.  This is the reference's
stream-major hot loop (codec/huffman.cpp:825-843) re-derived for a vector
machine with thousands of lanes:

* the per-byte code lookup is a nibble-factored one-hot matmul
  (`ops.lookup.lookup256`), dense arithmetic with no gather;
* bit-packing is NOT a serial accumulator loop.  Every output bit position
  is known in advance: a parallel prefix sum of code lengths gives each
  byte's bit offset (the same determinism the reference exploits to
  precompute exact stream sizes, huffman.cpp:770-786 — applied per symbol
  instead of per stream).  Each 16-bit-left-aligned code then splits into
  at most two word-aligned pieces, and pieces land in their target words
  via log2(S) rounds of monotone shift-plus-OR — dense elementwise work,
  no scatters, no ``lax.scan`` (whose per-step overhead dominated the old
  serial version).

Bit semantics match the wire format exactly: codes are appended MSB-first;
emitted 16-bit words hold stream bits in forward order (bit 15 first).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .compaction import compact_lanes, compact_packed
from ..constants import TPU_MAX_CODE_LEN as _L
from .lookup import lookup256

_U32 = jnp.uint32
_I32 = jnp.int32


def _or_place(piece, disp, t_rows):
    """Move piece[r] (uint16 payload in an int32) left by disp[r] rows,
    OR-combining pieces that land on the same row.

    Requires: disp >= 0, nondecreasing with steps in {0, 1} along axis 0.
    Under that invariant the binary-decomposition rounds never merge
    entries bound for different targets (same argument as
    `compaction.compact_packed`; equal targets imply equal remaining
    displacement, so the displacement bits of merged entries coincide and
    OR preserves them).
    """
    T = piece.shape[0]
    packed = (disp << 16) | piece

    shift = 1
    while shift < T:
        pad = jnp.zeros((shift,) + packed.shape[1:], packed.dtype)
        xs = jax.lax.slice_in_dim(
            jnp.concatenate([packed, pad], axis=0), shift, shift + T, axis=0
        )
        arrive = ((xs >> 16) & shift) != 0
        stay = ((packed >> 16) & shift) == 0
        moved = jnp.where(arrive, xs - (shift << 16), 0)
        kept = jnp.where(stay, packed, 0)
        packed = moved | kept
        shift <<= 1
    return jax.lax.slice_in_dim(packed & 0xFFFF, 0, t_rows, axis=0)


def encode_lanes(byte_matrix, valid, enc_table):
    """Encode K lanes in lockstep.

    Args:
      byte_matrix: (S, K) int32 — byte s of each lane's slice (dense,
        transposed layout).
      valid: (S, K) bool — real input bytes (False rows append nothing).
      enc_table: (256,) int32 packed ``code<<4 | len`` (code
        TPU_MAX_CODE_LEN-bit left-aligned; len <= 15 fits the nibble).

    Returns:
      words: (W16, K) int32 (uint16 range) — per-lane stream words, forward
        bit order, MSB-first; rows >= word_counts are zero.
        W16 = ceil(S*_L/16)+1.
      word_counts: (K,) int32.
      bit_counts: (K,) int32 — exact stream bit length per lane (drives
        byte-exact sizing, the huffman.cpp:770-786 trick).
    """
    S, K = byte_matrix.shape
    if S + 1 >= (1 << 14):
        return _encode_lanes_scan(byte_matrix, valid, enc_table)

    entries = jnp.where(valid, lookup256(byte_matrix, enc_table), 0)

    lens = entries & 15
    if K % 2 == 0 and S * _L < 65000:
        # Two lanes per word (per-lane totals <= _L*S < 2^16): the length
        # prefix sum is the costliest dense pass here, so halve its
        # traffic.  Unsigned arithmetic: the high half legitimately
        # reaches bit 31 (totals >= 2^15 when S > 2730), which would
        # corrupt a signed shift.
        half = K // 2
        lp = (lens[:, :half] | (lens[:, half:] << 16)).astype(jnp.uint32)
        pends = jnp.cumsum(lp, axis=0)
        ends = jnp.concatenate(
            [pends & 0xFFFF, pends >> 16], axis=1
        ).astype(jnp.int32)
    else:
        ends = jnp.cumsum(lens, axis=0)  # inclusive
    bit_counts = ends[-1]
    offs = ends - lens

    cv = ((entries >> 4) << (16 - _L)).astype(_I32) & 0xFFFF  # 16-bit left-aligned
    sh = offs & 15
    w0 = offs >> 4

    idx = jax.lax.broadcasted_iota(_I32, (S, K), 0)
    # Max word index is (_L*S-1)//16 < S (needs _L < 16), so t_rows <= S
    # always suffices.
    t_rows = min(S, (S * _L) // 16 + 2)

    # Piece 0: top bits of the code into word w0.
    pieceA = (cv >> sh) & 0xFFFF
    dispA = idx - w0

    # Piece 1: spill into word w0+1, staged one row later so its
    # displacement stays nonnegative with {0,1} steps.
    spill = ((cv << (16 - sh)) & 0xFFFF).astype(_I32)
    spill = jnp.where(sh == 0, 0, spill)
    pieceB = jnp.concatenate([jnp.zeros((1, K), _I32), spill], axis=0)
    wB = jnp.concatenate([jnp.zeros((1, K), _I32), w0 + 1], axis=0)
    idxB = jax.lax.broadcasted_iota(_I32, (S + 1, K), 0)
    dispB = jnp.where(idxB > 0, idxB - wB, 0)

    wordsA = _or_place(pieceA, dispA, t_rows)
    wordsB = _or_place(pieceB, dispB, t_rows)
    words = wordsA | wordsB

    word_counts = (bit_counts + 15) >> 4
    return words, word_counts, bit_counts


def _encode_lanes_scan(byte_matrix, valid, enc_table):
    """Serial-accumulator fallback for very long lane slices (tiny-K parity
    configurations), where the placement displacement would not fit beside
    a 16-bit piece in an int32."""
    S, K = byte_matrix.shape

    entries = jnp.where(valid, lookup256(byte_matrix, enc_table), 0)

    def step(carry, e):
        acc, nbits = carry  # acc: u32 left-aligned bit buffer; nbits: i32
        code = (e >> 4).astype(_U32)  # _L-bit left-aligned code value
        ln = e & 15
        acc = acc | (code << (32 - _L - nbits).astype(_U32))
        nbits = nbits + ln
        emit = nbits >= 16
        word = (acc >> 16).astype(jnp.int32)
        acc = jnp.where(emit, acc << 16, acc)
        nbits = jnp.where(emit, nbits - 16, nbits)
        return (acc, nbits), (word, emit)

    acc0 = jnp.zeros((K,), _U32)
    nb0 = jnp.zeros((K,), jnp.int32)
    (acc, nbits), (words, emits) = jax.lax.scan(step, (acc0, nb0), entries)

    # Tail: flush remaining bits (zero-padded at the low end of the word).
    tail_word = (acc >> 16).astype(jnp.int32)[None]
    tail_emit = (nbits > 0)[None]
    words = jnp.concatenate([words, tail_word], axis=0)
    emits = jnp.concatenate([emits, tail_emit], axis=0)

    bit_counts = jnp.sum(entries & 15, axis=0)

    if S + 1 < (1 << 14):
        compacted, word_counts = compact_packed(words, emits, vbits=17)
    else:
        # Long lane slices (small K): displacement no longer fits next to a
        # 17-bit value in an int32, so use the unpacked multi-array variant.
        compacted, word_counts = compact_lanes(words, emits)
    return compacted, word_counts, bit_counts


def words_to_byte_columns(words):
    """(W, K) u32 forward words -> (4W, K) u8 forward stream bytes."""
    w = words.astype(jnp.uint32)
    parts = [((w >> sh) & 0xFF).astype(jnp.uint8) for sh in (24, 16, 8, 0)]
    return jnp.stack(parts, axis=1).reshape(4 * words.shape[0], words.shape[1])

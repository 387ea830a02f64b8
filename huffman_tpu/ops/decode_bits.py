"""Bit-serial lockstep decode — the gather-free XLA decode kernel, the
route every non-GPU backend takes (ops/route.py).

Design (SURVEY.md §7 "hard parts" — the per-lane gathers that bottleneck
the reference, huffman.cpp:1516-1521 / README.md:129-138, are eliminated
entirely):

* All K lanes advance **exactly one bit per step**, so at step ``t`` every
  lane is at bit ``t`` of *its own* stream.  With the lane-transposed word
  payload, the input for 32 consecutive steps is ONE dense (K,) row — no
  per-lane addressing exists anywhere in the loop.
* Countdown formulation: at every bit position the MAX_CODE_LEN-bit window
  and the code length that *would* start there are computed independently
  of the serial state (pure feed-forward work the compiler can pipeline
  across bits); the only loop-carried value is a per-lane countdown ``c``
  to the next symbol boundary — 3 ops deep per bit.  Code-length detection
  is the canonical-boundary compare ``len = 1 + #{l : window >= E[l]}``
  (the reference's comparison-based AVX Permute decode idea,
  huffman.cpp:1697-1722, reborn as pure vector arithmetic).
* Variable-rate output is staged densely (the lookahead window at the step
  a symbol starts) and compacted per lane with `compact_packed`.
* Symbol resolution happens **after** compaction, once per symbol instead
  of once per bit: code length and rank arithmetically, then
  rank -> byte through a one-hot matmul (`lookup256`).

The minimum code length ``l_min`` (static, from the table) lets groups of
``l_min`` consecutive bit-steps share one staging slot — at most one emit
can occur per group — shrinking the compaction input by that factor.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .compaction import compact_packed
from .lookup import lookup256

# tpu format profile: deeper 15-bit limit (see constants.TPU_MAX_CODE_LEN).
# The staged emit packs {valid flag (bit 15) | window (bits 14..0)} in a
# uint16, so 15 is also the widest window this staging layout can carry.
from ..constants import TPU_MAX_CODE_LEN as MAX_CODE_LEN

_I32 = jnp.int32


def decode_tables_bitserial(len_count, sorted_syms):
    """Host: constant arrays for the bit-serial decoder.

    Returns dict of numpy arrays:
      e_bound: (MAX+2,) int32 — E[l] = sum_{j<=l} len_count[j] << (MAX-j);
        a prefix w (left-aligned) of length l is a code iff w < E[l].
      g_rank: (MAX+1,) int32 — rank = (w >> (MAX-l)) + g_rank[l].
      syms: (256,) int32 — rank -> symbol (padded past num_syms).
      l_min: int — shortest code length (>=1; caller must special-case the
        degenerate single-symbol length-0 coding).
    """
    import numpy as np

    # Accept shorter len_count arrays (the ref profile limits at 12; zero
    # counts above its limit make the boundaries saturate, so the 15-bit
    # window decoder handles 12-limited streams unchanged).
    lc_in = np.asarray(len_count, dtype=np.int64)
    lc = np.zeros(MAX_CODE_LEN + 1, dtype=np.int64)
    lc[: len(lc_in)] = lc_in
    e = np.zeros(MAX_CODE_LEN + 2, dtype=np.int64)
    base = np.zeros(MAX_CODE_LEN + 1, dtype=np.int64)  # codes shorter than l
    acc = 0
    nshorter = 0
    for l in range(MAX_CODE_LEN + 1):
        base[l] = nshorter
        acc += int(lc[l]) << (MAX_CODE_LEN - l)
        e[l] = acc
        nshorter += int(lc[l])
    e[MAX_CODE_LEN + 1] = acc
    # first code of length l, left-aligned, is E[l-1]; rank offset:
    g = np.zeros(MAX_CODE_LEN + 1, dtype=np.int64)
    for l in range(1, MAX_CODE_LEN + 1):
        g[l] = base[l] - (e[l - 1] >> (MAX_CODE_LEN - l))
    syms = np.zeros(256, dtype=np.int32)
    ns = len(sorted_syms)
    syms[:ns] = np.asarray(sorted_syms, dtype=np.int32)
    nonzero = np.nonzero(lc[1:])[0]
    l_min = int(nonzero[0]) + 1 if len(nonzero) else 1
    return {
        "e_bound": e.astype(np.int32),
        "g_rank": g.astype(np.int32),
        "syms": syms,
        "l_min": l_min,
    }


def decode_bitserial(words, e_bound, g_rank, syms, *, group: int, out_len: int):
    """Decode K lanes, one bit per lane per step.

    Args:
      words: (W, K) uint32 — lane-transposed payload, forward bit order,
        MSB-first; bits past each lane's stream must be zero (the encoder
        zero-pads).  Padding bits decode as garbage symbols AFTER the
        lane's real S symbols and fall past ``out_len`` in the stable
        compaction, so no per-bit masking is needed at all.
      e_bound: (MAX_CODE_LEN+2,) int32 constant (`decode_tables_bitserial`).
      g_rank: (MAX_CODE_LEN+1,) int32 constant.
      syms: (256,) int32 constant rank->symbol.
      group: static int in [1, 32]; must be <= l_min of the coding.  Each
        group of ``group`` bit-steps shares one staging slot.
      out_len: static; output rows (>= max symbols per lane).

    Returns:
      out: (out_len, K) uint8 decoded bytes (rows past the lane's symbol
      count are garbage).
    """
    W, K = words.shape
    slots = -(-32 // group)  # staging slots per 32-bit word

    nxt = jnp.concatenate([words[1:], jnp.zeros((1, K), words.dtype)], 0)

    # group <= l_min, so lengths below `group` always satisfy their
    # canonical compare (E[l] = 0 there): fold them into the initial count.
    eb = [e_bound[l] for l in range(group, MAX_CODE_LEN)]

    def step(carry, rows):
        c = carry
        cur, nx = rows
        slot_val = [jnp.zeros((K,), jnp.uint16)] * slots
        for j in range(32):
            if j == 0:
                win = (cur >> (32 - MAX_CODE_LEN)).astype(_I32)
            else:
                win = (((cur << j) | (nx >> (32 - j))) >> (32 - MAX_CODE_LEN)).astype(_I32)
            # Length of the code starting at this bit: canonical-boundary
            # compares — feed-forward, off the serial path.
            ln = jnp.full((K,), group, _I32)
            for e in eb:
                ln = ln + (win >= e).astype(_I32)
            boundary = c == 0
            s = j // group
            slot_val[s] = jnp.where(
                boundary, (win | 0x8000).astype(jnp.uint16), slot_val[s]
            )
            c = jnp.where(boundary, ln - 1, c - 1)
        return c, jnp.stack(slot_val)

    # Derive the zero carry from the payload (not a literal) so its vma
    # type matches the body's output under shard_map's check_vma.
    init = (words[0] & 0).astype(_I32)
    _, staged = jax.lax.scan(step, init, (words, nxt))  # (W, slots, K)
    staged = staged.reshape(W * slots, K)

    valid = (staged & 0x8000) != 0
    wvals = (staged & ((1 << MAX_CODE_LEN) - 1)).astype(_I32)
    # Every lane emits >= out_len - 1 symbols, bounding displacements.
    codes, _counts = compact_packed(
        wvals, valid, vbits=MAX_CODE_LEN + 1, out_len=out_len,
        max_disp=max(W * slots - out_len + 1, 1),
    )

    # Post-pass, per symbol: length, rank, byte.
    lw = 1 + jnp.sum(
        codes[..., None] >= e_bound[1:MAX_CODE_LEN][None, None, :], axis=-1
    )
    g = jnp.sum(
        jnp.where(
            lw[..., None] == jnp.arange(1, MAX_CODE_LEN + 1)[None, None, :],
            g_rank[1:][None, None, :],
            0,
        ),
        axis=-1,
    )
    rank = (codes >> (MAX_CODE_LEN - lw)) + g
    # For a normal coding every row < out_len is a real symbol and rank is
    # in range.  The degenerate single-symbol coding (zero-length codes)
    # produces rank -1 both for its zero-window emits and for empty rows;
    # clamping to 0 yields the most-frequent == only symbol, so one jitted
    # pipeline handles degenerate blocks with no branch.
    rank = jnp.clip(rank, 0, 255)
    return lookup256(rank, syms).astype(jnp.uint8)

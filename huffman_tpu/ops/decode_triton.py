"""Per-lane decode kernel for NVIDIA GPUs (Pallas through Triton).

One GPU thread owns one lane and walks its ``out_len`` output rows in an
in-kernel loop.  Each step takes the 15-bit window at the lane's bit
position from the lane's buffered u32 words, finds the code length with the
canonical compare against ``e_bound`` (``len = 1 + #{l : window >=
E[l]}``, the same arithmetic as :mod:`huffman_tpu.ops.decode_bits`),
turns the code into its rank and the rank into a byte through the
256-entry ``syms`` table, and stores the byte in row ``r``.  Under the
strided lane map row ``r`` of a block of lanes is one contiguous store.

Words are read from the lane's column of the ``(W, K)`` payload, so
neighbouring lanes read neighbouring addresses; a lane loads a new word
only when its bit position crosses a word boundary.  Reads past row W
return zero, so lanes that run past their real symbols (the ref
profile's one-shorter lanes) decode harmless garbage that the caller
drops, as in the XLA path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .pallas_util import sds_like
from ..constants import TPU_MAX_CODE_LEN as MAX_CODE_LEN

#: Lanes per program: one per thread, four warps.
LANES = 128


def _kernel(words_ref, eb_ref, gr_ref, syms_ref, out_ref, *, k, w, out_len):
    lanes = pl.program_id(0) * LANES + jnp.arange(LANES, dtype=jnp.int32)
    live = lanes < k
    u32 = jnp.uint32
    bounds = [plgpu.load(eb_ref.at[l]) for l in range(1, MAX_CODE_LEN)]

    def word(i, pred, other):
        return plgpu.load(
            words_ref.at[i, lanes], mask=pred & live & (i < w), other=other
        )

    def step(r, carry):
        # cur and nxt hold the window; ahead is the word after them, loaded
        # one crossing early so the load's latency is off the serial path.
        cur, nxt, ahead, pos, wi = carry
        p = pos.astype(u32)
        # (nxt >> 1) >> (31 - p) == nxt >> (32 - p), defined at p == 0.
        win = (((cur << p) | ((nxt >> 1) >> (31 - p))) >> (32 - MAX_CODE_LEN))
        win = win.astype(jnp.int32)
        ln = jnp.ones((LANES,), jnp.int32)
        for e in bounds:
            ln = ln + (win >= e).astype(jnp.int32)
        rank = (win >> (MAX_CODE_LEN - ln)) + plgpu.load(gr_ref.at[ln])
        sym = plgpu.load(syms_ref.at[jnp.clip(rank, 0, 255)])
        plgpu.store(out_ref.at[r, lanes], sym.astype(jnp.uint8), mask=live)
        pos = pos + ln
        cross = pos >= 32
        pos = jnp.where(cross, pos - 32, pos)
        wi = wi + cross.astype(jnp.int32)
        cur = jnp.where(cross, nxt, cur)
        nxt = jnp.where(cross, ahead, nxt)
        # Words past row W read as zero, as in the XLA decoder.
        ahead = word(wi + 2, cross, jnp.where(cross, jnp.uint32(0), ahead))
        return cur, nxt, ahead, pos, wi

    zero = jnp.zeros((LANES,), jnp.int32)
    none = jnp.zeros((LANES,), u32)
    init = (
        word(zero, True, none), word(zero + 1, True, none),
        word(zero + 2, True, none), zero, zero,
    )
    jax.lax.fori_loop(0, out_len, step, init)


@functools.partial(jax.jit, static_argnames=("out_len", "interpret"))
def decode_rows_triton(words, e_bound, g_rank, syms, *, out_len: int,
                       interpret: bool = False):
    """Decode ``out_len`` symbols from each of K lanes.

    Args:
      words: (W, K) uint32 lane-transposed payload, forward bit order,
        MSB-first.
      e_bound: (MAX_CODE_LEN+2,) int32 canonical boundaries.
      g_rank: (MAX_CODE_LEN+1,) int32 rank offsets.
      syms: (256,) int32 rank -> symbol.
      out_len: static symbols per lane.
      interpret: run the kernel in the Pallas interpreter (CPU tests).

    Returns:
      (out_len, K) uint8 decoded bytes, row r = symbol r of every lane.
    """
    w, k = words.shape
    kernel = functools.partial(_kernel, k=k, w=w, out_len=out_len)
    return pl.pallas_call(
        kernel,
        out_shape=sds_like((out_len, k), jnp.uint8, words, e_bound, g_rank, syms),
        grid=(pl.cdiv(k, LANES),),
        compiler_params=plgpu.CompilerParams(num_warps=LANES // 32, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="huffman_decode",
    )(
        words.astype(jnp.uint32),
        e_bound.astype(jnp.int32),
        g_rank.astype(jnp.int32),
        syms.astype(jnp.int32),
    )

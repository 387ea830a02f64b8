"""Per-lane encode kernel for NVIDIA GPUs (Pallas through Triton).

One GPU thread owns one lane.  It walks its S input rows in order, looks
each byte's code up in the 256-entry ``enc_table`` (a gather the GPU
serves from L1), appends the code to a 32-bit bit buffer and writes each
full u32 word straight into the wire layout: row ``w`` of the
``(W, K)`` word matrix holds stream bits ``[32w, 32w+32)`` of every lane,
MSB-first.  Rows past a lane's last word are zero, so the words and the
exact per-lane ``bit_counts`` are bit-identical to the XLA path
(:func:`huffman_tpu.ops.encode.encode_lanes` + u16->u32 packing).

Row ``r`` of the byte matrix is contiguous across lanes, so the byte
loads of a block of lanes coalesce; the word stores scatter by at most a
few rows, because every lane of the strided lane map carries about the
same number of bits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .pallas_util import sds_like
from ..constants import TPU_MAX_CODE_LEN as _L

#: Lanes per program: one per thread, four warps.
LANES = 128
#: Input rows handled per loop step.  The next step's byte loads are
#: issued before this step's codes are appended, so their latency overlaps
#: the serial bit-buffer work.
_ROWS = 8


def _kernel(bytes_ref, counts_ref, tab_ref, words_ref, bits_ref, *, k, s, w32):
    lanes = pl.program_id(0) * LANES + jnp.arange(LANES, dtype=jnp.int32)
    live = lanes < k
    count = plgpu.load(counts_ref.at[lanes], mask=live, other=0)
    u32 = jnp.uint32

    def load_rows(c):
        rows = [c * _ROWS + j for j in range(_ROWS)]
        return tuple(
            plgpu.load(bytes_ref.at[r, lanes], mask=live & (r < count), other=0)
            for r in rows
        )

    def chunk(c, carry):
        acc, nb, wi, total, byte = carry
        ahead = load_rows(c + 1)
        ent = [plgpu.load(tab_ref.at[b.astype(jnp.int32)]) for b in byte]
        for j, e in enumerate(ent):
            e = jnp.where(c * _ROWS + j < count, e, 0)
            ln = e & 15
            code = ((e >> 4) << (32 - _L)).astype(u32)  # left-aligned
            acc = acc | (code >> nb.astype(u32))
            nb = nb + ln
            full = nb >= 32
            plgpu.store(words_ref.at[wi, lanes], acc, mask=full & live)
            # The code's bits that did not fit: code << (32 - old nb), with
            # old nb >= 32 - _L here, written as two shifts below 32.
            rest = (code << 1) << (31 - (nb - ln)).astype(u32)
            acc = jnp.where(full, rest, acc)
            wi = wi + full.astype(jnp.int32)
            nb = jnp.where(full, nb - 32, nb)
            total = total + ln
        return acc, nb, wi, total, ahead

    zero = jnp.zeros((LANES,), jnp.int32)
    init = (jnp.zeros((LANES,), u32), zero, zero, zero, load_rows(0))
    acc, nb, wi, total, _ = jax.lax.fori_loop(0, pl.cdiv(s, _ROWS), chunk, init)
    plgpu.store(words_ref.at[wi, lanes], acc, mask=live & (nb > 0))
    end = wi + (nb > 0).astype(jnp.int32)

    def clear(j, carry):
        plgpu.store(
            words_ref.at[j, lanes], jnp.zeros((LANES,), u32), mask=live & (j >= end)
        )
        return carry

    jax.lax.fori_loop(0, w32, clear, None)
    plgpu.store(bits_ref.at[lanes], total, mask=live)


@functools.partial(jax.jit, static_argnames=("w32", "interpret"))
def encode_words_triton(byte_matrix, counts, enc_table, *, w32: int,
                        interpret: bool = False):
    """Encode K lanes into the u32 wire layout.

    Args:
      byte_matrix: (S, K) uint8 — row r holds byte r of every lane.
      counts: (K,) int32 — real rows per lane; rows at or past a lane's
        count append nothing.
      enc_table: (256,) int32 packed ``code<<4 | len`` (code left-aligned
        in TPU_MAX_CODE_LEN bits).
      w32: static output rows; at least ceil(max lane bits / 32).
      interpret: run the kernel in the Pallas interpreter (CPU tests).

    Returns:
      words: (w32, K) uint32, forward bit order, zero past each lane's
        stream.
      bit_counts: (K,) int32 exact stream bits per lane.
    """
    s, k = byte_matrix.shape
    kernel = functools.partial(_kernel, k=k, s=s, w32=w32)
    return pl.pallas_call(
        kernel,
        out_shape=(
            sds_like((w32, k), jnp.uint32, byte_matrix, counts, enc_table),
            sds_like((k,), jnp.int32, byte_matrix, counts, enc_table),
        ),
        grid=(pl.cdiv(k, LANES),),
        compiler_params=plgpu.CompilerParams(num_warps=LANES // 32, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="huffman_encode",
    )(byte_matrix, counts.astype(jnp.int32), enc_table.astype(jnp.int32))

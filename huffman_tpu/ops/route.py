"""The one rule that picks the codec's device kernels.

On a GPU backend the codec runs its Pallas-Triton kernels
(:mod:`~huffman_tpu.ops.encode_triton`, :mod:`~huffman_tpu.ops.decode_triton`);
on every other backend it runs the plain XLA kernels
(:mod:`~huffman_tpu.ops.encode`, :mod:`~huffman_tpu.ops.decode_bits`).
Both produce bit-identical words, bit counts and decoded bytes, for every
lane count K and rows per lane S.

There is no fallback between the two: a kernel never hands its work to
the XLA path, and it runs in the Pallas interpreter only when a caller
passes ``interpret=True`` (the CPU tests do).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .decode_bits import decode_bitserial
from .decode_triton import decode_rows_triton
from .decode_words import pack_u16_words_to_u32
from .encode import encode_lanes
from .encode_triton import encode_words_triton


def gpu_kernels() -> bool:
    """True when the codec should run its GPU kernels: JAX's default
    backend is a GPU.  Read when a codec program is traced."""
    return jax.default_backend() == "gpu"


def encode_words(byte_matrix, enc_table, w32: int, *, kernels: bool,
                 counts=None, interpret: bool = False):
    """Encode K lanes in lockstep into the u32 wire layout.

    Args:
      byte_matrix: (S, K) uint8 — row r holds byte r of every lane.
      enc_table: (256,) int32 packed ``code<<4 | len``.
      w32: static output rows (>= ceil(max lane bits / 32)).
      kernels: run the GPU kernel (see :func:`gpu_kernels`).
      counts: optional (K,) int32 real rows per lane (default: all S);
        rows at or past a lane's count append nothing.
      interpret: run the GPU kernel in the Pallas interpreter.

    Returns:
      words: (w32, K) uint32, zero past each lane's stream.
      bit_counts: (K,) int32.
    """
    s, k = byte_matrix.shape
    if kernels:
        if counts is None:
            counts = jnp.full((k,), s, jnp.int32)
        return encode_words_triton(
            byte_matrix, counts, enc_table, w32=w32, interpret=interpret
        )
    if counts is None:
        valid = jnp.ones((s, k), bool)
    else:
        valid = jnp.arange(s, dtype=jnp.int32)[:, None] < counts[None, :]
    words16, word_counts, bit_counts = encode_lanes(
        byte_matrix.astype(jnp.int32), valid, enc_table
    )
    rows = words16.shape[0]
    if rows < 2 * w32:
        words16 = jnp.concatenate(
            [words16, jnp.zeros((2 * w32 - rows, k), words16.dtype)], axis=0
        )
    else:
        words16 = jax.lax.slice_in_dim(words16, 0, 2 * w32, axis=0)
    words32 = pack_u16_words_to_u32(words16, jnp.minimum(word_counts, 2 * w32))
    return words32, bit_counts


def decode_rows(words, e_bound, g_rank, syms, *, out_len: int, group: int,
                kernels: bool, interpret: bool = False):
    """Decode ``out_len`` symbols from each of K lanes.

    Args:
      words: (W, K) uint32 lane-transposed payload, W >= 1.
      e_bound, g_rank, syms: decode constants (`decode_tables_bitserial`
        or the device table build).
      out_len: static symbols per lane.
      group: static staging group of the XLA decoder (<= l_min); the GPU
        kernel decodes one symbol per step and ignores it.
      kernels: run the GPU kernel (see :func:`gpu_kernels`).
      interpret: run the GPU kernel in the Pallas interpreter.

    Returns:
      (out_len, K) uint8.
    """
    if kernels:
        return decode_rows_triton(
            words, e_bound, g_rank, syms, out_len=out_len, interpret=interpret
        )
    return decode_bitserial(
        words, e_bound, g_rank, syms, group=group, out_len=out_len
    )

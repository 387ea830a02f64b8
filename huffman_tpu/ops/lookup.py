"""Table lookups and histograms as nibble-factored one-hot matmuls.

These are the XLA route's primitives (ops/encode.py, ops/decode_bits.py
and the table build).  They contain no gather or scatter, so every table
access is dense arithmetic:

A 256-entry lookup ``T[b]`` factors over nibbles ``b = 16*h + l``:

    M = onehot16(l) @ T2^T          (T2 = T.reshape(16, 16))
    T[b] = sum_h onehot16(h) * M

Histograms use the same factorization run in reverse:
``hist.reshape(16,16) = onehot16(hi)^T @ onehot16(lo)`` — one
(16,N)@(N,16) matmul.  This is the counterpart of the reference's
banked-accumulator histograms (codec/histogram.cpp:14-92): both avoid a
serialized read-modify-write on one counter.

Exactness on every backend: the matmul operands are integers the
operand type holds exactly, and the sums stay below 2**24, so the float
accumulation is exact (see each function).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _onehot16(x, dtype):
    # (..., 16) one-hot of values in [0, 16)
    iota = jax.lax.broadcasted_iota(jnp.int32, x.shape + (16,), x.ndim)
    return (x[..., None] == iota).astype(dtype)


def lookup256(indices, table):
    """Gather-free ``table[indices]`` for a 256-entry int table.

    The table is split into three bytes so every matmul input is an
    integer <= 255 — exact in bf16 (8 explicit mantissa bits) — and one
    bf16 matmul with f32 accumulation (each output sums a single nonzero
    term) yields each byte exactly, with no high-precision matmul mode.
    Three bytes (not two) because the tpu-profile enc_table entries are
    ``code<<4 | len`` with 15-bit codes — 19 bits; the f32 recombination
    is exact to 2**24.

    Args:
      indices: (...,) int32 in [0, 256) byte values.
      table: (256,) int array with values in [0, 2**24).

    Returns:
      (...,) int32.
    """
    t32 = table.astype(jnp.int32)
    th2 = ((t32 >> 16) & 0xFF).reshape(16, 16)  # [h, l]
    thi = ((t32 >> 8) & 0xFF).reshape(16, 16)
    tlo = (t32 & 0xFF).reshape(16, 16)
    # B: (16 l-values, 48): columns 0..15 = byte 2 of entry [h][l] per h,
    # 16..31 = byte 1, 32..47 = byte 0.
    b_mat = jnp.concatenate([th2.T, thi.T, tlo.T], axis=1).astype(jnp.bfloat16)
    lo = _onehot16(indices & 15, jnp.bfloat16)
    hi = _onehot16(indices >> 4, jnp.float32)
    m = jax.lax.dot_general(
        lo,
        b_mat,
        (((lo.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (..., 48)
    vals = (
        m[..., :16] * 65536.0 + m[..., 16:32] * 256.0 + m[..., 32:]
    )  # exact: < 2**24 in f32
    out = jnp.sum(hi * vals, axis=-1)
    return out.astype(jnp.int32)


def histogram256(data_u8):
    """Gather/scatter-free byte histogram.

    Args:
      data_u8: (...,) uint8/int32 byte values.

    Returns:
      (256,) int32 counts.
    """
    x = data_u8.reshape(-1).astype(jnp.int32)
    n = x.shape[0]
    # Chunk so f32 accumulation stays exact (integer sums < 2**24) on inputs
    # of any size.  The f32 one-hot operands are 0/1, which a GPU's TF32
    # matmul mode also holds exactly, so the counts equal a bincount.
    # Adaptive: small inputs use one right-sized chunk instead of padding to
    # the maximum (padding IS counted work for the one-hot matmul).
    chunk = min(1 << 22, max(512, -(-n // 512) * 512))
    pad = (-n) % chunk if n else chunk  # at least one chunk seeds the sum
    if pad:
        # Pad with value 256 -> one-hot rows of all zeros (never counted).
        x = jnp.concatenate([x, jnp.full((pad,), 256, jnp.int32)])
    xc = x.reshape(-1, chunk)

    def one(acc, xi):
        hi = _onehot16(xi >> 4, jnp.float32)  # (chunk, 16)
        lo = _onehot16(xi & 15, jnp.float32)
        h2 = jax.lax.dot_general(
            hi, lo, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
        )  # (16, 16)
        return acc + jnp.round(h2).astype(jnp.int32), None

    # The first chunk seeds the carry, so the carry varies over the same
    # mesh axes as the data under shard_map's vma check.
    acc, _ = one(jnp.zeros((16, 16), jnp.int32), xc[0])
    if xc.shape[0] > 1:
        acc, _ = jax.lax.scan(one, acc, xc[1:])
    return acc.reshape(256)

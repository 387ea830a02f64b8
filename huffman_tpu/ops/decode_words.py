"""Word-payload framing helpers for the ``tpu`` profile.

The ``tpu`` profile stores each lane's bitstream as big-endian-bit u32
words in a dense (W, K) matrix — word ``w`` of every lane sits in one
row, so the XLA lockstep decoder (ops/decode_bits.py) reads whole rows
and never addresses per-lane, and the GPU decoder (ops/decode_triton.py)
reads neighbouring lanes' words from neighbouring addresses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_U32 = jnp.uint32


def pack_u16_words_to_u32(words16, word16_counts):
    """(W16, K) u16 compacted words -> (ceil(W16/2), K) u32 rows.

    Lane word j16 becomes the (j16//2)-th u32's high (even j16) or low half;
    missing halves are zero.  word16_counts masks garbage rows first.
    """
    W16, K = words16.shape
    rows = jnp.arange(W16, dtype=jnp.int32)[:, None]
    w = jnp.where(rows < word16_counts[None, :], words16, 0).astype(_U32)
    if W16 % 2:
        w = jnp.concatenate([w, jnp.zeros((1, K), _U32)], axis=0)
    w = w.reshape(-1, 2, K)
    return (w[:, 0, :] << 16) | w[:, 1, :]

"""Shared set-up for the kernel tests: a corpus case framed as K lanes.

The byte matrix uses the tpu profile's strided lane map (byte i -> lane
i % K, row i // K), zero-padded to whole rows.
"""

import numpy as np
import jax.numpy as jnp

from huffman_tpu import coding
from huffman_tpu.constants import MAX_CODE_LEN as REF_MAX_CODE_LEN
from huffman_tpu.constants import TPU_MAX_CODE_LEN
from huffman_tpu.ops import tables
from huffman_tpu.ops.decode_bits import decode_tables_bitserial

#: K = one lane, a non-multiple of the 128-lane kernel block, several blocks.
KS = (8, 200, 384)


def frame(raw: bytes, k: int, profile: str):
    """(data, byte_matrix, coding, enc_table, decode tables, w32) for ``raw``
    in K lanes, with the ``ref`` (12-bit) or ``tpu`` (15-bit, clamped)
    code build."""
    data = np.frombuffer(raw, dtype=np.uint8)
    s = max(1, -(-len(data) // k))
    padded = np.zeros(s * k, np.uint8)
    padded[: len(data)] = data
    hist = np.bincount(padded, minlength=256).astype(np.uint64)
    if profile == "tpu":
        cc = coding.make_canonical_coding(hist, TPU_MAX_CODE_LEN, clamp=True)
    else:
        cc = coding.make_canonical_coding(hist, REF_MAX_CODE_LEN)
    enc = jnp.asarray(tables.pack_encode_table(cc).astype(np.int32))
    t = decode_tables_bitserial(cc.len_count, cc.sorted_syms)
    w32 = (s * TPU_MAX_CODE_LEN + 31) // 32 + 1
    return padded, jnp.asarray(padded.reshape(s, k)), cc, enc, t, w32


def lane_bits(padded: np.ndarray, k: int, cc) -> list:
    """Each lane's forward bit string (MSB-first codes), from the host
    coding alone (code_bits are left-aligned in ``cc.max_len`` bits)."""
    out = []
    for lane in range(k):
        syms = padded[lane::k]
        bits = [
            (int(cc.code_bits[b]) >> (cc.max_len - 1 - i)) & 1
            for b in syms
            for i in range(int(cc.code_lens[b]))
        ]
        out.append(np.asarray(bits, np.uint8))
    return out


def words_to_bits(words: np.ndarray, lane: int, nbits: int) -> np.ndarray:
    """The first ``nbits`` stream bits of ``lane`` from (W, K) u32 words."""
    col = words[:, lane].astype(">u4").view(np.uint8)
    return np.unpackbits(col)[:nbits]

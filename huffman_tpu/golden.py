"""Golden scalar K-stream codec (NumPy, host side).

This is the framework's *oracle*: a clear, direct implementation of the
``ref`` format profile whose behavior every accelerated path (JAX, Triton,
native C++) is tested against — the same role the scalar
``CompressMulti``/``DecompressMulti`` play for the reference's AVX paths
(reference: codec/huffman.cpp:738-846, 892-960; cross-check idea:
codec/huffman_test.cpp:15-32 ``AvxCheckCompressor``).

Not a performance path.  Encode is NumPy-vectorized; decode is a small
per-symbol loop over the flat decode tables.
"""

from __future__ import annotations

import numpy as np

from . import coding, format as fmt
from .constants import MAX_CODE_LEN, STREAM_SLOP


def _encode_stream(data: np.ndarray, code_bits: np.ndarray, code_lens: np.ndarray) -> np.ndarray:
    """Encode one slice into its backward-bitstream region bytes.

    Returns uint8[region_size] with the stream occupying the top bytes
    (slop bytes at the front are zero).
    """
    lens = code_lens[data].astype(np.int64)
    total_bits = int(lens.sum())
    region_size = (total_bits + 7) // 8 + STREAM_SLOP
    region = np.zeros(region_size, dtype=np.uint8)
    if total_bits == 0:
        return region
    # Expand codes to a forward bit sequence, MSB of each code first.
    starts = np.cumsum(lens) - lens
    src = np.repeat(np.arange(len(data)), lens)
    within = np.arange(total_bits, dtype=np.int64) - np.repeat(starts, lens)
    codes = code_bits[data].astype(np.uint32)
    bitvals = (codes[src] >> (MAX_CODE_LEN - 1 - within)) & 1
    packed = np.packbits(bitvals.astype(np.uint8))  # forward bytes, MSB-first
    # Backward layout: stream byte i lives at region_end - 1 - i.
    region[region_size - len(packed) :] = packed[::-1]
    return region


def _decode_stream(
    region: np.ndarray,
    n_out: int,
    t2_bits: np.ndarray,
    t2_s0: np.ndarray,
    t2_s1: np.ndarray,
    t2_n: np.ndarray,
    t1_len: np.ndarray,
    t1_sym: np.ndarray,
) -> np.ndarray:
    """Decode ``n_out`` symbols from one backward-bitstream region."""
    out = np.zeros(n_out, dtype=np.uint8)
    if n_out == 0:
        return out
    # Forward bit order = bytes from region end backward, MSB-first; pad with
    # zeros so 12-bit peeks never index out of range (the reference simulates
    # zero bytes past the region begin, huffman.cpp:536-556).
    fwd = np.concatenate([region[::-1], np.zeros(8, dtype=np.uint8)])
    bits = np.unpackbits(fwd)
    pos = 0
    i = 0
    # Two-symbol decode while at least 2 outputs remain, then one-symbol —
    # the 1x table is immune to trailing garbage bits in the peek window.
    while i + 2 <= n_out:
        w = bits[pos : pos + MAX_CODE_LEN]
        code = int(w.dot(1 << np.arange(MAX_CODE_LEN - 1, -1, -1)))
        out[i] = t2_s0[code]
        out[i + 1] = t2_s1[code]
        i += int(t2_n[code])
        pos += int(t2_bits[code])
    while i < n_out:
        w = bits[pos : pos + MAX_CODE_LEN]
        code = int(w.dot(1 << np.arange(MAX_CODE_LEN - 1, -1, -1)))
        out[i] = t1_sym[code]
        i += 1
        pos += int(t1_len[code])
    return out


def compress(raw: bytes, k: int) -> bytes:
    """Compress ``raw`` into the K-stream ``ref``-profile format."""
    data = np.frombuffer(raw, dtype=np.uint8)
    n = len(data)
    sizes = fmt.slice_sizes(n, k)
    bounds = np.concatenate([[0], np.cumsum(sizes)])

    part_hists = [coding.histogram(data[bounds[i] : bounds[i + 1]]) for i in range(k)]
    total_hist = np.sum(part_hists, axis=0, dtype=np.uint64)
    cc = coding.make_canonical_coding(total_hist)

    lens64 = cc.code_lens.astype(np.int64)
    per_stream_bits = np.array([int((h.astype(np.int64) * lens64).sum()) for h in part_hists])
    region_sizes = fmt.stream_region_sizes(per_stream_bits)
    end_offsets = np.cumsum(region_sizes)

    header = fmt.write_header(n, cc.len_count, cc.len_mask, cc.sorted_syms, end_offsets)
    regions = [
        _encode_stream(data[bounds[i] : bounds[i + 1]], cc.code_bits, cc.code_lens)
        for i in range(k)
    ]
    return header + b"".join(r.tobytes() for r in regions)


def decompress(compressed: bytes, k: int) -> bytes:
    """Decompress a K-stream ``ref``-profile blob."""
    h = fmt.parse_header(compressed, k)
    t2 = coding.decode_tables_2x(h.len_count, h.sorted_syms)
    t1 = coding.decode_tables_1x(h.len_count, h.sorted_syms)
    sizes = fmt.slice_sizes(h.raw_size, k)
    payload = np.frombuffer(h.payload, dtype=np.uint8)
    out = np.zeros(h.raw_size, dtype=np.uint8)
    obounds = np.concatenate([[0], np.cumsum(sizes)])
    start = 0
    for i in range(k):
        end = int(h.end_offsets[i])
        region = payload[start:end]
        out[obounds[i] : obounds[i + 1]] = _decode_stream(
            region, int(sizes[i]), *t2, *t1
        )
        start = end
    return out.tobytes()


class GoldenCodec:
    """Facade matching the reference's compressor-class shape
    (reference: huffman.h:42-52 ``HuffmanCompressorMulti``)."""

    def __init__(self, k: int):
        self.k = k

    def compress(self, raw: bytes) -> bytes:
        return compress(raw, self.k)

    def decompress(self, blob: bytes) -> bytes:
        return decompress(blob, self.k)

    @property
    def name(self) -> str:
        return f"Golden<{self.k}>"

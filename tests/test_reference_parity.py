"""Cross-implementation parity vs the C++ reference binary.

Builds the reference (read-only, in a scratch dir) and verifies:
  * our decoder bit-exactly decompresses reference-produced blobs
    (scalar and, when the CPU supports it, both AVX-512 paths);
  * the reference decompresses our blobs;
  * our compressed size <= reference's (same table construction, and our
    deterministic tie-break never hurts the size: lengths are identical).

Skipped when the oracle cannot be built (no compiler / no reference).
This is this framework's version of the reference's own
``AvxCheckCompressor`` equivalence testing (codec/huffman_test.cpp:15-32).
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import build_reference_oracle as oracle  # noqa: E402

from huffman_tpu import golden  # noqa: E402
from corpus import standard_cases  # noqa: E402

LIB = oracle.load()
pytestmark = pytest.mark.skipif(LIB is None, reason="reference oracle unavailable")

SCALAR, AVX_GATHER, AVX_PERMUTE = 0, 1, 2
KS_SCALAR = [1, 2, 4, 8, 16, 32]
KS_AVX = [8, 16, 24, 32, 40, 48]  # all six reference instantiations (huffman.cpp:1999-2004)


# Subprocess probe: SIGILL from missing AVX-512 kills the prober, not us.
HAS_AVX = LIB is not None and oracle.avx_ok()


@pytest.mark.parametrize("name,raw", standard_cases())
@pytest.mark.parametrize("k", KS_SCALAR)
def test_we_decode_reference_blobs(name, raw, k):
    blob = oracle.run(LIB, 0, k, SCALAR, raw)
    assert golden.decompress(blob, k) == raw


@pytest.mark.parametrize("name,raw", standard_cases())
@pytest.mark.parametrize("k", KS_SCALAR)
def test_reference_decodes_our_blobs(name, raw, k):
    blob = golden.compress(raw, k)
    assert oracle.run(LIB, 1, k, SCALAR, blob) == raw


@pytest.mark.parametrize("name,raw", standard_cases())
@pytest.mark.parametrize("k", KS_SCALAR)
def test_compressed_size_parity(name, raw, k):
    ours = golden.compress(raw, k)
    theirs = oracle.run(LIB, 0, k, SCALAR, raw)
    # Both builds produce optimal (length-limited) codes, so total code bits
    # must match exactly; per-stream byte rounding may differ by <=1 byte per
    # stream because equal-frequency tie order shifts which symbols share a
    # length (the reference's sort is unstable, huffman.cpp:353-354).
    import numpy as np
    from huffman_tpu import coding, format as fmt

    hist = coding.histogram(raw).astype(np.int64)

    def total_bits(blob):
        h = fmt.parse_header(blob, k)
        lens = np.zeros(256, dtype=np.int64)
        i = 0
        for ln in range(13):
            for _ in range(int(h.len_count[ln])):
                lens[int(h.sorted_syms[i])] = ln
                i += 1
        return int((hist * lens).sum())

    assert total_bits(ours) == total_bits(theirs)
    assert len(ours) <= len(theirs) + k


@pytest.mark.skipif(not HAS_AVX, reason="CPU lacks AVX-512")
@pytest.mark.parametrize("name,raw", standard_cases())
@pytest.mark.parametrize("k", KS_AVX)
@pytest.mark.parametrize("method", [AVX_GATHER, AVX_PERMUTE])
def test_avx_cross_parity(name, raw, k, method):
    # Reference AVX compress -> our decode, and our compress -> AVX decode.
    blob = oracle.run(LIB, 0, k, method, raw)
    assert golden.decompress(blob, k) == raw
    ours = golden.compress(raw, k)
    assert oracle.run(LIB, 1, k, method, ours) == raw

"""The GPU encode kernel (Pallas-Triton, interpret mode on CPU) against
the XLA route and a bit-by-bit host encoding.

Words and bit counts must be bit-identical: the codec is integer-valued,
so the tolerance is zero.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from huffman_tpu.ops import route
from huffman_tpu.ops.encode_triton import encode_words_triton

from corpus import standard_cases
from kernel_cases import KS, frame, lane_bits, words_to_bits


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,raw", standard_cases(), ids=[c[0] for c in standard_cases()])
def test_encode_kernel_matches_xla_and_host(name, raw, k):
    padded, b2, cc, enc, _t, w32 = frame(raw, k, "ref")
    s = b2.shape[0]
    counts = jnp.full((k,), s, jnp.int32)
    words, bits = encode_words_triton(b2, counts, enc, w32=w32, interpret=True)
    xw, xb = route.encode_words(b2, enc, w32, kernels=False)
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(xb))
    np.testing.assert_array_equal(np.asarray(words), np.asarray(xw))
    words = np.asarray(words)
    want = lane_bits(padded, k, cc)
    for lane in range(0, k, max(1, k // 16)):
        assert int(bits[lane]) == len(want[lane])
        np.testing.assert_array_equal(
            words_to_bits(words, lane, len(want[lane])), want[lane],
            err_msg=f"lane {lane}",
        )
        # Every bit past the stream is zero (the wire format relies on it).
        tail = np.unpackbits(words[:, lane].astype(">u4").view(np.uint8))
        assert not tail[len(want[lane]):].any()


@pytest.mark.parametrize("k", KS)
def test_encode_kernel_ragged_lane_counts(k):
    """Per-lane row counts (the ref profile's one-shorter lanes): rows at
    or past a lane's count append nothing, as the XLA valid mask does."""
    rng = np.random.default_rng(k)
    raw = rng.integers(0, 40, size=k * 9, dtype=np.uint8).tobytes()
    _padded, b2, _cc, enc, _t, w32 = frame(raw, k, "ref")
    counts = jnp.asarray(rng.integers(0, b2.shape[0] + 1, size=k).astype(np.int32))
    kw, kb = route.encode_words(
        b2, enc, w32, kernels=True, counts=counts, interpret=True
    )
    xw, xb = route.encode_words(b2, enc, w32, kernels=False, counts=counts)
    np.testing.assert_array_equal(np.asarray(kb), np.asarray(xb))
    np.testing.assert_array_equal(np.asarray(kw), np.asarray(xw))

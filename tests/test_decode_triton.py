"""The GPU decode kernel (Pallas-Triton, interpret mode on CPU) against
the XLA route and the original bytes, with the tpu profile's 15-bit
codes (every bit of the decode window is live)."""

import numpy as np
import pytest

from huffman_tpu.ops import route
from huffman_tpu.ops.decode_triton import decode_rows_triton

from corpus import standard_cases
from kernel_cases import KS, frame


def _group(l_min):
    return max(g for g in (1, 2, 3, 4, 6, 8) if g <= max(1, l_min))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,raw", standard_cases(), ids=[c[0] for c in standard_cases()])
def test_decode_kernel_matches_xla_and_input(name, raw, k):
    padded, b2, cc, enc, t, w32 = frame(raw, k, "tpu")
    s = b2.shape[0]
    words, bits = route.encode_words(b2, enc, w32, kernels=True, interpret=True)
    xw, _ = route.encode_words(b2, enc, w32, kernels=False)
    np.testing.assert_array_equal(np.asarray(words), np.asarray(xw))
    w = max(1, int((np.asarray(bits).max() + 31) // 32))
    eb, gr, sy = t["e_bound"], t["g_rank"], t["syms"]
    out = decode_rows_triton(words[:w], eb, gr, sy, out_len=s, interpret=True)
    assert out.shape == (s, k) and out.dtype == np.uint8
    if cc.num_syms > 1:
        xo = route.decode_rows(
            words[:w], eb, gr, sy, out_len=s, group=_group(t["l_min"]),
            kernels=False,
        )
        np.testing.assert_array_equal(np.asarray(out), np.asarray(xo))
        np.testing.assert_array_equal(np.asarray(out).reshape(-1), padded)
    else:
        # One symbol: zero-length codes; the decoders emit rank 0, the
        # only symbol (the codec short-circuits this case before decode).
        assert (np.asarray(out) == cc.sorted_syms[0]).all()


@pytest.mark.parametrize("k", KS)
def test_decode_kernel_reads_zeros_past_payload(k):
    """Lanes that run past their real symbols (the ref profile's shorter
    lanes) read zero words beyond row W, exactly like the XLA decoder, so
    the whole (out_len, K) output matches, garbage rows included."""
    rng = np.random.default_rng(k)
    raw = rng.integers(0, 30, size=k * 6, dtype=np.uint8).tobytes()
    _padded, b2, _cc, enc, t, w32 = frame(raw, k, "tpu")
    words, bits = route.encode_words(b2, enc, w32, kernels=False)
    w = max(1, int((np.asarray(bits).max() + 31) // 32))
    s = b2.shape[0] + 5  # five rows past every lane's stream
    eb, gr, sy = t["e_bound"], t["g_rank"], t["syms"]
    out = route.decode_rows(
        words[:w], eb, gr, sy, out_len=s, group=1, kernels=True, interpret=True
    )
    xo = route.decode_rows(words[:w], eb, gr, sy, out_len=s, group=1, kernels=False)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(xo))

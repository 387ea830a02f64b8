"""The XLA bit-serial decoder (the route of every non-GPU backend) over
every staging-group width it is dispatched with."""

import numpy as np
import pytest

from huffman_tpu.ops import route

from kernel_cases import frame


def _flat(n_syms, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_syms, size=96 * 40, dtype=np.uint8).tobytes()


# Near-flat corpora and their shortest code length l_min (256 symbols ->
# 7, 48 -> 5, 12 -> 3): each group width up to l_min shares one staging
# slot, so every width in {1, 2, 3, 4, 6, 8} the codec dispatches is
# walked by at least one corpus with l_min >= group.
CORPORA = {"flat256": _flat(256), "flat48": _flat(48, 1), "flat12": _flat(12, 2)}
CASES = [
    ("flat256", g) for g in (1, 2, 3, 4, 6)
] + [("flat48", g) for g in (1, 2, 3, 4)] + [("flat12", g) for g in (1, 2, 3)]


@pytest.mark.parametrize("corpus,group", CASES)
def test_decode_bitserial_groups(corpus, group):
    k = 96
    padded, b2, _cc, enc, t, w32 = frame(CORPORA[corpus], k, "tpu")
    assert group <= t["l_min"]
    words, bits = route.encode_words(b2, enc, w32, kernels=False)
    w = int((np.asarray(bits).max() + 31) // 32)
    out = route.decode_rows(
        words[:w], t["e_bound"], t["g_rank"], t["syms"], out_len=b2.shape[0],
        group=group, kernels=False,
    )
    np.testing.assert_array_equal(np.asarray(out).reshape(-1), padded)


def test_decode_bitserial_group8():
    """group 8 needs l_min >= 8: a 2-symbol alphabet cannot, so use all
    256 symbols at equal counts (every code exactly 8 bits)."""
    from corpus import equal_counts

    raw = equal_counts() * 2
    padded, b2, _cc, enc, t, w32 = frame(raw, 64, "tpu")
    assert t["l_min"] == 8
    words, bits = route.encode_words(b2, enc, w32, kernels=False)
    w = int((np.asarray(bits).max() + 31) // 32)
    out = route.decode_rows(
        words[:w], t["e_bound"], t["g_rank"], t["syms"], out_len=b2.shape[0],
        group=8, kernels=False,
    )
    np.testing.assert_array_equal(np.asarray(out).reshape(-1), padded)

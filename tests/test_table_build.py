"""Device (jittable) table builder vs the host oracle.

The device builder must reproduce the host `make_canonical_coding` exactly
(same tie-breaks) so that device-built and host-built blobs are
bit-identical.
"""

import numpy as np
import pytest

from huffman_tpu import coding
# The device builder limits at the tpu profile depth with the count
# clamp; the host oracle must be called with the same parameters.
from huffman_tpu.constants import TPU_MAX_CODE_LEN as MAX_CODE_LEN
from huffman_tpu.ops.table_build import build_coding_device
from huffman_tpu.ops.decode_bits import decode_tables_bitserial


def _check(hist):
    hist = np.asarray(hist, dtype=np.int64)
    cc = coding.make_canonical_coding(hist.astype(np.uint64), MAX_CODE_LEN, clamp=True)
    dev = {k: np.asarray(v) for k, v in build_coding_device(hist).items()}

    assert dev["num_syms"] == cc.num_syms
    np.testing.assert_array_equal(
        dev["len_count"], cc.len_count.astype(np.int64), err_msg="len_count"
    )
    np.testing.assert_array_equal(
        dev["sorted_syms"][: cc.num_syms],
        cc.sorted_syms.astype(np.int64),
        err_msg="sorted_syms",
    )
    # Packed encode entries: code<<4 | len per symbol.
    want = (cc.code_bits.astype(np.int64) << 4) | cc.code_lens
    got = dev["enc_table"]
    np.testing.assert_array_equal(got, want, err_msg="enc_table")

    if cc.num_syms > 1:
        t = decode_tables_bitserial(cc.len_count, cc.sorted_syms)
        np.testing.assert_array_equal(dev["e_bound"], t["e_bound"])
        np.testing.assert_array_equal(dev["g_rank"], t["g_rank"])
        assert int(dev["l_min"]) == t["l_min"]


CASES = {
    "empty": np.zeros(256),
    "single": np.eye(1, 256, 65).ravel() * 1000,
    "two": np.array([0] * 254 + [3, 9]),
    "uniform": np.full(256, 17),
    "equal_pairs": np.repeat(np.arange(128), 2) + 1,
    # NOTE: device-builder contract is total count < 2^30 (int32 weight
    # sums); cases stay within it while still forcing the length limiter.
    "geometric": np.maximum((0.8 ** np.arange(256) * 1e6).astype(int), 0),
    "exponential": 2 ** np.clip(np.arange(256) // 12, 0, 21),
    "long_codes": np.array(
        [2**21, 2**19, 2**17, 2**14, 2**11, 2**9, 2**5, 2**2, 2, 1, 1, 1]
        + [0] * 244
    ),
}


@pytest.mark.parametrize("name", list(CASES))
def test_named_cases(name):
    _check(CASES[name])


def test_random_histograms():
    rng = np.random.default_rng(7)
    for i in range(40):
        n_active = int(rng.integers(1, 257))
        hist = np.zeros(256, np.int64)
        active = rng.choice(256, size=n_active, replace=False)
        style = i % 4
        if style == 0:
            hist[active] = rng.integers(1, 100, size=n_active)
        elif style == 1:
            hist[active] = rng.integers(1, 2**21, size=n_active)
        elif style == 2:
            hist[active] = 1  # all ties
        else:
            hist[active] = rng.geometric(0.01, size=n_active)
        _check(hist)


def test_big_counts():
    # Near-contract-limit weights: deep optimal trees before limiting.
    hist = np.zeros(256, np.int64)
    hist[:40] = (2.0 ** np.linspace(1, 24, 40)).astype(np.int64)
    _check(hist)

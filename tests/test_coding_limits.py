"""Length-limited construction quality: clamp_hist + MiniZ vs package-merge.

The tpu profile's table build feeds `clamp_hist`-ed counts to the ordinary
two-queue + MiniZ pipeline (coding.py).  These tests pin the property that
construction relies on: the clamped build's cost matches the package-merge
OPTIMUM (the true minimum-redundancy length-limited code) to within a
fraction of a percent, on benchmark corpora and on fuzzed histograms.
"""

import numpy as np
import pytest

from huffman_tpu import coding
from huffman_tpu.constants import TPU_MAX_CODE_LEN


def package_merge_lens(weights: np.ndarray, L: int) -> np.ndarray:
    """Optimal length-limited code lengths (coin-collector oracle).

    O(L * n log n) reference implementation for tests only.
    """
    n = len(weights)
    assert n >= 2
    order = np.argsort(weights, kind="stable")
    w = np.asarray(weights, dtype=np.int64)[order]
    cur = [(int(wi), (i,)) for i, wi in enumerate(w)]
    for _ in range(L - 1):
        cur.sort(key=lambda t: t[0])
        pk = [
            (cur[2 * i][0] + cur[2 * i + 1][0], cur[2 * i][1] + cur[2 * i + 1][1])
            for i in range(len(cur) // 2)
        ]
        cur = sorted(
            [(int(wi), (i,)) for i, wi in enumerate(w)] + pk, key=lambda t: t[0]
        )
    cur.sort(key=lambda t: t[0])
    lens = np.zeros(n, np.int64)
    for _, items in cur[: 2 * n - 2]:
        for i in items:
            lens[i] += 1
    out = np.zeros(n, np.int64)
    out[order] = lens
    return out


def _cost(hist, lens):
    return int((hist.astype(np.int64) * lens.astype(np.int64)).sum())


def _kraft(lens, L):
    lens = lens[lens > 0]
    return int((1 << (L - lens.astype(np.int64))).sum())


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("L", [12, TPU_MAX_CODE_LEN])
def test_clamped_build_near_package_merge_fuzz(seed, L):
    rng = np.random.default_rng(seed)
    kind = seed % 4
    if kind == 0:  # geometric long tail (biased-like)
        hist = np.maximum((1e6 * 0.8 ** np.arange(256)).astype(np.int64), 0)
    elif kind == 1:  # smoothed sample: many count-1 symbols
        hist = rng.integers(0, 50, 256).astype(np.int64) ** 3 + 1
    elif kind == 2:  # random sparse
        hist = np.where(rng.random(256) < 0.3, rng.integers(1, 1 << 20, 256), 0)
    else:  # fibonacci-ish adversarial skew
        f = np.ones(64, np.int64)
        for i in range(2, 64):
            f[i] = min(f[i - 1] + f[i - 2], 1 << 40)
        hist = np.zeros(256, np.int64)
        hist[:64] = f[::-1]
    if (hist > 0).sum() < 2:
        pytest.skip("degenerate")
    cc = coding.make_canonical_coding(hist.astype(np.uint64), L, clamp=True)
    lens = cc.code_lens.astype(np.int64)
    present = hist > 0
    assert (lens[present] > 0).all()
    assert lens.max() <= L
    assert _kraft(lens, L) == 1 << L
    pm = package_merge_lens(hist[present], L)
    c_build, c_opt = _cost(hist[present], lens[present]), _cost(hist[present], pm)
    assert c_build <= c_opt * 1.005, (
        f"clamped build {c_build} vs package-merge {c_opt} "
        f"(+{c_build / c_opt - 1:.3%})"
    )


def test_clamped_build_matches_pm_on_smoothed_biased():
    """The motivating case: full-alphabet smoothed sampled histogram of the
    headline biased corpus.  Unclamped MiniZ loses ~5%; clamped must stay
    within 0.5% of optimal."""
    from huffman_tpu.bench import workloads

    data = np.frombuffer(workloads.biased_u8(1 << 20).tobytes(), np.uint8)
    samp = np.bincount(data[::8], minlength=256).astype(np.int64) + 1
    L = TPU_MAX_CODE_LEN
    cc = coding.make_canonical_coding(samp.astype(np.uint64), L, clamp=True)
    pm = package_merge_lens(samp, L)
    c_build = _cost(samp, cc.code_lens)
    c_opt = _cost(samp, pm)
    assert c_build <= c_opt * 1.005


def test_default_construction_unchanged():
    """max_len/clamp default off: byte-identical tables to round-3 behavior
    (ref-profile wire compatibility depends on this)."""
    hist = np.zeros(256, np.uint64)
    hist[:64] = (1e6 * 0.9 ** np.arange(64)).astype(np.uint64) + 1
    a = coding.make_canonical_coding(hist)
    b = coding.make_canonical_coding(hist, coding.MAX_CODE_LEN, clamp=False)
    np.testing.assert_array_equal(a.code_bits, b.code_bits)
    np.testing.assert_array_equal(a.code_lens, b.code_lens)
    assert a.len_mask == b.len_mask
    assert a.code_lens.max() <= coding.MAX_CODE_LEN

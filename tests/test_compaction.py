"""Property tests for the shift-based per-lane compaction primitive."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from huffman_tpu.ops.compaction import compact_lanes as _compact_lanes

compact_lanes = jax.jit(_compact_lanes, static_argnames=("out_len",))


def _oracle(values, valid):
    out = np.zeros_like(values)
    counts = np.zeros(values.shape[1:], dtype=np.int32)
    for lane in np.ndindex(values.shape[1:]):
        col = values[(slice(None),) + lane]
        m = valid[(slice(None),) + lane]
        picked = col[m]
        out[(slice(0, len(picked)),) + lane] = picked
        counts[lane] = len(picked)
    return out, counts


@pytest.mark.parametrize("t", [1, 2, 3, 7, 16, 33, 128, 257])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_compact_matches_oracle(t, density):
    rng = np.random.default_rng(t * 1000 + int(density * 10))
    vals = rng.integers(0, 1 << 30, size=(t, 4, 8)).astype(np.int32)
    valid = rng.random((t, 4, 8)) < density
    got, counts = compact_lanes(jnp.asarray(vals), jnp.asarray(valid))
    exp_vals, exp_counts = _oracle(vals, valid)
    np.testing.assert_array_equal(np.asarray(counts), exp_counts)
    got = np.asarray(got)
    for lane in np.ndindex(4, 8):
        n = exp_counts[lane]
        np.testing.assert_array_equal(
            got[(slice(0, n),) + lane], exp_vals[(slice(0, n),) + lane]
        )


def test_compact_multi_arrays_move_together():
    rng = np.random.default_rng(0)
    t = 64
    a = rng.integers(0, 255, size=(t, 16)).astype(np.uint8)
    b = rng.integers(0, 1 << 15, size=(t, 16)).astype(np.uint16)
    valid = rng.random((t, 16)) < 0.3
    (ga, gb), counts = compact_lanes((jnp.asarray(a), jnp.asarray(b)), jnp.asarray(valid))
    ea, ca = _oracle(a, valid)
    eb, _ = _oracle(b, valid)
    for k in range(16):
        n = ca[k]
        np.testing.assert_array_equal(np.asarray(ga)[:n, k], ea[:n, k])
        np.testing.assert_array_equal(np.asarray(gb)[:n, k], eb[:n, k])


def test_out_len_trim():
    vals = jnp.arange(32, dtype=jnp.int32).reshape(32, 1)
    valid = jnp.ones((32, 1), dtype=bool)
    got, counts = compact_lanes(vals, valid, out_len=8)
    assert got.shape == (8, 1)
    np.testing.assert_array_equal(np.asarray(got)[:, 0], np.arange(8))


def test_displacement_rounds_lsb_first_randomized():
    """Randomized model of the displacement rounds of `compact_packed`:
    LSB-first binary shifts compact any monotone staged pattern without
    collisions.  (MSB-first provably corrupts — intermediate rows invert —
    which is why the round order is load-bearing.)"""
    import numpy as np

    rng = np.random.default_rng(42)
    tested = 0
    for _ in range(400):
        T = int(rng.integers(4, 100))
        out_len = int(rng.integers(1, T + 1))
        d_max = T - out_len + 1
        valid = rng.random(T) < rng.uniform(0.2, 1.0)
        if valid.sum() < out_len:
            continue
        rank = np.cumsum(valid) - 1
        disp = np.arange(T) - rank
        # The kernel guarantees disp <= d_max only for NEEDED entries
        # (rank < out_len); garbage entries past a lane's real data may
        # displace up to T - 1 and must stay out of [0, out_len) via
        # their residual (unprocessed) high displacement bits.
        needed = valid & (rank < out_len)
        if disp[needed].max(initial=0) > d_max:
            continue
        tested += 1
        db = max(int(T - 1).bit_length(), 1)
        win = rng.integers(0, 4096, T)
        packed = np.where(valid, ((win + 1) << db) | disp, 0).astype(np.int64)
        pad = 1 << (int(d_max).bit_length() - 1) if d_max >= 1 else 0
        src = np.concatenate([packed, np.zeros(pad, np.int64)])
        dst = np.zeros_like(src)
        shifts = []
        sh = 1
        while sh <= d_max:
            shifts.append(sh)
            sh <<= 1
        heights = [0] * len(shifts)
        rem = 0
        for i in range(len(shifts) - 1, -1, -1):
            heights[i] = min(T, out_len + rem)
            rem += shifts[i]
        for sh, h in zip(shifts, heights):
            base, xs = src[:h], src[sh : sh + h]
            arrive = (xs & sh) != 0
            stay = (base & sh) == 0
            dst[:h] = np.where(arrive, xs - sh, np.where(stay, base, 0))
            src, dst = dst.copy(), src
        got = src[:out_len] >> db
        want = (win[valid] + 1)[:out_len]
        np.testing.assert_array_equal(got[: len(want)], want)
    assert tested >= 100

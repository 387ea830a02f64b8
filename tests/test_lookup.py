"""Exactness tests for the matmul-based lookup/histogram primitives."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from huffman_tpu.ops.lookup import lookup256, histogram256


def test_lookup256_exact_all_values():
    rng = np.random.default_rng(0)
    tab = rng.integers(0, 1 << 16, size=256).astype(np.int32)  # full u16 range
    idx = np.arange(256, dtype=np.int32)
    got = np.asarray(jax.jit(lookup256)(jnp.asarray(idx), jnp.asarray(tab)))
    np.testing.assert_array_equal(got, tab[idx])


def test_lookup256_2d_shapes():
    rng = np.random.default_rng(1)
    tab = rng.integers(0, 65536, size=256).astype(np.int32)
    idx = rng.integers(0, 256, size=(37, 53)).astype(np.int32)
    got = np.asarray(jax.jit(lookup256)(jnp.asarray(idx), jnp.asarray(tab)))
    np.testing.assert_array_equal(got, tab[idx])


def test_histogram256_matches_bincount():
    rng = np.random.default_rng(2)
    for n in [0, 1, 999, 100_000]:
        d = rng.integers(0, 256, size=n).astype(np.uint8)
        got = np.asarray(jax.jit(histogram256)(jnp.asarray(d)))
        np.testing.assert_array_equal(got, np.bincount(d, minlength=256))


def test_histogram256_skewed():
    d = np.zeros(200_000, dtype=np.uint8)
    d[::7] = 255
    got = np.asarray(jax.jit(histogram256)(jnp.asarray(d)))
    np.testing.assert_array_equal(got, np.bincount(d, minlength=256))


def test_pack_unpack_decode_table():
    """Packed Decoder2x entries (C14 device packing) round-trip."""
    import numpy as np
    from huffman_tpu import coding
    from huffman_tpu.ops import tables

    hist = np.zeros(256, np.uint64)
    hist[:7] = [50, 20, 10, 5, 3, 2, 1]
    cc = coding.make_canonical_coding(hist)
    packed = tables.pack_decode_table(cc.len_count, cc.sorted_syms)
    nb, n, s0, s1 = tables.unpack_decode_entry(packed)
    t_bits, t_s0, t_s1, t_n = coding.decode_tables_2x(cc.len_count, cc.sorted_syms)
    np.testing.assert_array_equal(nb, t_bits)
    np.testing.assert_array_equal(n, t_n)
    np.testing.assert_array_equal(s0, t_s0)
    np.testing.assert_array_equal(s1, t_s1)


def test_histogram256_batch_fallback_matches_bincount():
    """The batched codec's per-block histograms: jax.vmap(histogram256)."""
    rng = np.random.default_rng(3)
    d = rng.integers(0, 256, size=(5, 4096)).astype(np.uint8)
    got = np.asarray(jax.jit(jax.vmap(histogram256))(jnp.asarray(d)))
    want = np.stack([np.bincount(r, minlength=256) for r in d])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "b,n", [(1, 1024), (3, 1000), (4, 102_400), (2, (1 << 22) + 4096), (2, 777)]
)
def test_histogram256_batch_exact(b, n):
    """Batched histograms stay exact across the chunking corners: one
    chunk, a padded tail, and blocks longer than one f32-exact chunk."""
    rng = np.random.default_rng(4)
    d = rng.integers(0, 256, size=(b, n)).astype(np.uint8)
    got = np.asarray(jax.jit(jax.vmap(histogram256))(jnp.asarray(d)))
    want = np.stack([np.bincount(r, minlength=256) for r in d])
    np.testing.assert_array_equal(got, want, err_msg=f"B={b} n={n}")


def test_histogram256_batch_skewed_single_symbol():
    """All-one-byte blocks stress the padding (value-256 rows never count)."""
    d = np.zeros((3, 70_000), dtype=np.uint8)
    d[1, :] = 255
    d[2, ::3] = 7
    got = np.asarray(jax.jit(jax.vmap(histogram256))(jnp.asarray(d)))
    want = np.stack([np.bincount(r, minlength=256) for r in d])
    np.testing.assert_array_equal(got, want)

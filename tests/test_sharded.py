"""Sharded (multi-device) pipeline tests on the 8-virtual-device CPU mesh."""

import jax
import numpy as np
import pytest

from huffman_tpu.parallel import ShardedCodec, make_mesh

pytestmark = pytest.mark.slow


def _data(n, seed=0, style="biased"):
    rng = np.random.default_rng(seed)
    if style == "biased":
        p = 0.8 ** np.arange(256) * 0.2
        p /= p.sum()
        return rng.choice(256, size=n, p=p).astype(np.uint8)
    if style == "uniform":
        return rng.integers(0, 256, size=n, dtype=np.uint8)
    if style == "single":
        return np.full(n, 65, np.uint8)
    raise ValueError(style)


@pytest.mark.parametrize("stream", [1, 2, 4])
@pytest.mark.parametrize("style", ["biased", "uniform", "single"])
def test_sharded_roundtrip(stream, style):
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    mesh = make_mesh(stream=stream)
    codec = ShardedCodec(mesh=mesh, block_bytes=4096, k=64)
    data = _data(3 * 4096 + 1000, style=style)
    out, bits, words = codec.roundtrip(data)
    np.testing.assert_array_equal(out, data)
    # Exact sizing invariant: compressed bits per lane are precise.
    assert int(np.asarray(bits).sum()) >= 0


def test_sharded_matches_single_device():
    """Same blocks, 1-device vs 8-device mesh: identical bits (determinism)."""
    data = _data(2 * 4096, seed=3)
    m1 = make_mesh(devices=np.asarray(jax.devices())[:1], stream=1)
    m8 = make_mesh(stream=2)
    c1 = ShardedCodec(mesh=m1, block_bytes=4096, k=64)
    c8 = ShardedCodec(mesh=m8, block_bytes=4096, k=64)
    out1, bits1, words1 = c1.roundtrip(data)
    out8, bits8, words8 = c8.roundtrip(data)
    np.testing.assert_array_equal(out1, out8)
    # The wider mesh pads the block count up to its data-axis size; the
    # real blocks must be bit-identical.
    nb = np.asarray(bits1).shape[0]
    np.testing.assert_array_equal(np.asarray(bits1), np.asarray(bits8)[:nb])
    np.testing.assert_array_equal(np.asarray(words1), np.asarray(words8)[:nb])


@pytest.mark.parametrize("stream", [1, 2])
def test_sharded_bytes_api_interop(stream):
    """ShardedCodec.compress emits a standard HTP3 container that the
    single-device TpuCodec decodes byte-identically, and vice versa — the
    mesh changes WHERE the work runs, not the wire format."""
    from huffman_tpu.models.tpu_codec import TpuCodec

    mesh = make_mesh(stream=stream)
    sc = ShardedCodec(mesh=mesh, block_bytes=4096, k=64)
    raw = _data(3 * 4096 + 777, seed=9).tobytes()
    blob = sc.compress(raw)
    assert sc.decompress(blob) == raw
    # Cross-decode: single-device codec reads the sharded container.
    tc = TpuCodec()
    assert tc.decompress(blob) == raw
    # And the sharded codec reads a single-device container of its shape.
    tc2 = TpuCodec(64)
    tc2.block_bytes = 4096
    from huffman_tpu import container as ctn

    blob2 = ctn.compress_blocks(raw, tc2, 4096)
    assert sc.decompress(blob2) == raw


def test_sharded_bytes_api_stored_and_empty():
    mesh = make_mesh(stream=2)
    sc = ShardedCodec(mesh=mesh, block_bytes=4096, k=64)
    assert sc.decompress(sc.compress(b"")) == b""
    incompressible = _data(2 * 4096, seed=11, style="uniform").tobytes()
    blob = sc.compress(incompressible)
    assert sc.decompress(blob) == incompressible
    single = b"z" * (4096 * 2 + 5)
    assert sc.decompress(sc.compress(single)) == single

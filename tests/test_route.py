"""The one backend rule (ops/route.py) and the GPU route of every codec
program.

Where no GPU is present the kernels cannot run natively, but every codec
program can still be lowered for CUDA: that checks that the GPU route
reaches the Pallas-Triton kernels (and that every primitive in them has
a Triton lowering), and that the XLA route has no kernel in it.
"""

import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from huffman_tpu.ops import route

TRITON_CALL = "stablehlo.custom_call @__gpu$xla.gpu.triton"


@pytest.mark.parametrize(
    "backend,expected", [("gpu", True), ("cpu", False), ("tpu", False)]
)
def test_gpu_kernels_follows_default_backend(monkeypatch, backend, expected):
    monkeypatch.setattr(route.jax, "default_backend", lambda: backend)
    assert route.gpu_kernels() is expected


def _cuda_text(fn, *args, **kwargs) -> str:
    return fn.trace(*args, **kwargs).lower(lowering_platforms=("cuda",)).as_text()


def _n_triton(text: str) -> int:
    return len(re.findall(re.escape(TRITON_CALL), text))


U8 = jnp.uint8
I32 = jnp.int32
U32 = jnp.uint32


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


def _tpu_profile_programs(kernels):
    from huffman_tpu.models import tpu_codec as tc

    s, k, w32 = 100, 1024, 48
    tab = (_sds((16,), I32), _sds((15 + 1,), I32), _sds((256,), I32))
    return {
        "encode_full": (tc._encode_full, (_sds((s * k - 7,), U8), s, k, w32, kernels, 1), 1),
        "encode_with_tables": (
            tc._encode_with_tables, (_sds((s * k,), U8), _sds((256,), I32), s, k, w32, kernels), 1,
        ),
        "encode_batch": (tc._encode_batch, (_sds((3, s * k), U8), s, k, w32, kernels), 1),
        "decode_full": (tc._decode_full, (_sds((10, k), U32), *tab, s, s * k, 2, 10, kernels), 1),
        "decode_batch": (tc._decode_batch, (_sds((3, 10, k), U32), _sds((3, 16), I32),
                                            _sds((3, 16), I32), _sds((3, 256), I32), s, 2, 10, kernels), 1),
    }


def _ref_programs(kernels):
    from huffman_tpu.models import jax_codec as jc

    s, k = 64, 32
    return {
        "ref_encode": (jc._encode_jit, (_sds((s * k - 5,), U8), _sds((256,), I32),
                                        _sds((k,), I32), _sds((k,), I32), s, k, kernels), 1),
        "ref_decode": (jc._decode_ref_jit, (_sds((20, k), U32), _sds((16,), I32), _sds((16,), I32),
                                            _sds((256,), I32), _sds((s * k - 5,), I32), s, 2, kernels), 1),
    }


PROGRAMS = [
    "encode_full", "encode_with_tables", "encode_batch", "decode_full",
    "decode_batch", "ref_encode", "ref_decode",
]


@pytest.mark.parametrize("name", PROGRAMS)
def test_codec_program_routes(name):
    """kernels=True puts the Triton kernel in the program; kernels=False
    (every non-GPU backend) leaves no kernel call in it."""
    for kernels in (True, False):
        progs = {**_tpu_profile_programs(kernels), **_ref_programs(kernels)}
        fn, args, want = progs[name]
        n = _n_triton(_cuda_text(fn, *args))
        assert n == (want if kernels else 0), (name, kernels, n)


@pytest.mark.parametrize("stream", [1, 2])
def test_sharded_programs_route_to_kernels(monkeypatch, stream):
    """Under shard_map (vma-checked) and vmap the sharded steps reach the
    same kernels when the backend is a GPU."""
    from huffman_tpu.parallel.sharded import (
        make_mesh, sharded_decode, sharded_encode, sharded_roundtrip,
    )

    monkeypatch.setattr(route, "gpu_kernels", lambda: True)
    mesh = make_mesh(devices=jax.devices()[:4], stream=stream)
    k, s = 256 * stream, 16
    w32 = (s * 15 + 31) // 32 + 1
    data = _sds((4, k * s), U8)
    assert _n_triton(_cuda_text(sharded_roundtrip, data, mesh=mesh, k=k, s=s, w32=w32)) == 2
    assert _n_triton(_cuda_text(sharded_encode, data, mesh=mesh, k=k, s=s, w32=w32)) == 1
    dec = _cuda_text(
        sharded_decode, _sds((4, 6, k), U32), _sds((4, 16), I32), _sds((4, 16), I32),
        _sds((4, 256), I32), mesh=mesh, k=k, s=s, w=6, group=1,
    )
    assert _n_triton(dec) == 1


@pytest.mark.parametrize("k,s", [(8, 1), (200, 3), (1024, 100)])
def test_kernel_wrapper_shapes(k, s):
    """The wrappers' output shapes and dtypes: (w32, K) u32 words and (K,)
    int32 bit counts from encode, (out_len, K) u8 from decode, for any K
    (the kernels mask the lanes past K in their last 128-lane block)."""
    from huffman_tpu.ops.decode_triton import decode_rows_triton
    from huffman_tpu.ops.encode_triton import encode_words_triton

    w32 = (s * 15 + 31) // 32 + 1
    words, bits = jax.eval_shape(
        lambda b, c, t: encode_words_triton(b, c, t, w32=w32),
        _sds((s, k), U8), _sds((k,), I32), _sds((256,), I32),
    )
    assert (words.shape, words.dtype) == ((w32, k), np.uint32)
    assert (bits.shape, bits.dtype) == ((k,), np.int32)
    out = jax.eval_shape(
        lambda w, e, g, y: decode_rows_triton(w, e, g, y, out_len=s),
        _sds((3, k), U32), _sds((16,), I32), _sds((16,), I32), _sds((256,), I32),
    )
    assert (out.shape, out.dtype) == ((s, k), np.uint8)

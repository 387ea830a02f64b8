"""Multi-chip parallelism: mesh construction and the sharded block codec.

Submodules are loaded lazily: `distributed.initialize()` must be callable
BEFORE anything initializes the XLA backend, and importing the sharded
codec (device kernels) does exactly that.
"""


def __getattr__(name):
    if name in ("ShardedCodec", "make_mesh", "sharded_roundtrip",
                "sharded_encode", "sharded_decode"):
        from . import sharded

        return getattr(sharded, name)
    if name in ("distributed", "sharded"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'huffman_tpu.parallel' has no attribute {name!r}")


__all__ = [
    "ShardedCodec",
    "make_mesh",
    "sharded_roundtrip",
    "sharded_encode",
    "sharded_decode",
    "distributed",
]

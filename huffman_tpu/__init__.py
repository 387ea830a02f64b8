"""huffman_tpu: a multi-stream canonical-Huffman codec framework in JAX.

A ground-up JAX/XLA/Pallas re-design with the capabilities of the
``ahartik/huffman-avx512`` reference (AVX-512 C++): K independent
sub-streams sharing one canonical Huffman table, encoded/decoded in lockstep
across vector lanes.  Where the reference keeps 8 streams per zmm register,
this design keeps one stream per device lane — thousands of them — and
scales further by sharding independent blocks across a device mesh.

Format profiles:
  * ``ref`` — byte-compatible with the reference's format (K streams,
    backward bitstreams); used for cross-verification and the golden model.
  * ``tpu`` — large-K, lane-transposed word framing (magic ``HTP3``); the
    performance profile.  The name is the format's, not a hardware
    requirement: it runs on any JAX backend.
"""

from .utils.config import setup_compilation_cache as _setup_cache

_setup_cache()

from .constants import MAX_CODE_LEN, NUM_SYMBOLS, STREAM_SLOP
from .coding import (
    CanonicalCoding,
    histogram,
    make_canonical_coding,
    decode_tables_1x,
    decode_tables_2x,
)
from .format import ParsedHeader, parse_header, slice_sizes, write_header
from .golden import GoldenCodec, compress, decompress
from . import container, native
from .utils import debug


def __getattr__(name):
    # Device-codec classes import jax kernels; load them lazily so the
    # pure-host surfaces (golden/native/format) stay import-light.
    if name == "TpuCodec":
        from .models.tpu_codec import TpuCodec

        return TpuCodec
    if name == "JaxCodec":
        from .models.jax_codec import JaxCodec

        return JaxCodec
    if name == "NativeCodec":
        from .native import NativeCodec

        return NativeCodec
    if name == "ShardedCodec":
        from .parallel import ShardedCodec

        return ShardedCodec
    raise AttributeError(f"module 'huffman_tpu' has no attribute {name!r}")

__all__ = [
    "MAX_CODE_LEN",
    "NUM_SYMBOLS",
    "STREAM_SLOP",
    "CanonicalCoding",
    "histogram",
    "make_canonical_coding",
    "decode_tables_1x",
    "decode_tables_2x",
    "ParsedHeader",
    "parse_header",
    "slice_sizes",
    "write_header",
    "GoldenCodec",
    "compress",
    "decompress",
    "TpuCodec",
    "JaxCodec",
    "NativeCodec",
    "ShardedCodec",
]

__version__ = "0.1.0"

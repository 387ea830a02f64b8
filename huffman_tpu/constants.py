"""Format constants shared by every codec implementation.

These mirror the wire-format constants of the reference implementation
(reference: codec/huffman.cpp:38-42) so that the ``ref`` format profile is
bit-compatible with it.  The ``tpu`` format profile (HTP3) reuses the same
canonical-code construction, with the deeper limit below.
"""

# Maximum canonical code length in bits.  The reference caps at 12
# (codec/huffman.cpp:38): its AVX compressor packs the length into a nibble
# and its decode table has 2^12 entries.  We keep 12 so decode tables stay
# small (4096 entries) and compressed output is byte-compatible.
MAX_CODE_LEN = 12

# Maximum canonical code length for the ``tpu`` format profile (HTP3).  The
# 12-bit cap above is a *reference wire-format* constraint (nibble-packed
# lengths, 2^12 decode table); the tpu profile has neither — its decoder
# is table-free (canonical-boundary compares) and its header stores
# lengths in a bitmask with room to 23.  15 bits cuts the length-limiting
# ratio loss (~0.3-0.6% on the benchmark corpora at 12) and, combined
# with histogram clamping (`clamp_hist`), makes full-alphabet sampled
# tables cost < 1% vs exact (tests/test_coding_limits.py).
TPU_MAX_CODE_LEN = 15

# Length assigned by the unconstrained Huffman build before limiting.  The
# reference assumes <= 32 (codec/huffman.cpp:41-42), which adversarially
# skewed histograms (Fibonacci-like counts) can exceed; 64 is safe for any
# 64-bit total count.
MAX_OPTIMAL_CODE_LEN = 64

# Per-stream slop appended to every stream region so 8-byte-wide writers and
# readers may overhang safely (codec/huffman.cpp:770 ``kSlop``).
STREAM_SLOP = 8

# Number of symbols in the alphabet (bytes).
NUM_SYMBOLS = 256

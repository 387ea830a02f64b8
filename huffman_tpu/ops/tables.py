"""Device-side table packing.

The canonical coding (host-built, tiny) is packed into flat integer arrays
that device kernels index with vectorized gathers:

* encode table: u32[256]   — ``code_value << 4 | code_len`` where
  ``code_value`` is the 12-bit left-aligned canonical code
  (reference equivalent: ``BitCode`` huffman.cpp:214-224).
* decode table: i32[4096]  — packed ``Decoder2x`` entry
  (reference equivalent: ``DecodedSym2x`` huffman.cpp:634-640):
  bits 0-7 consumed-bit-count, bits 8-9 symbol count, bits 10-17 sym0,
  bits 18-25 sym1.

Flat tables in device memory replace the reference's in-register
``vpermi2b`` tables.
"""

from __future__ import annotations

import numpy as np

from .. import coding
from ..constants import MAX_CODE_LEN


def pack_encode_table(cc: coding.CanonicalCoding) -> np.ndarray:
    """u32[256]: code_value<<4 | len.

    The encode kernels (ops/encode.py, ops/encode_triton.py) consume code
    values left-aligned in TPU_MAX_CODE_LEN (15) bits, so the ref
    profile's 12-bit-aligned canonical codes are up-shifted here; the
    emitted stream bits are identical (alignment is kernel-internal).
    """
    from ..constants import TPU_MAX_CODE_LEN

    # cc.code_bits are left-aligned in cc.max_len bits (12 for the ref
    # build, 15 for the tpu-profile clamp build) — shift by the
    # DIFFERENCE, not a hardcoded 3: a 15-bit cc is already aligned.
    shift = TPU_MAX_CODE_LEN - getattr(cc, "max_len", MAX_CODE_LEN)
    assert shift >= 0, "cc built deeper than the kernel alignment"
    code15 = cc.code_bits.astype(np.uint32) << shift
    return (code15 << 4) | cc.code_lens.astype(np.uint32)


def pack_decode_table(len_count: np.ndarray, sorted_syms: np.ndarray) -> np.ndarray:
    """i32[4096] packed two-symbol decode entries."""
    t_bits, t_s0, t_s1, t_n = coding.decode_tables_2x(len_count, sorted_syms)
    packed = (
        t_bits.astype(np.int32)
        | (t_n.astype(np.int32) << 8)
        | (t_s0.astype(np.int32) << 10)
        | (t_s1.astype(np.int32) << 18)
    )
    return packed


def unpack_decode_entry(e):
    """Split a packed decode entry (works on jnp or np arrays)."""
    nb = e & 0xFF
    n = (e >> 8) & 0x3
    s0 = (e >> 10) & 0xFF
    s1 = (e >> 18) & 0xFF
    return nb, n, s0, s1


assert MAX_CODE_LEN <= 15, "encode table packs len in 4 bits"

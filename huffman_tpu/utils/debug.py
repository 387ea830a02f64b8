"""Debug facilities (SURVEY §5 parity with the reference's DLOG layer).

The reference has a compile-time leveled ``DLOG(level)`` gated on
``HUFF_VLOG``/``HUFF_DEBUG`` (huffman.cpp:44-53) plus vector
pretty-printers and ``ASSERT_VEC_EQ`` for SIMD debugging (:61-91), all
zero-cost when disabled.  The equivalents here:

* ``dlog(level, ...)`` — leveled host-side logging gated on
  ``HUFFMAN_TPU_VLOG`` (env, read once).  Zero-cost when disabled in the
  sense that hot paths never call it (it is for framing/driver code);
  inside jitted code use `jax.debug.print` via `dprint`.
* ``dprint(fmt, **kw)`` — traced-value printing inside jit,
  compiled in only when ``HUFFMAN_TPU_VLOG`` >= its level at trace time
  (so production traces carry no debug ops at all — the same
  compile-time gating idea as the reference).
* ``assert_vec_eq`` — ASSERT_VEC_EQ for tests: pretty numpy diff.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np

VLOG = int(os.environ.get("HUFFMAN_TPU_VLOG", "0"))


def dlog(level: int, *args) -> None:
    """Host-side leveled log (reference: DLOG, huffman.cpp:44-53)."""
    if VLOG >= level:
        print(f"[huffman_tpu:{level}]", *args, file=sys.stderr, flush=True)


def dprint(level: int, fmt: str, **kwargs) -> None:
    """Traced-value print inside jit; compiled out when VLOG < level."""
    if VLOG >= level:
        import jax

        jax.debug.print(fmt, **kwargs)


def assert_vec_eq(a, b, msg: str = "") -> None:
    """Pretty elementwise comparison for kernel debugging
    (reference: ASSERT_VEC_EQ, huffman.cpp:78-91)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a, b):
        neq = np.nonzero(a != b) if a.shape == b.shape else None
        detail = (
            f"first diffs at {[tuple(int(x[i]) for x in neq) for i in range(min(8, len(neq[0])))]}"
            if neq and len(neq[0])
            else f"shapes {a.shape} vs {b.shape}"
        )
        raise AssertionError(f"vectors differ{': ' + msg if msg else ''} ({detail})")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed block (the
    reference's --config=profopt analog: feed this to XProf/TensorBoard)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()

"""Benchmark input generators (reference parity: huffman_benchmark.cpp).

Mirrors the reference's six workloads (C30):
  biased   GenerateProbaData(0.2) — FSE/Huff0's exponential "Proba"
           distribution (huffman_benchmark.cpp:27-36)
  sorted   the biased data, sorted (:84-91)
  uniform  uniform random bytes (:109-120)
  short    100 bytes of ``rand() & rand() & rand()`` (:143-153)
  lorem    lorem-ipsum text repeated to length (:180+)
  file     first LEN bytes of a user-supplied file (enwik8 in the
           reference, :38-59); falls back to a deterministic text-like
           synthetic corpus when no file is available (this environment
           has no network egress).

The reference's exact bytes depend on libstdc++'s mt19937/rand; we use
numpy's deterministic generators — distributions match, bytes don't,
which only matters for absolute ratio comparisons (reported anyway).
"""

from __future__ import annotations

import os

import numpy as np

LEN = 100 << 10  # reference benchmark input size (huffman_benchmark.cpp:19)

LOREM = (
    "Lorem ipsum dolor sit amet, consectetur adipiscing elit, sed do eiusmod "
    "tempor incididunt ut labore et dolore magna aliqua. Ut enim ad minim "
    "veniam, quis nostrud exercitation ullamco laboris nisi ut aliquip ex ea "
    "commodo consequat. Duis aute irure dolor in reprehenderit in voluptate "
    "velit esse cillum dolore eu fugiat nulla pariatur. Excepteur sint "
    "occaecat cupidatat non proident, sunt in culpa qui officia deserunt "
    "mollit anim id est laborum.\n"
)


def biased_u8(n: int, seed: int = 0) -> np.ndarray:
    """The headline biased corpus as a (n,) uint8 array.

    This is the ONE definition every measurement entry point (bench.py,
    chip_smoke.py) must share: same-call A/B ratios and cross-tool
    numbers are only comparable when the corpora are byte-identical.
    ``rng.choice`` over the truncated-renormalized P(c) ~ 0.8^c * 0.2
    (distinct bytes from :func:`biased` below, which predates it)."""
    rng = np.random.default_rng(seed)
    p = 0.8 ** np.arange(256) * 0.2
    p /= p.sum()
    return rng.choice(256, size=n, p=p).astype(np.uint8)


def biased(n: int = LEN, p: float = 0.2, seed: int = 0) -> bytes:
    """FSE-style exponential distribution: P(c) ~ (1-p)^c * p."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    logp = np.log(1.0 - p)
    return (np.minimum(np.log(u) / logp, 1e9).astype(np.int64) % 256).astype(
        np.uint8
    ).tobytes()


def sorted_biased(n: int = LEN, seed: int = 0) -> bytes:
    arr = np.frombuffer(biased(n, seed=seed), dtype=np.uint8).copy()
    arr.sort()
    return arr.tobytes()


def uniform(n: int = LEN, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def short(n: int = 100, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=n, dtype=np.uint8)
    b = rng.integers(0, 256, size=n, dtype=np.uint8)
    c = rng.integers(0, 256, size=n, dtype=np.uint8)
    return (a & b & c).tobytes()


def lorem(n: int = LEN) -> bytes:
    reps = -(-n // len(LOREM))
    return (LOREM * reps).encode()[:n]


def synthetic_text(n: int = LEN, seed: int = 1) -> bytes:
    """Deterministic text-like corpus (enwik8 stand-in, zero-egress env):
    a Zipf-weighted bag of English-ish tokens with punctuation/markup."""
    rng = np.random.default_rng(seed)
    words = (
        "the of and to a in is was for that it as on with by he at his are "
        "from this which or had not but they have an were her she been we "
        "their one also all its may can world war city state year time "
        "[[link]] == &amp; &lt;ref&gt; category wikipedia article external "
        "history population january century government national university"
    ).split()
    ranks = np.arange(1, len(words) + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    idx = rng.choice(len(words), size=n // 4, p=probs)
    text = " ".join(words[i] for i in idx)
    return text.encode()[:n].ljust(n, b" ")


#: Checked-in real-file corpus: 4 MiB of concatenated Python standard
#: library sources (assembled once, deterministic; real program text with
#: natural-language comments).  The zero-egress build can't fetch enwik8
#: (huffman_benchmark.cpp:38-59), so this is the measured 'file' row's
#: default input; pass --file to benchmark any other file.
CORPUS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "benchmarks",
    "corpus.bin",
)


def file_data(path: str | None, n: int = LEN) -> bytes:
    if path:
        # An explicitly requested file must exist — silently substituting
        # the corpus would mislabel the benchmark row.
        with open(path, "rb") as f:
            return f.read(n)
    if os.path.exists(CORPUS_PATH):
        with open(CORPUS_PATH, "rb") as f:
            data = f.read(n)
        if len(data) < n:  # tile to the requested size
            data = (data * (n // max(len(data), 1) + 1))[:n]
        return data
    return synthetic_text(n)


WORKLOADS = {
    "biased": biased,
    "sorted": sorted_biased,
    "uniform": uniform,
    "short": short,
    "lorem": lorem,
    "file": None,  # needs a path; resolved by make_workload
}


def make_workload(name: str, n: int = LEN, file_path: str | None = None) -> bytes:
    if name == "file":
        return file_data(file_path, n)
    if name == "short":
        return short()
    return WORKLOADS[name](n)

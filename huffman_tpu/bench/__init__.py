"""Benchmark harness: workloads, timing, and table rendering.

The JAX codec's equivalent of the reference's google-benchmark harness
(codec/huffman_benchmark.cpp, C30) and its offline table generator
(make_table.py, C32).
"""

from .workloads import WORKLOADS, make_workload
from .harness import run_suite, sustained_seconds
from .table import render_markdown

__all__ = [
    "WORKLOADS",
    "make_workload",
    "run_suite",
    "sustained_seconds",
    "render_markdown",
]

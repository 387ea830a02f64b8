"""Test configuration.

Tests run on CPU with 8 virtual XLA devices so multi-device sharding code
is exercised without accelerator hardware.  Must set env vars before jax
is imported anywhere.  The compilation cache follows the package's rule
(huffman_tpu/utils/config.py).

``HUFFMAN_TPU_GPU_TESTS=1 pytest -m gpu`` instead leaves JAX on its
default backend, for the ``gpu``-marked tests on a GPU host.
"""

import os

ON_GPU = os.environ.get("HUFFMAN_TPU_GPU_TESTS") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run compile-heavy tests (full battery)",
    )


def pytest_collection_modifyitems(config, items):
    """Default run = fast core + parity set; the compile-heavy battery
    (sharded shard_map programs, shape-diverse fuzz) needs --runslow."""
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="compile-heavy; run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none (every
    run without HUFFMAN_TPU_GPU_TESTS=1 pins JAX to the CPU)."""
    if not ON_GPU:
        pytest.skip("GPU tests run with HUFFMAN_TPU_GPU_TESTS=1 on a GPU host")
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("no GPU device")
    return devs[0]

"""Two-process jax.distributed integration test (CPU, Gloo collectives).

The reference has no distributed backend at all; this framework's
multi-host path (`parallel/distributed.py` + the sharded codec) is
exercised here for real: two OS processes, each owning half of an
8-device CPU mesh, run the ONE-program sharded round-trip with a psum
over the 'stream' axis crossing the process boundary.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.slow

_WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4"
        ).strip()
    import jax
    jax.config.update("jax_platforms", "cpu")

    from huffman_tpu.parallel import distributed

    addr, pid = sys.argv[1], int(sys.argv[2])
    distributed.initialize(
        coordinator_address=addr, num_processes=2, process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8, jax.device_count()

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from huffman_tpu.parallel import ShardedCodec, make_mesh

    mesh = make_mesh(stream=2)  # 4 x 2 over both processes
    codec = ShardedCodec(mesh=mesh, block_bytes=4096, k=64)

    rng = np.random.default_rng(0)
    p = 0.8 ** np.arange(256) * 0.2
    p /= p.sum()
    n = 8 * 4096
    data = rng.choice(256, size=n, p=p).astype(np.uint8)

    # Same host bytes on every process; device_put with a NamedSharding
    # places each process's addressable shards.
    blocks = codec._permute_in(data.reshape(8, 4096))
    sharding = NamedSharding(mesh, P("data", "stream"))
    dev = jax.device_put(jnp.asarray(blocks), sharding)

    from huffman_tpu.constants import TPU_MAX_CODE_LEN as MAX_CODE_LEN
    from huffman_tpu.parallel.sharded import sharded_roundtrip

    w32 = (codec.s * MAX_CODE_LEN + 31) // 32 + 1
    out, bits, words = sharded_roundtrip(
        dev, mesh=mesh, k=codec.k, s=codec.s, w32=w32
    )
    ok = jnp.all(out == dev)  # replicated scalar: fetchable everywhere
    assert bool(ok), "multi-process sharded roundtrip mismatch"
    print(f"proc {pid} OK", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_roundtrip(tmp_path):
    addr = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), addr, str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-4000:]}"
        assert f"proc {pid} OK" in out

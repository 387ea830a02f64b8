"""Weak-scaling benchmark for the sharded pipeline.

Runs the one-program sharded roundtrip on 1, 2, 4, ..., N devices with a
constant per-device workload and reports aggregate GiB/s + scaling
efficiency.  On one device this degenerates to the 1-device row; on CPU
it measures nothing useful but exercises the code path.

Usage: python tools/bench_sharded.py [--per-device-mib 4] [--stream 1]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device-mib", type=float, default=4.0)
    ap.add_argument("--stream", type=int, default=1)
    ap.add_argument("--k", type=int, default=8192)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from huffman_tpu.constants import TPU_MAX_CODE_LEN as MAX_CODE_LEN
    from huffman_tpu.parallel import make_mesh
    from huffman_tpu.parallel.sharded import sharded_roundtrip
    from huffman_tpu.bench.harness import sustained_seconds

    devices = jax.devices()
    rng = np.random.default_rng(0)
    p = 0.8 ** np.arange(256) * 0.2
    p /= p.sum()

    block = 1 << 20
    per_dev_blocks = max(1, int(args.per_device_mib))
    k, s = args.k, block // args.k

    rows = []
    nd = 1
    base = None
    while nd <= len(devices):
        mesh = make_mesh(devices=np.asarray(devices[:nd]), stream=args.stream)
        d_axis = nd // args.stream
        nb = per_dev_blocks * d_axis
        data = rng.choice(256, size=(nb, block), p=p).astype(np.uint8)
        blocks = jax.device_put(
            jnp.asarray(data), NamedSharding(mesh, P("data", "stream"))
        )
        w32 = (s * MAX_CODE_LEN + 31) // 32 + 1

        def body(pert, blocks=blocks, mesh=mesh):
            out, bits, words = sharded_roundtrip(
                blocks + pert, mesh=mesh, k=k, s=s, w32=w32
            )
            return jnp.sum(bits).astype(jnp.float32)

        # correctness
        out, bits, words = sharded_roundtrip(blocks, mesh=mesh, k=k, s=s, w32=w32)
        ok = np.array_equal(np.asarray(out), data)

        t = sustained_seconds(body, reps=8)
        total = nb * block
        gibs = total / t / (1 << 30)
        if base is None:
            base = gibs / nd
        rows.append(
            {
                "devices": nd,
                "roundtrip_GiB_s": round(gibs, 3),
                "efficiency": round(gibs / (base * nd), 3),
                "ok": bool(ok),
            }
        )
        nd *= 2

    print(json.dumps({"per_device_blocks": per_dev_blocks, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()

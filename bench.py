"""Benchmark: the codec's 16 MiB biased round trip on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "GiB/s", "vs_baseline": N, "detail": {...}}
``detail`` names the platform, the device kind, the device count and the
card's power limit.  On any platform other than ``gpu`` the line carries
``"value": null`` and an ``"error"``, and the process exits non-zero: a
CPU run measures XLA's CPU backend, which is not this system's device.

Workload: the reference's headline *biased* distribution
(GenerateProbaData(0.2), huffman_benchmark.cpp:27-36) as one 16 MiB
block (K=131072 lanes).  Baseline: the reference's best per-direction
biased numbers on a Ryzen 9950X — 2988 MiB/s compress (Permute/16) and
5026 MiB/s decompress (Gather/32), i.e. a combined round-trip rate of
1/(1/2988 + 1/5026) = 1874 MiB/s = 1.830 GiB/s (BASELINE.md).  ``value``
is our combined rate; ``vs_baseline`` = value / 1.830.

Timing: each direction runs R times inside one jitted loop with a
carried data dependency; cost = (t(R) - t(1)) / (R - 1)
(huffman_tpu/bench/harness.py).  The kernels are the ones the codec
dispatches on this backend (ops/route.py).
"""

import json
import subprocess
import sys
import time

import numpy as np

METRIC = "biased 16MiB compress+decompress sustained, 1 GPU"
REF_COMBINED_GIB_S = 1.830


def _fail(reason: str, detail: dict) -> None:
    print(json.dumps({"metric": METRIC, "value": None, "unit": "GiB/s",
                      "vs_baseline": None, "error": reason, "detail": detail}),
          flush=True)
    sys.exit(1)


def main() -> None:
    t_start = time.monotonic()
    import jax
    import jax.numpy as jnp

    from huffman_tpu.bench.harness import sustained_seconds
    from huffman_tpu.bench.workloads import biased_u8
    from huffman_tpu.constants import TPU_MAX_CODE_LEN as MAX_CODE_LEN
    from huffman_tpu.models.tpu_codec import (
        TpuCodec, _decode_full, _encode_full, decode_statics,
    )
    from huffman_tpu.ops import route

    dev = jax.devices()[0]
    detail = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices())}
    if dev.platform != "gpu":
        _fail(f"refusing to time platform {dev.platform!r}: no GPU", detail)
    detail["power_limit"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    n = 16 << 20
    data = biased_u8(n)
    d = jax.device_put(jnp.asarray(data))
    codec = TpuCodec()
    comp = codec.encode_device(d)
    if not np.array_equal(np.asarray(codec.decode_device(comp)), data):
        _fail("round-trip mismatch", detail)
    # Headline ratio counts EVERY serialized byte.
    ratio = n / len(codec.serialize(comp))

    k = comp.k
    s = -(-n // k)
    w32 = (s * MAX_CODE_LEN + 31) // 32 + 1
    # The ONE shared derivation of the decode-dispatch statics, so the
    # benchmark times exactly the program decode_device dispatches.
    group, w = decode_statics(comp.meta(), s)
    kernels = route.gpu_kernels()
    hist_stride = codec._hist_stride(n)
    words = comp.words
    if words.shape[0] < w:
        words = jnp.concatenate([words, jnp.zeros((w - words.shape[0], k), words.dtype)])
    eb, gr, sy = (comp.tables[x] for x in ("e_bound", "g_rank", "sorted_syms"))

    def enc_once(pert):
        _, bits, t = _encode_full(d + pert, s, k, w32, kernels, hist_stride)
        return (jnp.sum(bits) + jnp.sum(t["enc_table"])).astype(jnp.float32)

    def dec_once(pert):
        o = _decode_full(words + pert.astype(jnp.uint32), eb, gr, sy, s, n,
                         group, w, kernels)
        return jnp.sum(o.astype(jnp.int32)).astype(jnp.float32)

    t_c = sustained_seconds(enc_once, reps=64, tries=4)
    t_d = sustained_seconds(dec_once, reps=64, tries=4)
    combined = n / (t_c + t_d) / (1 << 30)
    detail.update({
        "compress_GiB_s": round(n / t_c / (1 << 30), 4),
        "decompress_GiB_s": round(n / t_d / (1 << 30), 4),
        "ratio": round(ratio, 4),
        "k_lanes": k,
        "kernels": kernels,
        "roundtrip_ok": True,
        "wall_s": round(time.monotonic() - t_start, 1),
    })
    print(json.dumps({"metric": METRIC, "value": round(combined, 4), "unit": "GiB/s",
                      "vs_baseline": round(combined / REF_COMBINED_GIB_S, 4),
                      "detail": detail}), flush=True)


if __name__ == "__main__":
    main()

"""Benchmark timing harness.

Two timing modes:

* **sustained** (device codecs): run the jitted pipeline R times inside
  one program with a carried data dependency; cost = (t(R) - t(1))/(R-1).
  Every dispatch carries a fixed host cost that would otherwise swamp
  sub-millisecond kernels.
* **wall** (host codecs): classic repeated wall-clock timing.

Results are plain dicts, JSON-serializable, rendered by
:mod:`huffman_tpu.bench.table` (the make_table.py equivalent).
"""

from __future__ import annotations

import time

import numpy as np


def sustained_seconds(
    body, reps: int = 32, tries: int = 2, max_reps: int = 512
) -> float:
    """Seconds per run of ``body(pert)`` (a traced fn returning a f32
    scalar), measured by in-jit repetition.

    The repetition count is a *traced* ``fori_loop`` bound, so every rep
    count shares ONE compiled program — escalating reps costs zero
    recompiles.  Escalation is capped at ``max_reps``; with a 16 MiB
    workload the starting count already clears the noise floor.
    """
    import functools

    import jax
    import jax.numpy as jnp

    def it(i, acc):
        pert = jnp.isnan(acc).astype(jnp.uint8)
        return acc + body(pert)

    # Static trip counts for the first ladder rungs (1 and `reps`): a
    # dynamic fori_loop bound lowers to a while loop whose per-iteration
    # overhead would be billed to the kernel.
    # Escalation beyond `reps` (small bodies lost in dispatch noise)
    # switches to ONE dynamic-bound program so arbitrarily higher rep
    # counts cost zero further compiles.
    @functools.partial(jax.jit, static_argnames=("r",))
    def f_static(r):
        return jax.lax.fori_loop(0, r, it, jnp.float32(0.0), unroll=False)

    @jax.jit
    def f_dyn(r):
        return jax.lax.fori_loop(0, r, it, jnp.float32(0.0))

    def measure(r, f, arg):
        float(f(arg))  # warm (first call per (f, shape) compiles; later sync)
        best = float("inf")
        for _ in range(tries):
            t0 = time.perf_counter()
            float(f(arg))
            best = min(best, time.perf_counter() - t0)
        return best

    t1 = measure(1, f_static, 1)
    tr = measure(reps, f_static, reps)
    escalated = False
    while tr - t1 <= 0.015 and reps < max_reps:
        if not escalated:
            # Both ends of the delta must come from the SAME program:
            # the dynamic-bound while loop costs extra per iteration,
            # which would otherwise be billed to the kernel.
            t1 = measure(1, f_dyn, jnp.int32(1))
            escalated = True
        reps *= 4
        tr = measure(reps, f_dyn, jnp.int32(reps))
    return max((tr - t1) / (reps - 1), 1e-9)


def wall_seconds(fn, min_time: float = 0.3) -> float:
    fn()  # warm
    reps, total = 0, 0.0
    best = float("inf")
    while total < min_time:
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        best = min(best, dt)
        total += dt
        reps += 1
        if reps > 1000:
            break
    return best


def bench_tpu_codec(codec, raw: bytes, reps: int = 32) -> dict:
    """Sustained compress/decompress rates for a TpuCodec on one device."""
    import jax.numpy as jnp

    from ..constants import TPU_MAX_CODE_LEN as MAX_CODE_LEN
    from ..models.tpu_codec import _decode_full, _encode_full, decode_statics
    from ..ops import route

    n = len(raw)
    data = jnp.asarray(np.frombuffer(raw, dtype=np.uint8))
    comp = codec.encode_device(data)
    out = codec.decode_device(comp)
    ok = np.asarray(out).tobytes() == raw
    m = comp.meta()

    k = comp.k
    s = -(-n // k)
    w32 = (s * MAX_CODE_LEN + 31) // 32 + 1
    group, w = decode_statics(m, s)
    kernels = route.gpu_kernels()

    hist_stride = codec._hist_stride(n)

    def enc_once(pert):
        words32, bits, t = _encode_full(
            data + pert, s, k, w32, kernels, hist_stride
        )
        return (jnp.sum(bits) + jnp.sum(t["enc_table"])).astype(jnp.float32)

    words = comp.words
    if words.shape[0] < w:
        words = jnp.concatenate(
            [words, jnp.zeros((w - words.shape[0], k), words.dtype)]
        )
    eb, gr, sy = (
        comp.tables["e_bound"],
        comp.tables["g_rank"],
        comp.tables["sorted_syms"],
    )

    def dec_once(pert):
        o = _decode_full(
            words + pert.astype(jnp.uint32), eb, gr, sy, s, n, group, w,
            kernels,
        )
        return jnp.sum(o.astype(jnp.int32)).astype(jnp.float32)

    t_c = sustained_seconds(enc_once, reps=reps)
    t_d = sustained_seconds(dec_once, reps=reps)
    blob = codec.serialize(comp)
    return {
        "method": codec.name,
        "streams": k,
        "compress_bps": n / t_c,
        "decompress_bps": n / t_d,
        "ratio": len(blob) / n,
        "roundtrip_ok": bool(ok),
    }


def bench_bytes_codec(codec, raw: bytes, name: str, streams) -> dict:
    """Wall-clock rates for any {compress, decompress} bytes codec."""
    blob = codec.compress(raw)
    ok = codec.decompress(blob) == raw
    t_c = wall_seconds(lambda: codec.compress(raw))
    t_d = wall_seconds(lambda: codec.decompress(blob))
    return {
        "method": name,
        "streams": streams,
        "compress_bps": len(raw) / t_c,
        "decompress_bps": len(raw) / t_d,
        "ratio": len(blob) / len(raw),
        "roundtrip_ok": bool(ok),
    }


def run_suite(workload_names, codecs, n, file_path=None, reps=32) -> dict:
    """codecs: list of ("tpu", TpuCodec) / ("bytes", name, streams, codec)."""
    from .workloads import make_workload

    results = {}
    for wname in workload_names:
        raw = make_workload(wname, n, file_path)
        rows = []
        for spec in codecs:
            if spec[0] == "tpu":
                rows.append(bench_tpu_codec(spec[1], raw, reps=reps))
            else:
                _, name, streams, codec = spec
                rows.append(bench_bytes_codec(codec, raw, name, streams))
        results[wname] = {"bytes": len(raw), "rows": rows}
    return results

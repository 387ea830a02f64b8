"""Smoke run of the codec's main path on an NVIDIA GPU.

    python chip_smoke.py          one card: kernel parity at real sizes, the
                                  device API, the bytes API, timings
    python chip_smoke.py --four   four cards: the sharded mesh path and its
                                  interop with the single-device codec only

Every phase raises on error, and the script then exits non-zero without
printing its final line.  The last line of standard output is one JSON
object, ``{"ok": true, "device": {"platform", "kind", "count"}}``; every
other line comes before it.  One process drives the card(s).

The codec is integer-valued, so every comparison is bit-exact: words,
bit counts and decoded bytes, against the XLA route and against NumPy.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

#: (S, K) of the parity and timing checks: the 16 MiB block (S=128 rows
#: of K=131072 lanes, `TpuCodec.block_bytes`) and the reference's own
#: 100 KiB benchmark size (huffman_benchmark.cpp:19), which the codec
#: frames as K=1024 lanes of S=100.
REAL_SIZES = ((128, 131072), (100, 1024))
MIB = 1 << 20


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    """The cards' names and power limits, as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip()


# ---------------------------------------------------------------- inputs


def inputs(n: int) -> dict:
    """The parity corpora at ``n`` bytes, generated from fixed seeds:
    the reference's biased distribution, the same sorted, uniform bytes,
    and the in-repo text corpus (benchmarks/corpus.bin, tiled)."""
    from huffman_tpu.bench import workloads as wl

    biased = wl.biased_u8(n)
    return {
        "biased": biased,
        "sorted": np.sort(biased),
        "uniform": np.frombuffer(wl.uniform(n), np.uint8),
        "corpus": np.frombuffer(wl.file_data(None, n), np.uint8),
    }


def numpy_words(rows: np.ndarray, enc_table: np.ndarray, w32: int) -> np.ndarray:
    """(S, m) bytes of m lanes -> (w32, m) u32 wire words, bit by bit on
    the host: each code's bits MSB-first at its lane's running offset."""
    from huffman_tpu.constants import TPU_MAX_CODE_LEN as L

    ent = enc_table.astype(np.int64)[rows]
    lens, codes = ent & 15, ent >> 4  # codes left-aligned in L bits
    offs = np.cumsum(lens, axis=0) - lens
    s, m = rows.shape
    bits = np.zeros((m, w32 * 32), np.uint8)
    lane = np.broadcast_to(np.arange(m), (s, m))
    for j in range(L):
        sel = j < lens
        bits[lane[sel], (offs + j)[sel]] = (codes[sel] >> (L - 1 - j)) & 1
    return np.packbits(bits, axis=1).view(">u4").astype(np.uint32).T


class Programs:
    """Compiles each program once per argument signature, printing its
    compile time and ``compiled.memory_analysis()``."""

    def __init__(self):
        self._cache = {}

    def run(self, label: str, fn, *args):
        import jax

        key = (label,) + tuple(
            (getattr(a, "shape", None), str(getattr(a, "dtype", ""))) for a in args
        )
        compiled = self._cache.get(key)
        if compiled is None:
            t0 = time.perf_counter()
            compiled = jax.jit(fn).lower(*args).compile()
            dt = time.perf_counter() - t0
            log(f"  compile {label}: {dt:.3f} s; memory {compiled.memory_analysis()}")
            self._cache[key] = compiled
        return jax.block_until_ready(compiled(*args))


def _equal(name: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else "shape"
        raise AssertionError(f"{name}: mismatch ({bad} elements differ)")


# ---------------------------------------------------------------- phases


def device_phase(count: int):
    """Fail unless JAX's devices are GPUs (at least ``count``); print the
    cards, the JAX version, the compile cache and the native library."""
    import jax

    from huffman_tpu import native  # importing the package sets the cache dir

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {devs[0].platform}")
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX found {len(devs)}")
    log(card_line())
    log(f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    if native.load() is None:
        raise RuntimeError("native host library did not load (build/libhuffman_host.so)")
    log(f"native host library loaded: {native._SO}")
    return devs


def parity_phase(sizes=REAL_SIZES, interpret: bool = False) -> None:
    """Each GPU kernel against the XLA route and NumPy, bit-exact, at each
    (S, K) on every parity corpus; plus the XLA route's matmul primitives
    (histogram, 256-entry lookup) against NumPy on the card."""
    import jax
    import jax.numpy as jnp

    from huffman_tpu.constants import TPU_MAX_CODE_LEN as L
    from huffman_tpu.models.tpu_codec import _group
    from huffman_tpu.ops import route
    from huffman_tpu.ops.lookup import histogram256, lookup256
    from huffman_tpu.ops.table_build import build_coding_device

    progs = Programs()
    for s, k in sizes:
        n, w32 = s * k, (s * L + 31) // 32 + 1
        log(f"parity S={s} K={k} ({n} bytes)")
        for name, data in inputs(n).items():
            rows = data.reshape(s, k)
            x = jnp.asarray(data)
            # The histogram's f32 one-hot matmul may run in TF32 on the
            # card: its 0/1 operands are exact there, and its f32 sums stay
            # below 2**24, so it must equal a bincount exactly.
            hist = progs.run("histogram256", histogram256, x)
            _equal(f"{name} histogram", hist, np.bincount(data, minlength=256))
            # lookup256 splits entries into bytes <= 255 (exact bf16
            # operands) with f32 accumulation of one nonzero term each, so
            # it must equal a plain take for any entry below 2**24.
            tab = np.random.default_rng(s).integers(0, 1 << 24, 256).astype(np.int32)
            got = progs.run("lookup256", lookup256, jnp.asarray(rows.astype(np.int32)),
                            jnp.asarray(tab))
            _equal(f"{name} lookup256", got, tab[rows])

            t = build_coding_device(hist)
            enc = t["enc_table"]
            kw, kb = progs.run(
                "encode kernel",
                lambda b, e: route.encode_words(b, e, w32, kernels=True, interpret=interpret),
                x.reshape(s, k), enc,
            )
            xw, xb = progs.run(
                "encode xla",
                lambda b, e: route.encode_words(b, e, w32, kernels=False),
                x.reshape(s, k), enc,
            )
            _equal(f"{name} bit_counts kernel/xla", kb, xb)
            _equal(f"{name} words kernel/xla", kw, xw)
            enc_np = np.asarray(enc)
            _equal(f"{name} bit_counts kernel/numpy", kb, (enc_np[rows] & 15).sum(axis=0))
            lanes = np.arange(0, k, max(1, k // 2048))
            _equal(
                f"{name} words kernel/numpy ({len(lanes)} lanes)",
                np.asarray(kw)[:, lanes], numpy_words(rows[:, lanes], enc_np, w32),
            )

            w = max(1, int((np.asarray(kb).max() + 31) // 32))
            group = _group(int(t["l_min"]))
            dec_args = (kw[:w], t["e_bound"], t["g_rank"], t["sorted_syms"])
            ko = progs.run(
                "decode kernel",
                lambda *a: route.decode_rows(*a, out_len=s, group=1, kernels=True,
                                             interpret=interpret),
                *dec_args,
            )
            xo = progs.run(
                f"decode xla group={group}",
                lambda *a: route.decode_rows(*a, out_len=s, group=group, kernels=False),
                *dec_args,
            )
            _equal(f"{name} decode kernel/xla", ko, xo)
            _equal(f"{name} decode kernel/input", ko, rows)
            log(f"  {name}: bit-exact (ratio {n * 8 / int(np.asarray(kb).sum()):.4f})")


def device_api_phase(n_block: int = 16 * MIB, n_shared: int = 4,
                     batch: tuple = (64, 100 << 10)) -> None:
    """encode_device/decode_device on one block, build_tables +
    encode_device(tables=...) over several blocks, and encode_batch/
    decode_batch over a batch of small blocks."""
    import jax.numpy as jnp

    from huffman_tpu.bench.workloads import biased_u8
    from huffman_tpu.models.tpu_codec import TpuCodec

    c = TpuCodec()
    data = biased_u8(n_block)
    comp = c.encode_device(jnp.asarray(data))
    _equal("device round trip", c.decode_device(comp), data)
    log(f"device API: {n_block} bytes, K={comp.k}, round trip bit-exact")

    blocks = [biased_u8(n_block, seed=1 + i) for i in range(n_shared)]
    tables = c.build_tables(jnp.asarray(blocks[0][: max(1, n_block // 16)]))
    for i, b in enumerate(blocks):
        comp = c.encode_device(jnp.asarray(b), tables=tables)
        _equal(f"shared-table block {i}", c.decode_device(comp), b)
    log(f"device API: {n_shared} blocks under one shared table, bit-exact")

    nb_, nbytes = batch
    bb = np.stack([biased_u8(nbytes, seed=100 + i) for i in range(nb_)])
    words, bits, tabs = c.encode_batch(jnp.asarray(bb))
    out = np.asarray(c.decode_batch(words, bits, tabs, nbytes))
    _equal("batch round trip", out.reshape(nb_, -1)[:, :nbytes], bb)
    log(f"device API: batch of {nb_} x {nbytes} bytes, bit-exact")


def bytes_api_phase(sizes=(100 << 10, 16 * MIB, 64 * MIB), uniform_n: int = 16 * MIB,
                    block_bytes: int | None = None, ref_n: int = MIB) -> None:
    """TpuCodec.compress/decompress at each size (the largest through the
    block container), the edge-case probes, the CLI and the ref profile."""
    from huffman_tpu import cli, container, golden
    from huffman_tpu.bench.workloads import biased_u8, uniform
    from huffman_tpu.models.jax_codec import JaxCodec
    from huffman_tpu.models.tpu_codec import TpuCodec

    def codec(k=None):
        c = TpuCodec(k)
        if block_bytes is not None:
            c.block_bytes = block_bytes
        return c

    c = codec()
    for n in sizes:
        raw = biased_u8(n, seed=7).tobytes()
        blob = c.compress(raw)
        if c.decompress(blob) != raw:
            raise AssertionError(f"bytes round trip mismatch at {n}")
        framed = "container" if blob[:4] == container.MAGIC else "single blob"
        if (n > c.block_bytes) != (framed == "container"):
            raise AssertionError(f"{n} bytes framed as {framed}")
        log(f"bytes API: {n} bytes -> {len(blob)} ({framed}), ratio {n / len(blob):.4f}")

    for raw in (b"", b"x", b"a" * 100000):
        if c.decompress(c.compress(raw)) != raw:
            raise AssertionError(f"probe of {len(raw)} bytes failed")
    raw = uniform(uniform_n)
    blob = c.compress(raw)
    kinds = {kind for kind, *_ in container.parse_records(blob)[2]}
    if container.KIND_STORED not in kinds or c.decompress(blob) != raw:
        raise AssertionError("uniform input did not round-trip as a stored record")
    raw = biased_u8(min(100 << 10, c.block_bytes), seed=8).tobytes()
    blob = c.compress(raw)  # one HTP3 blob, no container
    if codec(2048).decompress(blob) != raw:
        raise AssertionError("cross-K decode failed (K is read from the header)")
    try:
        c.decompress(b"XXXX" + blob[4:])
    except ValueError:
        pass
    else:
        raise AssertionError("tampered magic was accepted")
    if c.serialize(c.deserialize(blob)) != blob:
        raise AssertionError("serialize(deserialize(b)) != b")
    log("bytes API probes: empty, 1 byte, single symbol, uniform->stored, "
        "cross-K, tampered magic, reserialize: ok")

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "in.bin")
        with open(path, "wb") as f:
            f.write(biased_u8(MIB, seed=9).tobytes())
        cli.main(["roundtrip", path, "--profile", "tpu"])

    raw = biased_u8(ref_n, seed=10).tobytes()
    for k in (32, 1024):  # 32 streams run natively; 1024 on the device
        jc = JaxCodec(k)
        blob = jc.compress(raw)
        if blob != golden.compress(raw, k) or jc.decompress(blob) != raw:
            raise AssertionError(f"ref profile K={k} differs from the golden model")
    log(f"ref profile: JaxCodec(32) and JaxCodec(1024) at {ref_n} bytes match golden")


def _median_spread(xs):
    q = statistics.quantiles(xs, n=4)
    return statistics.median(xs), q[2] - q[0]


def _time_calls(fn, calls: int) -> float:
    import jax

    t0 = time.perf_counter()
    for _ in range(calls):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / calls * 1e3


def _device_ms(fn, calls: int = 5) -> float:
    """Device busy time per call: the summed durations of the operations
    a profiler trace records on the GPU's streams, over ``calls`` calls."""
    import glob

    import jax

    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            for _ in range(calls):
                jax.block_until_ready(fn())
        path = sorted(glob.glob(os.path.join(td, "plugins", "profile", "*", "*.xplane.pb")))[-1]
        prof = jax.profiler.ProfileData.from_file(path)
    ns = sum(
        ev.duration_ns
        for plane in prof.planes if "/device:GPU" in plane.name
        for line in plane.lines if "stream" in line.name.lower()
        for ev in line.events
    )
    return ns / 1e6 / calls


def timing_phase(card: str, rounds: int = 15, calls: int = 20) -> None:
    """Informational: kernel route vs XLA route end to end on the device
    API programs (encode_device's and decode_device's), interleaved
    kernel, XLA, XLA, kernel, on the host clock and as device busy time
    from a profiler trace; then the stages of encode_device alone."""
    import jax
    import jax.numpy as jnp

    from huffman_tpu.bench.workloads import biased_u8
    from huffman_tpu.constants import TPU_MAX_CODE_LEN as L
    from huffman_tpu.models import tpu_codec as tc
    from huffman_tpu.ops import route
    from huffman_tpu.ops.table_build import build_coding_device

    for s, k in REAL_SIZES:
        n, w32 = s * k, (s * L + 31) // 32 + 1
        data = biased_u8(n)
        d = jnp.asarray(data)
        c = tc.TpuCodec()
        if c._lanes(n) != k:
            raise AssertionError(f"codec frames {n} bytes as K={c._lanes(n)}, not {k}")
        comp = c.encode_device(d)
        group, w = tc.decode_statics(comp.meta(), s)
        hs = c._hist_stride(n)
        t = comp.tables
        words = jnp.concatenate(
            [comp.words, jnp.zeros((max(0, w - comp.words.shape[0]), k), jnp.uint32)]
        )
        enc = {
            kern: (lambda kern=kern: tc._encode_full(d, s, k, w32, kern, hs))
            for kern in (True, False)
        }
        dec = {
            kern: (lambda kern=kern: tc._decode_full(
                words, t["e_bound"], t["g_rank"], t["sorted_syms"], s, n, group, w, kern))
            for kern in (True, False)
        }
        _equal("timing encode arms", enc[True]()[0], enc[False]()[0])
        _equal("timing decode arms", dec[True](), dec[False]())
        for what, fns in (("encode_device", enc), ("decode_device", dec)):
            samples = {True: [], False: []}
            for _ in range(rounds):
                for kern in (True, False, False, True):
                    samples[kern].append(_time_calls(fns[kern], calls))
            mk, sk = _median_spread(samples[True])
            mx, sx = _median_spread(samples[False])
            log(f"timing [{card}] {what} {n} bytes biased (S={s}, K={k}): "
                f"kernel {mk:.4f} ms (IQR {sk:.4f}), XLA {mx:.4f} ms (IQR {sx:.4f}), "
                f"{len(samples[True])} samples x {calls} calls each, medians")
            busy = {kern: [] for kern in (True, False)}
            for kern in (True, False, False, True):
                busy[kern].append(_device_ms(fns[kern]))
            log(f"timing [{card}] {what} {n} bytes device busy per call: "
                f"kernel {min(busy[True]):.4f} ms, XLA {min(busy[False]):.4f} ms "
                f"(profiler trace, lower of two traces of 5 calls)")

        hist_fn = jax.jit(lambda x: tc._table_hist(x, hs))
        hist = hist_fn(d)  # n == s * k: no padding
        eb, gr, sy = t["e_bound"], t["g_rank"], t["sorted_syms"]
        stages = {
            "histogram": (hist_fn, (d,)),
            "table build": (build_coding_device, (hist,)),
        }
        for kern, name in ((True, "kernel"), (False, "XLA")):
            stages[f"encode body ({name})"] = (
                jax.jit(lambda b, e, kern=kern: route.encode_words(
                    b, e, w32, kernels=kern)),
                (d.reshape(s, k), t["enc_table"]),
            )
            stages[f"decode body ({name})"] = (
                jax.jit(lambda wd, e, g, y, kern=kern: route.decode_rows(
                    wd, e, g, y, out_len=s, group=group, kernels=kern)),
                (words[:w], eb, gr, sy),
            )
        for label, (fn, args) in stages.items():
            jax.block_until_ready(fn(*args))
            ts = [_time_calls(lambda: fn(*args), calls) for _ in range(rounds)]
            m, sp = _median_spread(ts)
            busy = _device_ms(lambda: fn(*args))
            log(f"timing [{card}] stage {label} at {n} bytes: {m:.4f} ms host clock "
                f"(IQR {sp:.4f}), device busy {busy:.4f} ms")


def four_phase(n_block: int = 16 * MIB, k: int = 131072, n_devices: int = 4) -> None:
    """The sharded path on a ('data', 'stream') mesh of four devices, with
    stream = 1 and 2, checked bit-exact and against the single-device
    codec in both directions; every shard must sit on its own device."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from huffman_tpu import container
    from huffman_tpu.bench.workloads import biased_u8
    from huffman_tpu.constants import TPU_MAX_CODE_LEN as L
    from huffman_tpu.models.tpu_codec import TpuCodec
    from huffman_tpu.parallel.sharded import ShardedCodec, make_mesh, sharded_roundtrip

    devs = jax.devices()[:n_devices]
    s = n_block // k
    w32 = (s * L + 31) // 32 + 1
    data = np.stack([biased_u8(n_block, seed=20 + i) for i in range(n_devices)])
    raw = data.tobytes()
    for stream in (1, 2):
        mesh = make_mesh(devices=devs, stream=stream)
        blocks = jax.device_put(data, NamedSharding(mesh, P("data", "stream")))
        t0 = time.perf_counter()
        out, bits, words = jax.block_until_ready(
            sharded_roundtrip(blocks, mesh=mesh, k=k, s=s, w32=w32))
        dt = time.perf_counter() - t0
        _equal(f"sharded roundtrip stream={stream}", out, data)
        for name, arr in (("decoded", out), ("bit counts", bits), ("words", words)):
            placed = {sh.device for sh in arr.addressable_shards}
            if placed != set(devs):
                raise AssertionError(f"{name} shards sit on {placed}, not on all {n_devices}")
        t0 = time.perf_counter()
        jax.block_until_ready(sharded_roundtrip(blocks, mesh=mesh, k=k, s=s, w32=w32))
        log(f"sharded_roundtrip stream={stream}: {n_devices} x {n_block} bytes bit-exact, "
            f"one shard per device; first call {dt:.2f} s, second {time.perf_counter() - t0:.4f} s")

        sc = ShardedCodec(mesh=mesh, block_bytes=n_block, k=k)
        blob = sc.compress(raw)
        if sc.decompress(blob) != raw:
            raise AssertionError(f"ShardedCodec round trip stream={stream}")
        if TpuCodec().decompress(blob) != raw:
            raise AssertionError("single-device decode of the sharded container")
        single = container.compress_blocks(raw, TpuCodec(k), n_block)
        if sc.decompress(single) != raw:
            raise AssertionError("sharded decode of the single-device container")
        log(f"ShardedCodec stream={stream}: {len(raw)} bytes -> {len(blob)}, "
            "interop with TpuCodec both ways")
    for d in devs:
        stats = d.memory_stats() or {}
        log(f"  {d}: peak {stats.get('peak_bytes_in_use', 'n/a')} bytes")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    devs = device_phase(4 if args.four else 1)
    card = card_line().splitlines()[0]
    if args.four:
        four_phase()
    else:
        parity_phase()
        device_api_phase()
        bytes_api_phase()
        timing_phase(card)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

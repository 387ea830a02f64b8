"""Data/stream-parallel block codec over a ``jax.sharding.Mesh``.

The reference is strictly single-core (SURVEY.md §2: no threads, no NCCL);
its only parallelism is K in-core streams.  This module adds two device
axes, as one fully-jitted ``shard_map`` step:

* ``data`` axis — independent blocks, embarrassingly parallel (the "new: DP
  over blocks" row of SURVEY.md §2's parallelism table).
* ``stream`` axis — the K lanes of a *single* block sharded across devices.
  All shards must agree on one shared code table, so per-shard histograms
  are ``psum``-reduced over ``stream`` (the distributed analog of the
  reference's histogram-merge loop, codec/huffman.cpp:762-766) and every
  shard runs the identical device table build (replicated compute instead
  of a host broadcast — the table build is O(256 log 256)).

Because the table builder itself is jittable (ops/table_build.py), the
entire histogram -> psum -> table -> encode -> decode step compiles to ONE
XLA program: zero host syncs; the one collective is the 1 KiB histogram
psum.  On GPUs the per-shard encode and decode are the Triton kernels, the
same rule as the single-device codec (ops/route.py).

Layout: within each shard the lane framing is STRIDED, matching the
single-device tpu profile — ``block.reshape(s, k_local)``, local byte b ->
lane ``b % k_local``, row ``b // k_local`` (see ``_shard_encode_one``).
The host-side ``_permute_in``/``_permute_out`` hand shard c exactly the
global strided byte subset for lanes ``[c*k_local, (c+1)*k_local)``, so
shard-local streams equal the global tpu-profile lane map and
sharded-compressed blobs are standard HTP3 blocks.  The permutation is a
host reshape/transpose; no device resharding collective is needed on
either side of the step.

Per-lane exact bit counts (the huffman.cpp:770-786 sizing trick) come back
sharded the same way, so global serialization offsets need only a tiny
all-gather of per-shard counts, never a payload reshuffle.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..constants import TPU_MAX_CODE_LEN as MAX_CODE_LEN
from ..ops import route
from ..ops.lookup import histogram256
from ..ops.table_build import build_coding_device


def make_mesh(devices=None, axis_names=("data", "stream"), stream=1) -> Mesh:
    """Mesh over all (or given) devices: ``data`` × ``stream``.

    ``stream`` divides the device count; the rest goes to ``data``.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    assert n % stream == 0, (n, stream)
    return Mesh(devices.reshape(n // stream, stream), axis_names)


def _shard_encode_one(block, k_local, s, w32, kernels):
    """One block shard -> (words32, bit_counts, tables) with the SHARED
    table (psum'd histogram over the 'stream' axis, huffman.cpp:762-766
    distributed).

    Framing is STRIDED within the shard (local byte b -> lane b % k_local,
    row b // k_local), so when the host hands shard c the global strided
    byte subset for lanes [c*k_local, (c+1)*k_local) the per-lane streams
    equal the single-device tpu profile's exactly — sharded-compressed
    blobs are standard HTP3 blocks (see ShardedCodec.compress)."""
    hist = jax.lax.psum(histogram256(block), "stream")
    t = build_coding_device(hist)
    words32, bit_counts = route.encode_words(
        block.reshape(s, k_local), t["enc_table"], w32, kernels=kernels
    )
    return words32, bit_counts, t


@functools.partial(jax.jit, static_argnames=("mesh", "k", "s", "w32"))
def sharded_encode(data, *, mesh, k, s, w32):
    """Sharded compress step: one program over the ('data','stream') mesh.

    Args/returns mirror `sharded_roundtrip`'s encode half; per-block table
    metadata comes back replicated over 'stream' (P('data', None)) so the
    host can serialize each block without further collectives — the
    distributed form of the reference's exact-offsets trick
    (huffman.cpp:770-786): per-lane bit counts are exact, so all
    serialization offsets are computable with zero payload reshuffles.
    """
    k_local = k // mesh.shape["stream"]
    kernels = route.gpu_kernels()

    def step(blocks):
        def one(block):
            words32, bit_counts, t = _shard_encode_one(
                block, k_local, s, w32, kernels
            )
            return (
                words32,
                bit_counts,
                t["len_count"],
                t["sorted_syms"],
                t["num_syms"],
            )

        return jax.vmap(one)(blocks)

    spec_in = P("data", "stream")
    return shard_map(
        step,
        mesh=mesh,
        in_specs=(spec_in,),
        out_specs=(
            P("data", None, "stream"),
            P("data", "stream"),
            P("data", None),
            P("data", None),
            P("data"),
        ),
        check_vma=True,
    )(data)


@functools.partial(jax.jit, static_argnames=("mesh", "k", "s", "w", "group"))
def sharded_decode(words, e_bound, g_rank, syms, *, mesh, k, s, w, group):
    """Sharded decompress step: blocks over 'data', lanes over 'stream'.

    Args:
      words: (B, W, k) uint32, sharded P('data', None, 'stream').
      e_bound/g_rank/syms: per-block decode constants, (B, ...), sharded
        P('data', None) — identical on every stream shard.
    Returns:
      (B, N) uint8 decoded shard-local strided bytes.
    """
    kernels = route.gpu_kernels()

    def step(wds, eb, gr, sy):
        def one(wv, eb1, gr1, sy1):
            wt = jax.lax.slice_in_dim(wv, 0, max(w, 1), axis=0)
            out = route.decode_rows(
                wt, eb1, gr1, sy1, out_len=s, group=group, kernels=kernels
            )
            return out.reshape(-1)

        return jax.vmap(one)(wds, eb, gr, sy)

    return shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P("data", None, "stream"),
            P("data", None),
            P("data", None),
            P("data", None),
        ),
        out_specs=P("data", "stream"),
        check_vma=True,
    )(words, e_bound, g_rank, syms)


@functools.partial(jax.jit, static_argnames=("mesh", "k", "s", "w32", "group"))
def sharded_roundtrip(data, *, mesh, k, s, w32, group=1):
    """Fully-jitted sharded compress+decompress step.

    Args:
      data: (B, N) uint8, N = k*s, sharded (or shardable) as
        ``P('data', 'stream')``.
      mesh: the ('data', 'stream') Mesh (static).
      k: total lanes per block; k % mesh.shape['stream'] == 0.
      s: bytes per lane.
      w32: static payload words per lane (>= ceil(s*MAX_CODE_LEN/32)+1 for
        worst case; smaller only if the data is known compressible).
      group: static staging-group width for the XLA bit-serial decoder
        (1 is always safe; the GPU kernel ignores it).

    Returns:
      decoded: (B, N) uint8 — must equal ``data``.
      bit_counts: (B, k) int32 exact compressed bits per lane.
      words: (B, w32, k) uint32 lane-transposed payload shards.
    """
    k_local = k // mesh.shape["stream"]
    kernels = route.gpu_kernels()

    def step(blocks):  # blocks: (B_local, k_local * s) u8
        def one(block):
            words32, bit_counts, t = _shard_encode_one(
                block, k_local, s, w32, kernels
            )
            out = route.decode_rows(
                words32, t["e_bound"], t["g_rank"], t["sorted_syms"],
                out_len=s, group=group, kernels=kernels,
            )
            return out.reshape(-1), bit_counts, words32

        return jax.vmap(one)(blocks)

    spec_in = P("data", "stream")
    out, bits, words = shard_map(
        step,
        mesh=mesh,
        in_specs=(spec_in,),
        out_specs=(spec_in, P("data", "stream"), P("data", None, "stream")),
        # vma checking stays ON (the loop carries in table_build/decode_bits
        # derive their zeros from data, not literals, so inference passes).
        check_vma=True,
    )(data)
    return out, bits, words


class ShardedCodec:
    """Block-data-parallel codec facade for multi-device runs.

    Splits an input byte stream into fixed-size blocks, shards them over the
    mesh, and runs the one-program roundtrip/encode step.  Host-side
    serialization walks the (already exact) per-lane bit counts, so framing
    adds no device syncs beyond fetching results.
    """

    def __init__(self, mesh=None, block_bytes=1 << 20, k=4096):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.block_bytes = block_bytes
        self.k = k
        assert block_bytes % k == 0
        self.s = block_bytes // k

    def roundtrip(self, data: np.ndarray):
        """Pad to whole blocks, run the sharded step, return decoded bytes."""
        n = data.shape[0]
        bb = self.block_bytes
        nb = -(-max(n, 1) // bb)
        d_axis = self.mesh.shape["data"]
        nb = -(-nb // d_axis) * d_axis  # whole blocks per data shard
        padded = np.zeros(nb * bb, np.uint8)
        padded[:n] = data
        # Host permutation makes the shard-local strided framing equal the
        # GLOBAL tpu-profile lane map, so bits/words are identical for any
        # mesh shape (and to the single-device codec's).
        # Host arrays go straight to their shards (no staging copy on one
        # device).
        blocks = self._permute_in(padded.reshape(nb, bb))
        sharding = NamedSharding(self.mesh, P("data", "stream"))
        blocks = jax.device_put(blocks, sharding)
        w32 = (self.s * MAX_CODE_LEN + 31) // 32 + 1
        out, bits, words = sharded_roundtrip(
            blocks, mesh=self.mesh, k=self.k, s=self.s, w32=w32
        )
        out = self._permute_out(np.asarray(out))
        return out.reshape(-1)[:n], bits, words

    # ---------- bytes API (standard HTP3 container, mesh-accelerated) ----------

    def _n_stream(self) -> int:
        return self.mesh.shape["stream"]

    def _permute_in(self, blocks: np.ndarray) -> np.ndarray:
        """(B, N) -> shard layout whose local strided framing equals the
        GLOBAL tpu-profile strided lane map: shard c's local (s, k_local)
        cell (r, j) holds global byte r*k + c*k_local + j.  Blobs built
        from the sharded encode are therefore byte-identical standard
        HTP3 blocks, decodable by a single-device TpuCodec (and vice
        versa)."""
        b, n = blocks.shape
        ns, kl = self._n_stream(), self.k // self._n_stream()
        return (
            blocks.reshape(b, self.s, ns, kl)
            .transpose(0, 2, 1, 3)
            .reshape(b, n)
        )

    def _permute_out(self, blocks: np.ndarray) -> np.ndarray:
        b, n = blocks.shape
        ns, kl = self._n_stream(), self.k // self._n_stream()
        return (
            blocks.reshape(b, ns, self.s, kl)
            .transpose(0, 2, 1, 3)
            .reshape(b, n)
        )

    def compress(self, raw: bytes) -> bytes:
        """Compress to the standard block container via ONE mesh program.

        Every record is a normal tpu-profile (HTP3) blob — the output is
        bit-compatible with `TpuCodec.decompress`; the mesh only changes
        WHERE the work runs."""
        from .. import container
        from ..models.tpu_codec import TpuCodec, TpuCompressed

        n = len(raw)
        bb = self.block_bytes
        if n == 0:
            return container.pack(
                [(container.KIND_HUFF, 0, b""), container.crc_record(b"")], bb
            )
        nb = -(-n // bb)
        d_axis = self.mesh.shape["data"]
        nb_pad = -(-nb // d_axis) * d_axis
        padded = np.zeros(nb_pad * bb, np.uint8)
        padded[:n] = np.frombuffer(raw, np.uint8)
        blocks = self._permute_in(padded.reshape(nb_pad, bb))
        sharding = NamedSharding(self.mesh, P("data", "stream"))
        w32 = (self.s * MAX_CODE_LEN + 31) // 32 + 1
        words, bits, lc, ss, ns_arr = sharded_encode(
            jax.device_put(blocks, sharding),
            mesh=self.mesh,
            k=self.k,
            s=self.s,
            w32=w32,
        )
        words = np.asarray(words)
        bits = np.asarray(bits)
        lc, ss, ns_arr = np.asarray(lc), np.asarray(ss), np.asarray(ns_arr)

        tc = TpuCodec(self.k)
        records = []
        for b in range(nb):
            raw_len = min(bb, n - b * bb)
            comp = TpuCompressed(
                words=words[b],
                bit_counts=bits[b],
                raw_size=bb,
                k=self.k,
                tables={
                    "len_count": lc[b],
                    "sorted_syms": ss[b],
                    "num_syms": ns_arr[b],
                },
            )
            blob = tc.serialize(comp)
            if len(blob) >= raw_len + 8:
                records.append(
                    (container.KIND_STORED, raw_len, raw[b * bb : b * bb + raw_len])
                )
            else:
                records.append((container.KIND_HUFF, raw_len, blob))
        records.append(container.crc_record(raw))
        return container.pack(records, bb)

    def decompress(self, blob: bytes) -> bytes:
        """Decode a block container with ONE sharded program for all the
        uniform tpu-profile records; stored/ref-profile/degenerate/
        foreign-shaped records are decoded host-side per record (the
        shared `container.decode_record` path)."""
        from .. import container
        from ..models.tpu_codec import TpuCodec

        _bs, total_raw, records = container.parse_records(blob)

        tc = TpuCodec(self.k)
        outs: list[bytes | None] = [None] * len(records)
        batch = []  # (idx, TpuCompressed)
        for i, (kind, kx, raw_len, rec) in enumerate(records):
            if kind != container.KIND_HUFF or raw_len == 0:
                outs[i] = container.decode_record(kind, kx, raw_len, rec, tc)
                continue
            comp = tc.deserialize(rec)
            m = comp.meta()
            if (
                comp.k != self.k
                or comp.raw_size != self.block_bytes
                or m["num_syms"] <= 1
            ):
                # Degenerate or foreign-shaped block: single-block path.
                outs[i] = np.asarray(tc.decode_device(comp)).tobytes()[:raw_len]
            else:
                batch.append((i, comp))

        if batch:
            d_axis = self.mesh.shape["data"]
            nbatch = len(batch)
            nb_pad = -(-nbatch // d_axis) * d_axis
            w = max(
                (c.meta()["max_bits"] + 31) // 32 for _, c in batch
            )
            w = max(w, 1)
            group = min(
                max(g for g in (1, 2, 3, 4, 6, 8) if g <= max(1, c.meta()["l_min"]))
                for _, c in batch
            )
            wordsb = np.zeros((nb_pad, w, self.k), np.uint32)
            ebb = np.zeros((nb_pad, MAX_CODE_LEN + 2), np.int32)
            grb = np.zeros((nb_pad, MAX_CODE_LEN + 1), np.int32)
            syb = np.zeros((nb_pad, 256), np.int32)
            for j, (_, c) in enumerate(batch):
                wv = np.asarray(c.words)[:w]
                wordsb[j, : wv.shape[0]] = wv
                ebb[j] = np.asarray(c.tables["e_bound"])
                grb[j] = np.asarray(c.tables["g_rank"])
                syb[j] = np.asarray(c.tables["sorted_syms"])
            sh_w = NamedSharding(self.mesh, P("data", None, "stream"))
            sh_t = NamedSharding(self.mesh, P("data", None))
            dec = sharded_decode(
                jax.device_put(wordsb, sh_w),
                jax.device_put(ebb, sh_t),
                jax.device_put(grb, sh_t),
                jax.device_put(syb, sh_t),
                mesh=self.mesh,
                k=self.k,
                s=self.s,
                w=w,
                group=group,
            )
            dec = self._permute_out(np.asarray(dec)[:nbatch])
            for j, (i, _) in enumerate(batch):
                outs[i] = dec[j].tobytes()[: records[i][2]]

        out = b"".join(o for o in outs if o is not None)
        if len(out) != total_raw:
            raise ValueError(
                f"container truncated: decoded {len(out)} of {total_raw} bytes"
            )
        container.check_crc(records, out)
        return out

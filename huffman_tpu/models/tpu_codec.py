"""Large-K lane-parallel codec (the ``tpu`` format profile).

The performance profile of the framework.  The profile's name is the name
of its wire format (magic ``HTP3``), not of the hardware it runs on; it
runs on any JAX backend, with GPU kernels on a GPU (ops/route.py).
Differences from the ``ref`` profile:

* **K is large** (thousands): the device wants thousands of independent
  streams where Zen 5's zmm registers cap the reference at 48
  (README.md:15-27).
* **Equal lane slices by zero-padding**: input is padded to ``K*S`` bytes
  so lane framing is a pure reshape — byte i goes to lane i % K, row
  i // K.  The pad (< K bytes) is encoded like real data; ``raw_size``
  trims it on decode.
* **Lane-transposed word payload**: the in-memory compressed form is a
  dense (W, K) uint32 matrix — word ``w`` of every lane in one row, forward
  bit order, MSB-first.  Neighbouring lanes' words sit side by side, so a
  block of lanes reads and writes contiguous memory.
* **Exact per-lane bit counts** in the header (the serialized analog of the
  reference's precomputed end offsets, huffman.cpp:770-786).
* **Zero host syncs on encode**: histogram, canonical table construction
  (ops/table_build.py), encoding, and packing compile into one program.
  Host metadata (max bits, l_min) is fetched lazily, once, on first use.

The encode and decode kernels come from one rule (ops/route.py): the
Pallas-Triton kernels on a GPU, the pure-XLA kernels (ops/encode.py,
ops/decode_bits.py) everywhere else, with bit-identical results — the
analog of the reference's scalar/AVX shared format (README.md:91-94).

Serialized layout (little-endian; flags live in the top byte of the
len_mask word — bit 24 = wide legacy counts, bit 25 = compact format):

    u32 magic 'HTP3' | u32 raw_size | u32 K | u32 len_mask|flags
    u8  count[popcount(len_mask)]   (256 wraps to 0, as ref profile)
    u8  syms[num_syms]

  compact (flag bit 25, the round-5 default — written by `serialize`):
    u32 base | u8 width            (base = min lane bits)
    bit-packed deltas[K] at `width` bits each, MSB-first, byte-padded
    bit-packed payload: lane k's first bits_k stream bits, concatenated
    lane-major with NO per-lane byte rounding, final byte zero-padded

  huff counts (flag bits 25+26 — written when it wins the size race):
    u32 base | u8 width | u32 clen
    ref-profile blob[clen]: the K delta bytes min(delta, 255),
      compressed by the codec's OWN ref-profile path (native C++ with
      the golden NumPy fallback — bit-identical blobs by invariant), 8
      streams.  The reference's own varint TODO (huffman.cpp:793) taken
      one step further: the header is entropy-coded by the codec itself.
    bit-packed escapes: one `width`-bit raw delta per decoded 255 byte
    bit-packed payload (as compact)

  legacy (flag bit 25 clear — all pre-round-5 blobs; still parsed):
    pad to 2B | u16 bit_counts[K]   (u32 when flag bit 24 is set —
                                     worst-case lane bits >= 2^16)
    u8  payload[sum_k ceil(bits_k/8)]  (lane-major, byte-granular)

The legacy per-lane overhead was ~2.5 bytes (u16 count + ~3.5 wasted
bits of final-byte rounding) — ~4.3% of a biased 16 MiB blob at
K=131072.  The compact layout stores the same information in ~width/8
bytes per lane (width ≈ 9–11 on real data, since lane bit counts
cluster around the per-lane mean under the strided mapping) and zero
rounding waste, reclaiming ~3% of the blob at unchanged kernel cost.
The reference flags the identical waste in its own (K-1)*u32 offset
framing ("TODO: Use varints", huffman.cpp:793, 1062, 1301).
"""

from __future__ import annotations

import dataclasses
import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np

from .. import coding
# The tpu profile limits codes at TPU_MAX_CODE_LEN (15): deeper than the
# reference's 12 because this profile's decoder is table-free and its
# header mask has room — see constants.py.  Wire compat: the serialized
# layout stores only len_count + payload bits, so 12-limited blobs from
# earlier builds parse and decode unchanged through the 15-sized tables.
from ..constants import TPU_MAX_CODE_LEN as MAX_CODE_LEN
from ..ops import route
from ..ops.decode_bits import decode_tables_bitserial
from ..ops.lookup import histogram256
from ..ops.table_build import build_coding_device

MAGIC = 0x48545033  # 'HTP3'
#: Header flag (top byte of the len_mask word): compact bit counts +
#: bit-granular payload.  Bit 24 stays the legacy wide-counts flag.
FLAG_COMPACT = 1 << 25
#: With FLAG_COMPACT: the count deltas ride as a ref-profile blob
#: (entropy-coded by the codec's own host path) + raw escapes.
FLAG_HUFF_COUNTS = 1 << 26
#: Stream count for the embedded counts blob: small enough that its
#: (k-1) u32 end offsets stay negligible, large enough for the native
#: runtime to thread the decode.
_HUFF_COUNTS_STREAMS = 8


def _pack_lane_bits(lane_bytes: np.ndarray, bits: np.ndarray) -> bytes:
    """Concatenate lane k's first ``bits[k]`` bits (MSB-first within each
    byte) into one bit-granular stream with no per-lane byte rounding.

    Vectorized without an 8x ``unpackbits`` blow-up: mask each lane's
    tail garbage, shift each lane's byte string right by its output bit
    phase (``off_k % 8``) in one broadcast u16 op, then observe that the
    bytes each lane exclusively owns (all but a lane's first byte when it
    shares that byte with its predecessor) tile the output exactly in
    row-major order — a single boolean select builds the stream, and the
    <=K shared boundary bytes are OR-accumulated on top.
    """
    k, nb = lane_bytes.shape
    bits = bits.astype(np.int64)
    off = np.zeros(k, np.int64)
    np.cumsum(bits[:-1], out=off[1:])
    total = int(off[-1] + bits[-1]) if k else 0
    if total == 0:
        return b""
    out_len = (total + 7) >> 3

    # Zero every bit past bits_k: a nonzero tail would OR garbage into
    # the next lane's leading bits through the shared boundary byte.
    nbytes = (bits + 7) >> 3
    rem = (bits & 7).astype(np.uint16)
    j = np.arange(nb, dtype=np.int64)[None, :]
    b = np.where(j < nbytes[:, None], lane_bytes, 0).astype(np.uint16)
    tail_mask = ((0xFF00 >> rem) & 0xFF).astype(np.uint16)  # rem=0 -> 0xFF
    lb = np.maximum(nbytes - 1, 0)
    b[np.arange(k), lb] &= np.where(rem > 0, tail_mask, 0xFF)

    s = (off & 7).astype(np.uint16)
    start = off >> 3
    zlen = np.where(bits > 0, (bits + s + 7) >> 3, 0)
    # z[k, j] = byte j of lane k's segment shifted right by s_k:
    # (prev << (8-s)) | (cur >> s), via a 16-bit window.
    bp = np.zeros((k, nb + 2), np.uint16)
    bp[:, 1 : nb + 1] = b
    z = (((bp[:, :-1] << 8) | bp[:, 1:]) >> s[:, None]).astype(np.uint8)
    jz = np.arange(nb + 1, dtype=np.int64)[None, :]
    shared = (s > 0) & (bits > 0)  # first byte straddles the predecessor
    keep = (jz >= shared[:, None]) & (jz < zlen[:, None])
    out = z[keep]
    if out.size != out_len:  # internal invariant, not an input error
        raise AssertionError(f"packed {out.size} bytes, expected {out_len}")
    np.bitwise_or.at(out, start[shared], z[shared, 0])
    return out.tobytes()


def _unpack_lane_bits(
    stream: np.ndarray, bits: np.ndarray, nb_out: int
) -> np.ndarray:
    """Inverse of :func:`_pack_lane_bits`: split a bit-granular stream
    back into per-lane byte strings of ``nb_out`` bytes (tail zeroed).

    One fancy-index gather of each lane's touched stream bytes plus a
    broadcast u16 left-shift by the lane's bit phase; no unpackbits.
    """
    k = bits.shape[0]
    bits = bits.astype(np.int64)
    off = np.zeros(k, np.int64)
    np.cumsum(bits[:-1], out=off[1:])
    s = (off & 7).astype(np.uint16)
    start = off >> 3
    nbytes = (bits + 7) >> 3
    cols = int(nbytes.max(initial=0)) + 1
    pad_len = int(start.max(initial=0)) + cols + 1
    padded = np.zeros(pad_len, np.uint8)
    padded[: stream.shape[0]] = stream[:pad_len]
    idx = start[:, None] + np.arange(cols, dtype=np.int64)[None, :]
    z = padded[idx].astype(np.uint16)
    # lane byte i = ((z[i] << 8 | z[i+1]) >> (8 - s)) & 0xFF  (s=0 -> z[i])
    grid = ((((z[:, :-1] << 8) | z[:, 1:]) >> (8 - s)[:, None]) & 0xFF).astype(
        np.uint8
    )
    lane_bytes = np.zeros((k, nb_out), np.uint8)
    j = np.arange(cols - 1, dtype=np.int64)[None, :]
    valid = j < nbytes[:, None]
    lane_bytes[:, : cols - 1] = np.where(valid, grid, 0)
    # Zero the bits past bits_k in each lane's final byte (they belong to
    # the next lane) so parsed words match compress-produced words.
    rem = (bits & 7).astype(np.uint16)
    tail_mask = ((0xFF00 >> rem) & 0xFF).astype(np.uint8)
    lb = np.maximum(nbytes - 1, 0)
    lane_bytes[np.arange(k), np.minimum(lb, nb_out - 1)] &= np.where(
        (rem > 0) & (bits > 0), tail_mask, 0xFF
    ).astype(np.uint8)
    return lane_bytes


@jax.jit
def _meta_pack(bit_counts, len_count, num_syms, sorted_syms):
    """Pack every host-needed metadata scalar into one int32 vector:
    [max_bits, num_syms, len_count[0:14], sorted_syms[0:256]] — fetched
    by `TpuCompressed.meta` in a single device->host transfer."""
    head = jnp.stack(
        [jnp.max(bit_counts), num_syms.astype(jnp.int32)]
    ).astype(jnp.int32)
    return jnp.concatenate(
        [head, len_count.astype(jnp.int32), sorted_syms.astype(jnp.int32)]
    )


def default_lanes(n: int) -> int:
    """Lane count heuristic: ~128 B per lane, clamped to [8, 2**17].

    S (bytes per lane) near 128 keeps each lane's serial walk short;
    inputs beyond 16 MiB grow S instead, so the bytes API frames them as
    16 MiB blocks (`TpuCodec.block_bytes`).
    """
    if n <= 0:
        return 8
    # Small inputs scale K down (8 minimum) — per-lane header overhead
    # would otherwise dominate.
    k = 1 << max(3, min(17, (-(-n // 128)).bit_length() - 1))
    if k < 1024 and n >= 64 << 10:
        # From 64 KiB on, at least 1024 lanes: twice the lanes (so half
        # the serial steps per lane) for ~1% more wire overhead
        # (2 B/lane x 512 lanes at 100 KiB).
        k = 1024
    return k


@dataclasses.dataclass
class TpuCompressed:
    """In-memory (device-resident) compressed block."""

    words: jax.Array  # (W, K) uint32 lane-transposed payload
    bit_counts: jax.Array  # (K,) int32
    raw_size: int
    k: int
    tables: dict  # device table state (build_coding_device layout)
    _meta: dict | None = None  # lazy host metadata
    _statics: tuple | None = None  # lazy decode_statics cache

    def meta(self) -> dict:
        """Host metadata (ONE device sync, cached).

        All scalars the host dispatch needs (max bits, table state) are
        packed on device into one ~1 KiB int32 vector and fetched in a
        single transfer: every fetch is a device sync, and the naive
        version (separate np.asarray per field) also shipped the whole
        (K,) bit-count array — 512 KiB at K=131072 — just to take its
        max."""
        if self._meta is None:
            packed = np.asarray(
                _meta_pack(
                    self.bit_counts,
                    self.tables["len_count"],
                    self.tables["num_syms"],
                    self.tables["sorted_syms"],
                )
            )
            lc = packed[2 : 2 + MAX_CODE_LEN + 1]
            nz = np.nonzero(lc[1:])[0]
            self._meta = {
                "max_bits": int(packed[0]),
                "l_min": int(nz[0]) + 1 if len(nz) else 1,
                "num_syms": int(packed[1]),
                "len_count": lc,
                "sorted_syms": packed[2 + MAX_CODE_LEN + 1 :],
            }
        return self._meta

    @property
    def coding(self) -> coding.CanonicalCoding:
        """Host CanonicalCoding reconstructed from the device tables."""
        m = self.meta()
        num_syms = m["num_syms"]
        sorted_syms = m["sorted_syms"][:num_syms].astype(np.uint8)
        len_count = m["len_count"].astype(np.uint16)
        code_bits, code_lens = coding.assign_canonical_codes(
            len_count, sorted_syms, MAX_CODE_LEN
        )
        len_mask = 0
        for ln in range(MAX_CODE_LEN + 1):
            if len_count[ln]:
                len_mask |= 1 << ln
        return coding.CanonicalCoding(
            code_bits=code_bits,
            code_lens=code_lens,
            sorted_syms=sorted_syms,
            len_count=len_count,
            len_mask=len_mask,
            num_syms=num_syms,
            max_len=MAX_CODE_LEN,  # 15: tpu-profile alignment
        )


#: Histogram sampling threshold and stride for table construction.  The
#: histogram's ONLY consumer is code-length selection (per-lane sizes come
#: from the encode pass and decode tables from the blob header), so on
#: large blocks a strided sample chooses a statistically identical table
#: at ~1/stride the cost: 512 KiB of samples pins 256 symbol frequencies
#: far below the code-length quantization noise (CPU check: payload ratio
#: 2.19165 / 2.19164 / 2.19162 at strides 8/16/32 on the 16 MiB biased
#: block).  Add-one smoothing guarantees every byte value a code, so
#: round-trips stay exact even for symbols the sample missed.
#: `TpuCodec(hist_stride=1)` forces exact counting.
_HIST_SAMPLE_MIN = 4 << 20
_HIST_SAMPLE_STRIDE = 32
_HIST_ROW = 512  # sampled run length (bytes); strided CONTIGUOUS rows
#                  vectorize (a flat [::stride] slice would shuffle lanes)


def _table_hist(padded, hist_stride: int):
    n = padded.shape[0]
    if hist_stride <= 1 or n < _HIST_ROW * hist_stride:
        return histogram256(padded)
    rows = n // (_HIST_ROW * hist_stride)
    # Truncate FLAT first (guard above ensures rows >= 1): n itself need
    # not divide _HIST_ROW for custom lane counts (e.g. k=8, 5 MB input).
    sample = jax.lax.slice(
        padded[: rows * hist_stride * _HIST_ROW].reshape(-1, _HIST_ROW),
        (0, 0),
        (rows * hist_stride, _HIST_ROW),
        (hist_stride, 1),
    ).reshape(-1)
    return histogram256(sample) + 1


@functools.partial(
    jax.jit, static_argnames=("s", "k", "w32", "kernels", "hist_stride")
)
def _encode_full(data, s: int, k: int, w32: int, kernels: bool, hist_stride: int = 1):
    """Fully-device compress: histogram -> table -> encode -> pack."""
    pad = s * k - data.shape[0]
    padded = jnp.concatenate([data, jnp.zeros((pad,), jnp.uint8)])
    t = build_coding_device(_table_hist(padded, hist_stride))
    words32, bit_counts = _encode_with_tables_body(
        padded, t["enc_table"], s, k, w32, kernels
    )
    return words32, bit_counts, t


def _encode_with_tables_body(padded, enc_table, s, k, w32, kernels):
    # Strided lane mapping: byte i -> lane i % k, row i // k.  Unlike
    # contiguous chunks, every lane samples the whole block, so per-lane
    # bit counts stay near the mean even on locally skewed data (sorted
    # runs): W (= max lane words, the decode scan bound) collapses to
    # ~average, and the (s, k) view needs no physical transpose.
    return route.encode_words(padded.reshape(s, k), enc_table, w32, kernels=kernels)


@functools.partial(jax.jit, static_argnames=("s", "k", "w32", "kernels"))
def _encode_with_tables(data, enc_table, s: int, k: int, w32: int, kernels: bool):
    """Encode with a pre-built (shared/dictionary) table: no histogram, no
    table construction — the streaming fast path."""
    pad = s * k - data.shape[0]
    padded = jnp.concatenate([data, jnp.zeros((pad,), jnp.uint8)])
    return _encode_with_tables_body(padded, enc_table, s, k, w32, kernels)


@functools.partial(jax.jit, static_argnames=("s", "k", "w32", "kernels"))
def _encode_batch(blocks, s: int, k: int, w32: int, kernels: bool):
    """vmapped full pipeline over B equal-size blocks, each with its own
    table.  Batching amortizes the serial table-build loop: its ~255
    iterations run element-parallel across the whole batch, so B tables
    cost barely more than one."""

    def one(block):
        t = build_coding_device(histogram256(block))
        words32, bit_counts = _encode_with_tables_body(
            block, t["enc_table"], s, k, w32, kernels
        )
        return words32, bit_counts, t

    return jax.vmap(one)(blocks)


@functools.partial(jax.jit, static_argnames=("s", "group", "w", "kernels"))
def _decode_batch(words, e_bound, g_rank, syms, s: int, group: int, w: int,
                  kernels: bool):
    def one(wds, eb, gr, sy):
        wt = jax.lax.slice_in_dim(wds, 0, w, axis=0)
        return route.decode_rows(
            wt, eb, gr, sy, out_len=s, group=group, kernels=kernels
        )

    return jax.vmap(one)(words, e_bound, g_rank, syms)


def _group(l_min: int) -> int:
    """Staging-group width of the XLA decoder, bucketed to {1,2,3,4,6,8}
    <= l_min so few distinct programs compile."""
    return max(g for g in (1, 2, 3, 4, 6, 8) if g <= max(1, l_min))


def decode_statics(m: dict, s: int) -> tuple:
    """Static decode-dispatch parameters from block metadata: the ONE
    derivation the codec API and every benchmark share, so benchmarks
    always measure exactly the dispatched program.

    Returns (group, w):
      group — staging-group width of the XLA decoder (`_group`);
      w — payload word rows read, rounded up to a multiple of 2
        (program-cache bucketing) and capped at the worst-case payload.
    """
    w = (m["max_bits"] + 31) // 32
    w = min(-(-w // 2) * 2, (s * MAX_CODE_LEN + 31) // 32 + 1)
    return _group(m["l_min"]), max(w, 1)


@functools.partial(jax.jit, static_argnames=("s", "n", "group", "w", "kernels"))
def _decode_full(words, e_bound, g_rank, syms, s: int, n: int, group: int,
                 w: int, kernels: bool):
    wt = jax.lax.slice_in_dim(words, 0, w, axis=0)
    out = route.decode_rows(
        wt, e_bound, g_rank, syms, out_len=s, group=group, kernels=kernels
    )
    return out.reshape(-1)[:n]


class TpuCodec:
    """Large-K transposed-payload codec.  Flagship performance path."""

    def __init__(self, k: int | None = None, hist_stride: int | None = None):
        """Args:
          k: lane count (None = size heuristic, `default_lanes`).
          hist_stride: table-construction histogram sampling.  None (auto)
            counts every byte below 4 MiB and samples 1 byte row in 32
            above (see `_table_hist`: the table is the histogram's only
            consumer, round-trips stay exact, ratio moves < 0.01% on the
            16 MiB biased block).  Pass 1 to force exact counting at any
            size.
        """
        self.k = k
        self.hist_stride = hist_stride

    def _hist_stride(self, n: int) -> int:
        if self.hist_stride is not None:
            return max(1, int(self.hist_stride))
        return _HIST_SAMPLE_STRIDE if n >= _HIST_SAMPLE_MIN else 1

    def _lanes(self, n: int) -> int:
        return self.k if self.k is not None else default_lanes(n)

    @property
    def name(self) -> str:
        return f"Tpu<{self.k if self.k is not None else 'auto'}>"

    # ---------- device API ----------

    def build_tables(self, sample: jax.Array, full_alphabet: bool = True) -> dict:
        """Build a shared (dictionary) coding from sample data, on device.

        With ``full_alphabet`` every byte value gets a nonzero count, so
        the table can encode ANY later block (at a tiny ratio cost); this
        is the reference's one-table-for-K-streams sharing
        (huffman.cpp:762-768) lifted across blocks — pass the result to
        `encode_device(..., tables=...)` to skip per-block histogram and
        table construction entirely (streaming fast path).
        """
        return _build_tables_jit(sample, full_alphabet)

    def encode_device(self, data: jax.Array, tables: dict | None = None) -> TpuCompressed:
        """Compress a device-resident uint8 array; stays on device.

        The whole pipeline (histogram, canonical table build — the device
        equivalent of the reference's MakeCanonicalCoding, huffman.cpp:339-
        437 — encode, word packing) is ONE jitted program with no host
        syncs."""
        n = int(data.shape[0])
        k = self._lanes(n)
        if n == 0:
            t = {key: jnp.asarray(v) for key, v in _EMPTY_TABLES.items()}
            return TpuCompressed(
                words=jnp.zeros((1, k), jnp.uint32),
                bit_counts=jnp.zeros((k,), jnp.int32),
                raw_size=0,
                k=k,
                tables=t,
            )
        s = -(-n // k)
        w32 = (s * MAX_CODE_LEN + 31) // 32 + 1
        kernels = route.gpu_kernels()
        if tables is not None:
            words32, bit_counts = _encode_with_tables(
                data, tables["enc_table"], s, k, w32, kernels
            )
            t = tables
        else:
            words32, bit_counts, t = _encode_full(
                data, s, k, w32, kernels, self._hist_stride(n)
            )
        return TpuCompressed(
            words=words32, bit_counts=bit_counts, raw_size=n, k=k, tables=t
        )

    def decode_device(self, comp: TpuCompressed) -> jax.Array:
        """Decompress to a device-resident uint8 array.

        First call on a block fetches its host metadata (one sync, cached
        on the TpuCompressed); repeated decodes are sync-free."""
        n, k = comp.raw_size, comp.k
        if n == 0:
            return jnp.zeros(0, jnp.uint8)
        m = comp.meta()
        s = -(-n // k)
        if m["num_syms"] <= 1:
            sym = int(m["sorted_syms"][0]) if m["num_syms"] else 0
            return jnp.full((n,), sym, jnp.uint8)
        if comp._statics is None:
            comp._statics = decode_statics(m, s)
        group, w = comp._statics
        words = comp.words
        if words.shape[0] < w:
            words = jnp.concatenate(
                [words, jnp.zeros((w - words.shape[0], k), words.dtype)]
            )
        return _decode_full(
            words,
            comp.tables["e_bound"],
            comp.tables["g_rank"],
            comp.tables["sorted_syms"],
            s,
            n,
            group,
            w,
            route.gpu_kernels(),
        )

    # ---------- batched device API ----------

    def encode_batch(self, blocks: jax.Array):
        """Compress B equal-size blocks in one program, one table each.

        Args:
          blocks: (B, n_block) uint8.
        Returns:
          (words (B, W, K) u32, bit_counts (B, K) i32, tables dict of
          batched arrays) — feed to `decode_batch`.
        """
        bcount, nb = blocks.shape
        k = self._lanes(nb)
        s = -(-nb // k)
        assert s * k == nb, "block size must be divisible by the lane count"
        w32 = (s * MAX_CODE_LEN + 31) // 32 + 1
        return _encode_batch(blocks, s, k, w32, route.gpu_kernels())

    def batch_decode_statics(self, words, bit_counts, tables, n_block: int):
        """Host-side decode statics (group, w) for a batch.

        The ONE place the batched decode path syncs device metadata (two
        fetches: bit_counts max, len_count).  Compute once per batch
        stream and pass to repeated `decode_batch` calls, which then
        dispatch without a device sync."""
        bits = np.asarray(bit_counts)
        lc = np.asarray(tables["len_count"])
        nzmask = lc[:, 1:] > 0
        l_min = min(
            int(np.argmax(row) + 1) if row.any() else 1 for row in nzmask
        )
        w = int((bits.max() + 31) // 32)
        w = max(min(-(-w // 4) * 4, words.shape[1]), 1)
        return _group(l_min), w

    def decode_batch(self, words, bit_counts, tables, n_block: int,
                     statics: tuple | None = None):
        """Inverse of `encode_batch` (blocks of identical raw size).

        ``statics``: optional (group, w) from `batch_decode_statics`
        — pass it on repeated decodes to keep the dispatch sync-free."""
        _, _, k = words.shape
        s = -(-n_block // k)
        if statics is None:
            statics = self.batch_decode_statics(words, bit_counts, tables, n_block)
        group, w = statics
        out = _decode_batch(
            words,
            tables["e_bound"],
            tables["g_rank"],
            tables["sorted_syms"],
            s,
            group,
            w,
            route.gpu_kernels(),
        )
        return out  # (B, S, K); caller reshapes per block

    # ---------- bytes API ----------

    #: Inputs above this go through the block container (bounded kernel
    #: shapes, one compiled program per block size).
    block_bytes = 16 << 20

    def _compress_blob(self, raw: bytes) -> bytes:
        comp = self.encode_device(jnp.asarray(np.frombuffer(raw, dtype=np.uint8)))
        return self.serialize(comp)

    def compress(self, raw: bytes) -> bytes:
        from .. import container

        n = len(raw)
        if n > self.block_bytes:
            return container.compress_blocks(raw, self, self.block_bytes)
        blob = self._compress_blob(raw)
        if n > 0 and len(blob) >= n + 8:
            # Incompressible: stored record (the fallback the reference's
            # in-repo codecs lack; its Huff0 wrapper has one, huff0.cpp:23-31).
            return container.pack(
                [(container.KIND_STORED, n, raw)], self.block_bytes
            )
        return blob

    def decompress(self, blob: bytes) -> bytes:
        from .. import container

        if blob[:4] == container.MAGIC:
            return container.decompress_blocks(blob, self)
        comp = self.deserialize(blob)
        return np.asarray(self.decode_device(comp)).tobytes()

    # ---------- serialization ----------

    def serialize(
        self, comp: TpuCompressed, *, compact: bool = True, counts: str = "auto"
    ) -> bytes:
        """Serialize; ``compact=False`` writes the pre-round-5 legacy
        layout (kept for wire-compat tests and old-blob regeneration).
        ``counts`` pins the compact count encoding for tests: "auto"
        (size race, the default), "flat", or "huff"."""
        cc = comp.coding
        k = comp.k
        bits = np.asarray(comp.bit_counts).astype(np.int64)
        wide = (not compact) and bool(bits.max(initial=0) >= (1 << 16))
        flags = (int(wide) << 24) | (FLAG_COMPACT if compact else 0)
        out = bytearray()
        out += struct.pack("<IIII", MAGIC, comp.raw_size, k, cc.len_mask | flags)
        for ln in range(MAX_CODE_LEN + 1):
            c = int(cc.len_count[ln])
            if c:
                out.append(c & 0xFF)
        out += cc.sorted_syms.tobytes()
        if cc.num_syms <= 1:
            # Degenerate coding: zero-length codes, zero payload bits —
            # the bit-count array and payload are implicit.
            return bytes(out)

        words = np.asarray(comp.words)  # (W, K) uint32
        w = words.shape[0]
        lane_bytes = (
            np.ascontiguousarray(words.T).astype(">u4").view(np.uint8).reshape(k, 4 * w)
        )
        if compact:
            # Bit counts as base + fixed-width bit-packed deltas: lane
            # counts cluster around the per-lane mean (strided mapping),
            # so width lands ~9-11 bits vs the legacy flat u16.
            base = int(bits.min())  # k >= 1 always (validated on parse)
            deltas = bits - base
            width = int(deltas.max(initial=0)).bit_length()
            flat_cost = 5 + (k * width + 7) // 8
            # Entropy-coded alternative (flag bit 26): the delta bytes
            # min(delta, 255) as a ref-profile blob via the codec's own
            # host path, plus width-bit raw escapes.  Deltas carry ~6
            # bits of entropy against a 9-11 bit packing width on real
            # data; the smaller representation wins the race (small k
            # loses to the blob's ~0.3 KiB table+offset overhead and
            # stays flat).
            d8 = np.minimum(deltas, 255).astype(np.uint8)
            esc = deltas[deltas >= 255]
            from .. import native as _native

            cblob = _native.compress(d8.tobytes(), _HUFF_COUNTS_STREAMS)
            esc_bytes = b""
            if len(esc) and width:
                ebits = (
                    (esc[:, None] >> np.arange(width - 1, -1, -1)) & 1
                ).astype(np.uint8)
                esc_bytes = np.packbits(ebits.reshape(-1)).tobytes()
            huff_cost = 9 + len(cblob) + len(esc_bytes)
            if counts == "huff" or (counts == "auto" and huff_cost < flat_cost):
                # Rewrite the flags word in place: huff counts selected.
                struct.pack_into(
                    "<I", out, 12, cc.len_mask | flags | FLAG_HUFF_COUNTS
                )
                out += struct.pack("<IBI", base, width, len(cblob))
                out += cblob
                out += esc_bytes
            else:
                out += struct.pack("<IB", base, width)
                if width:
                    dbits = (
                        (deltas[:, None] >> np.arange(width - 1, -1, -1)) & 1
                    ).astype(np.uint8)
                    out += np.packbits(dbits.reshape(-1)).tobytes()
            # Bit-granular payload: lane k contributes exactly its first
            # bits_k stream bits (MSB-first within each byte, matching
            # the forward big-endian u32 stream order) — no per-lane
            # byte rounding.  The native C single-pass packer is ~10x
            # the vectorized NumPy reference (which stays canonical and
            # is the fallback).
            from .. import native as _nat

            packed = _nat.pack_lane_bits(lane_bytes, bits)
            out += packed if packed is not None else _pack_lane_bits(lane_bytes, bits)
            return bytes(out)

        while len(out) % 2:
            out.append(0)
        out += bits.astype("<u4" if wide else "<u2").tobytes()
        # Byte-granular payload: lane k contributes its first
        # ceil(bits_k/8) stream bytes (big-endian within each u32 word —
        # the stream's forward MSB-first order).
        nbytes = (bits + 7) // 8
        mask = np.arange(4 * w, dtype=np.int64)[None, :] < nbytes[:, None]
        out += lane_bytes[mask].tobytes()
        return bytes(out)

    def deserialize(self, blob: bytes) -> TpuCompressed:
        """Parse a tpu-profile blob.

        Unlike the reference ("not hardened against malformed input",
        README.md:140-146), every structural field is validated; corrupt
        input raises ValueError rather than crashing downstream.
        """
        buf = memoryview(blob)
        if len(buf) < 16:
            raise ValueError("blob too short for header")
        magic, raw_size, k, len_mask = struct.unpack_from("<IIII", buf, 0)
        if magic != MAGIC:
            raise ValueError("not a tpu-profile blob (bad magic)")
        flags = len_mask >> 24
        wide = bool(flags & 1)
        compact = bool(flags & 2)
        huff_counts = bool(flags & 4)
        if flags >> 3:
            raise ValueError(f"unknown header flags 0x{flags:02x}")
        if huff_counts and not compact:
            raise ValueError("huff-counts flag requires the compact layout")
        len_mask &= (1 << 24) - 1
        if not (1 <= k <= 1 << 22):
            raise ValueError(f"implausible lane count {k}")
        if len_mask >> (MAX_CODE_LEN + 1):
            raise ValueError("len_mask has lengths beyond MAX_CODE_LEN")
        pos = 16
        len_count = np.zeros(MAX_CODE_LEN + 1, dtype=np.uint16)
        one_size = bin(len_mask).count("1") == 1
        num_syms = 0
        for ln in range(MAX_CODE_LEN + 1):
            if len_mask & (1 << ln):
                if pos >= len(buf):
                    raise ValueError("truncated length counts")
                c = buf[pos]
                pos += 1
                if c == 0 and not one_size:
                    raise ValueError("zero count for flagged length")
                if one_size and c == 0:
                    c = 256
                len_count[ln] = c
                num_syms += c
        if num_syms > 256:
            raise ValueError(f"{num_syms} symbols > 256")
        if num_syms > 1:
            kraft = int(
                (
                    len_count.astype(np.int64)
                    << (MAX_CODE_LEN - np.arange(MAX_CODE_LEN + 1))
                ).sum()
            )
            if kraft != 1 << MAX_CODE_LEN:
                raise ValueError("length counts violate Kraft equality")
        if pos + num_syms > len(buf):
            raise ValueError("truncated symbol table")
        sorted_syms = np.frombuffer(buf[pos : pos + num_syms], dtype=np.uint8).copy()
        pos += num_syms
        if num_syms <= 1:
            bits = np.zeros(k, dtype=np.int64)
            lane_bytes = np.zeros((k, 4), dtype=np.uint8)
            return self._finish_deserialize(
                raw_size, k, len_count, sorted_syms, num_syms, bits, lane_bytes
            )
        if compact and huff_counts:
            if pos + 9 > len(buf):
                raise ValueError("truncated huff-count header")
            base, width, clen = struct.unpack_from("<IBI", buf, pos)
            pos += 9
            if width > 24:
                raise ValueError(f"implausible bit-count delta width {width}")
            if clen > len(buf) - pos:
                raise ValueError("truncated huff-count blob")
            from .. import native as _native

            d8 = np.frombuffer(
                _native.decompress(
                    bytes(buf[pos : pos + clen]), _HUFF_COUNTS_STREAMS
                ),
                dtype=np.uint8,
            )
            pos += clen
            if len(d8) != k:
                raise ValueError(
                    f"huff-count blob decodes to {len(d8)} deltas, expected {k}"
                )
            deltas = d8.astype(np.int64)
            n_esc = int((d8 == 255).sum())
            if n_esc:
                if width < 8:
                    raise ValueError("escaped deltas need width >= 8")
                nb = (n_esc * width + 7) // 8
                if pos + nb > len(buf):
                    raise ValueError("truncated escape deltas")
                e = np.unpackbits(
                    np.frombuffer(buf[pos : pos + nb], dtype=np.uint8),
                    count=n_esc * width,
                )
                deltas[d8 == 255] = (
                    e.reshape(n_esc, width).astype(np.int64)
                    << np.arange(width - 1, -1, -1)
                ).sum(axis=1)
                pos += nb
            bits = base + deltas
        elif compact:
            if pos + 5 > len(buf):
                raise ValueError("truncated compact bit counts")
            base, width = struct.unpack_from("<IB", buf, pos)
            pos += 5
            if width > 24:
                raise ValueError(f"implausible bit-count delta width {width}")
            if width:
                nb = (k * width + 7) // 8
                if pos + nb > len(buf):
                    raise ValueError("truncated bit-count deltas")
                d = np.unpackbits(
                    np.frombuffer(buf[pos : pos + nb], dtype=np.uint8),
                    count=k * width,
                )
                bits = base + (
                    d.reshape(k, width).astype(np.int64)
                    << np.arange(width - 1, -1, -1)
                ).sum(axis=1)
                pos += nb
            else:
                bits = np.full(k, base, dtype=np.int64)
        else:
            pos = (pos + 1) & ~1
            cw = 4 if wide else 2
            if pos + cw * k > len(buf):
                raise ValueError("truncated bit counts")
            bits = np.frombuffer(
                buf[pos : pos + cw * k], dtype="<u4" if wide else "<u2"
            ).astype(np.int64)
            pos += cw * k

        s = -(-raw_size // k) if raw_size else 0
        if int(bits.max(initial=0)) > max(s, 1) * MAX_CODE_LEN:
            raise ValueError("per-lane bit count exceeds slice capacity")
        wmax = max(int((bits.max(initial=0) + 31) // 32), 1)
        if compact:
            total = int(bits.sum())
            if total > (len(buf) - pos) * 8:
                raise ValueError("payload shorter than bit counts imply")
            from .. import native as _nat

            stream = np.frombuffer(buf[pos:], dtype=np.uint8)
            lane_bytes = _nat.unpack_lane_bits(stream, bits, 4 * wmax)
            if lane_bytes is None:
                lane_bytes = _unpack_lane_bits(stream, bits, 4 * wmax)
        else:
            flat = np.frombuffer(buf[pos:], dtype=np.uint8)
            nbytes = (bits + 7) // 8
            if int(nbytes.sum()) > len(flat):
                raise ValueError("payload shorter than bit counts imply")
            lane_bytes = np.zeros((k, 4 * wmax), dtype=np.uint8)
            mask = np.arange(4 * wmax, dtype=np.int64)[None, :] < nbytes[:, None]
            lane_bytes[mask] = flat[: int(nbytes.sum())]
        return self._finish_deserialize(
            raw_size, k, len_count, sorted_syms, num_syms, bits, lane_bytes
        )

    def _finish_deserialize(
        self, raw_size, k, len_count, sorted_syms, num_syms, bits, lane_bytes
    ) -> TpuCompressed:
        words = lane_bytes.view(">u4").astype(np.uint32).T.copy()

        t = decode_tables_bitserial(len_count, sorted_syms)
        syms256 = np.zeros(256, np.int32)
        syms256[:num_syms] = sorted_syms
        tables = {
            "e_bound": jnp.asarray(t["e_bound"]),
            "g_rank": jnp.asarray(t["g_rank"]),
            "sorted_syms": jnp.asarray(syms256),
            "len_count": jnp.asarray(len_count.astype(np.int32)),
            "num_syms": jnp.asarray(num_syms, jnp.int32),
        }
        meta = {
            "max_bits": int(bits.max()) if k else 0,
            "l_min": t["l_min"],
            "num_syms": num_syms,
            "len_count": len_count.astype(np.int32),
            "sorted_syms": syms256,
        }
        return TpuCompressed(
            words=jnp.asarray(words),
            bit_counts=jnp.asarray(bits.astype(np.int32)),
            raw_size=raw_size,
            k=k,
            tables=tables,
            _meta=meta,
        )


@functools.partial(jax.jit, static_argnames=("full_alphabet",))
def _build_tables_jit(sample, full_alphabet: bool):
    hist = histogram256(sample)
    if full_alphabet:
        hist = hist + 1
    return build_coding_device(hist)


_EMPTY_TABLES = {
    "e_bound": np.zeros(MAX_CODE_LEN + 2, np.int32),
    "g_rank": np.zeros(MAX_CODE_LEN + 1, np.int32),
    "sorted_syms": np.zeros(256, np.int32),
    "len_count": np.zeros(MAX_CODE_LEN + 1, np.int32),
    "num_syms": np.zeros((), np.int32),
}

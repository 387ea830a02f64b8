"""JAX codec: ``ref``-profile compress/decompress with device kernels.

Wire-compatible with the reference's K-stream format (and with
:mod:`huffman_tpu.golden`); the per-byte hot loops run on the accelerator
(through the kernels ops/route.py picks) while table construction and
framing stay on the host, exactly as the reference keeps its table build
scalar (codec/huffman.cpp:339-437).

For the high-throughput ``tpu`` format profile (large K, transposed word
payload, no host framing in the hot path) see
:mod:`huffman_tpu.models.tpu_codec`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import coding, format as fmt, golden, native
from ..constants import STREAM_SLOP, TPU_MAX_CODE_LEN
from ..ops import route, tables
from ..ops.decode_bits import decode_tables_bitserial
from ..ops.encode import words_to_byte_columns


@functools.partial(jax.jit, static_argnames=("s", "k", "kernels"))
def _encode_jit(data, enc_table, bounds, sizes, s: int, k: int, kernels: bool):
    idx = bounds[None, :] + jnp.arange(s, dtype=jnp.int32)[:, None]
    b = jnp.take(data, jnp.clip(idx, 0, data.shape[0] - 1))
    w32 = (s * TPU_MAX_CODE_LEN + 31) // 32 + 1
    words, bit_counts = route.encode_words(
        b, enc_table, w32, kernels=kernels, counts=sizes
    )
    return words_to_byte_columns(words), bit_counts


@functools.partial(jax.jit, static_argnames=("s", "group", "kernels"))
def _decode_ref_jit(words, e_bound, g_rank, syms, out_idx, s: int, group: int,
                    kernels: bool):
    out = route.decode_rows(
        words, e_bound, g_rank, syms, out_len=s, group=group, kernels=kernels
    )
    return jnp.take(out.reshape(-1), out_idx)


@jax.jit
def _hist_jit(data):
    return jnp.zeros(256, jnp.int32).at[data].add(1)


def device_histogram(data: jnp.ndarray) -> np.ndarray:
    return np.asarray(_hist_jit(data))


class JaxCodec:
    """K-stream ``ref``-profile codec with XLA kernels."""

    def __init__(self, k: int):
        self.k = k

    @property
    def name(self) -> str:
        return f"Jax<{self.k}>"

    def compress(self, raw: bytes) -> bytes:
        n = len(raw)
        k = self.k
        if n == 0 or n < 4 * k or n > 4096 * k:
            # Tiny inputs: device launch overhead dwarfs any win.  Very long
            # slices (tiny K vs input, a ref-parity configuration): a
            # lockstep walk would serialize ~n/k steps for almost no lane
            # parallelism — the native host runtime is faster and emits
            # identical bytes (golden if no toolchain).
            return native.compress(raw, k)
        data = jnp.asarray(np.frombuffer(raw, dtype=np.uint8))
        hist = device_histogram(data)
        cc = coding.make_canonical_coding(hist)

        sizes_np = fmt.slice_sizes(n, k)
        bounds_np = np.concatenate([[0], np.cumsum(sizes_np)])[:-1]
        s = int(sizes_np.max())

        enc_table = jnp.asarray(tables.pack_encode_table(cc))
        byte_cols, bit_counts = _encode_jit(
            data,
            enc_table,
            jnp.asarray(bounds_np.astype(np.int32)),
            jnp.asarray(sizes_np.astype(np.int32)),
            s,
            k,
            route.gpu_kernels(),
        )
        byte_cols = np.asarray(byte_cols)
        bits = np.asarray(bit_counts).astype(np.int64)

        region_sizes = fmt.stream_region_sizes(bits)
        end_offsets = np.cumsum(region_sizes)
        header = fmt.write_header(n, cc.len_count, cc.len_mask, cc.sorted_syms, end_offsets)

        # Backward layout, vectorized: forward stream byte j of lane i
        # lands at payload[end_i - 1 - j].
        payload = np.zeros(int(end_offsets[-1]), dtype=np.uint8)
        nb = (bits + 7) // 8
        maxnb = max(int(nb.max()), 1)
        cols = np.arange(maxnb, dtype=np.int64)
        dest = end_offsets[:, None] - 1 - cols[None, :]
        mask = cols[None, :] < nb[:, None]
        payload[dest[mask]] = byte_cols[:maxnb].T[mask]
        return header + payload.tobytes()

    def decompress(self, blob: bytes) -> bytes:
        """Decode a reference-format blob with the lockstep word decoder.

        The backward per-stream byte regions are reframed host-side into
        the dense forward (W, K) word matrix (byte reversal + zero-pad),
        after which the ``tpu``-profile decoders run unchanged — i.e. the
        REFERENCE's wire format decodes through the same device kernels
        as our own.  Per-lane symbol counts differ by one (slice_sizes),
        handled by the out_idx selection gather.
        """
        k = self.k
        h = fmt.parse_header(blob, k)
        n = h.raw_size
        if n == 0:
            return b""
        if n < 4 * k or n > 4096 * k:
            return native.decompress(bytes(blob), k)
        sizes_np = fmt.slice_sizes(n, k)
        s = int(sizes_np.max())

        payload = np.frombuffer(h.payload, dtype=np.uint8)
        if len(payload) == 0:
            # Malformed (all-empty regions with nonzero raw size): keep the
            # clipped fancy-index below in range; masks are all False.
            payload = np.zeros(1, dtype=np.uint8)
        starts = np.concatenate([[0], h.end_offsets[:-1]])
        region_len = (h.end_offsets - starts).astype(np.int64)
        # Forward byte streams: each region reversed; drop the slop (the
        # low 8 bytes of every region are never part of the stream).
        # Vectorized: forward byte j of lane i sits at end_offsets[i]-1-j.
        nb = region_len - STREAM_SLOP
        max_bytes = int(nb.max())
        wmax = max(-(-max_bytes // 4), 1)
        cols = np.arange(4 * wmax, dtype=np.int64)
        src = h.end_offsets[:, None] - 1 - cols[None, :]
        mask = cols[None, :] < nb[:, None]
        lane_bytes = np.where(
            mask, payload[np.clip(src, 0, len(payload) - 1)], 0
        ).astype(np.uint8)
        words = jnp.asarray(lane_bytes.view(">u4").astype(np.uint32).T.copy())

        t = decode_tables_bitserial(h.len_count, h.sorted_syms)
        if h.num_syms <= 1:
            sym = int(h.sorted_syms[0]) if h.num_syms else 0
            return bytes([sym]) * n
        group = max(g for g in (1, 2, 3, 4, 6, 8) if g <= max(1, t["l_min"]))

        lane_of = np.repeat(np.arange(k, dtype=np.int64), sizes_np)
        s_of = np.arange(n, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(sizes_np)])[:-1], sizes_np
        )
        out_idx = (s_of * k + lane_of).astype(np.int32)

        out = _decode_ref_jit(
            words,
            jnp.asarray(t["e_bound"]),
            jnp.asarray(t["g_rank"]),
            jnp.asarray(t["syms"]),
            jnp.asarray(out_idx),
            s,
            group,
            route.gpu_kernels(),
        )
        return np.asarray(out).tobytes()

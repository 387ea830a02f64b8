// Native host runtime for huffman_tpu: fast CPU codec for the `ref`
// format profile (K-stream canonical Huffman, backward bitstreams).
//
// Role in the framework: the host-side runtime around the device compute
// path — small-block fallback, serialization-side processing, and the
// fast cross-check anchor for the accelerated paths.  It implements the
// same wire format as huffman_tpu.golden (see huffman_tpu/format.py for
// the layout contract) with the same deterministic tie-breaks, so its
// output is bit-identical to the golden model and the JAX/Pallas paths.
//
// Written from the format contract in this repository's Python
// implementation (golden.py / coding.py / format.py); the wire format
// itself is byte-compatible with the ahartik/huffman-avx512 reference
// (codec/huffman.cpp:794-813 header, backward streams) by design.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxLen = 12;           // MAX_CODE_LEN
constexpr int kSlop = 8;              // STREAM_SLOP
constexpr int kNumSyms = 256;

struct Coding {
  uint16_t code_bits[kNumSyms];  // left-aligned in 12-bit field
  uint8_t code_lens[kNumSyms];
  uint8_t sorted_syms[kNumSyms];
  uint16_t len_count[kMaxLen + 1];
  uint32_t len_mask;
  int num_syms;
};

// ---------------- histogram ----------------
// Four interleaved count banks over 64-bit loads: keeps several
// independent increment chains in flight (same motivation as the
// reference's banked histograms, histogram.cpp:14-92; implementation
// is our own).
void Histogram(const uint8_t* p, size_t n, uint64_t out[kNumSyms]) {
  // Eight banks, one per byte position of a 16-byte step: on repetitive
  // (skewed) data a narrower banking repeatedly increments the same
  // counter back-to-back and stalls on store-to-load forwarding — the
  // exact effect the reference's 8 interleaved arrays dodge
  // (histogram.cpp:18-20).
  uint32_t bank[8][kNumSyms] = {};
  size_t i = 0;
  for (; i + 16 <= n; i += 16) {
    uint64_t w0, w1;
    std::memcpy(&w0, p + i, 8);
    std::memcpy(&w1, p + i + 8, 8);
    bank[0][w0 & 0xFF]++;
    bank[1][(w0 >> 8) & 0xFF]++;
    bank[2][(w0 >> 16) & 0xFF]++;
    bank[3][(w0 >> 24) & 0xFF]++;
    bank[4][(w0 >> 32) & 0xFF]++;
    bank[5][(w0 >> 40) & 0xFF]++;
    bank[6][(w0 >> 48) & 0xFF]++;
    bank[7][w0 >> 56]++;
    bank[0][w1 & 0xFF]++;
    bank[1][(w1 >> 8) & 0xFF]++;
    bank[2][(w1 >> 16) & 0xFF]++;
    bank[3][(w1 >> 24) & 0xFF]++;
    bank[4][(w1 >> 32) & 0xFF]++;
    bank[5][(w1 >> 40) & 0xFF]++;
    bank[6][(w1 >> 48) & 0xFF]++;
    bank[7][w1 >> 56]++;
  }
  for (; i < n; ++i) bank[0][p[i]]++;
  for (int v = 0; v < kNumSyms; ++v)
    out[v] = (uint64_t)bank[0][v] + bank[1][v] + bank[2][v] + bank[3][v] +
             bank[4][v] + bank[5][v] + bank[6][v] + bank[7][v];
}

// ---------------- canonical coding ----------------
// Mirrors huffman_tpu.coding.make_canonical_coding exactly:
// order = (freq desc, symbol asc); two-queue build, leaf popped on tie;
// MiniZ-style Kraft repair to <= 12 bits.
void BuildCoding(const uint64_t hist[kNumSyms], Coding* cc) {
  std::memset(cc, 0, sizeof(*cc));
  int order[kNumSyms];
  int n = 0;
  for (int s = 0; s < kNumSyms; ++s)
    if (hist[s]) order[n++] = s;
  cc->num_syms = n;
  if (n == 0) return;
  std::sort(order, order + n, [&](int a, int b) {
    if (hist[a] != hist[b]) return hist[a] > hist[b];
    return a < b;
  });
  for (int i = 0; i < n; ++i) cc->sorted_syms[i] = (uint8_t)order[i];

  // Unlimited depths via two-queue merge over ascending weights.
  int64_t len_count_raw[64] = {};
  if (n == 1) {
    len_count_raw[0] = 1;
  } else {
    std::vector<uint64_t> w(n);  // ascending
    for (int i = 0; i < n; ++i) w[i] = hist[order[n - 1 - i]];
    std::vector<uint64_t> tree_w(n);
    std::vector<int> child0(n), child1(n);
    int next_leaf = 0, next_tree = 0, tree_size = 0;
    auto heap_size = [&] { return (tree_size - next_tree) + (n - next_leaf); };
    auto pop_min = [&](int* node) -> uint64_t {
      bool leaf = false;
      if (next_leaf < n)
        leaf = (next_tree == tree_size) || (w[next_leaf] <= tree_w[next_tree]);
      if (leaf) {
        *node = -1;
        return w[next_leaf++];
      }
      *node = next_tree;
      return tree_w[next_tree++];
    };
    while (heap_size() > 1) {
      int na, nb;
      uint64_t wa = pop_min(&na);
      uint64_t wb = pop_min(&nb);
      child0[tree_size] = na;
      child1[tree_size] = nb;
      tree_w[tree_size] = wa + wb;
      tree_size++;
    }
    int root;
    pop_min(&root);
    // Iterative depth collection.
    std::vector<std::pair<int, int>> stack;
    stack.push_back({root, 0});
    while (!stack.empty()) {
      auto [node, depth] = stack.back();
      stack.pop_back();
      if (node < 0) {
        len_count_raw[depth < 63 ? depth : 63]++;
      } else {
        stack.push_back({child0[node], depth + 1});
        stack.push_back({child1[node], depth + 1});
      }
    }
  }

  // Limit to kMaxLen (fold + Kraft repair).
  int64_t lc[kMaxLen + 1] = {};
  for (int l = 0; l <= kMaxLen; ++l) lc[l] = len_count_raw[l];
  for (int l = kMaxLen + 1; l < 64; ++l) lc[kMaxLen] += len_count_raw[l];
  int64_t one = 1ll << kMaxLen, kraft = 0;
  for (int l = 0; l <= kMaxLen; ++l) kraft += lc[l] << (kMaxLen - l);
  while (kraft > one) {
    lc[kMaxLen]--;
    for (int j = kMaxLen - 1; j >= 0; --j) {
      if (lc[j] > 0) {
        lc[j]--;
        lc[j + 1] += 2;
        break;
      }
    }
    kraft--;
  }
  for (int l = 0; l <= kMaxLen; ++l) {
    cc->len_count[l] = (uint16_t)lc[l];
    if (lc[l]) cc->len_mask |= 1u << l;
  }

  // Canonical assignment in sorted_syms order grouped by ascending length.
  uint32_t current = 0;
  int i = 0;
  for (int l = 0; l <= kMaxLen; ++l) {
    uint32_t inc = 1u << (kMaxLen - l);
    for (int c = 0; c < lc[l]; ++c, ++i) {
      int s = cc->sorted_syms[i];
      cc->code_bits[s] = (uint16_t)current;
      cc->code_lens[s] = (uint8_t)l;
      current += inc;
    }
  }
}

// ---------------- decode tables ----------------
struct D1 {
  uint8_t len;
  uint8_t sym;
};
struct D2 {
  uint8_t nbits;
  uint8_t nsyms;
  uint8_t s0, s1;
};

void BuildTables(const uint16_t len_count[kMaxLen + 1],
                 const uint8_t* sorted_syms, int num_syms,
                 std::vector<D1>& t1, std::vector<D2>& t2) {
  t1.assign(1 << kMaxLen, D1{0, 0});
  t2.assign(1 << kMaxLen, D2{0, 0, 0, 0});
  // Enumerate codes (ascending length).
  struct CodeEnt {
    int sym, bits, len;
  };
  std::vector<CodeEnt> codes;
  codes.reserve(num_syms);
  uint32_t current = 0;
  int i = 0;
  for (int l = 0; l <= kMaxLen; ++l) {
    uint32_t inc = 1u << (kMaxLen - l);
    for (int c = 0; c < len_count[l]; ++c, ++i) {
      codes.push_back({sorted_syms[i], (int)current, l});
      current += inc;
    }
  }
  for (auto& e : codes) {
    int fill = 1 << (kMaxLen - e.len);
    for (int j = 0; j < fill; ++j)
      t1[e.bits + j] = D1{(uint8_t)e.len, (uint8_t)e.sym};
  }
  for (auto& e1 : codes) {
    int last = e1.bits;
    for (auto& e2 : codes) {
      if (e1.len + e2.len > kMaxLen) break;  // lengths ascend
      int c = e1.bits | (e2.bits >> e1.len);
      int inc = 1 << (kMaxLen - e1.len - e2.len);
      for (int j = 0; j < inc; ++j)
        t2[c + j] = D2{(uint8_t)(e1.len + e2.len), 2, (uint8_t)e1.sym,
                       (uint8_t)e2.sym};
      last = c + inc;
    }
    int end1 = e1.bits + (1 << (kMaxLen - e1.len));
    for (int j = last; j < end1; ++j)
      t2[j] = D2{(uint8_t)e1.len, 1, (uint8_t)e1.sym, 0};
  }
}

// ---------------- bit IO ----------------
// Backward stream writer: stream byte i lives at region_end-1-i,
// bits MSB-first within a byte (format contract in format.py).
struct BitWriter {
  uint8_t* end;      // one past region end; writes walk down
  uint64_t acc = 0;  // upcoming bits at the top
  int nbits = 0;

  explicit BitWriter(uint8_t* region_end) : end(region_end) {}
  inline void Put(uint32_t code12, int len) {
    acc |= (uint64_t)code12 << (52 - nbits);
    nbits += len;
  }
  // Bulk flush of all whole bytes with ONE unaligned store: on a
  // little-endian machine the u64's byte j lands at end-8+j, so byte 7
  // (acc>>56, the oldest bits) lands at end-1 — exactly the backward
  // layout.  Safe because every region has kSlop low bytes never read.
  inline void FlushBulk() {
    uint64_t w = acc;
    std::memcpy(end - 8, &w, 8);
    int nb = nbits >> 3;
    end -= nb;
    acc <<= 8 * nb;
    nbits -= 8 * nb;
  }
  inline void Finish() {
    FlushBulk();
    if (nbits > 0) {
      *(--end) = (uint8_t)(acc >> 56);
      acc = 0;
      nbits = 0;
    }
  }
};

// Backward stream reader: mirrors the writer; bytes below region begin
// read as zero (same contract as huffman.cpp:536-556 and golden.py).
struct BitReader {
  const uint8_t* begin;
  const uint8_t* next;  // next byte to load (walking down)
  uint64_t buf = 0;     // upcoming bits at the top
  int navail = 0;

  BitReader(const uint8_t* region_begin, const uint8_t* region_end)
      : begin(region_begin), next(region_end) {}
  inline void Fill() {
    if (next - begin >= 8) {
      // Bulk refill: one unaligned load + bswap delivers the next 8
      // stream bytes (they sit just below `next`, newest at the lowest
      // address).  Mask to whole bytes so no future bits leak in.
      // Little-endian load: memory byte next-1 (the next stream byte)
      // lands in the TOP u64 byte, subsequent stream bytes below it.
      uint64_t w;
      std::memcpy(&w, next - 8, 8);
      int need = (63 - navail) >> 3;
      if (need) {
        uint64_t take = w & (~0ull << (64 - 8 * need));
        buf |= take >> navail;
        next -= need;
        navail += 8 * need;
      }
      return;
    }
    while (navail <= 56) {
      uint8_t b = (next > begin) ? *(--next) : 0;
      buf |= (uint64_t)b << (56 - navail);
      navail += 8;
    }
  }
  inline uint32_t Peek12() const { return (uint32_t)(buf >> 52); }
  inline void Consume(int n) {
    buf <<= n;
    navail -= n;
  }
};

inline void WriteU32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(v & 0xFF);
  out.push_back((v >> 8) & 0xFF);
  out.push_back((v >> 16) & 0xFF);
  out.push_back((v >> 24) & 0xFF);
}

inline uint32_t ReadU32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

void SliceSizes(size_t n, int k, std::vector<size_t>& sizes) {
  sizes.assign(k, n / k);
  for (size_t i = 0; i < n % (size_t)k; ++i) sizes[i]++;
}

}  // namespace

extern "C" {

// Upper bound on compressed size for n bytes in k streams.
size_t hh_compress_bound(size_t n, int k) {
  return 8 + 13 + 256 + 4 * (size_t)k + 2 * n + 16 * (size_t)k + 64;
}

// Compress into the ref-profile K-stream format.  Returns compressed
// size, or 0 on error (out_cap too small).
size_t hh_compress(const uint8_t* data, size_t n, int k, uint8_t* out,
                   size_t out_cap) {
  std::vector<size_t> sizes;
  SliceSizes(n, k, sizes);

  std::vector<uint64_t> part_hist((size_t)k * kNumSyms, 0);
  uint64_t total[kNumSyms] = {};
  {
    size_t off = 0;
    for (int s = 0; s < k; ++s) {
      Histogram(data + off, sizes[s], &part_hist[(size_t)s * kNumSyms]);
      off += sizes[s];
      for (int v = 0; v < kNumSyms; ++v)
        total[v] += part_hist[(size_t)s * kNumSyms + v];
    }
  }
  Coding cc;
  BuildCoding(total, &cc);

  // Exact per-stream bit counts -> region sizes -> end offsets.
  std::vector<size_t> region(k), endoff(k);
  size_t payload = 0;
  for (int s = 0; s < k; ++s) {
    uint64_t bits = 0;
    for (int v = 0; v < kNumSyms; ++v)
      bits += part_hist[(size_t)s * kNumSyms + v] * cc.code_lens[v];
    region[s] = (size_t)((bits + 7) / 8) + kSlop;
    payload += region[s];
    endoff[s] = payload;
  }

  // Header.
  std::vector<uint8_t> hdr;
  hdr.reserve(16 + 256 + 4 * k);
  WriteU32(hdr, (uint32_t)n);
  WriteU32(hdr, cc.len_mask);
  for (int l = 0; l <= kMaxLen; ++l)
    if (cc.len_count[l]) hdr.push_back((uint8_t)(cc.len_count[l] & 0xFF));
  for (int i = 0; i < cc.num_syms; ++i) hdr.push_back(cc.sorted_syms[i]);
  for (int s = 0; s < k - 1; ++s) WriteU32(hdr, (uint32_t)endoff[s]);

  size_t total_size = hdr.size() + payload;
  if (total_size > out_cap) return 0;
  std::memcpy(out, hdr.data(), hdr.size());
  uint8_t* pay = out + hdr.size();
  std::memset(pay, 0, payload);

  // Merged encode table: one load per symbol (code<<8 | len) instead of
  // two array reads.
  uint32_t enc[kNumSyms];
  for (int v = 0; v < kNumSyms; ++v)
    enc[v] = ((uint32_t)cc.code_bits[v] << 8) | cc.code_lens[v];

  // Streams are encoded in PAIRS: two independent acc/nbits chains keep
  // the out-of-order core busy where a single writer's serial
  // accumulator RMW chain stalls it — the encode-side use of the
  // reference's multi-chain insight (README.md:15-27).  Bit output per
  // stream is unchanged (bit-exact vs the golden model).
  std::vector<size_t> rs(k);
  {
    size_t rstart = 0, off2 = 0;
    for (int s = 0; s < k; ++s) {
      rs[s] = rstart;
      rstart += region[s];
      off2 += sizes[s];
    }
  }
  std::vector<size_t> ob(k);
  {
    size_t oo = 0;
    for (int s = 0; s < k; ++s) {
      ob[s] = oo;
      oo += sizes[s];
    }
  }
  auto encode_tail = [&](BitWriter& bw, const uint8_t* p, size_t i, size_t m) {
    for (; i + 4 <= m; i += 4) {
      // 4 codes (<= 48 bits) per bulk flush, as the reference's writer
      // batches 4 WriteFast per Flush (huffman.cpp:832-836).
      uint32_t e0 = enc[p[i]], e1 = enc[p[i + 1]];
      uint32_t e2 = enc[p[i + 2]], e3 = enc[p[i + 3]];
      bw.Put(e0 >> 8, e0 & 0xFF);
      bw.Put(e1 >> 8, e1 & 0xFF);
      bw.Put(e2 >> 8, e2 & 0xFF);
      bw.Put(e3 >> 8, e3 & 0xFF);
      bw.FlushBulk();
    }
    for (; i < m; ++i) bw.Put(enc[p[i]] >> 8, enc[p[i]] & 0xFF);
    bw.Finish();
  };
  int s = 0;
  for (; s + 2 <= k; s += 2) {
    BitWriter bwa(pay + rs[s] + region[s]);
    BitWriter bwb(pay + rs[s + 1] + region[s + 1]);
    const uint8_t* pa = data + ob[s];
    const uint8_t* pb = data + ob[s + 1];
    size_t ma = sizes[s], mb = sizes[s + 1];
    size_t both = std::min(ma, mb) & ~(size_t)3;
    size_t i = 0;
    for (; i < both; i += 4) {
      uint32_t a0 = enc[pa[i]], a1 = enc[pa[i + 1]];
      uint32_t a2 = enc[pa[i + 2]], a3 = enc[pa[i + 3]];
      uint32_t b0 = enc[pb[i]], b1 = enc[pb[i + 1]];
      uint32_t b2 = enc[pb[i + 2]], b3 = enc[pb[i + 3]];
      bwa.Put(a0 >> 8, a0 & 0xFF);
      bwb.Put(b0 >> 8, b0 & 0xFF);
      bwa.Put(a1 >> 8, a1 & 0xFF);
      bwb.Put(b1 >> 8, b1 & 0xFF);
      bwa.Put(a2 >> 8, a2 & 0xFF);
      bwb.Put(b2 >> 8, b2 & 0xFF);
      bwa.Put(a3 >> 8, a3 & 0xFF);
      bwb.Put(b3 >> 8, b3 & 0xFF);
      bwa.FlushBulk();
      bwb.FlushBulk();
    }
    encode_tail(bwa, pa, i, ma);
    encode_tail(bwb, pb, i, mb);
    // Bulk flushes smear not-yet-final bits below the final stream head;
    // the format keeps slop bytes zero (bit-exact vs the golden model).
    std::memset(pay + rs[s], 0, (size_t)(bwa.end - (pay + rs[s])));
    std::memset(pay + rs[s + 1], 0, (size_t)(bwb.end - (pay + rs[s + 1])));
  }
  for (; s < k; ++s) {
    BitWriter bw(pay + rs[s] + region[s]);
    encode_tail(bw, data + ob[s], 0, sizes[s]);
    std::memset(pay + rs[s], 0, (size_t)(bw.end - (pay + rs[s])));
  }
  return total_size;
}

// Raw size recorded in a compressed blob.
size_t hh_raw_size(const uint8_t* blob, size_t blob_len) {
  if (blob_len < 8) return 0;
  return ReadU32(blob);
}

// Decompress a ref-profile blob (k must match the encoder's).  Returns
// bytes written, or (size_t)-1 on error.
size_t hh_decompress(const uint8_t* blob, size_t blob_len, int k,
                     uint8_t* out, size_t out_cap) {
  if (blob_len < 8) return (size_t)-1;
  size_t n = ReadU32(blob);
  uint32_t len_mask = ReadU32(blob + 4);
  if (n > out_cap) return (size_t)-1;
  if (len_mask >> (kMaxLen + 1)) return (size_t)-1;
  size_t pos = 8;

  uint16_t len_count[kMaxLen + 1] = {};
  int pops = __builtin_popcount(len_mask);
  int num_syms = 0;
  for (int l = 0; l <= kMaxLen; ++l) {
    if (len_mask & (1u << l)) {
      if (pos >= blob_len) return (size_t)-1;
      int c = blob[pos++];
      if (c == 0) {
        // Count-overflow encoding: only legal for 256 codes of length 8.
        if (!(pops == 1 && l == 8)) return (size_t)-1;
        c = 256;
      }
      len_count[l] = (uint16_t)c;
      num_syms += c;
    }
  }
  // Structural validation (the reference skips this, README.md:140-146):
  // an invalid Kraft sum would walk BuildTables' fill loops out of the
  // 2^12-entry tables — heap corruption, not just garbage output.
  if (num_syms > 256) return (size_t)-1;
  if (num_syms >= 2) {
    if (len_count[0]) return (size_t)-1;
    uint64_t kraft = 0;
    for (int l = 0; l <= kMaxLen; ++l)
      kraft += (uint64_t)len_count[l] << (kMaxLen - l);
    if (kraft != (1u << kMaxLen)) return (size_t)-1;
  }
  if (pos + (size_t)num_syms > blob_len) return (size_t)-1;
  const uint8_t* sorted_syms = blob + pos;
  pos += num_syms;

  std::vector<size_t> endoff(k);
  for (int s = 0; s < k - 1; ++s) {
    if (pos + 4 > blob_len) return (size_t)-1;
    endoff[s] = ReadU32(blob + pos);
    pos += 4;
  }
  const uint8_t* pay = blob + pos;
  size_t pay_len = blob_len - pos;
  endoff[k - 1] = pay_len;

  // Plausibility: every symbol costs >= 1 payload bit, so raw_size can
  // never exceed 8x the payload (guards against a corrupt multi-GiB
  // raw_size field driving the decode loops).
  if (num_syms >= 2 && n > 8 * pay_len) return (size_t)-1;

  if (num_syms == 0) return n == 0 ? 0 : (size_t)-1;
  if (num_syms == 1) {
    std::memset(out, sorted_syms[0], n);
    return n;
  }

  std::vector<D1> t1;
  std::vector<D2> t2;
  BuildTables(len_count, sorted_syms, num_syms, t1, t2);

  std::vector<size_t> sizes;
  SliceSizes(n, k, sizes);

  // Stream bounds.
  std::vector<size_t> rbeg(k), rend(k), obeg(k);
  {
    size_t rstart = 0, oo = 0;
    for (int s = 0; s < k; ++s) {
      rbeg[s] = rstart;
      rend[s] = endoff[s];
      if (rend[s] > pay_len || rend[s] < rstart) return (size_t)-1;
      obeg[s] = oo;
      rstart = rend[s];
      oo += sizes[s];
    }
  }

  // Hot loop: decode FOUR streams in lockstep so the superscalar core
  // keeps four dependency chains in flight — the reference's central
  // multi-stream insight (README.md:15-27; interleaved loop
  // huffman.cpp:931-948), our own loop structure.
  auto finish_stream = [&](int s, size_t i) {
    BitReader br(pay + rbeg[s], pay + rend[s]);
    // Re-derive reader state by replaying is not possible; instead this
    // helper is only used from a fresh reader at i==0 (scalar path).
    uint8_t* op = out + obeg[s];
    size_t m = sizes[s];
    while (i + 2 <= m) {
      br.Fill();
      const D2& e = t2[br.Peek12()];
      op[i] = e.s0;
      op[i + 1] = e.s1;
      i += e.nsyms;
      br.Consume(e.nbits);
    }
    while (i < m) {
      br.Fill();
      const D1& e = t1[br.Peek12()];
      op[i++] = e.sym;
      br.Consume(e.len);
    }
  };

  int s0 = 0;
  for (; s0 + 4 <= k; s0 += 4) {
    BitReader br0(pay + rbeg[s0 + 0], pay + rend[s0 + 0]);
    BitReader br1(pay + rbeg[s0 + 1], pay + rend[s0 + 1]);
    BitReader br2(pay + rbeg[s0 + 2], pay + rend[s0 + 2]);
    BitReader br3(pay + rbeg[s0 + 3], pay + rend[s0 + 3]);
    uint8_t* o0 = out + obeg[s0 + 0];
    uint8_t* o1 = out + obeg[s0 + 1];
    uint8_t* o2 = out + obeg[s0 + 2];
    uint8_t* o3 = out + obeg[s0 + 3];
    size_t i0 = 0, i1 = 0, i2 = 0, i3 = 0;
    size_t m0 = sizes[s0], m1 = sizes[s0 + 1], m2 = sizes[s0 + 2],
           m3 = sizes[s0 + 3];
    size_t mmin = std::min(std::min(m0, m1), std::min(m2, m3));
    size_t guard = (mmin >= 9) ? mmin - 9 : 0;  // 4 rounds x <=2 syms + s1 slot
    size_t imax = 0;
    while (imax < guard) {
      br0.Fill();
      br1.Fill();
      br2.Fill();
      br3.Fill();
      // FOUR D2 decodes per stream per refill: a Fill leaves >= 56 bits
      // and the last of four 12-bit peeks starts at offset <= 36, so one
      // refill covers the whole round (the reference's 4-rounds-per-
      // refill interleave, huffman.cpp:931-948) — halves refill cost vs
      // the previous 2-per-refill loop.
      for (int rep = 0; rep < 4; ++rep) {
        const D2& a0 = t2[br0.Peek12()];
        const D2& a1 = t2[br1.Peek12()];
        const D2& a2 = t2[br2.Peek12()];
        const D2& a3 = t2[br3.Peek12()];
        o0[i0] = a0.s0;
        o0[i0 + 1] = a0.s1;
        o1[i1] = a1.s0;
        o1[i1 + 1] = a1.s1;
        o2[i2] = a2.s0;
        o2[i2 + 1] = a2.s1;
        o3[i3] = a3.s0;
        o3[i3 + 1] = a3.s1;
        i0 += a0.nsyms;
        i1 += a1.nsyms;
        i2 += a2.nsyms;
        i3 += a3.nsyms;
        br0.Consume(a0.nbits);
        br1.Consume(a1.nbits);
        br2.Consume(a2.nbits);
        br3.Consume(a3.nbits);
      }
      imax = std::max(std::max(i0, i1), std::max(i2, i3));
    }
    // Tails, one stream at a time with the live reader state.
    BitReader* brs[4] = {&br0, &br1, &br2, &br3};
    uint8_t* ops[4] = {o0, o1, o2, o3};
    size_t is[4] = {i0, i1, i2, i3};
    size_t ms[4] = {m0, m1, m2, m3};
    for (int j = 0; j < 4; ++j) {
      BitReader& br = *brs[j];
      uint8_t* op = ops[j];
      size_t i = is[j], m = ms[j];
      while (i + 2 <= m) {
        br.Fill();
        const D2& e = t2[br.Peek12()];
        op[i] = e.s0;
        op[i + 1] = e.s1;
        i += e.nsyms;
        br.Consume(e.nbits);
      }
      while (i < m) {
        br.Fill();
        const D1& e = t1[br.Peek12()];
        op[i++] = e.sym;
        br.Consume(e.len);
      }
    }
  }
  for (; s0 < k; ++s0) finish_stream(s0, 0);
  return n;
}

// Standalone helpers reused by tests/tools.
void hh_histogram(const uint8_t* data, size_t n, uint64_t out[256]) {
  Histogram(data, n, out);
}

// ---- HTP3 compact-profile bit-granular lane payload (host fast path) ----
//
// The tpu-profile compact layout (models/tpu_codec.py docstring)
// concatenates lane i's first bits[i] payload bits, MSB-first within
// each byte, with no per-lane byte rounding.  The NumPy reference
// implementation (_pack_lane_bits / _unpack_lane_bits) is the canonical
// semantics and costs ~150 ms per 16 MiB block; these single-pass
// bit-buffer versions are ~10x faster and are dispatched by
// huffman_tpu.native when the library is available.  Tests pin C ==
// NumPy byte-for-byte (test_tpu_codec.py::test_native_lane_bits_*).

// Pack k lanes of row stride nb into `out`; returns bytes written
// ((sum bits + 7) / 8).  `out` must have at least that capacity.
int64_t hp_pack_lane_bits(const uint8_t* lane_bytes, const int64_t* bits,
                          int64_t k, int64_t nb, uint8_t* out) {
  uint64_t buf = 0;
  int nbuf = 0;
  int64_t op = 0;
  for (int64_t i = 0; i < k; ++i) {
    const uint8_t* src = lane_bytes + i * nb;
    const int64_t nbits = bits[i];
    const int64_t full = nbits >> 3;
    const int rem = (int)(nbits & 7);
    for (int64_t j = 0; j < full; ++j) {
      buf = (buf << 8) | src[j];
      nbuf += 8;
      if (nbuf >= 8) {
        nbuf -= 8;
        out[op++] = (uint8_t)(buf >> nbuf);
      }
    }
    if (rem) {
      buf = (buf << rem) | (uint64_t)(src[full] >> (8 - rem));
      nbuf += rem;
      if (nbuf >= 8) {
        nbuf -= 8;
        out[op++] = (uint8_t)(buf >> nbuf);
      }
    }
  }
  if (nbuf) out[op++] = (uint8_t)(buf << (8 - nbuf));
  return op;
}

// Inverse: split `stream` into k rows of nb bytes (callers pass a
// ZEROED buffer; tails beyond each lane's bits stay zero, matching the
// NumPy reference).  Returns 0 on success, -1 if the stream is shorter
// than the bit counts imply.
int64_t hp_unpack_lane_bits(const uint8_t* stream, int64_t stream_len,
                            const int64_t* bits, int64_t k, int64_t nb,
                            uint8_t* out) {
  int64_t total = 0;
  for (int64_t i = 0; i < k; ++i) total += bits[i];
  if (total > stream_len * 8) return -1;
  uint64_t buf = 0;
  int nbuf = 0;
  int64_t sp = 0;
  for (int64_t i = 0; i < k; ++i) {
    uint8_t* dst = out + i * nb;
    const int64_t nbits = bits[i];
    const int64_t full = nbits >> 3;
    const int rem = (int)(nbits & 7);
    for (int64_t j = 0; j < full; ++j) {
      if (nbuf < 8) {
        buf = (buf << 8) | (sp < stream_len ? stream[sp] : 0);
        ++sp;
        nbuf += 8;
      }
      nbuf -= 8;
      dst[j] = (uint8_t)(buf >> nbuf);
    }
    if (rem) {
      if (nbuf < rem) {
        buf = (buf << 8) | (sp < stream_len ? stream[sp] : 0);
        ++sp;
        nbuf += 8;
      }
      nbuf -= rem;
      dst[full] = (uint8_t)(((buf >> nbuf) & ((1u << rem) - 1)) << (8 - rem));
    }
  }
  return 0;
}

}  // extern "C"

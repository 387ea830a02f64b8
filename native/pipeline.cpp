// Threaded block-pipeline file runtime for the ref-profile host codec.
//
// The reference is strictly single-threaded (SURVEY §2: "no threads
// even"); its unit of parallelism is K in-core streams.  This runtime
// adds the process-level axis the framework's device side gets from the
// 'data' mesh axis: independent blocks compressed/decompressed by a
// worker pool, sequenced into the same HTPC container the Python side
// reads (container.py layout).  Record kind 'R' = a ref-profile blob
// (huffman_host.cpp wire format, bit-identical to golden.py); its
// stream count k rides in the two header pad bytes.
//
// Compiled into libhuffman_host.so next to huffman_host.cpp.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <functional>
#include <string>
#include <thread>
#include <vector>

// From huffman_host.cpp (same shared object).
extern "C" {
size_t hh_compress_bound(size_t n, int k);
size_t hh_compress(const uint8_t* data, size_t n, int k, uint8_t* out,
                   size_t out_cap);
size_t hh_decompress(const uint8_t* blob, size_t blob_len, int k, uint8_t* out,
                     size_t out_cap);
}

namespace {

constexpr uint8_t kMagic[4] = {'H', 'T', 'P', 'C'};
constexpr uint8_t kKindStored = 0x53;  // 'S'
constexpr uint8_t kKindRef = 0x52;     // 'R'
constexpr uint8_t kKindCrc = 0x43;     // 'C' trailer: u32 crc32 of raw content

// CRC-32 (IEEE reflected, poly 0xEDB88320) — matches Python zlib.crc32,
// which writes/verifies the same container trailer (container.py).
uint32_t Crc32(const uint8_t* p, size_t n, uint32_t crc = 0) {
  static const auto table = [] {
    std::vector<uint32_t> t(256);
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t r = i;
      for (int b = 0; b < 8; ++b) r = (r >> 1) ^ (0xEDB88320u & (~(r & 1) + 1));
      t[i] = r;
    }
    return t;
  }();
  crc = ~crc;
  for (size_t i = 0; i < n; ++i) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// crc32(A++B) from crc32(A), crc32(B), len(B): zlib's GF(2) matrix-power
// method.  Lets the worker pool crc blocks in parallel (a serial whole-
// file crc would rate-limit the threaded pipeline to ~0.5 GB/s).
uint32_t Gf2Times(const uint32_t* mat, uint32_t vec) {
  uint32_t sum = 0;
  for (int i = 0; vec; vec >>= 1, ++i)
    if (vec & 1) sum ^= mat[i];
  return sum;
}
void Gf2Square(uint32_t* sq, const uint32_t* mat) {
  for (int n = 0; n < 32; ++n) sq[n] = Gf2Times(mat, mat[n]);
}
uint32_t Crc32Combine(uint32_t crc1, uint32_t crc2, uint64_t len2) {
  if (len2 == 0) return crc1;
  uint32_t even[32], odd[32];
  odd[0] = 0xEDB88320u;  // the crc polynomial advances one zero bit
  uint32_t row = 1;
  for (int n = 1; n < 32; ++n, row <<= 1) odd[n] = row;
  Gf2Square(even, odd);  // two bits
  Gf2Square(odd, even);  // four bits
  do {  // apply len2 zero BYTES: square to 2x bytes each step
    Gf2Square(even, odd);
    if (len2 & 1) crc1 = Gf2Times(even, crc1);
    len2 >>= 1;
    if (!len2) break;
    Gf2Square(odd, even);
    if (len2 & 1) crc1 = Gf2Times(odd, crc1);
    len2 >>= 1;
  } while (len2);
  return crc1 ^ crc2;
}

void PutU32(std::string& s, uint32_t v) {
  char b[4] = {(char)(v & 0xFF), (char)((v >> 8) & 0xFF), (char)((v >> 16) & 0xFF),
               (char)((v >> 24) & 0xFF)};
  s.append(b, 4);
}
void PutU64(std::string& s, uint64_t v) {
  PutU32(s, (uint32_t)(v & 0xFFFFFFFFu));
  PutU32(s, (uint32_t)(v >> 32));
}
uint32_t GetU32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint64_t GetU64(const uint8_t* p) {
  return (uint64_t)GetU32(p) | ((uint64_t)GetU32(p + 4) << 32);
}

// Run fn(i) for i in [0, n) on up to `threads` workers.  Returns false
// if any call threw (e.g. bad_alloc in a worker's buffer resize) — an
// uncaught exception in a std::thread would std::terminate the whole
// embedding process, defeating the never-abort-through-the-C-ABI guard.
bool ParallelFor(long n, int threads, const std::function<void(long)>& fn) {
  std::atomic<bool> ok{true};
  auto safe = [&](long i) {
    try {
      fn(i);
    } catch (...) {
      ok = false;
    }
  };
  if (threads < 1) threads = 1;
  if (n <= 1 || threads == 1) {
    for (long i = 0; i < n && ok; ++i) safe(i);
    return ok;
  }
  std::atomic<long> next{0};
  auto worker = [&] {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n || !ok) return;
      safe(i);
    }
  };
  int nt = (int)std::min<long>(threads, n);
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  for (int t = 0; t < nt - 1; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return ok;
}

bool ReadAll(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz < 0) {
    std::fclose(f);
    return false;
  }
  out.resize((size_t)sz);
  size_t rd = sz ? std::fread(out.data(), 1, (size_t)sz, f) : 0;
  std::fclose(f);
  return rd == (size_t)sz;
}

bool WriteAll(const char* path, const void* data, size_t n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  size_t wr = n ? std::fwrite(data, 1, n, f) : 0;
  std::fclose(f);
  return wr == n;
}

}  // namespace

extern "C" {

// Compress `in_path` into an HTPC container of ref-profile records at
// `out_path`.  Returns bytes written, or -1 on error.
long hp_compress_file(const char* in_path, const char* out_path, long block,
                      int k, int threads) {
  if (block <= 0 || k < 1) return -1;
  std::vector<uint8_t> raw;
  if (!ReadAll(in_path, raw)) return -1;
  const long n = (long)raw.size();
  const long nb = n ? (n + block - 1) / block : 1;

  struct Rec {
    uint8_t kind;
    uint32_t raw_len;
    uint32_t crc;
    std::string payload;
  };
  std::vector<Rec> recs(nb);

  bool ok = ParallelFor(nb, threads, [&](long i) {
    long off = i * block;
    long m = std::min(block, n - off);
    Rec& r = recs[i];
    r.raw_len = (uint32_t)std::max<long>(m, 0);
    r.crc = m > 0 ? Crc32(raw.data() + off, (size_t)m) : 0;
    if (m <= 0) {
      r.kind = kKindRef;
      return;
    }
    size_t bound = hh_compress_bound((size_t)m, k);
    std::string buf;
    buf.resize(bound);
    size_t sz =
        hh_compress(raw.data() + off, (size_t)m, k, (uint8_t*)buf.data(), bound);
    if (sz != 0 && sz < (size_t)m + 8) {
      buf.resize(sz);
      r.kind = kKindRef;
      r.payload = std::move(buf);
    } else {
      // Incompressible (or error): stored record — the fallback the
      // reference's in-repo codecs lack (only its Huff0 wrapper has one,
      // huff0.cpp:23-31).
      r.kind = kKindStored;
      r.payload.assign((const char*)raw.data() + off, (size_t)m);
    }
  });
  if (!ok) return -1;

  std::string out;
  out.append((const char*)kMagic, 4);
  PutU32(out, (uint32_t)block);
  PutU64(out, (uint64_t)n);
  for (auto& r : recs) {
    PutU32(out, (uint32_t)r.payload.size());
    PutU32(out, r.raw_len);
    out.push_back((char)r.kind);
    // Pad bytes carry k (u16 LE) for 'R' records; zero otherwise.
    uint16_t kx = r.kind == kKindRef ? (uint16_t)k : 0;
    out.push_back((char)(kx & 0xFF));
    out.push_back((char)(kx >> 8));
    out.push_back(0);
    out += r.payload;
  }
  // Integrity trailer: whole-content crc from the per-block worker crcs.
  uint32_t crc = 0;
  for (auto& r : recs) crc = Crc32Combine(crc, r.crc, r.raw_len);
  PutU32(out, 4);  // rec_len
  PutU32(out, 0);  // raw_len
  out.push_back((char)kKindCrc);
  out.append(3, '\0');
  PutU32(out, crc);
  if (!WriteAll(out_path, out.data(), out.size())) return -1;
  return (long)out.size();
}

// Decompress an HTPC container of 'R'/'S' records.  Returns bytes
// written, or -1 on error (including containers holding record kinds
// this runtime cannot decode, e.g. tpu-profile 'H' blobs).
long hp_decompress_file(const char* in_path, const char* out_path,
                        int threads) {
  std::vector<uint8_t> blob;
  if (!ReadAll(in_path, blob)) return -1;
  if (blob.size() < 16 || std::memcmp(blob.data(), kMagic, 4) != 0) return -1;
  uint64_t block_size = GetU32(blob.data() + 4);
  uint64_t total = GetU64(blob.data() + 8);

  struct Rec {
    uint8_t kind;
    uint16_t k;
    uint32_t raw_len;
    const uint8_t* p;
    uint32_t len;
    uint64_t out_off;
    uint32_t crc = 0;  // of this record's decoded bytes (worker-computed)
  };
  std::vector<Rec> recs;
  size_t pos = 16;
  uint64_t out_off = 0;
  while (pos < blob.size()) {
    if (pos + 12 > blob.size()) return -1;
    uint32_t rec_len = GetU32(blob.data() + pos);
    uint32_t raw_len = GetU32(blob.data() + pos + 4);
    uint8_t kind = blob[pos + 8];
    uint16_t kx = (uint16_t)blob[pos + 9] | ((uint16_t)blob[pos + 10] << 8);
    pos += 12;
    if (pos + rec_len > blob.size()) return -1;
    // Structural sanity from untrusted fields: no record may claim more
    // raw bytes than the container's own block size.
    if (raw_len > block_size) return -1;
    recs.push_back({kind, kx, raw_len, blob.data() + pos, rec_len, out_off});
    out_off += raw_len;
    pos += rec_len;
  }
  if (out_off != total) return -1;

  // A corrupt header can still claim an absurd total (e.g. huge
  // block_size x many records); allocation failure must come back as an
  // error code, never a bad_alloc abort through the C ABI.
  std::vector<uint8_t> out;
  try {
    out.resize(total);
  } catch (const std::exception&) {
    return -1;
  }
  std::atomic<bool> fail{false};
  bool ran = ParallelFor((long)recs.size(), threads, [&](long i) {
    Rec& r = recs[i];
    if (r.raw_len == 0) return;  // incl. the 'C' integrity trailer
    if (r.kind == kKindStored) {
      if (r.len != r.raw_len) {
        fail = true;
        return;
      }
      std::memcpy(out.data() + r.out_off, r.p, r.raw_len);
    } else if (r.kind == kKindRef) {
      // kx == 0 on an 'R' record is malformed (container.decode_record
      // enforces 1 <= kx), and a short decode would leave silently
      // zero-filled tail bytes — require the exact record length back.
      if (r.k < 1) {
        fail = true;
        return;
      }
      size_t got = hh_decompress(r.p, r.len, r.k, out.data() + r.out_off, r.raw_len);
      if (got != (size_t)r.raw_len) {
        fail = true;
        return;
      }
    } else {
      fail = true;  // 'H' (tpu-profile) records need the Python decoder
      return;
    }
    r.crc = Crc32(out.data() + r.out_off, r.raw_len);
  });
  if (fail || !ran) return -1;
  // Verify the 'C' trailer when present (older containers lack one):
  // combine the workers' per-record crcs in output order.
  bool have_want = false;
  uint32_t want = 0;
  for (const Rec& r : recs) {
    if (r.kind == kKindCrc && r.len == 4) {
      have_want = true;
      want = GetU32(r.p);
    }
  }
  if (have_want) {
    uint32_t crc = 0;
    for (const Rec& r : recs) crc = Crc32Combine(crc, r.crc, r.raw_len);
    if (crc != want) return -1;
  }
  if (!WriteAll(out_path, out.data(), out.size())) return -1;
  return (long)out.size();
}

}  // extern "C"

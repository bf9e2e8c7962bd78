// Zstandard decoder (RFC 8878) of the PyTorch port's checkpoint reader:
// the JAX package's Orbax checkpoints hold zstd frames in their OCDBT files
// (ckpt/ocdbt.py) and zarr chunks (ckpt/zarr.py). Bound with ctypes by
// dnncancerannotator_torch/data/_native.py, which builds it with g++ at
// first use into build/torch_host/ beside the host data layer's sources.
//
// What it reads:
// - frames back to back, skippable frames between them, a window
//   descriptor or a single segment, the content-size field, and the XXH64
//   content checksum, checked when the frame's flag is set; a frame that
//   names a dictionary is refused;
// - raw, RLE and compressed blocks, at most 128 KiB each;
// - literals raw, RLE, Huffman-coded in 1 or 4 streams, or treeless (the
//   frame's previous Huffman table), the Huffman weights direct or
//   FSE-coded;
// - sequences with predefined, RLE, FSE and repeat tables, the three
//   repeat offsets (with the literal-length-0 rule), and matches that
//   overlap their own output.
// Every malformed input ends the call with an error message; nothing is
// written past the caller's buffer.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& why) { throw DecodeError(why); }

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMagicMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kBlockMax = 128 * 1024;

inline uint32_t read_le32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t read_le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// XXH64 with seed 0 (the content checksum keeps its low 32 bits) -------------

constexpr uint64_t kP1 = 11400714785074694791ull;
constexpr uint64_t kP2 = 14029467366897019727ull;
constexpr uint64_t kP3 = 1609587929392839161ull;
constexpr uint64_t kP4 = 9650029242287828579ull;
constexpr uint64_t kP5 = 2870177450012600261ull;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
  acc += input * kP2;
  acc = rotl64(acc, 31);
  return acc * kP1;
}

inline uint64_t xxh_merge(uint64_t acc, uint64_t val) {
  acc ^= xxh_round(0, val);
  return acc * kP1 + kP4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0 - kP1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, read_le64(p));
      v2 = xxh_round(v2, read_le64(p + 8));
      v3 = xxh_round(v3, read_le64(p + 16));
      v4 = xxh_round(v4, read_le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = kP5;
  }
  h += static_cast<uint64_t>(len);
  while (p + 8 <= end) {
    h ^= xxh_round(0, read_le64(p));
    h = rotl64(h, 27) * kP1 + kP4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(read_le32(p)) * kP1;
    h = rotl64(h, 23) * kP2 + kP3;
    p += 4;
  }
  while (p < end) {
    h ^= static_cast<uint64_t>(*p++) * kP5;
    h = rotl64(h, 11) * kP1;
  }
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

// Bit readers -----------------------------------------------------------------

// A backward bitstream (RFC 8878 §4.1): read from its last byte, whose
// highest set bit marks the start, towards its first. ``pos`` counts the
// bits not yet read; a read past the first byte gives zero bits and leaves
// ``pos`` negative (the "overflow" some decoders test for).
struct BackBits {
  const uint8_t* src = nullptr;
  int64_t size = 0;
  int64_t pos = 0;

  void init(const uint8_t* s, size_t n, const char* what) {
    if (n == 0) fail(std::string("empty bitstream in ") + what);
    src = s;
    size = static_cast<int64_t>(n);
    uint8_t last = s[n - 1];
    if (last == 0) fail(std::string("bitstream of ") + what + " ends in a zero byte");
    pos = (size - 1) * 8 + highbit(last);
  }

  // 64 bits from byte ``b`` on, zeros outside the stream
  uint64_t window(int64_t b) const {
    if (b >= 0 && b + 8 <= size) return read_le64(src + b);
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) {
      int64_t j = b + i;
      if (j >= 0 && j < size) v |= static_cast<uint64_t>(src[j]) << (8 * i);
    }
    return v;
  }

  // the ``n`` (<= 56) bits below ``pos``, without consuming them
  uint64_t peek(int n) const {
    int64_t p = pos - n;
    if (p >= 0) return (window(p >> 3) >> (p & 7)) & ((1ull << n) - 1);
    if (pos <= 0) return 0;
    return (window(0) & ((1ull << pos) - 1)) << (-p);
  }

  uint64_t read(int n) {
    if (n == 0) return 0;
    uint64_t v = peek(n);
    pos -= n;
    return v;
  }
};

// A forward little-endian bitstream, for the FSE table descriptions.
struct FwdBits {
  const uint8_t* src;
  size_t size;
  size_t pos = 0;  // in bits

  FwdBits(const uint8_t* s, size_t n) : src(s), size(n) {}

  uint32_t peek32() const {
    uint64_t v = 0;
    size_t b = pos >> 3;
    for (int i = 0; i < 5; ++i)
      if (b + i < size) v |= static_cast<uint64_t>(src[b + i]) << (8 * i);
    return static_cast<uint32_t>(v >> (pos & 7));
  }
  void skip(int n) { pos += n; }
  size_t bytes_used() const { return (pos + 7) >> 3; }
};

// FSE tables ------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t nb_bits;
  uint16_t base;  // the next state is base + the nb_bits read
};

struct FseTable {
  int log = -1;  // -1: no table yet
  std::vector<FseEntry> cells;
};

// Read a normalized distribution (RFC 8878 §4.1.1) from ``src``: fills
// ``norm`` for symbols 0..max_symbol, returns the bytes read and sets
// ``log``.
size_t read_ncount(const uint8_t* src, size_t n, int max_log, int max_symbol,
                   std::vector<int16_t>& norm, int& log, const char* what) {
  if (n == 0) fail(std::string("missing FSE table description of ") + what);
  FwdBits bits(src, n);
  uint32_t w = bits.peek32();
  log = static_cast<int>(w & 0xF) + 5;
  bits.skip(4);
  if (log > max_log)
    fail(std::string("FSE accuracy log ") + std::to_string(log) + " above " +
         std::to_string(max_log) + " in " + what);
  norm.assign(max_symbol + 1, 0);
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nb_bits = log + 1;
  int symbol = 0;
  bool previous0 = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous0) {
      int n0 = symbol;
      for (;;) {
        uint32_t r = bits.peek32() & 3;
        bits.skip(2);
        n0 += static_cast<int>(r);
        if (r != 3) break;
        if (n0 > max_symbol) break;
      }
      if (n0 > max_symbol)
        fail(std::string("FSE zero-run past the last symbol in ") + what);
      while (symbol < n0) norm[symbol++] = 0;
      if (bits.pos > n * 8)
        fail(std::string("FSE table description of ") + what + " is truncated");
      if (symbol > max_symbol) break;
    }
    w = bits.peek32();
    int max = (2 * threshold - 1) - remaining;
    int count;
    if (static_cast<int>(w & (threshold - 1)) < max) {
      count = static_cast<int>(w & (threshold - 1));
      bits.skip(nb_bits - 1);
    } else {
      count = static_cast<int>(w & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      bits.skip(nb_bits);
    }
    --count;  // 0 stands for "less than 1" (-1)
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = static_cast<int16_t>(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --nb_bits;
      threshold >>= 1;
    }
    if (bits.pos > n * 8)
      fail(std::string("FSE table description of ") + what + " is truncated");
  }
  if (remaining != 1)
    fail(std::string("FSE probabilities of ") + what + " do not sum to the table size");
  norm.resize(symbol);
  return bits.bytes_used();
}

void build_fse(const std::vector<int16_t>& norm, int log, FseTable& table,
               const char* what) {
  int size = 1 << log;
  table.log = log;
  table.cells.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail(std::string("too many low-probability symbols in ") + what);
      table.cells[high--].symbol = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint32_t>(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3;
  int mask = size - 1;
  int position = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      table.cells[position].symbol = static_cast<uint16_t>(s);
      do {
        position = (position + step) & mask;
      } while (position > high);
    }
  }
  if (position != 0) fail(std::string("FSE table of ") + what + " does not fill");
  for (int u = 0; u < size; ++u) {
    FseEntry& e = table.cells[u];
    uint32_t state = next[e.symbol]++;
    if (state == 0) fail(std::string("FSE table of ") + what + " is malformed");
    int nb = log - highbit(state);
    e.nb_bits = static_cast<uint8_t>(nb);
    e.base = static_cast<uint16_t>((state << nb) - size);
  }
}

void rle_fse(uint8_t symbol, FseTable& table) {
  table.log = 0;
  table.cells.assign(1, FseEntry{symbol, 0, 0});
}

struct FseState {
  const FseTable* table;
  uint32_t state;
  void init(const FseTable& t, BackBits& bits) {
    table = &t;
    state = static_cast<uint32_t>(bits.read(t.log));
  }
  uint16_t symbol() const { return table->cells[state].symbol; }
  void update(BackBits& bits) {
    const FseEntry& e = table->cells[state];
    state = e.base + static_cast<uint32_t>(bits.read(e.nb_bits));
  }
};

// Huffman tables -------------------------------------------------------------

constexpr int kHufMaxBits = 11;

struct HufTable {
  int max_bits = 0;         // 0: no table yet
  std::vector<uint16_t> dt;  // by the next max_bits bits: symbol << 8 | code length
};

void build_huffman(const uint8_t* weights, int n_weights, HufTable& table) {
  // the last symbol's weight is implied by the others
  uint32_t total = 0;
  for (int i = 0; i < n_weights; ++i) {
    if (weights[i] > kHufMaxBits) fail("Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("Huffman weights are all zero");
  int max_bits = highbit(total) + 1;
  if (max_bits > kHufMaxBits) fail("Huffman code longer than 11 bits");
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights leave no power of two for the last symbol");
  int n = n_weights + 1;
  std::vector<uint8_t> w(weights, weights + n_weights);
  w.push_back(static_cast<uint8_t>(highbit(rest) + 1));
  uint32_t rank_start[kHufMaxBits + 2] = {0};
  uint32_t rank_count[kHufMaxBits + 2] = {0};
  for (int s = 0; s < n; ++s) rank_count[w[s]]++;
  uint32_t next = 0;
  for (int k = 1; k <= max_bits; ++k) {
    rank_start[k] = next;
    next += rank_count[k] << (k - 1);
  }
  int size = 1 << max_bits;
  if (next != static_cast<uint32_t>(size)) fail("Huffman weights do not fill the table");
  table.max_bits = max_bits;
  table.dt.assign(size, 0);
  for (int s = 0; s < n; ++s) {
    if (!w[s]) continue;
    uint32_t length = (1u << w[s]) >> 1;
    uint32_t start = rank_start[w[s]];
    uint16_t entry = static_cast<uint16_t>(s << 8 | (max_bits + 1 - w[s]));
    std::fill(table.dt.begin() + start, table.dt.begin() + start + length, entry);
    rank_start[w[s]] += length;
  }
}

// Read a Huffman tree description; returns its size in bytes.
size_t read_huffman(const uint8_t* src, size_t n, HufTable& table) {
  if (n == 0) fail("missing Huffman tree description");
  uint8_t header = src[0];
  uint8_t weights[256];
  int n_weights = 0;
  size_t used;
  if (header >= 128) {
    n_weights = header - 127;
    used = 1 + (n_weights + 1) / 2;
    if (used > n) fail("Huffman weights are truncated");
    for (int i = 0; i < n_weights; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 0xF) : (b >> 4);
    }
  } else {
    size_t csize = header;
    used = 1 + csize;
    if (used > n) fail("FSE-coded Huffman weights are truncated");
    std::vector<int16_t> norm;
    int log;
    size_t hsize = read_ncount(src + 1, csize, 6, 255, norm, log, "Huffman weights");
    if (hsize >= csize) fail("FSE-coded Huffman weights have no bitstream");
    FseTable fse;
    build_fse(norm, log, fse, "Huffman weights");
    BackBits bits;
    bits.init(src + 1 + hsize, csize - hsize, "Huffman weights");
    FseState s1, s2;
    s1.init(fse, bits);
    s2.init(fse, bits);
    // two interleaved states; the stream ends when a read goes past its
    // start, and the other state gives the last weight
    for (;;) {
      if (n_weights > 253) fail("too many Huffman weights");
      weights[n_weights++] = static_cast<uint8_t>(s1.symbol());
      s1.update(bits);
      if (bits.pos < 0) {
        weights[n_weights++] = static_cast<uint8_t>(s2.symbol());
        break;
      }
      weights[n_weights++] = static_cast<uint8_t>(s2.symbol());
      s2.update(bits);
      if (bits.pos < 0) {
        weights[n_weights++] = static_cast<uint8_t>(s1.symbol());
        break;
      }
    }
  }
  if (n_weights > 255) fail("too many Huffman weights");
  build_huffman(weights, n_weights, table);
  return used;
}

// One Huffman stream being decoded: its bits, its bit position and where
// its symbols go. Kept in locals by the loops below: ``out`` is a byte
// pointer, and a store through it may alias any member the compiler would
// otherwise have to reload.
struct HufStream {
  const uint8_t* src;
  int64_t size;
  int64_t pos;
  uint8_t* out;
  size_t count;
};

HufStream open_stream(const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  BackBits bits;
  bits.init(src, n, "Huffman literals");
  return HufStream{src, bits.size, bits.pos, out, count};
}

// Four symbols of one stream from a 64-bit window; needs pos >= 64 and
// four symbols left (4 * 11 bits fit in the 56 the window guarantees).
inline void huf_step4(const uint16_t* dt, int mb, HufStream& s) {
  int64_t base = s.pos - 56;
  uint64_t w = read_le64(s.src + (base >> 3)) >> (base & 7);
  const uint64_t mask = (1ull << mb) - 1;
  int avail = 56;
  uint8_t* out = s.out;
  for (int k = 0; k < 4; ++k) {
    uint16_t e = dt[(w >> (avail - mb)) & mask];
    out[k] = static_cast<uint8_t>(e >> 8);
    avail -= e & 0xFF;
  }
  s.out = out + 4;
  s.count -= 4;
  s.pos = base + avail;
}

void huf_finish(const HufTable& t, HufStream s) {
  const uint16_t* dt = t.dt.data();
  const int mb = t.max_bits;
  while (s.count >= 4 && s.pos >= 64) huf_step4(dt, mb, s);
  BackBits bits;
  bits.src = s.src;
  bits.size = s.size;
  bits.pos = s.pos;
  for (size_t i = 0; i < s.count; ++i) {
    uint16_t e = dt[bits.peek(mb)];
    s.out[i] = static_cast<uint8_t>(e >> 8);
    bits.pos -= e & 0xFF;
    if (bits.pos < 0) fail("Huffman stream read past its start");
  }
  if (bits.pos != 0) fail("Huffman stream not consumed exactly");
}

void decode_huffman_1(const HufTable& t, const uint8_t* src, size_t n, uint8_t* out,
                      size_t count) {
  huf_finish(t, open_stream(src, n, out, count));
}

// The four streams in lockstep (four independent chains of table loads),
// then each one's rest alone.
void decode_huffman_4(const HufTable& t, const uint8_t* const src[4], const size_t n[4],
                      uint8_t* const out[4], const size_t count[4]) {
  HufStream a = open_stream(src[0], n[0], out[0], count[0]);
  HufStream b = open_stream(src[1], n[1], out[1], count[1]);
  HufStream c = open_stream(src[2], n[2], out[2], count[2]);
  HufStream d = open_stream(src[3], n[3], out[3], count[3]);
  const uint16_t* dt = t.dt.data();
  const int mb = t.max_bits;
  while (a.count >= 4 && b.count >= 4 && c.count >= 4 && d.count >= 4 && a.pos >= 64 &&
         b.pos >= 64 && c.pos >= 64 && d.pos >= 64) {
    huf_step4(dt, mb, a);
    huf_step4(dt, mb, b);
    huf_step4(dt, mb, c);
    huf_step4(dt, mb, d);
  }
  huf_finish(t, a);
  huf_finish(t, b);
  huf_finish(t, c);
  huf_finish(t, d);
}

// Sequences -------------------------------------------------------------------

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11,
    12, 13, 14, 15, 16, 18, 20, 22, 24, 28, 32, 40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
    16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                                -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct SeqKind {
  const char* name;
  int max_log;
  int max_symbol;
  const int16_t* defaults;
  int n_defaults;
  int default_log;
};

const SeqKind kLL = {"literal lengths", 9, 35, kLLDefault, 36, 6};
const SeqKind kOF = {"offsets", 8, 31, kOFDefault, 29, 5};
const SeqKind kML = {"match lengths", 9, 52, kMLDefault, 53, 6};

struct Output {
  uint8_t* dst;
  size_t cap;
  size_t pos = 0;
  std::vector<uint8_t>* grow;  // measuring: the bytes go here instead

  void reserve(size_t n) {
    if (pos + n <= cap) return;
    if (grow == nullptr)
      fail("decoded data exceed the " + std::to_string(cap) + " bytes expected");
    size_t want = std::max(pos + n, grow->size() * 2 + 4096);
    grow->resize(want);
    dst = grow->data();
    cap = want;
  }
};

class Decoder {
 public:
  explicit Decoder(Output& out) : out_(out) {}

  void decode_all(const uint8_t* src, size_t n) {
    size_t pos = 0;
    while (pos < n) {
      if (n - pos < 4) fail("trailing bytes that are not a frame");
      uint32_t magic = read_le32(src + pos);
      if ((magic & kSkippableMagicMask) == kSkippableMagic) {
        if (n - pos < 8) fail("skippable frame header is truncated");
        uint64_t len = read_le32(src + pos + 4);
        if (len > n - pos - 8) fail("skippable frame is truncated");
        pos += 8 + len;
        continue;
      }
      if (magic != kFrameMagic) fail("bad frame magic number");
      pos += decode_frame(src + pos + 4, n - pos - 4) + 4;
    }
  }

 private:
  Output& out_;
  size_t frame_start_ = 0;
  uint32_t rep_[3] = {1, 4, 8};
  HufTable huf_;
  FseTable ll_, of_, ml_;
  std::vector<uint8_t> literals_;

  size_t decode_frame(const uint8_t* src, size_t n) {
    if (n < 1) fail("frame header is truncated");
    uint8_t fhd = src[0];
    int fcs_flag = fhd >> 6;
    bool single = (fhd >> 5) & 1;
    if (fhd & 0x08) fail("reserved bit set in the frame header");
    bool checksum = (fhd >> 2) & 1;
    int did_flag = fhd & 3;
    size_t pos = 1;
    uint64_t window = 0;
    if (!single) {
      if (pos >= n) fail("frame header is truncated");
      uint8_t wd = src[pos++];
      int wlog = 10 + (wd >> 3);
      uint64_t wbase = 1ull << wlog;
      window = wbase + (wbase / 8) * (wd & 7);
    }
    static const int kDidSize[4] = {0, 1, 2, 4};
    int did_size = kDidSize[did_flag];
    if (pos + did_size > n) fail("frame header is truncated");
    uint32_t did = 0;
    for (int i = 0; i < did_size; ++i) did |= static_cast<uint32_t>(src[pos + i]) << (8 * i);
    pos += did_size;
    if (did != 0) fail("frame needs dictionary " + std::to_string(did));
    static const int kFcsSize[4] = {0, 2, 4, 8};
    int fcs_size = (fcs_flag == 0 && single) ? 1 : kFcsSize[fcs_flag];
    bool has_size = fcs_size > 0;
    uint64_t content = 0;
    if (pos + fcs_size > n) fail("frame header is truncated");
    for (int i = 0; i < fcs_size; ++i) content |= static_cast<uint64_t>(src[pos + i]) << (8 * i);
    if (fcs_size == 2) content += 256;
    pos += fcs_size;
    if (single) window = content;
    size_t block_max = static_cast<size_t>(std::min<uint64_t>(window, kBlockMax));
    if (has_size && out_.grow == nullptr && content > out_.cap - out_.pos)
      fail("frame declares " + std::to_string(content) + " bytes, past the " +
           std::to_string(out_.cap) + " expected");

    frame_start_ = out_.pos;
    rep_[0] = 1;
    rep_[1] = 4;
    rep_[2] = 8;
    huf_.max_bits = 0;
    ll_.log = of_.log = ml_.log = -1;
    for (;;) {
      if (pos + 3 > n) fail("block header is truncated");
      uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
      pos += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type == 3) fail("reserved block type");
      if (type == 1) {
        if (size > block_max) fail("RLE block above the block size limit");
        if (pos + 1 > n) fail("RLE block is truncated");
        out_.reserve(size);
        std::memset(out_.dst + out_.pos, src[pos], size);
        out_.pos += size;
        pos += 1;
      } else {
        if (size > block_max) fail("block above the block size limit");
        if (pos + size > n) fail("block is truncated");
        if (type == 0) {
          out_.reserve(size);
          std::memcpy(out_.dst + out_.pos, src + pos, size);
          out_.pos += size;
        } else {
          decode_block(src + pos, size, block_max);
        }
        pos += size;
      }
      if (last) break;
    }
    size_t produced = out_.pos - frame_start_;
    if (has_size && produced != content)
      fail("frame decoded to " + std::to_string(produced) + " bytes, its header says " +
           std::to_string(content));
    if (checksum) {
      if (pos + 4 > n) fail("content checksum is truncated");
      uint32_t want = read_le32(src + pos);
      uint32_t got = static_cast<uint32_t>(xxh64(out_.dst + frame_start_, produced));
      if (want != got) fail("content checksum mismatch");
      pos += 4;
    }
    return pos;
  }

  // Returns the number of literals; they are in literals_.
  size_t decode_literals(const uint8_t* src, size_t n, size_t& used) {
    if (n < 1) fail("literals section is truncated");
    int type = src[0] & 3;
    int sf = (src[0] >> 2) & 3;
    if (type <= 1) {
      size_t regen, hsize;
      if ((sf & 1) == 0) {
        regen = src[0] >> 3;
        hsize = 1;
      } else if (sf == 1) {
        if (n < 2) fail("literals header is truncated");
        regen = (src[0] >> 4) | (static_cast<size_t>(src[1]) << 4);
        hsize = 2;
      } else {
        if (n < 3) fail("literals header is truncated");
        regen = (src[0] >> 4) | (static_cast<size_t>(src[1]) << 4) |
                (static_cast<size_t>(src[2]) << 12);
        hsize = 3;
      }
      if (regen > kBlockMax) fail("literals above the block size limit");
      literals_.resize(regen);
      if (type == 0) {
        if (hsize + regen > n) fail("raw literals are truncated");
        if (regen) std::memcpy(literals_.data(), src + hsize, regen);
        used = hsize + regen;
      } else {
        if (hsize + 1 > n) fail("RLE literals are truncated");
        if (regen) std::memset(literals_.data(), src[hsize], regen);
        used = hsize + 1;
      }
      return regen;
    }
    size_t regen, csize, hsize;
    int streams = sf == 0 ? 1 : 4;
    if (sf <= 1) {
      if (n < 3) fail("literals header is truncated");
      uint32_t h = src[0] | (src[1] << 8) | (src[2] << 16);
      regen = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
      hsize = 3;
    } else if (sf == 2) {
      if (n < 4) fail("literals header is truncated");
      uint32_t h = read_le32(src);
      regen = (h >> 4) & 0x3FFF;
      csize = (h >> 18) & 0x3FFF;
      hsize = 4;
    } else {
      if (n < 5) fail("literals header is truncated");
      uint64_t h = read_le32(src) | (static_cast<uint64_t>(src[4]) << 32);
      regen = (h >> 4) & 0x3FFFF;
      csize = (h >> 22) & 0x3FFFF;
      hsize = 5;
    }
    if (regen > kBlockMax) fail("literals above the block size limit");
    if (hsize + csize > n) fail("compressed literals are truncated");
    const uint8_t* p = src + hsize;
    size_t rest = csize;
    if (type == 2) {
      size_t tree = read_huffman(p, rest, huf_);
      p += tree;
      rest -= tree;
    } else if (huf_.max_bits == 0) {
      fail("treeless literals with no previous Huffman table");
    }
    literals_.resize(regen);
    if (streams == 1) {
      decode_huffman_1(huf_, p, rest, literals_.data(), regen);
    } else {
      if (rest < 6) fail("Huffman jump table is truncated");
      size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
      if (6 + s1 + s2 + s3 > rest) fail("Huffman jump table points past the literals");
      size_t s4 = rest - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("too few literals for four Huffman streams");
      const uint8_t* q = p + 6;
      uint8_t* lit = literals_.data();
      const uint8_t* const srcs[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
      const size_t sizes[4] = {s1, s2, s3, s4};
      uint8_t* const outs[4] = {lit, lit + seg, lit + 2 * seg, lit + 3 * seg};
      const size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
      decode_huffman_4(huf_, srcs, sizes, outs, counts);
    }
    used = hsize + csize;
    return regen;
  }

  size_t read_table(const uint8_t* src, size_t n, int mode, const SeqKind& kind,
                    FseTable& table) {
    switch (mode) {
      case 0: {
        std::vector<int16_t> norm(kind.defaults, kind.defaults + kind.n_defaults);
        build_fse(norm, kind.default_log, table, kind.name);
        return 0;
      }
      case 1:
        if (n < 1) fail(std::string("RLE table of ") + kind.name + " is truncated");
        if (src[0] > kind.max_symbol)
          fail(std::string("RLE symbol out of range for ") + kind.name);
        rle_fse(src[0], table);
        return 1;
      case 2: {
        std::vector<int16_t> norm;
        int log;
        size_t used = read_ncount(src, n, kind.max_log, kind.max_symbol, norm, log, kind.name);
        if (used > n) fail(std::string("FSE table of ") + kind.name + " is truncated");
        build_fse(norm, log, table, kind.name);
        return used;
      }
      default:
        if (table.log < 0)
          fail(std::string("repeat mode with no previous table of ") + kind.name);
        return 0;
    }
  }

  void copy_literals(const uint8_t*& lit, const uint8_t* lit_end, size_t count) {
    if (count > static_cast<size_t>(lit_end - lit)) fail("sequence takes more literals than the block has");
    out_.reserve(count);
    std::memcpy(out_.dst + out_.pos, lit, count);
    out_.pos += count;
    lit += count;
  }

  void copy_match(size_t offset, size_t length) {
    if (offset == 0 || offset > out_.pos - frame_start_)
      fail("match offset " + std::to_string(offset) + " reaches before the frame");
    out_.reserve(length);
    uint8_t* d = out_.dst + out_.pos;
    const uint8_t* s = d - offset;
    if (offset >= length) {
      std::memcpy(d, s, length);
    } else if (offset >= 8) {
      size_t i = 0;
      for (; i + 8 <= length; i += 8) std::memcpy(d + i, s + i, 8);
      for (; i < length; ++i) d[i] = s[i];
    } else {
      for (size_t i = 0; i < length; ++i) d[i] = s[i];  // overlaps its own output
    }
    out_.pos += length;
  }

  void decode_block(const uint8_t* src, size_t n, size_t block_max) {
    size_t block_start = out_.pos;
    size_t used;
    size_t n_lit = decode_literals(src, n, used);
    const uint8_t* p = src + used;
    size_t rest = n - used;
    if (rest < 1) fail("sequences section is missing");
    size_t n_seq;
    uint8_t b0 = p[0];
    if (b0 < 128) {
      n_seq = b0;
      p += 1;
      rest -= 1;
    } else if (b0 < 255) {
      if (rest < 2) fail("sequence count is truncated");
      n_seq = ((b0 - 128) << 8) + p[1];
      p += 2;
      rest -= 2;
    } else {
      if (rest < 3) fail("sequence count is truncated");
      n_seq = p[1] + (p[2] << 8) + 0x7F00;
      p += 3;
      rest -= 3;
    }
    const uint8_t* lit = literals_.data();
    const uint8_t* lit_end = lit + n_lit;
    if (n_seq == 0) {
      if (rest != 0) fail("bytes after an empty sequences section");
      copy_literals(lit, lit_end, n_lit);
      if (out_.pos - block_start > block_max) fail("block decodes past the block size limit");
      return;
    }
    if (rest < 1) fail("sequence modes are missing");
    uint8_t modes = p[0];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    p += 1;
    rest -= 1;
    size_t k = read_table(p, rest, modes >> 6, kLL, ll_);
    p += k;
    rest -= k;
    k = read_table(p, rest, (modes >> 4) & 3, kOF, of_);
    p += k;
    rest -= k;
    k = read_table(p, rest, (modes >> 2) & 3, kML, ml_);
    p += k;
    rest -= k;

    BackBits bits;
    bits.init(p, rest, "sequences");
    FseState ll, of, ml;
    ll.init(ll_, bits);
    of.init(of_, bits);
    ml.init(ml_, bits);
    for (size_t i = 0; i < n_seq; ++i) {
      uint32_t of_code = of.symbol();
      uint32_t ml_code = ml.symbol();
      uint32_t ll_code = ll.symbol();
      if (of_code > 31) fail("offset code above 31");
      uint32_t of_value = (1u << of_code) + static_cast<uint32_t>(bits.read(of_code));
      uint32_t match = kMLBase[ml_code] + static_cast<uint32_t>(bits.read(kMLBits[ml_code]));
      uint32_t litlen = kLLBase[ll_code] + static_cast<uint32_t>(bits.read(kLLBits[ll_code]));
      uint32_t offset;
      if (of_value > 3) {
        offset = of_value - 3;
        rep_[2] = rep_[1];
        rep_[1] = rep_[0];
        rep_[0] = offset;
      } else {
        uint32_t idx = of_value - 1 + (litlen == 0 ? 1 : 0);  // 0..3
        if (idx == 0) {
          offset = rep_[0];
        } else {
          offset = idx == 3 ? rep_[0] - 1 : rep_[idx];
          if (offset == 0) fail("repeat offset of zero");
          if (idx != 1) rep_[2] = rep_[1];
          rep_[1] = rep_[0];
          rep_[0] = offset;
        }
      }
      if (i + 1 < n_seq) {
        ll.update(bits);
        ml.update(bits);
        of.update(bits);
      }
      if (bits.pos < 0) fail("sequences bitstream read past its start");
      copy_literals(lit, lit_end, litlen);
      copy_match(offset, match);
    }
    if (bits.pos != 0) fail("sequences bitstream not consumed exactly");
    copy_literals(lit, lit_end, static_cast<size_t>(lit_end - lit));
    if (out_.pos - block_start > block_max) fail("block decodes past the block size limit");
  }
};

void set_error(char* err, int64_t err_cap, const char* msg) {
  if (err == nullptr || err_cap <= 0) return;
  std::snprintf(err, static_cast<size_t>(err_cap), "%s", msg);
}

}  // namespace

extern "C" {

// Decode every frame of src[0:n] into dst[0:cap]. Returns the number of
// bytes written, or -1 with the reason in err. With dst == NULL the bytes
// are decoded and counted but kept nowhere (the size of frames that do not
// declare theirs).
int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                        char* err, int64_t err_cap) {
  try {
    if (n < 0 || cap < 0) fail("negative size");
    std::vector<uint8_t> scratch;
    Output out{dst, static_cast<size_t>(cap), 0, dst == nullptr ? &scratch : nullptr};
    if (dst == nullptr) out.cap = 0;
    Decoder decoder(out);
    decoder.decode_all(src, static_cast<size_t>(n));
    return static_cast<int64_t>(out.pos);
  } catch (const std::exception& e) {  // DecodeError, or bad_alloc
    set_error(err, err_cap, e.what());
  }
  return -1;
}

}  // extern "C"

// TFRecord IO of the PyTorch port's host data layer (a copy of the JAX
// package's native/tfrecord_io.cc): CRC32C (Castagnoli, slicing-by-8) and
// record-frame indexing, bound with ctypes by
// dnncancerannotator_torch/data/_native.py, which builds it with g++ at
// first use into build/torch_host/. The chunked numpy CRC32C in
// data/tfrecord.py is the plain version it is tested against.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;  // reflected CRC32C

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int j = 0; j < 8; ++j) crc = (crc >> 1) ^ (kPoly & (0u - (crc & 1u)));
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = t[0][i];
      for (int k = 1; k < 8; ++k) {
        crc = t[0][crc & 0xFFu] ^ (crc >> 8);
        t[k][i] = crc;
      }
    }
  }
};

const Tables& tables() {
  static Tables tb;
  return tb;
}

}  // namespace

extern "C" {

uint32_t crc32c(const uint8_t* data, size_t n) {
  const Tables& tb = tables();
  uint32_t crc = 0xFFFFFFFFu;
  // slicing-by-8 over aligned body
  while (n >= 8) {
    uint32_t lo;
    uint32_t hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = tb.t[7][lo & 0xFFu] ^ tb.t[6][(lo >> 8) & 0xFFu] ^
          tb.t[5][(lo >> 16) & 0xFFu] ^ tb.t[4][lo >> 24] ^
          tb.t[3][hi & 0xFFu] ^ tb.t[2][(hi >> 8) & 0xFFu] ^
          tb.t[1][(hi >> 16) & 0xFFu] ^ tb.t[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = tb.t[0][(crc ^ *data++) & 0xFFu] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// Scan a TFRecord byte buffer and emit (offset, length) pairs of payloads.
// Returns the number of records found (at most max_records).
int64_t index_records(const uint8_t* buf, size_t size, int64_t* offsets,
                      int64_t* lengths, int64_t max_records) {
  size_t pos = 0;
  int64_t count = 0;
  while (pos + 12 <= size && count < max_records) {
    uint64_t length;
    std::memcpy(&length, buf + pos, 8);
    if (pos + 12 + length + 4 > size) break;
    offsets[count] = static_cast<int64_t>(pos + 12);
    lengths[count] = static_cast<int64_t>(length);
    pos += 12 + length + 4;
    ++count;
  }
  return count;
}

}  // extern "C"

// Exam decoder of the PyTorch port's host data layer (a copy of the JAX
// package's native/exam_decoder.cc): parse a serialized tf.train.Example of
// the exam schema (data/records.py: slices=TensorProto uint8 [S,H,W,C],
// patientID/examID int64, path/category bytes, shape int64 list,
// slice_types bytes list) and gather a channel subset (+ optional center
// crop) directly into a caller-provided C-contiguous buffer.
//
// It plays the role of tf.data's C++ Example parsing for the host streaming
// path; the pure-Python codec in data/tfrecord.py is the plain version it is
// tested against, and decodes the records this one declines (rc != 0). One
// pass with no intermediate copies: Python's `arr[..., idx]` +
// ascontiguousarray walks the tensor twice through a strided temporary.
//
// Built with g++ at first use by dnncancerannotator_torch/data/_native.py,
// together with tfrecord_io.cc, into build/torch_host/.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace {

struct Slice {
  const uint8_t* p = nullptr;
  size_t n = 0;
};

// Protobuf wire helpers ------------------------------------------------------

bool read_varint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    v |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

// Iterate fields of a message [p, end); invoke cb(field, wire, payload).
// Payload: length-delimited -> the bytes; varint -> value in val.
template <typename F>
bool for_fields(const uint8_t* p, const uint8_t* end, F&& cb) {
  while (p < end) {
    uint64_t key;
    if (!read_varint(p, end, &key)) return false;
    uint32_t field = static_cast<uint32_t>(key >> 3);
    uint32_t wire = key & 7;
    if (wire == 0) {  // varint
      uint64_t val;
      if (!read_varint(p, end, &val)) return false;
      cb(field, wire, Slice{nullptr, 0}, val);
    } else if (wire == 2) {  // length-delimited
      uint64_t n;
      // compare without pointer arithmetic: a huge crafted n would wrap
      // p + n (UB) and could pass a p + n > end check
      if (!read_varint(p, end, &n) ||
          n > static_cast<uint64_t>(end - p))
        return false;
      cb(field, wire, Slice{p, static_cast<size_t>(n)}, 0);
      p += n;
    } else if (wire == 5) {  // 32-bit
      if (p + 4 > end) return false;
      cb(field, wire, Slice{p, 4}, 0);
      p += 4;
    } else if (wire == 1) {  // 64-bit
      if (p + 8 > end) return false;
      cb(field, wire, Slice{p, 8}, 0);
      p += 8;
    } else {
      return false;
    }
  }
  return true;
}

struct Feature {
  // first two bytes values (bytes_list) and up to 8 int64s
  Slice bytes0, bytes1;
  int nbytes = 0;
  int64_t ints[8];
  int nints = 0;
  // all bytes_list entries concatenated with ',' go through types_out
  Slice all_bytes[16];
  int nall = 0;
};

// Decode a Feature message (bytes_list=1 / float_list=2 / int64_list=3).
void parse_feature(Slice f, Feature* out) {
  for_fields(f.p, f.p + f.n, [&](uint32_t field, uint32_t wire, Slice s,
                                 uint64_t) {
    if (field == 1 && wire == 2) {  // BytesList
      for_fields(s.p, s.p + s.n, [&](uint32_t bf, uint32_t bw, Slice bs,
                                     uint64_t) {
        if (bf == 1 && bw == 2) {
          if (out->nbytes == 0) out->bytes0 = bs;
          if (out->nbytes == 1) out->bytes1 = bs;
          ++out->nbytes;
          if (out->nall < 16) out->all_bytes[out->nall++] = bs;
        }
      });
    } else if (field == 3 && wire == 2) {  // Int64List
      for_fields(s.p, s.p + s.n, [&](uint32_t lf, uint32_t lw, Slice ls,
                                     uint64_t lv) {
        if (lf != 1) return;
        if (lw == 0) {
          if (out->nints < 8) out->ints[out->nints++] = static_cast<int64_t>(lv);
        } else if (lw == 2) {  // packed
          const uint8_t* q = ls.p;
          uint64_t v;
          while (q < ls.p + ls.n && read_varint(q, ls.p + ls.n, &v)) {
            if (out->nints < 8) out->ints[out->nints++] = static_cast<int64_t>(v);
          }
        }
      });
    }
  });
}

bool key_is(Slice key, const char* name) {
  size_t n = std::strlen(name);
  return key.n == n && std::memcmp(key.p, name, n) == 0;
}

// TensorProto: dtype=1 (varint), tensor_shape=2, tensor_content=4.
bool parse_tensor_u8(Slice t, Slice* content, int64_t* dims, int* ndims) {
  *ndims = 0;
  content->p = nullptr;
  bool ok = true;
  for_fields(t.p, t.p + t.n, [&](uint32_t field, uint32_t wire, Slice s,
                                 uint64_t v) {
    if (field == 1 && wire == 0) {
      if (v != 4) ok = false;  // DT_UINT8 only
    } else if (field == 2 && wire == 2) {  // TensorShapeProto
      for_fields(s.p, s.p + s.n, [&](uint32_t sf, uint32_t sw, Slice ds,
                                     uint64_t) {
        if (sf == 2 && sw == 2) {  // dim
          for_fields(ds.p, ds.p + ds.n, [&](uint32_t df, uint32_t dw,
                                            Slice, uint64_t dv) {
            if (df == 1 && dw == 0 && *ndims < 8)
              dims[(*ndims)++] = static_cast<int64_t>(dv);
          });
        }
      });
    } else if (field == 4 && wire == 2) {
      *content = s;
    }
  });
  return ok && content->p != nullptr;
}

void copy_str(Slice s, char* out, int64_t cap) {
  if (!out || cap <= 0) return;
  int64_t n = static_cast<int64_t>(s.n) < cap - 1
                  ? static_cast<int64_t>(s.n) : cap - 1;
  std::memcpy(out, s.p, static_cast<size_t>(n));
  out[n] = 0;
}

// Channel gather of one row with the output channel count known at compile
// time, so the inner loop fully unrolls and vectorizes.
template <int K>
uint8_t* gather_row(const uint8_t* row, int64_t cw, int64_t c_stride,
                    const int64_t* ci, uint8_t* dst) {
  for (int64_t x = 0; x < cw; ++x) {
    const uint8_t* px = row + x * c_stride;
    for (int c = 0; c < K; ++c) dst[c] = px[ci[c]];
    dst += K;
  }
  return dst;
}

uint8_t* gather_row_n(const uint8_t* row, int64_t cw, int64_t c_stride,
                      const int64_t* ci, int64_t k, uint8_t* dst) {
  switch (k) {
    case 1: return gather_row<1>(row, cw, c_stride, ci, dst);
    case 2: return gather_row<2>(row, cw, c_stride, ci, dst);
    case 3: return gather_row<3>(row, cw, c_stride, ci, dst);
    case 4: return gather_row<4>(row, cw, c_stride, ci, dst);
    case 5: return gather_row<5>(row, cw, c_stride, ci, dst);
    case 6: return gather_row<6>(row, cw, c_stride, ci, dst);
    case 7: return gather_row<7>(row, cw, c_stride, ci, dst);
    case 8: return gather_row<8>(row, cw, c_stride, ci, dst);
    default:
      for (int64_t x = 0; x < cw; ++x) {
        const uint8_t* px = row + x * c_stride;
        for (int64_t c = 0; c < k; ++c) *dst++ = px[ci[c]];
      }
      return dst;
  }
}

}  // namespace

extern "C" {

// Parse the Example in [rec, rec+len) and write:
//   shape_out[4]  = S, H, W, C (the stored tensor shape)
//   ids_out[2]    = patientID, examID
//   path_out      = exam path (NUL-terminated, truncated to path_cap)
//   cat_out       = category
//   types_out     = comma-joined slice_types
// When out != nullptr, additionally gather channels chan_idx[0..n_chan) of
// the stored tensor — optionally center-cropped to (crop_h, crop_w); pass
// -1 to keep full size — into out as C-contiguous [S, ch, cw, n_chan]
// uint8. Returns 0 on success; -1 parse error, -2 bad tensor, -3 capacity,
// -4 bad channel index.
int64_t exam_decode(const uint8_t* rec, int64_t len,
                    const int64_t* chan_idx, int64_t n_chan,
                    int64_t crop_h, int64_t crop_w,
                    uint8_t* out, int64_t out_cap,
                    int64_t* shape_out, int64_t* ids_out,
                    char* path_out, int64_t path_cap,
                    char* cat_out, int64_t cat_cap,
                    char* types_out, int64_t types_cap) {
  Slice slices_proto, path, category;
  Slice type_names[16];
  int n_types = 0;
  int64_t patient = 0, exam = 0;
  int64_t shape_feature[8];
  int n_shape_feature = 0;

  bool ok = for_fields(rec, rec + len, [&](uint32_t field, uint32_t wire,
                                           Slice s, uint64_t) {
    if (field != 1 || wire != 2) return;  // Example.features
    for_fields(s.p, s.p + s.n, [&](uint32_t ff, uint32_t fw, Slice entry,
                                   uint64_t) {
      if (ff != 1 || fw != 2) return;  // Features.feature map entry
      Slice key, value;
      for_fields(entry.p, entry.p + entry.n,
                 [&](uint32_t ef, uint32_t ew, Slice ev, uint64_t) {
                   if (ef == 1 && ew == 2) key = ev;
                   if (ef == 2 && ew == 2) value = ev;
                 });
      if (!key.p || !value.p) return;
      Feature feat;
      parse_feature(value, &feat);
      if (key_is(key, "slices")) {
        slices_proto = feat.bytes0;
      } else if (key_is(key, "patientID")) {
        if (feat.nints) patient = feat.ints[0];
      } else if (key_is(key, "examID")) {
        if (feat.nints) exam = feat.ints[0];
      } else if (key_is(key, "path")) {
        path = feat.bytes0;
      } else if (key_is(key, "category")) {
        category = feat.bytes0;
      } else if (key_is(key, "shape")) {
        for (int i = 0; i < feat.nints && i < 8; ++i)
          shape_feature[i] = feat.ints[i];
        n_shape_feature = feat.nints;
      } else if (key_is(key, "slice_types")) {
        for (int i = 0; i < feat.nall && i < 16; ++i)
          type_names[i] = feat.all_bytes[i];
        n_types = feat.nall > 16 ? 16 : feat.nall;
      }
    });
  });
  if (!ok || !slices_proto.p) return -1;

  Slice content;
  int64_t dims[8];
  int ndims = 0;
  if (!parse_tensor_u8(slices_proto, &content, dims, &ndims)) return -2;
  if (ndims != 4) {
    // fall back to the 'shape' feature (kept equal by the writer)
    if (n_shape_feature == 4) {
      ndims = 4;
      for (int i = 0; i < 4; ++i) dims[i] = shape_feature[i];
    } else {
      return -2;
    }
  }
  const int64_t S = dims[0], H = dims[1], W = dims[2], C = dims[3];
  // validate dims and compute S*H*W*C with overflow checks: a crafted
  // shape can overflow int64 and collide with content.n, bypassing the
  // size validation the copy loops below rely on
  if (S <= 0 || H <= 0 || W <= 0 || C <= 0) return -2;
  uint64_t total = static_cast<uint64_t>(S);
  const uint64_t kMax = static_cast<uint64_t>(INT64_MAX);
  for (int64_t d : {H, W, C}) {
    if (total > kMax / static_cast<uint64_t>(d)) return -2;
    total *= static_cast<uint64_t>(d);
  }
  if (static_cast<uint64_t>(content.n) != total) return -2;

  if (shape_out) {
    shape_out[0] = S; shape_out[1] = H; shape_out[2] = W; shape_out[3] = C;
  }
  if (ids_out) {
    ids_out[0] = patient;
    ids_out[1] = exam;
  }
  copy_str(path, path_out, path_cap);
  copy_str(category, cat_out, cat_cap);
  if (types_out && types_cap > 0) {
    int64_t pos = 0;
    for (int i = 0; i < n_types; ++i) {
      if (i && pos < types_cap - 1) types_out[pos++] = ',';
      int64_t n = static_cast<int64_t>(type_names[i].n);
      if (n > types_cap - 1 - pos) n = types_cap - 1 - pos;
      std::memcpy(types_out + pos, type_names[i].p, static_cast<size_t>(n));
      pos += n;
    }
    types_out[pos] = 0;
  }
  if (!out) return 0;  // metadata-only peek

  const int64_t ch = crop_h < 0 ? H : crop_h;
  const int64_t cw = crop_w < 0 ? W : crop_w;
  if (ch > H || cw > W) return -3;
  const int64_t top = (H - ch) / 2, left = (W - cw) / 2;
  const int64_t k = n_chan > 0 ? n_chan : C;
  if (out_cap < S * ch * cw * k) return -3;
  if (chan_idx) {
    for (int64_t i = 0; i < n_chan; ++i)
      if (chan_idx[i] < 0 || chan_idx[i] >= C) return -4;
  }

  const uint8_t* src = content.p;
  uint8_t* dst = out;
  for (int64_t s = 0; s < S; ++s) {
    for (int64_t y = 0; y < ch; ++y) {
      const uint8_t* row = src + ((s * H + top + y) * W + left) * C;
      if (!chan_idx && cw * k == W * C && left == 0) {
        std::memcpy(dst, row, static_cast<size_t>(cw * k));
        dst += cw * k;
      } else if (!chan_idx) {
        std::memcpy(dst, row, static_cast<size_t>(cw * C));
        dst += cw * C;
      } else {
        dst = gather_row_n(row, cw, C, chan_idx, k, dst);
      }
    }
  }
  return 0;
}

}  // extern "C"

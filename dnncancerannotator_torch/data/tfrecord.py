'''TFRecord / tf.train.Example / TensorProto codec, dependency-free
(counterpart of dnncancerannotator_tpu.data.tfrecord).

Implements:

- the TFRecord framing (length + masked CRC32C, data + masked CRC32C),
- a minimal protobuf wire-format reader/writer,
- Example{BytesList,Int64List,FloatList} encode/decode,
- TensorProto encode/decode matching ``tf.io.serialize_tensor``.

``crc32c`` runs in the host library (csrc/host/tfrecord_io.cc, slicing-by-8,
built by data/_native.py; a failed build raises). ``crc32c_plain`` is its
plain version: long buffers are cut into many chunks whose CRC registers
advance together as numpy vectors, and the chunk registers are then joined
with the linear "advance over L zero bytes" operator (tens of MB/s, where
the byte-at-a-time loop runs at about 0.5 MB/s); all give the same CRC.
'''

import functools
import os
import struct

import numpy as np

from . import _native

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli)
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78
_MASK32 = 0xFFFFFFFF
# below this many bytes the plain byte loop is cheaper than the chunked pass
_CHUNKED_MIN_BYTES = 1 << 16
_N_CHUNKS = 4096


@functools.lru_cache(maxsize=1)
def _crc_table():
    table = np.zeros(256, np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        table[i] = crc
    return table


def _crc_update_bytes(crc, data):
    '''Advance the (uninverted) CRC register over ``data`` byte by byte.'''
    table = _crc_table().tolist()
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


@functools.lru_cache(maxsize=16)
def _zero_advance_tables(length):
    '''Tables T[i][v] = register after ``length`` zero bytes from
    ``v << 8i``. The advance is linear over GF(2), so for any register r it
    is the XOR of T[i][(r >> 8i) & 0xFF] over the four bytes of r.'''
    table = _crc_table()
    regs = (np.arange(256, dtype=np.uint32)[None, :]
            << (8 * np.arange(4, dtype=np.uint32))[:, None]).reshape(-1)
    for _ in range(length):
        regs = table[regs & 0xFF] ^ (regs >> np.uint32(8))
    return [row.tolist() for row in regs.reshape(4, 256)]


def crc32c(data) -> int:
    '''CRC32C of a bytes-like object, in the host library.'''
    lib = _native.library()
    if isinstance(data, bytes):
        return lib.crc32c(data, len(data))
    arr = np.frombuffer(data, np.uint8)
    return lib.crc32c(arr.ctypes.data, arr.size)


def crc32c_plain(data) -> int:
    '''CRC32C in numpy (the plain version of ``crc32c``).'''
    arr = np.frombuffer(data, np.uint8)
    n = arr.size
    if n < _CHUNKED_MIN_BYTES:
        return _crc_update_bytes(_MASK32, arr.tolist()) ^ _MASK32
    length = n // _N_CHUNKS
    # [L, K]: row j holds byte j of every chunk, contiguous for the pass
    cols = np.ascontiguousarray(
        arr[:length * _N_CHUNKS].reshape(_N_CHUNKS, length).T)
    table = _crc_table()
    regs = np.zeros(_N_CHUNKS, np.uint32)
    regs[0] = _MASK32  # only the first chunk carries the initial value
    for j in range(length):
        regs = table[(regs ^ cols[j]) & 0xFF] ^ (regs >> np.uint32(8))
    t0, t1, t2, t3 = _zero_advance_tables(length)
    crc = 0
    for r in regs.tolist():
        crc = (t0[crc & 0xFF] ^ t1[(crc >> 8) & 0xFF]
               ^ t2[(crc >> 16) & 0xFF] ^ t3[crc >> 24]) ^ r
    crc = _crc_update_bytes(crc, arr[length * _N_CHUNKS:].tolist())
    return crc ^ _MASK32


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & _MASK32)


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

def write_record(f, data: bytes):
    length = struct.pack('<Q', len(data))
    f.write(length)
    f.write(struct.pack('<I', _masked_crc(length)))
    f.write(data)
    f.write(struct.pack('<I', _masked_crc(data)))


def read_records(path, verify_crc=False):
    '''Yield record payload bytes from a TFRecord file.'''
    with open(path, 'rb') as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack('<Q', header[:8])
            data = f.read(length)
            (dcrc,) = struct.unpack('<I', f.read(4))
            if verify_crc:
                (lcrc,) = struct.unpack('<I', header[8:12])
                if lcrc != _masked_crc(header[:8]):
                    raise ValueError(f'length CRC mismatch in {path}')
                if dcrc != _masked_crc(data):
                    raise ValueError(f'data CRC mismatch in {path}')
            yield data


def index_records(path):
    '''Return [(offset, length)] of payloads in a TFRecord file (one pass).'''
    index = []
    size = os.path.getsize(path)
    with open(path, 'rb') as f:
        pos = 0
        while pos + 12 <= size:
            f.seek(pos)
            (length,) = struct.unpack('<Q', f.read(8))
            index.append((pos + 12, length))
            pos += 12 + length + 4
    return index


def read_record_at(path, offset, length):
    with open(path, 'rb') as f:
        f.seek(offset)
        return f.read(length)


# ---------------------------------------------------------------------------
# Minimal protobuf wire format
# ---------------------------------------------------------------------------

def _write_varint(out, value):
    value &= 0xFFFFFFFFFFFFFFFF
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_tag(out, field, wire_type):
    _write_varint(out, (field << 3) | wire_type)


def _write_bytes_field(out, field, data):
    _write_tag(out, field, 2)
    _write_varint(out, len(data))
    out.extend(data)


def iter_fields(buf):
    '''Yield (field_number, wire_type, value) over a proto message buffer.

    Length-delimited values come back as memoryview slices; varints as ints;
    fixed32/fixed64 as raw bytes.
    '''
    buf = memoryview(buf)
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wt == 5:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        elif wt == 1:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        else:
            raise ValueError(f'Unsupported wire type {wt}')
        yield field, wt, val


# ---------------------------------------------------------------------------
# tf.train.Example
# ---------------------------------------------------------------------------

def encode_feature(value):
    '''Encode one Feature. value: bytes/list[bytes] -> BytesList,
    int/list[int] -> Int64List, float/list[float] -> FloatList.'''
    out = bytearray()
    if isinstance(value, (bytes, bytearray)):
        value = [bytes(value)]
    elif isinstance(value, str):
        value = [value.encode()]
    elif not isinstance(value, (list, tuple, np.ndarray)):
        value = [value]

    value = list(value)
    if value and isinstance(value[0], str):
        value = [v.encode() for v in value]

    if value and isinstance(value[0], (bytes, bytearray)):
        inner = bytearray()
        for v in value:
            _write_bytes_field(inner, 1, v)
        _write_bytes_field(out, 1, inner)  # Feature.bytes_list = 1
    elif value and isinstance(value[0], (float, np.floating)):
        inner = bytearray()
        packed = bytearray()
        for v in value:
            packed.extend(struct.pack('<f', float(v)))
        _write_bytes_field(inner, 1, packed)  # FloatList.value packed
        _write_bytes_field(out, 2, inner)  # Feature.float_list = 2
    else:
        inner = bytearray()
        packed = bytearray()
        for v in value:
            _write_varint(packed, int(v))
        _write_bytes_field(inner, 1, packed)  # Int64List.value packed
        _write_bytes_field(out, 3, inner)  # Feature.int64_list = 3
    return bytes(out)


def encode_example(features: dict) -> bytes:
    '''Encode {name: value} into a serialized tf.train.Example.'''
    feats = bytearray()
    for key, value in features.items():
        entry = bytearray()
        _write_bytes_field(entry, 1, key.encode())      # map key
        _write_bytes_field(entry, 2, encode_feature(value))  # map value
        _write_bytes_field(feats, 1, entry)             # Features.feature
    example = bytearray()
    _write_bytes_field(example, 1, feats)               # Example.features
    return bytes(example)


def _to_signed64(v):
    return v - (1 << 64) if v >= (1 << 63) else v


def decode_feature(buf):
    '''Decode a Feature buffer -> list of bytes / ints / floats.'''
    for field, _, val in iter_fields(buf):
        if field == 1:  # bytes_list
            return [bytes(v) for f, _, v in iter_fields(val) if f == 1]
        if field == 2:  # float_list
            floats = []
            for f, wt, v in iter_fields(val):
                if f == 1:
                    if wt == 2:  # packed
                        floats.extend(np.frombuffer(v, '<f4').tolist())
                    else:
                        floats.append(struct.unpack('<f', v)[0])
            return floats
        if field == 3:  # int64_list
            ints = []
            for f, wt, v in iter_fields(val):
                if f == 1:
                    if wt == 2:  # packed
                        pos = 0
                        while pos < len(v):
                            x, pos = _read_varint(v, pos)
                            ints.append(_to_signed64(x))
                    else:
                        ints.append(_to_signed64(v))
            return ints
    return []


def decode_example(buf) -> dict:
    '''Decode a serialized tf.train.Example -> {name: list of values}.'''
    result = {}
    for field, _, features_buf in iter_fields(buf):
        if field != 1:
            continue
        for f, _, entry in iter_fields(features_buf):
            if f != 1:
                continue
            key = None
            value = None
            for ef, _, ev in iter_fields(entry):
                if ef == 1:
                    key = bytes(ev).decode()
                elif ef == 2:
                    value = decode_feature(ev)
            if key is not None:
                result[key] = value
    return result


# ---------------------------------------------------------------------------
# TensorProto — parity with tf.io.serialize_tensor / parse_tensor
# ---------------------------------------------------------------------------

_DTYPES = {4: np.uint8, 1: np.float32, 9: np.int64, 3: np.int32}
_DTYPE_IDS = {np.dtype(np.uint8): 4, np.dtype(np.float32): 1,
              np.dtype(np.int64): 9, np.dtype(np.int32): 3}


def serialize_tensor(array: np.ndarray) -> bytes:
    '''Serialize an ndarray to TensorProto bytes (tensor_content layout).'''
    array = np.ascontiguousarray(array)
    dtype_id = _DTYPE_IDS[array.dtype]
    shape = bytearray()
    for dim in array.shape:
        d = bytearray()
        _write_tag(d, 1, 0)
        _write_varint(d, dim)
        _write_bytes_field(shape, 2, d)  # TensorShapeProto.dim = 2
    out = bytearray()
    _write_tag(out, 1, 0)
    _write_varint(out, dtype_id)        # dtype
    _write_bytes_field(out, 2, shape)   # tensor_shape
    _write_bytes_field(out, 4, array.tobytes())  # tensor_content
    return bytes(out)


def parse_tensor(buf) -> np.ndarray:
    '''Parse TensorProto bytes into an ndarray.'''
    dtype = np.uint8
    shape = []
    content = None
    int_vals = []
    for field, _, val in iter_fields(buf):
        if field == 1:
            dtype = _DTYPES.get(val, np.uint8)
        elif field == 2:
            for f, _, d in iter_fields(val):
                if f == 2:  # dim
                    for df, _, dv in iter_fields(d):
                        if df == 1:
                            shape.append(dv)
        elif field == 4:
            content = bytes(val)
        elif field in (16, 6, 5):  # int_val fallbacks per dtype
            if isinstance(val, int):
                int_vals.append(val)
            else:
                pos = 0
                while pos < len(val):
                    x, pos = _read_varint(val, pos)
                    int_vals.append(x)
    if content is not None:
        arr = np.frombuffer(content, dtype)
    else:
        arr = np.asarray(int_vals, dtype)
    return arr.reshape(shape)

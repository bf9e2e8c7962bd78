'''An OCDBT key-value store, read and written: the layout in which Orbax, through
TensorStore, writes the arrays of the JAX package's checkpoints (TensorStore's
"OCDBT storage format": google.github.io/tensorstore/kvstore/ocdbt/).

Every file the store reads (the manifest, each B-tree node) is an envelope:
a 4-byte big-endian magic (``0x0cdb3a2a`` manifest, ``0x0cdb20de`` B-tree
node), an 8-byte little-endian total length, a varint format version (0), a
varint compression (0 none, 1 zstd), the body, and the CRC32C of every byte
before it, little-endian. Integers in a body are LEB128 varints unless
stated; lists are stored column by column.

- The manifest (``<dir>/manifest.ocdbt``) holds the config (uuid, manifest
  kind 0 = this one file, the inline-value and node-size limits, the version
  tree's arity, the compression), then the newest versions inline: a data
  file table, the count, and per version its generation, root height (a
  byte), root location (data file, offset, length), statistics and commit
  time (8 bytes). References to version-tree nodes, which hold only older
  versions, close it (each: the newest generation it holds, location,
  count, commit time, height); the store reads the newest inline
  version.
- A B-tree node holds its height (a byte), a data file table and its
  entries' keys, each stored as the length of the prefix it shares with the
  previous key and its own suffix. A leaf's entries carry a value length and
  a kind (0 inline, 1 a reference: data file and offset), the inline values
  following in order. An interior node's entries carry the length of the
  key prefix their subtree shares (its keys are stored without it), the
  child's location and statistics.
- A data file table lists paths relative to the store's directory, each
  stored as a shared prefix, a suffix and the length of its base path. In
  an Orbax checkpoint the root manifest's tree points into
  ``ocdbt.process_<i>/d/``, where each writing process put its data.

``write_store`` writes a new store of one version (generation 1) in the
layout above: a manifest of kind 0 with the config Orbax writes its stores
with (values past 1 KiB out of line, nodes up to 100,000,000 bytes, zstd
envelopes), and one data file ``d/<random hex>`` holding the out-of-line
values and then the B-tree: a single leaf that holds every key. Its
envelopes are zstd frames of raw blocks (ckpt/zstd.py). A checkpoint's
leaf is a few hundred keys (the bn fixture's state has 320 leaves, unet_big's
about 300), far below the node limit; a store past it raises instead of
splitting the leaf.

The store walks the newest version's tree once, at open, into an index;
``read`` then takes inline values from it or reads a data file's range.
Every check fails with ValueError naming the file: a bad magic, length or
CRC32C, an unknown version or compression, a node of the wrong height, an
entry past its body, a path that leaves the directory.
'''

import os
import struct
import time
import uuid

from ..data.tfrecord import crc32c
from . import zstd

MANIFEST = 'manifest.ocdbt'
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_EMPTY = (1 << 64) - 1  # the offset of an empty tree's root
# the config of the stores Orbax writes (its tensorstore_utils'
# add_ocdbt_write_options), kept by write_store
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
_ZSTD, _ZSTD_LEVEL = 1, 0
DATA_DIR = 'd'


class _Body:
    '''A cursor over a decoded body.'''

    def __init__(self, data, where):
        self.data = data
        self.pos = 0
        self.where = where

    def _need(self, n):
        if self.pos + n > len(self.data):
            raise ValueError(f'{self.where}: body ends early')

    def varint(self):
        value = shift = 0
        while True:
            self._need(1)
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f'{self.where}: varint past 64 bits')

    def varints(self, n):
        return [self.varint() for _ in range(n)]

    def byte(self):
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n):
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def prefixed(self, n, extra=None):
        '''``n`` strings stored as shared-prefix lengths (the first has
        none), suffix lengths, then ``extra`` columns of varints, then the
        suffixes.'''
        prefix = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        columns = [self.varints(n) for _ in range(extra or 0)]
        out, previous = [], b''
        for i in range(n):
            if prefix[i] > len(previous):
                raise ValueError(f'{self.where}: prefix longer than the '
                                 f'previous key')
            previous = previous[:prefix[i]] + bytes(self.take(suffix[i]))
            out.append(previous)
        return out, columns

    def done(self):
        if self.pos != len(self.data):
            raise ValueError(f'{self.where}: {len(self.data) - self.pos} '
                             f'bytes after the last field')


def read_envelope(raw, magic, where):
    '''The body of one OCDBT file, checked and decompressed.'''
    if len(raw) < 18:
        raise ValueError(f'{where}: {len(raw)} bytes, too short for OCDBT')
    got = struct.unpack('>I', raw[:4])[0]
    if got != magic:
        raise ValueError(f'{where}: magic {got:#010x}, expected {magic:#010x}')
    length = struct.unpack('<Q', raw[4:12])[0]
    if length != len(raw):
        raise ValueError(f'{where}: header says {length} bytes, file has '
                         f'{len(raw)}')
    want = struct.unpack('<I', raw[-4:])[0]
    crc = crc32c(memoryview(raw)[:-4])
    if crc != want:
        raise ValueError(f'{where}: CRC32C {crc:#010x}, stored {want:#010x}')
    head = _Body(raw[:-4], where)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f'{where}: OCDBT format version {version}')
    body = raw[head.pos:-4]
    if compression == 1:
        body = zstd.decompress(body)
    elif compression != 0:
        raise ValueError(f'{where}: compression {compression}')
    return _Body(body, where)


class OcdbtStore:
    '''The newest version of the OCDBT store whose manifest is
    ``<path>/manifest.ocdbt``.'''

    def __init__(self, path):
        self.path = os.path.abspath(path)
        self._index = {}  # key -> bytes, or (data file, offset, length)
        body = read_envelope(self._file(MANIFEST), MANIFEST_MAGIC,
                             self._where(MANIFEST))
        body.take(16)  # uuid
        kind = body.varint()
        if kind != 0:
            raise ValueError(f'{body.where}: manifest kind {kind} (numbered '
                             'manifests are not read)')
        body.varints(2)  # max inline value bytes, max decoded node bytes
        body.byte()  # version tree arity log2
        method = body.varint()
        if method == 1:
            body.take(4)  # zstd level
        elif method != 0:
            raise ValueError(f'{body.where}: compression method {method}')
        files = self._file_table(body)
        n = body.varint()
        if n == 0:
            raise ValueError(f'{body.where}: no version')
        generations = body.varints(n)
        heights = [body.byte() for _ in range(n)]
        ids, offsets, lengths = (body.varints(n) for _ in range(3))
        body.varints(3 * n)  # statistics
        body.take(8 * n)  # commit times
        # references to version-tree nodes: generation, location, count,
        # commit time, height; they hold only generations older than the
        # inline ones
        m = body.varint()
        older = body.varints(m)
        body.varints(4 * m)
        body.take(8 * m)
        body.take(m)
        body.done()
        if older and max(older) >= generations[-1]:
            raise ValueError(f'{body.where}: generation {max(older)} in a '
                             f'version-tree node is past the newest inline '
                             f'one, {generations[-1]}')
        # the newest version is the last inline one
        if offsets[-1] != _EMPTY:
            self._node(files, ids[-1], offsets[-1], lengths[-1], heights[-1],
                       b'')

    def _where(self, rel):
        return os.path.join(self.path, rel)

    def _file(self, rel, offset=0, length=None):
        with open(self._where(rel), 'rb') as fh:
            fh.seek(offset)
            data = fh.read() if length is None else fh.read(length)
        if length is not None and len(data) != length:
            raise ValueError(f'{self._where(rel)}: {len(data)} bytes at '
                             f'{offset}, expected {length}')
        return data

    def _file_table(self, body):
        n = body.varint()
        paths, (base_lengths,) = body.prefixed(n, extra=1)
        out = []
        for path, base in zip(paths, base_lengths):
            rel = path.decode()
            if base > len(path) or os.path.isabs(rel) or \
                    '..' in rel.split('/'):
                raise ValueError(f'{body.where}: bad data file path {rel!r}')
            out.append(rel)
        return out

    def _node(self, files, file_id, offset, length, height, prefix):
        if file_id >= len(files):
            raise ValueError(f'node reference to data file {file_id} of '
                             f'{len(files)}')
        rel = files[file_id]
        where = f'{self._where(rel)}@{offset}'
        body = read_envelope(self._file(rel, offset, length), NODE_MAGIC,
                             where)
        got = body.byte()
        if got != height:
            raise ValueError(f'{where}: node height {got}, expected {height}')
        node_files = self._file_table(body)
        n = body.varint()
        if height == 0:
            keys, _ = body.prefixed(n)
            lengths = body.varints(n)
            kinds = body.varints(n)
            if any(k > 1 for k in kinds):
                raise ValueError(f'{where}: value kind {max(kinds)}')
            indirect = [i for i in range(n) if kinds[i]]
            ids = body.varints(len(indirect))
            offsets = body.varints(len(indirect))
            refs = dict(zip(indirect, zip(ids, offsets)))
            for i, key in enumerate(keys):
                if i in refs:
                    fid, off = refs[i]
                    if fid >= len(node_files):
                        raise ValueError(f'{where}: value in data file {fid} '
                                         f'of {len(node_files)}')
                    value = (node_files[fid], off, lengths[i])
                else:
                    value = bytes(body.take(lengths[i]))
                self._index[(prefix + key).decode()] = value
        else:
            keys, (common,) = body.prefixed(n, extra=1)
            ids, offsets, lengths = (body.varints(n) for _ in range(3))
            body.varints(3 * n)  # statistics
            children = []
            for i, key in enumerate(keys):
                if common[i] > len(key):
                    raise ValueError(f'{where}: subtree prefix past its key')
                children.append((ids[i], offsets[i], lengths[i],
                                 prefix + key[:common[i]]))
            body.done()
            for fid, off, size, child_prefix in children:
                self._node(node_files, fid, off, size, height - 1,
                           child_prefix)
            return
        body.done()

    def keys(self):
        '''Every key of the newest version, sorted.'''
        return sorted(self._index)

    def __contains__(self, key):
        return key in self._index

    def read(self, key) -> bytes:
        value = self._index.get(key)
        if value is None:
            raise KeyError(f'{key!r} not in the OCDBT store {self.path}')
        if isinstance(value, bytes):
            return value
        return self._file(*value)


# -- the writer ---------------------------------------------------------------

def _varint(value):
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _varints(values):
    return b''.join(map(_varint, values))


def _prefixed(strings, extra=()):
    '''``strings`` (sorted bytes) as ``_Body.prefixed`` reads them: the
    lengths of the prefix each shares with the one before (the first has
    none), the suffix lengths, the ``extra`` columns, then the suffixes.'''
    prefixes, suffixes, previous = [], [], b''
    for i, s in enumerate(strings):
        n = 0
        limit = min(len(s), len(previous))
        while n < limit and s[n] == previous[n]:
            n += 1
        if i:
            prefixes.append(n)
        suffixes.append(s[n:])
        previous = s
    return (_varints(prefixes) + _varints(map(len, suffixes)) +
            b''.join(_varints(column) for column in extra) +
            b''.join(suffixes))


def _file_table(paths):
    '''A data file table of ``paths`` relative to the store, each with an
    empty base path.'''
    encoded = [p.encode() for p in paths]
    return _varint(len(encoded)) + _prefixed(encoded, extra=[[0] * len(
        encoded)])


def _envelope(magic, body):
    '''One OCDBT file: the header, ``body`` as a zstd frame, the CRC32C.'''
    head = _varint(0) + _varint(_ZSTD)
    payload = zstd.compress(body)
    length = 4 + 8 + len(head) + len(payload) + 4
    out = struct.pack('>I', magic) + struct.pack('<Q', length) + head + \
        payload
    return out + struct.pack('<I', crc32c(out))


def _leaf(keys, values, data_rel, offsets):
    '''The body of a leaf holding ``keys``: inline values where ``offsets``
    has None, else a reference into the data file ``data_rel``.'''
    kinds = [0 if off is None else 1 for off in offsets]
    indirect = [off for off in offsets if off is not None]
    return (bytes([0]) + _file_table([data_rel]) + _varint(len(keys)) +
            _prefixed(keys) + _varints(map(len, values)) + _varints(kinds) +
            _varints([0] * len(indirect)) + _varints(indirect) +
            b''.join(v for v, off in zip(values, offsets) if off is None))


def write_store(path, items):
    '''Write ``items`` ({str key: bytes}) as a new OCDBT store in the
    directory ``path`` (made if absent; its manifest must not exist).
    Returns the number of bytes written.'''
    manifest = os.path.join(path, MANIFEST)
    if os.path.exists(manifest):
        raise ValueError(f'{manifest} exists: write_store makes a new store')
    if not items:
        raise ValueError(f'{path}: an OCDBT store to write needs a key')
    keys = sorted(k.encode() for k in items)
    values = [bytes(items[k.decode()]) for k in keys]
    data_rel = f'{DATA_DIR}/{uuid.uuid4().hex}'
    offsets, position, chunks = [], 0, []
    for value in values:
        if len(value) > MAX_INLINE_VALUE_BYTES:
            offsets.append(position)
            chunks.append(value)
            position += len(value)
        else:
            offsets.append(None)
    body = _leaf(keys, values, data_rel, offsets)
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f'{path}: a leaf of {len(keys)} keys takes '
                         f'{len(body)} bytes, past the node limit of '
                         f'{MAX_DECODED_NODE_BYTES}')
    node = _envelope(NODE_MAGIC, body)
    os.makedirs(os.path.join(path, DATA_DIR), exist_ok=True)
    written = 0
    with open(os.path.join(path, data_rel), 'wb') as fh:
        for chunk in chunks + [node]:
            written += fh.write(chunk)
    body = (uuid.uuid4().bytes + _varint(0) +
            _varint(MAX_INLINE_VALUE_BYTES) + _varint(MAX_DECODED_NODE_BYTES) +
            bytes([VERSION_TREE_ARITY_LOG2]) + _varint(_ZSTD) +
            struct.pack('<i', _ZSTD_LEVEL) +
            _file_table([data_rel]) +
            _varint(1) +                      # one version, inline
            _varint(1) + bytes([0]) +         # generation 1, root height 0
            _varints([0, position, len(node)]) +  # root location
            _varints([len(keys), len(node), position]) +  # statistics
            struct.pack('<Q', time.time_ns()) +
            _varint(0))                       # no version-tree nodes
    raw = _envelope(MANIFEST_MAGIC, body)
    with open(manifest, 'wb') as fh:
        written += fh.write(raw)
    return written

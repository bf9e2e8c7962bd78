'''zarr v2 arrays in a key-value store: ``<name>/.zarray`` (JSON) and one
value per chunk, keyed by the chunk's grid index joined by the dimension
separator (``0`` for a scalar's one chunk). This is how TensorStore writes
each array of an Orbax checkpoint into its OCDBT store
(ckpt/ocdbt.py).

Read: ``zarr_format`` 2, ``order`` "C", ``filters`` null, ``compressor``
null or zstd (decoded by ckpt/zstd.py), the dtypes ``<f4``, ``<f8``, ``<i4``,
``<i8``, ``|u1``, ``|b1`` and ``bfloat16`` (TensorStore's name; widened to
float32, which holds every bfloat16 exactly), ``dimension_separator`` "." or
"/", and ``fill_value`` (null is zero, as TensorStore reads it) for the
chunks the store does not hold. Every chunk is stored whole, edge chunks
padded; the array is assembled in C order. Any other field or value raises
ValueError naming it.

Write (``write_array``): the ``.zarray`` that TensorStore writes for Orbax,
byte for byte (sorted keys, no spaces): zarr_format 2, C order, no filters,
``dimension_separator`` ".", ``fill_value`` null, compressor ``{"id":
"zstd", "level": 1}``, and one chunk, the whole array (``0.0...`` or ``0``
for a scalar), stored even when it is all zeros (Orbax's
``store_array_data_equal_to_fill_value``), framed by ckpt/zstd.py.
'''

import json
import math

import numpy as np

from . import zstd

_DTYPES = {'<f4': np.float32, '<f8': np.float64, '<i4': np.int32,
           '<i8': np.int64, '|u1': np.uint8, '|b1': np.bool_,
           'bfloat16': np.uint16}
_FIELDS = {'zarr_format', 'shape', 'chunks', 'dtype', 'compressor',
           'fill_value', 'order', 'filters', 'dimension_separator'}
# numpy dtype -> the name written (bfloat16 is read only)
_WRITE_DTYPES = {np.dtype(v): k for k, v in _DTYPES.items()
                 if k != 'bfloat16'}
_COMPRESSOR = {'id': 'zstd', 'level': 1}
_SPECIAL_FILLS = {'NaN': math.nan, 'Infinity': math.inf,
                  '-Infinity': -math.inf}


def _field_error(name, key, value):
    return ValueError(f'zarr array {name!r}: unsupported {key} {value!r}')


def _metadata(store, name):
    meta = json.loads(store.read(f'{name}/.zarray'))
    unknown = sorted(set(meta) - _FIELDS)
    if unknown:
        raise ValueError(f'zarr array {name!r}: unknown field {unknown[0]!r}')
    for key, want in (('zarr_format', 2), ('order', 'C'), ('filters', None)):
        if meta.get(key, want) != want:
            raise _field_error(name, key, meta[key])
    compressor = meta.get('compressor')
    if compressor is not None and (compressor.get('id') != 'zstd' or
                                   set(compressor) - {'id', 'level',
                                                      'checksum'}):
        raise _field_error(name, 'compressor', compressor)
    if meta.get('dtype') not in _DTYPES:
        raise _field_error(name, 'dtype', meta.get('dtype'))
    sep = meta.get('dimension_separator', '.')
    if sep not in ('.', '/'):
        raise _field_error(name, 'dimension_separator', sep)
    shape, chunks = meta.get('shape'), meta.get('chunks')
    if not (isinstance(shape, list) and isinstance(chunks, list)
            and len(shape) == len(chunks)
            and all(isinstance(d, int) and d >= 0 for d in shape)
            and all(isinstance(c, int) and c > 0 for c in chunks)):
        raise _field_error(name, 'shape and chunks', (shape, chunks))
    fill = meta.get('fill_value')
    if isinstance(fill, str):
        if fill not in _SPECIAL_FILLS or meta['dtype'] not in ('<f4', '<f8'):
            raise _field_error(name, 'fill_value', fill)
        fill = _SPECIAL_FILLS[fill]
    elif fill is not None and not isinstance(fill, (int, float, bool)):
        raise _field_error(name, 'fill_value', fill)
    if meta['dtype'] == 'bfloat16' and fill not in (None, 0):
        raise _field_error(name, 'fill_value', fill)
    return meta, tuple(shape), tuple(chunks), sep, fill


def read_array(store, name) -> np.ndarray:
    '''The zarr v2 array ``name`` of ``store`` (anything with ``read(key)``
    and ``key in store``).'''
    meta, shape, chunks, sep, fill = _metadata(store, name)
    dtype = np.dtype(_DTYPES[meta['dtype']])
    out = np.full(shape, 0 if fill is None else fill, dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        key = f'{name}/' + (sep.join(map(str, index)) if index else '0')
        if key not in store:
            continue
        data = store.read(key)
        if meta.get('compressor') is not None:
            data = zstd.decompress(data, chunk_bytes)
        if len(data) != chunk_bytes:
            raise ValueError(f'zarr chunk {key!r}: {len(data)} bytes, '
                             f'expected {chunk_bytes}')
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        if dtype == np.bool_ and chunk.view(np.uint8).max(initial=0) > 1:
            raise ValueError(f'zarr chunk {key!r}: a bool byte above 1')
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    if meta['dtype'] == 'bfloat16':
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


def write_array(store, name, array):
    '''Put the zarr v2 array ``name`` into ``store`` (a dict of key ->
    bytes): its ``.zarray`` and its one chunk.'''
    array = np.asarray(array)
    kind = _WRITE_DTYPES.get(array.dtype)
    if kind is None:
        raise ValueError(f'zarr array {name!r}: dtype {array.dtype} is not '
                         f'written (one of {sorted(_WRITE_DTYPES.values())})')
    shape = list(array.shape)
    meta = {'chunks': shape, 'compressor': _COMPRESSOR,
            'dimension_separator': '.', 'dtype': kind, 'fill_value': None,
            'filters': None, 'order': 'C', 'shape': shape, 'zarr_format': 2}
    store[f'{name}/.zarray'] = json.dumps(
        meta, sort_keys=True, separators=(',', ':')).encode()
    chunk = '.'.join('0' * array.ndim) or '0'
    data = np.ascontiguousarray(array, _DTYPES[kind])
    store[f'{name}/{chunk}'] = zstd.compress(data.reshape(-1).view(np.uint8))

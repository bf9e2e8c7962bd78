'''Exam records (counterpart of dnncancerannotator_tpu.data.records).

The directory half reads exam trees laid out as
``path/{cancer,healthy}/patientID/examID/<slice_type>/*.png``:

- ``parse_exam``: per-type slice decode (PIL); a healthy exam gets an
  all-zero label shaped like its TRA slices; slice IDs in sorted order;
- ``prepare_combined_slices``: the slice IDs common to every type, the
  shapes within 0.7% of each other, everything cropped to the smallest
  shape and stacked into [S, H, W, C] uint8;
- ``generate_tfrecords``: center-crop to ``output_size`` and write one
  Example{slices, patientID, examID, path, category, shape, slice_types}
  an exam into a single .tfrecords file, byte for byte as the JAX package
  writes it.

The reading half decodes those records. ``parse_example_exam`` runs the
one-pass decode and channel gather of the host library
(csrc/host/exam_decoder.cc, data/_native.py) into a ``hugepage_empty``
buffer; a record it declines (rc != 0, or an output slice type the record
lacks) goes to ``parse_example_exam_plain``, the pure-Python codec, which is
also the plain version the tests hold the library against. ``declined``
counts those records. ``TFRecordExamReader`` keeps decoded exams in a
byte-budgeted LRU cache (2 GiB a reader) and decodes ahead in a thread pool
(``iter_exams(pool=...)``).
'''

import collections
import ctypes
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from glob import glob

import numpy as np

from . import _native
from . import tfrecord as tfr
from ..utils import hostmem

DEFAULT_SLICE_TYPES = ('TRA', 'ADC', 'DWI', 'DCEE', 'DCEL', 'label')

# the decode buffers of the streaming path churn constantly: recycle them in
# glibc's arena instead of faulting fresh pages for every exam
hostmem.tune_malloc()

# records the host library declined and the Python codec decoded, in this
# process
declined = 0
_declined_lock = threading.Lock()


# -- the directory half ----------------------------------------------------------
def _decode_image_gray(path):
    '''Decode an image file to [H, W] uint8 (first channel).'''
    from PIL import Image
    with Image.open(path) as img:
        arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[:, :, 0]
    return arr.astype(np.uint8)


def get_category_from_exam_path(exam_dir):
    category = os.path.normpath(exam_dir).split(os.path.sep)[-3]
    if category not in ('healthy', 'cancer'):
        raise ValueError(f'Unknown category {category}: {exam_dir}')
    return category


def get_id_from_exam_path(exam_path):
    patient_id, exam_id = map(int, os.path.normpath(
        exam_path).strip(os.path.sep).split(os.path.sep)[-2:])
    return patient_id, exam_id


def parse_exam(exam_dir, slice_types=DEFAULT_SLICE_TYPES, decoder=None):
    '''Parse one exam directory into {category, path, IDs, per-type slices}.'''
    decoder = decoder or _decode_image_gray
    result = {'path': exam_dir}
    result['category'] = get_category_from_exam_path(exam_dir)
    result['patientID'], result['examID'] = get_id_from_exam_path(exam_dir)

    if result['category'] == 'cancer':
        slices_per_type = {
            t: set(os.listdir(os.path.join(exam_dir, t))) for t in slice_types}
    else:
        slices_per_type = {
            t: set(os.listdir(os.path.join(exam_dir, t)))
            for t in slice_types if t != 'label'}
        if 'label' in slice_types:
            slices_per_type['label'] = slices_per_type['TRA']

    common = set.intersection(*(
        set(os.path.splitext(n)[0] for n in names)
        for names in slices_per_type.values()))
    if not common:
        raise ValueError(f'Not enough slices in {exam_dir}')
    result['nslices'] = len(common)

    stem_to_name = {
        t: {os.path.splitext(n)[0]: n for n in names}
        for t, names in slices_per_type.items()}

    for t in slice_types:
        if t == 'label' and result['category'] == 'healthy':
            result[t] = {
                stem: np.zeros_like(decoder(os.path.join(
                    exam_dir, 'TRA', stem_to_name['TRA'][stem])))
                for stem in sorted(common)}
        else:
            result[t] = {
                stem: decoder(os.path.join(exam_dir, t, stem_to_name[t][stem]))
                for stem in sorted(common)}
    return result


def prepare_combined_slices(exam_dir, slice_types=DEFAULT_SLICE_TYPES,
                            shape_variance_tolerance=0.007):
    '''Stack one exam into [S, H, W, C] uint8 with metadata.'''
    exam = parse_exam(exam_dir, slice_types=slice_types)
    slice_names = sorted(exam[slice_types[0]].keys())

    shapes = np.stack([
        exam[t][s].shape for t in slice_types for s in slice_names], 0)
    shape_min = shapes.min(0)
    shape_diff = (shapes.max(0) - shape_min) / shapes.mean(0)
    if shape_diff.max() > shape_variance_tolerance:
        raise ValueError(
            'Shape of input image differs greatly.\n'
            f'Exam: {exam_dir}\nShapes: {shapes}')

    slices = np.stack([
        np.stack([exam[t][s][:shape_min[0], :shape_min[1]]
                  for t in slice_types], axis=-1)
        for s in slice_names])
    return dict(
        slices=slices,
        category=exam['category'],
        patientID=exam['patientID'],
        examID=exam['examID'],
        path=exam['path'],
    )


def center_crop_np(image, output_size):
    '''Center-crop trailing-2-of-3 spatial dims of [..., H, W, C].'''
    h, w = image.shape[-3], image.shape[-2]
    th, tw = output_size
    top, left = (h - th) // 2, (w - tw) // 2
    return image[..., top:top + th, left:left + tw, :]


def generate_tfrecords(
    path,
    output,
    category=None,
    slice_types=DEFAULT_SLICE_TYPES,
    output_size=(512, 512),
):
    '''
    Generate a TFRecords file from an extracted exam directory tree.

    Args:
        path: path to the data directory, structured as
            path/{healthy,cancer}/patientID/examID/<slice_type>/<sliceID>.png
        output: output .tfrecords path
        category (str): category to include (e.g. cancer or healthy);
            default (None) includes all
        slice_types (list[str]): list of slice types to include
        output_size (list[int]): center crop of every slice, height width
            (default 512 512)
    '''
    slice_types = tuple(slice_types)
    exams = sorted(glob(os.path.join(path, *'*' * 3)))
    out_dir = os.path.dirname(output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    written = 0
    with open(output, 'wb') as f:
        for exam_dir in exams:
            exam = prepare_combined_slices(exam_dir, slice_types=slice_types)
            if category is not None and exam['category'] != category:
                continue
            slices = center_crop_np(exam['slices'], output_size)
            example = tfr.encode_example({
                'slices': tfr.serialize_tensor(slices),
                'patientID': exam['patientID'],
                'examID': exam['examID'],
                'path': exam['path'].encode(),
                'category': exam['category'].encode(),
                'shape': list(slices.shape),
                'slice_types': [t.encode() for t in slice_types],
            })
            tfr.write_record(f, example)
            written += 1
    logging.info('Wrote %d exams to %s', written, output)
    return written


# -- the reading half ----------------------------------------------------------------
def _decline():
    global declined
    with _declined_lock:
        declined += 1
    return None


def parse_example_exam_native(buf, output_slice_types=None):
    '''The host library's one-pass decode and channel gather of a serialized
    Example; None where it declines the record.'''
    lib = _native.library()
    shape = (ctypes.c_int64 * 4)()
    ids = (ctypes.c_int64 * 2)()
    path = ctypes.create_string_buffer(1024)
    cat = ctypes.create_string_buffer(64)
    types = ctypes.create_string_buffer(512)
    rc = lib.exam_decode(buf, len(buf), None, 0, -1, -1, None, 0,
                         shape, ids, path, 1024, cat, 64, types, 512)
    # a string that filled its buffer may have been cut: the codec reads it
    if rc != 0 or len(path.value) >= 1023 or len(cat.value) >= 63 or \
            len(types.value) >= 511:
        return _decline()
    slice_types = types.value.decode().split(',')
    if output_slice_types is not None and \
            list(output_slice_types) != slice_types:
        if any(t not in slice_types for t in output_slice_types):
            return _decline()
        idx = [slice_types.index(t) for t in output_slice_types]
        slice_types = list(output_slice_types)
        cidx, n_chan = (ctypes.c_int64 * len(idx))(*idx), len(idx)
    else:
        cidx, n_chan = None, int(shape[3])
    out = hostmem.hugepage_empty(
        (shape[0], shape[1], shape[2], n_chan), np.uint8)
    rc = lib.exam_decode(
        buf, len(buf), cidx, n_chan if cidx is not None else 0, -1, -1,
        out.ctypes.data, out.size, shape, ids, path, 1024, cat, 64, types,
        512)
    if rc != 0:
        return _decline()
    return dict(
        slices=out,
        patientID=int(ids[0]),
        examID=int(ids[1]),
        path=path.value.decode(),
        category=cat.value.decode(),
        slice_types=slice_types,
    )


def parse_example_exam_plain(buf, output_slice_types=None):
    '''The pure-Python decode of a serialized Example (the plain version of
    ``parse_example_exam_native``).'''
    d = tfr.decode_example(buf)
    shape = d['shape']
    slices = tfr.parse_tensor(d['slices'][0]).reshape(shape)
    slice_types = [s.decode() for s in d['slice_types']]
    if output_slice_types is not None and \
            list(output_slice_types) != slice_types:
        indices = [slice_types.index(t) for t in output_slice_types]
        slices = np.ascontiguousarray(slices[..., indices])
        slice_types = list(output_slice_types)
    return dict(
        slices=slices,
        patientID=d['patientID'][0],
        examID=d['examID'][0],
        path=d['path'][0].decode(),
        category=d['category'][0].decode(),
        slice_types=slice_types,
    )


def parse_example_exam(buf, output_slice_types=None):
    '''Decode a serialized Example into an exam dict, optionally gathering a
    channel subset in ``output_slice_types`` order: the host library's
    decode, or the Python codec's where the library declines the record.'''
    exam = parse_example_exam_native(buf, output_slice_types)
    if exam is None:
        exam = parse_example_exam_plain(buf, output_slice_types)
    return exam


class TFRecordExamReader:
    '''Lazy random-access reader over one .tfrecords file of exams, with a
    byte-budgeted LRU cache of decoded exams (``cache_bytes``, 2 GiB by
    default) so that a training stream does not decode every exam again
    every epoch.'''

    def __init__(self, path, output_slice_types=None, cache_bytes=2 << 30):
        self.path = path
        self.output_slice_types = (
            tuple(output_slice_types) if output_slice_types else None)
        self.index = tfr.index_records(path)
        self.cache_bytes = cache_bytes
        self._cache = collections.OrderedDict()
        self._cached_bytes = 0

    def __len__(self):
        return len(self.index)

    def _decode(self, i):
        '''Decode record ``i`` without touching the cache (thread-safe).'''
        offset, length = self.index[i]
        buf = tfr.read_record_at(self.path, offset, length)
        return parse_example_exam(buf, self.output_slice_types)

    def _cache_put(self, i, exam):
        size = exam['slices'].nbytes
        while self._cache and self._cached_bytes + size > self.cache_bytes:
            _, old = self._cache.popitem(last=False)
            self._cached_bytes -= old['slices'].nbytes
        if size <= self.cache_bytes:
            self._cache[i] = exam
            self._cached_bytes += size

    def exam(self, i):
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        exam = self._decode(i)
        self._cache_put(i, exam)
        return exam

    def iter_exams(self, pool=None):
        '''Iterate exams in record order.

        With ``pool`` > 1, up to that many uncached records decode at once
        in a thread pool (the library's decode runs without the GIL), at
        most 2 x ``pool`` ahead of the consumer. Only the consuming thread
        touches the cache; the workers run ``_decode``.
        '''
        n = len(self.index)
        if not pool or pool <= 1 or n <= 1:
            for i in range(n):
                yield self.exam(i)
            return
        with ThreadPoolExecutor(max_workers=pool) as ex:
            pending = collections.deque()
            nxt = 0

            def fill():
                nonlocal nxt
                while nxt < n and len(pending) < 2 * pool:
                    i = nxt
                    nxt += 1
                    if i in self._cache:
                        self._cache.move_to_end(i)
                        pending.append((i, None, self._cache[i]))
                    else:
                        pending.append((i, ex.submit(self._decode, i), None))

            fill()
            while pending:
                i, fut, exam = pending.popleft()
                if fut is not None:
                    exam = fut.result()
                    self._cache_put(i, exam)
                fill()
                yield exam

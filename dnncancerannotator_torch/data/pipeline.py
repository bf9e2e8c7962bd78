'''Datasets (counterpart of dnncancerannotator_tpu.data.pipeline).

A data path is a list of .tfrecords files (one source a file) or of
exam-directory trees ``path/{cancer,healthy}/patientID/examID/<type>/*.png``
(one source an exam directory, ``path/*/*/*``).

- ``TrainDataset`` / ``train_ds``: the training set. ``load_resident``
  loads it whole as one uint8 array ``[N, h, w, C]`` of host-cropped slices
  for the engine's device-resident sampler, and returns None past its
  byte budget, with ``device_cache: false`` or with ``loader: grain``; the
  engine then streams ``raw_batches(seed)`` from the host: the sources
  interleaved round-robin (each cycling on its own under
  ``normalize_exams``, the whole set again each pass under ``repeat``), a
  buffered shuffle, uint8 batches. The augmentation chain and all float
  math run in the engine's step on the device. ``loader: grain`` is built
  on ``torch.utils.data`` (the JAX package's grain loader's counterpart):
  the same per-source slice index, a global shuffle each epoch from the
  seed, drop-remainder batches, ``grain_workers`` worker processes.
- ``EvalDataset`` / ``eval_ds`` / ``predict_ds``: the host stream of raw
  uint8 [B, H, W, C] batches, center-cropped (or zero-padded) to
  ``output_size``, with per-slice metadata {patientID, examID, path,
  category, slice_types, sliceID}.
- ``base``: the element stream as float32 slices in [0, 1].

The native stream draws from one numpy generator in the JAX package's
order, so ``raw_batches(seed)`` yields the same bytes as its.
'''

import logging
import os
from glob import glob

import numpy as np

from . import augment as augment_mod
from . import records
from .records import DEFAULT_SLICE_TYPES, TFRecordExamReader
from ..utils import hostmem

logger = logging.getLogger(__name__)

GRAIN_WARNING = (
    'loader: grain approximates normalize_exams by equalizing per-source '
    'index counts per epoch (each draw is equal-probability across '
    'sources, but without replacement within an epoch); the native loader '
    'samples sources with replacement — reference data.py:515-525 '
    'semantics.')


def _is_tfrecords(path):
    return os.path.splitext(path)[1] == '.tfrecords'


def _center_crop_or_pad(img, th, tw):
    '''Center crop [H, W, C] to (th, tw); pads with zeros if smaller.'''
    h, w = img.shape[0], img.shape[1]
    if h < th or w < tw:
        pad_h, pad_w = max(th - h, 0), max(tw - w, 0)
        img = np.pad(img, ((pad_h // 2, pad_h - pad_h // 2),
                           (pad_w // 2, pad_w - pad_w // 2), (0, 0)))
        h, w = img.shape[0], img.shape[1]
    top, left = (h - th) // 2, (w - tw) // 2
    return img[top:top + th, left:left + tw, :]


def _exam_elements(exam, crop=None):
    '''Yield (slice_uint8, meta) per slice of one exam dict.'''
    slices = exam['slices']
    for slice_id in range(slices.shape[0]):
        img = slices[slice_id]
        if crop is not None:
            img = _center_crop_or_pad(img, *crop)
        meta = dict(
            patientID=exam['patientID'], examID=exam['examID'],
            path=exam['path'], category=exam['category'],
            slice_types=list(exam['slice_types']), sliceID=slice_id)
        yield img, meta


class _DirExamSource:
    '''One exam directory as an exam source (decoded once, kept).'''

    def __init__(self, exam_dir, slice_types):
        self.exam_dir = exam_dir
        self.slice_types = tuple(slice_types)
        self._exam = None

    def iter_exams(self, pool=None):
        del pool  # one exam: nothing to decode in parallel
        yield self.exam(0)

    def __len__(self):
        return 1

    def exam(self, i):
        assert i == 0, i
        if self._exam is None:
            exam = records.prepare_combined_slices(
                self.exam_dir, slice_types=self.slice_types)
            exam['slice_types'] = list(self.slice_types)
            self._exam = exam
        return self._exam


def _sources(paths, slice_types):
    '''Resolve data paths into exam sources: one reader a .tfrecords file,
    one source an exam directory (``path/*/*/*``) of a tree.'''
    if isinstance(paths, str):
        paths = [paths]
    paths = list(paths)
    if _is_tfrecords(paths[0]):
        if not all(map(_is_tfrecords, paths)):
            raise ValueError(f'cannot mix .tfrecords files and directories: '
                             f'{paths}')
        return [TFRecordExamReader(p, slice_types) for p in paths]
    exam_dirs = []
    for p in paths:
        if not os.path.isdir(p):
            raise ValueError(f'not a .tfrecords file or a directory: {p}')
        exam_dirs.extend(sorted(glob(os.path.join(p, *'*' * 3))))
    return [_DirExamSource(d, slice_types) for d in exam_dirs]


def _resolve_pool(decode_pool):
    ''''auto' -> one decode thread per host core (at most 8); 0, 1 or None
    -> serial. The host library's decode releases the GIL, so the threads
    decode in parallel.'''
    if decode_pool == 'auto':
        return min(8, os.cpu_count() or 1)
    return int(decode_pool or 0)


def _source_stream(source, crop, repeat, pool=None):
    '''Slice elements of one source, cycling forever with ``repeat`` (a
    source with no slice ends at once).'''
    while True:
        count = 0
        for exam in source.iter_exams(pool=pool):
            for element in _exam_elements(exam, crop):
                count += 1
                yield element
        if not repeat or count == 0:
            return


def _interleave(streams):
    '''Round-robin across streams, dropping each as it ends.'''
    alive = list(streams)
    while alive:
        nxt = []
        for stream in alive:
            try:
                yield next(stream)
                nxt.append(stream)
            except StopIteration:
                pass
        alive = nxt


def _shuffle(stream, buffer_size, rng):
    '''tf.data's buffered shuffle: fill a buffer, emit a random element,
    backfill from the stream.'''
    buf = []
    for item in stream:
        if len(buf) < buffer_size:
            buf.append(item)
            continue
        i = int(rng.integers(len(buf)))
        out, buf[i] = buf[i], item
        yield out
    rng.shuffle(buf)
    yield from buf


def _stack(batch):
    '''A DataLoader batch as one uint8 numpy array (no torch in workers).'''
    return np.stack(batch)


class _GrainSlices:
    '''The grain counterpart's map-style source: item i of ``index`` is
    (source, exam, slice), read and center-cropped to ``crop`` as numpy.
    Each process opens its own sources at its first item: a worker gets
    the paths, not the readers and their caches.'''

    def __init__(self, paths, slice_types, index, crop):
        self.paths, self.slice_types = paths, slice_types
        self.index = index
        self.crop = crop
        self._sources = None

    def __getstate__(self):
        return dict(self.__dict__, _sources=None)

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i):
        if self._sources is None:
            self._sources = _sources(self.paths, self.slice_types)
        si, ei, sj = self.index[i]
        img = self._sources[si].exam(ei)['slices'][sj]
        return np.ascontiguousarray(_center_crop_or_pad(img, *self.crop))


class _EpochShuffle:
    '''A new permutation of range(n) each epoch, from one seeded torch
    generator.'''

    def __init__(self, n, seed):
        import torch
        self.n = n
        self.gen = torch.Generator().manual_seed(int(seed))

    def __len__(self):
        return self.n

    def __iter__(self):
        import torch
        return iter(torch.randperm(self.n, generator=self.gen).tolist())


class TrainDataset:
    '''Training dataset handle: the config's ``data_options.train``.

    ``augment_methods`` is the parsed augmentation chain. When it starts with
    a jittered center crop, only the centred (output + 2 * max_) window of
    each base_size slice can ever be read, so the host keeps just that
    window (``host_crop``, 268 x 268 at the unet.yaml defaults).
    '''

    def __init__(self, path, batch_size, buffer_size, repeat=True,
                 slice_types=DEFAULT_SLICE_TYPES, normalize_exams=True,
                 output_size=(256, 256), augment_options=None, base_size=512,
                 seed=0, device_cache=True, loader='native',
                 grain_workers=0, decode_pool='auto'):
        if loader not in ('native', 'grain'):
            raise ValueError(f'unknown loader {loader!r} (native or grain)')
        self.slice_types = tuple(slice_types)
        self.batch_size = batch_size
        self.buffer_size = buffer_size
        self.repeat = repeat
        self.normalize_exams = normalize_exams
        self.output_size = tuple(output_size)
        self.base_size = (base_size, base_size)
        self.seed = seed
        self.device_cache = device_cache
        self.loader = loader
        self.grain_workers = grain_workers
        self.decode_pool = _resolve_pool(decode_pool)
        self.paths = path
        self.augment_methods = augment_mod.parse_augment_options(
            augment_options, self.slice_types, self.output_size)
        self.n_channels = len(self.slice_types)
        self.host_crop = self.base_size
        if self.augment_methods and \
                self.augment_methods[0][0] == 'random_crop':
            opts = self.augment_methods[0][1]
            margin = 2 * int(opts.get('max_', 6))
            th, tw = opts.get('output_size', self.output_size)
            self.host_crop = (min(th + margin, self.base_size[0]),
                              min(tw + margin, self.base_size[1]))

    @property
    def element_shape(self):
        '''Raw batch shape fed to the device.'''
        return (self.batch_size, *self.host_crop, self.n_channels)

    @property
    def feature_shape(self):
        '''Post-augmentation feature shape [B, h, w, C-1].'''
        out = self.output_size if any(
            n == 'random_crop' for n, _ in self.augment_methods) \
            else self.base_size
        return (self.batch_size, *out, self.n_channels - 1)

    def load_resident(self, budget_bytes=8 << 30):
        '''The whole training set as host arrays: ``data`` [N, h, w, C]
        uint8, per-source ``starts``/``counts`` (sources with no slice
        dropped) and ``balanced`` = normalize_exams, for the engine's
        equal-probability sampling across sources. None, so that the engine
        streams from the host, past ``budget_bytes``, with ``device_cache:
        false``, with ``loader: grain`` or without any slice.'''
        if not self.device_cache or self.loader == 'grain':
            return None
        chunks, starts, counts = [], [], []
        total = 0
        for source in _sources(self.paths, self.slice_types):
            starts.append(len(chunks))
            for exam in source.iter_exams(pool=self.decode_pool):
                for img, _meta in _exam_elements(exam, self.host_crop):
                    total += img.nbytes
                    if total > budget_bytes:
                        return None
                    chunks.append(img)
            counts.append(len(chunks) - starts[-1])
        if not chunks:
            return None
        keep = [i for i, c in enumerate(counts) if c > 0]
        data = hostmem.hugepage_empty(
            (len(chunks), *chunks[0].shape), chunks[0].dtype)
        np.stack(chunks, out=data)
        return dict(data=data,
                    starts=np.asarray([starts[i] for i in keep], np.int64),
                    counts=np.asarray([counts[i] for i in keep], np.int64),
                    balanced=self.normalize_exams)

    def _elements(self):
        '''Element stream: ``normalize_exams`` cycles each source on its own
        (equal sampling); ``repeat`` runs the whole set again after each
        pass. A pass with no element ends the stream.'''
        while True:
            streams = [
                _source_stream(s, self.host_crop, repeat=self.normalize_exams,
                               pool=self.decode_pool)
                for s in _sources(self.paths, self.slice_types)]
            count = 0
            for element in _interleave(streams):
                count += 1
                yield element
            if not self.repeat or count == 0:
                return

    def _grain_index(self, sources):
        '''(source, exam, slice) items: each source's in order, smaller
        sources repeated up to the largest under ``normalize_exams``,
        sources with no slice skipped.'''
        per_source = []
        for si, source in enumerate(sources):
            items = []
            for ei in range(len(source)):
                n = source.exam(ei)['slices'].shape[0]
                items.extend((si, ei, sj) for sj in range(n))
            if items:
                per_source.append(items)
        index = []
        if self.normalize_exams and len(per_source) > 1:
            logger.warning(GRAIN_WARNING)
            target = max(len(it) for it in per_source)
            for items in per_source:
                reps = -(-target // len(items))
                index.extend((items * reps)[:target])
        else:
            for items in per_source:
                index.extend(items)
        return index

    def _grain_batches(self, seed):
        '''``loader: grain`` on ``torch.utils.data``: the index of
        ``_grain_index``, a global shuffle each epoch from ``seed``,
        drop-remainder batches of ``batch_size`` from ``grain_workers``
        worker processes (spawned, not forked: the engine's process has
        threads and may hold a CUDA context; they return numpy only); one
        epoch without ``repeat``.'''
        from torch.utils.data import DataLoader

        index = self._grain_index(_sources(self.paths, self.slice_types))
        if len(index) < self.batch_size:
            raise ValueError(f'{len(index)} training slices in {self.paths}, '
                             f'fewer than a batch of {self.batch_size}')
        workers = int(self.grain_workers or 0)
        loader = DataLoader(
            _GrainSlices(self.paths, self.slice_types, index, self.host_crop),
            batch_size=self.batch_size, drop_last=True,
            sampler=_EpochShuffle(len(index), seed), num_workers=workers,
            collate_fn=_stack, persistent_workers=workers > 0,
            multiprocessing_context='spawn' if workers else None)
        while True:
            for batch in loader:
                yield np.ascontiguousarray(batch)
            if not self.repeat:
                return

    def raw_batches(self, seed=None):
        '''The stream of raw uint8 batches [B, h, w, C] (endless with
        ``repeat``).'''
        seed = self.seed if seed is None else seed
        if self.loader == 'grain':
            yield from self._grain_batches(seed)
            return
        rng = np.random.default_rng(seed)
        stream = (img for img, _meta in self._elements())
        batch = []
        for img in _shuffle(stream, self.buffer_size, rng):
            batch.append(img)
            if len(batch) == self.batch_size:
                yield np.ascontiguousarray(np.stack(batch))
                batch = []


class EvalDataset:
    '''Evaluation dataset handle: deterministic, finite, with metadata.'''

    def __init__(self, path, batch_size, slice_types=DEFAULT_SLICE_TYPES,
                 include_meta=False, output_size=(512, 512),
                 decode_pool='auto'):
        self.slice_types = tuple(slice_types)
        self.batch_size = batch_size
        self.include_meta = include_meta
        self.output_size = tuple(output_size) if output_size else None
        self.paths = path
        self.n_channels = len(self.slice_types)
        self.decode_pool = _resolve_pool(decode_pool)
        self._n_batches = None

    @property
    def element_shape(self):
        return (self.batch_size, *self.output_size, self.n_channels)

    @property
    def feature_shape(self):
        '''Shape of the model input (label channel excluded).'''
        return (self.batch_size, *self.output_size, self.n_channels - 1)

    def batches(self):
        '''Yield dicts {'slices': uint8 [b, h, w, C], 'meta': [b dicts]}.
        The final batch may be smaller.'''
        imgs, metas = [], []
        for source in _sources(self.paths, self.slice_types):
            for exam in source.iter_exams(pool=self.decode_pool):
                for img, meta in _exam_elements(exam, self.output_size):
                    imgs.append(img)
                    metas.append(meta)
                    if len(imgs) == self.batch_size:
                        yield dict(slices=np.stack(imgs), meta=metas)
                        imgs, metas = [], []
        if imgs:
            yield dict(slices=np.stack(imgs), meta=metas)

    def __len__(self):
        if self._n_batches is None:
            self._n_batches = sum(1 for _ in self.batches())
        return self._n_batches


def base(path, slice_types=DEFAULT_SLICE_TYPES, output_size=(512, 512),
         normalize_exams=True, include_meta=False):
    '''The element stream: center-cropped float32 slices in [0, 1], or
    ``{'slice': ..., meta...}`` dicts with ``include_meta``; an endless
    equal-sampling round-robin across sources with ``normalize_exams``,
    else one pass in order.'''
    streams = [
        _source_stream(s, tuple(output_size) if output_size else None,
                       repeat=normalize_exams)
        for s in _sources(path, slice_types)]
    for img, meta in _interleave(streams):
        slice_f32 = img.astype(np.float32) / 255.0
        if include_meta:
            yield dict(slice=slice_f32, **meta)
        else:
            yield slice_f32


def train_ds(path, batch_size, buffer_size, repeat=True,
             slice_types=DEFAULT_SLICE_TYPES, normalize_exams=True,
             output_size=(256, 256), augment_options=None, **kwargs):
    '''Build the training dataset from ``data_options.train``.'''
    return TrainDataset(
        path, batch_size=batch_size, buffer_size=buffer_size, repeat=repeat,
        slice_types=slice_types, normalize_exams=normalize_exams,
        output_size=output_size, augment_options=augment_options, **kwargs)


def eval_ds(path, batch_size, slice_types=DEFAULT_SLICE_TYPES,
            include_meta=False, output_size=(512, 512), decode_pool='auto',
            **kwargs):
    '''Build the evaluation dataset (``kwargs`` takes the config's other
    eval keys, which the host stream does not use).'''
    del kwargs
    return EvalDataset(
        path, batch_size=batch_size, slice_types=slice_types,
        include_meta=include_meta, output_size=output_size,
        decode_pool=decode_pool)


def predict_ds(path, slice_types=DEFAULT_SLICE_TYPES, output_size=(512, 512),
               batch_size=1):
    '''Prediction dataset: eval elements with metadata.'''
    return EvalDataset(path, batch_size=batch_size, slice_types=slice_types,
                       include_meta=True, output_size=output_size)

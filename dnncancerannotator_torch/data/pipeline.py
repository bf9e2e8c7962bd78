'''Datasets (counterpart of dnncancerannotator_tpu.data.pipeline).

- ``TrainDataset`` / ``train_ds``: the training set, loaded whole as one
  uint8 array ``[N, h, w, C]`` of host-cropped slices for the engine's
  resident sampler (the augmentation chain and all float math run in the
  engine's step on the device). Host streaming, the grain loader and
  datasets over the resident budget are not ported yet.
- ``EvalDataset`` / ``eval_ds`` / ``predict_ds``: the host stream of raw
  uint8 [B, H, W, C] batches, center-cropped (or zero-padded) to
  ``output_size``, with per-slice metadata {patientID, examID, path,
  category, slice_types, sliceID}.

Only .tfrecords files are read; the exam-directory branch is not ported
yet.
'''

import os

import numpy as np

from . import augment as augment_mod
from .records import DEFAULT_SLICE_TYPES, TFRecordExamReader


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


def _sources(paths, slice_types):
    '''Resolve data paths into one exam reader per .tfrecords file.'''
    if isinstance(paths, str):
        paths = [paths]
    paths = list(paths)
    if not all(map(_is_tfrecords, paths)):
        raise NotImplementedError(
            'the port reads .tfrecords files only; exam directory trees '
            'are not ported yet (ROADMAP.md queue 1)')
    return [TFRecordExamReader(p, slice_types) for p in paths]


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
        del buffer_size, repeat, seed, grain_workers, decode_pool
        if loader != 'native' or not device_cache:
            raise NotImplementedError(
                'the port trains from the device-resident pool only; host '
                'streaming and the grain loader are not ported yet '
                '(ROADMAP.md queue 1)')
        self.slice_types = tuple(slice_types)
        self.batch_size = batch_size
        self.normalize_exams = normalize_exams
        self.output_size = tuple(output_size)
        self.base_size = (base_size, base_size)
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
        equal-probability sampling across sources. Raises past
        ``budget_bytes``.'''
        chunks, starts, counts = [], [], []
        total = 0
        for source in _sources(self.paths, self.slice_types):
            starts.append(len(chunks))
            for exam in source.iter_exams():
                for img, _meta in _exam_elements(exam, self.host_crop):
                    total += img.nbytes
                    if total > budget_bytes:
                        raise NotImplementedError(
                            f'the training set exceeds the device-resident '
                            f'budget of {budget_bytes} bytes; host streaming '
                            'is not ported yet (ROADMAP.md queue 1)')
                    chunks.append(img)
            counts.append(len(chunks) - starts[-1])
        if not chunks:
            raise ValueError(f'no training slices in {self.paths}')
        keep = [i for i, c in enumerate(counts) if c > 0]
        return dict(data=np.stack(chunks),
                    starts=np.asarray([starts[i] for i in keep], np.int64),
                    counts=np.asarray([counts[i] for i in keep], np.int64),
                    balanced=self.normalize_exams)


class EvalDataset:
    '''Evaluation dataset handle: deterministic, finite, with metadata.'''

    def __init__(self, path, batch_size, slice_types=DEFAULT_SLICE_TYPES,
                 include_meta=False, output_size=(512, 512)):
        self.slice_types = tuple(slice_types)
        self.batch_size = batch_size
        self.include_meta = include_meta
        self.output_size = tuple(output_size) if output_size else None
        self.paths = path
        self.n_channels = len(self.slice_types)

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
            for exam in source.iter_exams():
                for img, meta in _exam_elements(exam, self.output_size):
                    imgs.append(img)
                    metas.append(meta)
                    if len(imgs) == self.batch_size:
                        yield dict(slices=np.stack(imgs), meta=metas)
                        imgs, metas = [], []
        if imgs:
            yield dict(slices=np.stack(imgs), meta=metas)


def train_ds(path, batch_size, buffer_size, repeat=True,
             slice_types=DEFAULT_SLICE_TYPES, normalize_exams=True,
             output_size=(256, 256), augment_options=None, **kwargs):
    '''Build the training dataset from ``data_options.train``.'''
    return TrainDataset(
        path, batch_size=batch_size, buffer_size=buffer_size, repeat=repeat,
        slice_types=slice_types, normalize_exams=normalize_exams,
        output_size=output_size, augment_options=augment_options, **kwargs)


def eval_ds(path, batch_size, slice_types=DEFAULT_SLICE_TYPES,
            include_meta=False, output_size=(512, 512), **kwargs):
    '''Build the evaluation dataset (``kwargs`` takes the config's other
    eval keys, which the host stream does not use).'''
    del kwargs
    return EvalDataset(
        path, batch_size=batch_size, slice_types=slice_types,
        include_meta=include_meta, output_size=output_size)


def predict_ds(path, slice_types=DEFAULT_SLICE_TYPES, output_size=(512, 512),
               batch_size=1):
    '''Prediction dataset: eval elements with metadata.'''
    return EvalDataset(path, batch_size=batch_size, slice_types=slice_types,
                       include_meta=True, output_size=output_size)

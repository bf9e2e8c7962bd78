'''Evaluation / prediction dataset (counterpart of the eval half of
dnncancerannotator_tpu.data.pipeline).

The host stream yields raw uint8 [B, H, W, C] batches, center-cropped (or
zero-padded) to ``output_size``, with per-slice metadata
{patientID, examID, path, category, slice_types, sliceID}; all float math
runs in the engine's step on the device. The training dataset and the
exam-directory branch are not ported yet.
'''

import os

import numpy as np

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

'''TensorBoard event files and PNG encoding (counterpart of
dnncancerannotator_tpu.utils.tboard).

``SummaryWriter`` writes Event protos in TFRecord framing with the port's
own proto and record codec (data/tfrecord.py), so nothing here needs
TensorFlow: scalars (``simple_value``), images (``Summary.Image`` with PNG
payloads) and raw PR curves (the ``pr_curves`` plugin's [6, T] float32
tensor: TP, FP, TN, FN, precision, recall). Pillow is imported only when a
PNG is encoded.
'''

import io
import itertools
import os
import socket
import struct
import threading
import time

import numpy as np

from ..data import tfrecord as tfr


def _varint_field(out, field, value):
    tfr._write_tag(out, field, 0)
    tfr._write_varint(out, value)


def _double_field(out, field, value):
    tfr._write_tag(out, field, 1)
    out.extend(struct.pack('<d', value))


def _float_field(out, field, value):
    tfr._write_tag(out, field, 5)
    out.extend(struct.pack('<f', value))


def _plugin_metadata(plugin_name, content=b''):
    plugin = bytearray()
    tfr._write_bytes_field(plugin, 1, plugin_name.encode())
    if content:
        tfr._write_bytes_field(plugin, 2, content)
    metadata = bytearray()
    tfr._write_bytes_field(metadata, 1, plugin)
    return bytes(metadata)


def _value_scalar(tag, value):
    out = bytearray()
    tfr._write_bytes_field(out, 1, tag.encode())
    _float_field(out, 2, float(value))
    return bytes(out)


def _value_image(tag, png_bytes, height, width, colorspace):
    image = bytearray()
    _varint_field(image, 1, height)
    _varint_field(image, 2, width)
    _varint_field(image, 3, colorspace)
    tfr._write_bytes_field(image, 4, png_bytes)
    out = bytearray()
    tfr._write_bytes_field(out, 1, tag.encode())
    tfr._write_bytes_field(out, 4, image)
    return bytes(out)


def _value_pr_curve(tag, data, num_thresholds):
    '''data: float32 [6, T], rows TP, FP, TN, FN, precision, recall.'''
    content = bytearray()
    _varint_field(content, 1, 0)  # PrCurvePluginData.version
    _varint_field(content, 2, num_thresholds)
    out = bytearray()
    tfr._write_bytes_field(out, 1, tag.encode())
    tfr._write_bytes_field(out, 8, tfr.serialize_tensor(
        np.asarray(data, np.float32)))  # Value.tensor
    tfr._write_bytes_field(out, 9, _plugin_metadata('pr_curves',
                                                    bytes(content)))
    return bytes(out)


def _event(step=None, summary_values=None, file_version=None):
    out = bytearray()
    _double_field(out, 1, time.time())
    if step is not None:
        _varint_field(out, 2, int(step))
    if file_version is not None:
        tfr._write_bytes_field(out, 3, file_version.encode())
    if summary_values:
        summary = bytearray()
        for value in summary_values:
            tfr._write_bytes_field(summary, 1, value)
        tfr._write_bytes_field(out, 5, summary)
    return bytes(out)


_FILE_IDS = itertools.count()  # files opened by this process


def encode_png(array, bitdepth=8):
    '''Encode [H, W] or [H, W, C] uint8/float array to PNG bytes.

    ``bitdepth=16`` writes a 16-bit grayscale PNG; the input is then taken
    as values in [0, 65535] (floats are clipped and rounded).
    '''
    from PIL import Image
    array = np.asarray(array)
    if bitdepth == 16:
        if array.ndim == 3 and array.shape[-1] == 1:
            array = array[..., 0]
        if array.ndim != 2:
            raise ValueError(f'16-bit PNG needs a 2-D array, got {array.shape}')
        array = np.clip(array, 0, 65535).astype(np.uint16)
        img = Image.fromarray(array)   # uint16 [H, W] is mode I;16
    else:
        if array.dtype != np.uint8:
            array = np.clip(array * 255.0, 0, 255).astype(np.uint8)
        if array.ndim == 3 and array.shape[-1] == 1:
            array = array[..., 0]
        img = Image.fromarray(array, mode='L' if array.ndim == 2 else 'RGB')
    buf = io.BytesIO()
    img.save(buf, format='PNG')
    return buf.getvalue()


class SummaryWriter:
    '''Event-file writer for one log directory; thread-safe. Each writer
    has a file of its own: the name ends in the process id and a counter,
    so two writers of one directory (the train scalars and the train-data
    Visualizer share ``tfevents/train``) never append to one file.'''

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        filename = 'events.out.tfevents.%010d.%s.%d.%d' % (
            time.time(), socket.gethostname(), os.getpid(), next(_FILE_IDS))
        self._file = open(os.path.join(logdir, filename), 'ab')
        self._lock = threading.Lock()
        self._write(_event(file_version='brain.Event:2'))

    def _write(self, event_bytes):
        with self._lock:
            tfr.write_record(self._file, event_bytes)

    def scalar(self, tag, value, step):
        self._write(_event(step=step,
                           summary_values=[_value_scalar(tag, value)]))

    def image(self, tag, array, step, png=None):
        '''array: [H, W], [H, W, 1] or [H, W, 3], uint8 or [0, 1] float;
        ``png``: its encode_png bytes, when the caller has them already.'''
        array = np.asarray(array)
        h, w = array.shape[0], array.shape[1]
        colorspace = 1 if array.ndim == 2 or array.shape[-1] == 1 else 3
        png = encode_png(array) if png is None else png
        self._write(_event(step=step, summary_values=[
            _value_image(tag, png, h, w, colorspace)]))

    def pr_curve_raw(self, tag, true_positive_counts, false_positive_counts,
                     true_negative_counts, false_negative_counts, precision,
                     recall, num_thresholds, step):
        data = np.stack([np.asarray(v, np.float32) for v in (
            true_positive_counts, false_positive_counts,
            true_negative_counts, false_negative_counts, precision, recall)])
        self._write(_event(step=step, summary_values=[_value_pr_curve(
            f'{tag}/pr_curves', data, num_thresholds)]))

    def flush(self):
        with self._lock:
            self._file.flush()

    def close(self):
        if not self._file.closed:
            self.flush()
            self._file.close()

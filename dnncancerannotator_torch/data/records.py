'''Exam records: decode and random access over .tfrecords files of exams
(counterpart of the reading half of dnncancerannotator_tpu.data.records).

Each record is a ``tf.train.Example`` with the features written by
``generate_tfrecords`` in the JAX package: slices (a uint8 TensorProto
[S, H, W, C]), patientID, examID, path, category, shape, slice_types.
The decode is the pure-Python codec; the JAX package's C++ exam decoder
(native/exam_decoder.cc) is not used here.
'''

import numpy as np

from . import tfrecord as tfr

DEFAULT_SLICE_TYPES = ('TRA', 'ADC', 'DWI', 'DCEE', 'DCEL', 'label')


def parse_example_exam(buf, output_slice_types=None):
    '''Decode a serialized Example into an exam dict, optionally gathering a
    channel subset in ``output_slice_types`` order.'''
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


class TFRecordExamReader:
    '''Lazy random-access reader over one .tfrecords file of exams. The
    JAX reader's decoded-exam cache is not ported: the predict path reads
    each exam once.'''

    def __init__(self, path, output_slice_types=None):
        self.path = path
        self.output_slice_types = (
            tuple(output_slice_types) if output_slice_types else None)
        self.index = tfr.index_records(path)

    def __len__(self):
        return len(self.index)

    def exam(self, i):
        offset, length = self.index[i]
        buf = tfr.read_record_at(self.path, offset, length)
        return parse_example_exam(buf, self.output_slice_types)

    def iter_exams(self):
        '''Iterate exams in record order.'''
        for i in range(len(self.index)):
            yield self.exam(i)

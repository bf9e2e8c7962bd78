'''The port's host data layer against the JAX package on the same seeded
inputs (tests/util_synth.py, 64 x 64 exams): the host library's CRC32C and
exam decode against their plain versions and JAX's, ``generate_tfrecords``
byte for byte, the exam-directory source, the streamed ``raw_batches``
bit for bit, ``load_resident``'s fallback, the decode pool and its LRU
cache, ``base`` and the grain loader's counterpart. Every comparison is
exact. Numpy only: nothing here compiles a JAX function.
'''

import collections
import itertools
import logging
import os

import numpy as np
import pytest

from dnncancerannotator_tpu.data import pipeline as jax_pipeline
from dnncancerannotator_tpu.data import records as jax_records
from dnncancerannotator_tpu.data import tfrecord as jax_tfr
from dnncancerannotator_torch.data import _native, pipeline, records
from dnncancerannotator_torch.data import tfrecord as tfr
from tests import util_synth

SIZE = 64
TRAIN = dict(batch_size=2, buffer_size=4, output_size=(32, 32),
             base_size=SIZE, augment_options={'random_crop': None,
                                              'random_flip': None})


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    '''An exam tree (2 patients x 2 categories x 3 slices), its two
    .tfrecords files and an empty one.'''
    tmp = str(tmp_path_factory.mktemp('torch_data_layer'))
    cancer, healthy = util_synth.make_tfrecords(tmp, size=SIZE)
    empty = os.path.join(tmp, 'empty.tfrecords')
    open(empty, 'wb').close()
    return dict(tree=os.path.join(tmp, 'tree'), cancer=cancer,
                healthy=healthy, empty=empty, tmp=tmp)


def _records_of(path):
    return list(tfr.read_records(path))


# -- the host library ------------------------------------------------------------
@pytest.mark.parametrize('n', [0, 1, 7, 65539, 1 << 20])
def test_crc32c_native_plain_and_jax_agree(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    want = tfr.crc32c_plain(data)
    assert tfr.crc32c(data) == want
    assert tfr.crc32c(bytearray(data)) == want
    assert jax_tfr.crc32c(data) == want
    if n == 0:
        assert want == 0
    _native.library()
    assert os.path.dirname(_native.library_path()) == _native.BUILD_DIR


def test_crc32c_known_vector():
    assert tfr.crc32c(b'123456789') == 0xE3069283
    assert tfr.crc32c_plain(b'123456789') == 0xE3069283


def test_failed_build_raises_with_the_compilers_message(monkeypatch,
                                                        tmp_path):
    '''A source g++ refuses raises with its message; nothing falls back.'''
    bad = tmp_path / 'host'
    bad.mkdir()
    for name in _native.SOURCES:
        (bad / name).write_text('this is not C++;\n')
    monkeypatch.setattr(_native, 'HOST_SRC_DIR', str(bad))
    monkeypatch.setattr(_native, 'BUILD_DIR', str(tmp_path / 'build'))
    with pytest.raises(RuntimeError,
                       match='(?s)g[+][+] failed.*error: expected'):
        _native.build()
    assert not [n for n in os.listdir(tmp_path / 'build')
                if n.endswith('.so')]


@pytest.mark.parametrize('subset', [
    None,                                       # every channel
    ('TRA', 'ADC', 'label'),                    # a subset in order
    ('label', 'DWI', 'TRA', 'DCEL'),            # a reordered subset
])
def test_exam_decode_matches_codec_and_jax(data, subset):
    before = records.declined
    for buf in _records_of(data['cancer']) + _records_of(data['healthy']):
        native = records.parse_example_exam_native(buf, subset)
        plain = records.parse_example_exam_plain(buf, subset)
        want = jax_records.parse_example_exam(buf, subset)
        for got in (native, plain):
            np.testing.assert_array_equal(got['slices'], want['slices'])
            assert got['slices'].flags['C_CONTIGUOUS']
            assert got['slices'].dtype == np.uint8
            for key in ('patientID', 'examID', 'path', 'category',
                        'slice_types'):
                assert got[key] == want[key], key
                assert type(got[key]) is type(want[key]), key
        assert records.parse_example_exam(buf, subset)['slices'].shape == \
            want['slices'].shape
    assert records.declined == before


def test_unknown_slice_type_declines_to_python(data):
    buf = _records_of(data['cancer'])[0]
    before = records.declined
    assert records.parse_example_exam_native(buf, ('TRA', 'T2')) is None
    assert records.declined == before + 1
    with pytest.raises(ValueError):
        records.parse_example_exam(buf, ('TRA', 'T2'))
    with pytest.raises(ValueError):
        jax_records.parse_example_exam(buf, ('TRA', 'T2'))
    assert records.declined == before + 2


def test_float_tensor_declines_to_python():
    '''A record whose slices are not uint8 goes to the codec.'''
    slices = np.arange(2 * 3 * 4 * 2, dtype=np.float32).reshape(2, 3, 4, 2)
    buf = tfr.encode_example({
        'slices': tfr.serialize_tensor(slices), 'patientID': 7,
        'examID': 2, 'path': b'/x/cancer/7/2', 'category': b'cancer',
        'shape': list(slices.shape), 'slice_types': [b'TRA', b'label']})
    before = records.declined
    got = records.parse_example_exam(buf)
    assert records.declined == before + 1
    np.testing.assert_array_equal(got['slices'], slices)
    assert (got['patientID'], got['examID'], got['path']) == (
        7, 2, '/x/cancer/7/2')


# -- the directory half ----------------------------------------------------------
@pytest.mark.parametrize('category,output_size', [(None, (64, 64)),
                                                  ('cancer', (48, 40)),
                                                  ('healthy', (64, 64))])
def test_generate_tfrecords_is_byte_identical(data, tmp_path, category,
                                              output_size):
    ours, theirs = str(tmp_path / 'a' / 'x.tfrecords'), str(tmp_path / 'b.tfr')
    n = records.generate_tfrecords(data['tree'], ours, category=category,
                                   output_size=output_size)
    assert n == jax_records.generate_tfrecords(
        data['tree'], theirs, category=category, output_size=output_size)
    assert n == (4 if category is None else 2)
    with open(ours, 'rb') as a, open(theirs, 'rb') as b:
        assert a.read() == b.read()


def test_prepare_combined_slices_matches_jax(data):
    exam_dirs = sorted(os.path.join(data['tree'], c, p, '1')
                       for c in ('cancer', 'healthy') for p in ('1', '2'))
    for exam_dir in exam_dirs:
        got = records.prepare_combined_slices(exam_dir)
        want = jax_records.prepare_combined_slices(exam_dir)
        np.testing.assert_array_equal(got['slices'], want['slices'])
        assert {k: got[k] for k in got if k != 'slices'} == \
            {k: want[k] for k in want if k != 'slices'}
        if got['category'] == 'healthy':
            assert not got['slices'][..., -1].any()
        assert records.get_id_from_exam_path(exam_dir) == (
            got['patientID'], got['examID'])


def test_prepare_combined_slices_rejects_shape_variance(tmp_path):
    from PIL import Image
    exam = tmp_path / 'cancer' / '1' / '1'
    for t, size in zip(('TRA', 'label'), (64, 60)):
        (exam / t).mkdir(parents=True)
        Image.fromarray(np.zeros((size, size), np.uint8)).save(
            exam / t / '01.png')
    with pytest.raises(ValueError, match='differs greatly'):
        records.prepare_combined_slices(str(exam), ('TRA', 'label'))


@pytest.mark.parametrize('source', ['tree', 'records'])
def test_eval_ds_matches_jax(data, source):
    paths = [data['tree']] if source == 'tree' else [
        data['cancer'], data['empty'], data['healthy']]
    kw = dict(batch_size=5, output_size=(48, 48), include_meta=True)
    got = list(pipeline.eval_ds(paths, **kw).batches())
    want = list(jax_pipeline.eval_ds(paths, **kw).batches())
    assert len(got) == len(want) == 3   # 12 slices: 5, 5, 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g['slices'], w['slices'])
        assert g['meta'] == w['meta']
    assert len(pipeline.eval_ds(paths, **kw)) == 3


# -- the training stream ---------------------------------------------------------
@pytest.mark.parametrize('normalize_exams', [False, True])
@pytest.mark.parametrize('repeat', [False, True])
def test_raw_batches_equal_jax(data, normalize_exams, repeat):
    '''The first 6 batches (with an empty source among the files) bit-equal
    to the JAX package's for the same seed; without either knob the stream
    ends after its 6.'''
    paths = [data['cancer'], data['empty'], data['healthy']]
    kw = dict(TRAIN, normalize_exams=normalize_exams, repeat=repeat)
    got = pipeline.train_ds(paths, **kw).raw_batches(seed=5)
    want = jax_pipeline.train_ds(paths, **kw).raw_batches(seed=5)
    for _ in range(6):
        g, w = next(got), next(want)
        assert g.shape == (2, 44, 44, 6) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    if not (normalize_exams or repeat):
        assert next(got, None) is None and next(want, None) is None


def test_raw_batches_from_a_tree_equal_jax(data):
    kw = dict(TRAIN, decode_pool=0)
    got = pipeline.train_ds([data['tree']], **kw).raw_batches(seed=1)
    want = jax_pipeline.train_ds([data['tree']], **kw).raw_batches(seed=1)
    for g, w in itertools.islice(zip(got, want), 8):
        np.testing.assert_array_equal(g, w)


def test_raw_batches_of_no_slice_end(data):
    '''A set with no slice ends its stream instead of cycling forever.'''
    ds = pipeline.train_ds([data['empty'], data['empty']], **TRAIN)
    assert list(ds.raw_batches(seed=0)) == []


@pytest.mark.parametrize('case', ['resident', 'budget', 'device_cache',
                                  'grain', 'empty'])
def test_load_resident_is_none_where_jax_is(data, case):
    paths = [data['cancer'], data['empty'], data['healthy']]
    kw, call = dict(TRAIN), {}
    if case == 'budget':
        call['budget_bytes'] = 1000
    elif case == 'device_cache':
        kw['device_cache'] = False
    elif case == 'grain':
        kw['loader'] = 'grain'
    elif case == 'empty':
        paths = [data['empty']]
    got = pipeline.train_ds(paths, **kw).load_resident(**call)
    want = jax_pipeline.train_ds(paths, **kw).load_resident(**call)
    assert (got is None) == (want is None) == (case != 'resident')
    if got is not None:
        np.testing.assert_array_equal(got['data'], want['data'])
        np.testing.assert_array_equal(got['starts'], want['starts'])
        np.testing.assert_array_equal(got['counts'], want['counts'])
        assert got['balanced'] == want['balanced']


def test_load_resident_from_a_tree(data):
    got = pipeline.train_ds([data['tree']], **TRAIN).load_resident()
    want = jax_pipeline.train_ds([data['tree']], **TRAIN).load_resident()
    np.testing.assert_array_equal(got['data'], want['data'])
    np.testing.assert_array_equal(got['counts'], [3, 3, 3, 3])


# -- the decode pool and the cache ---------------------------------------------------
def test_decode_pool_equals_serial(data):
    serial = records.TFRecordExamReader(data['cancer'])
    pooled = records.TFRecordExamReader(data['cancer'])
    a = list(serial.iter_exams())
    b = list(pooled.iter_exams(pool=4))
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x['slices'], y['slices'])
        assert x['path'] == y['path']
    # a second pooled pass reads the cache: the same objects
    assert all(x is y for x, y in zip(b, pooled.iter_exams(pool=4)))
    kw = dict(batch_size=4, output_size=(48, 48))
    for p0, p1 in zip(pipeline.eval_ds(data['cancer'], decode_pool=0,
                                       **kw).batches(),
                      pipeline.eval_ds(data['cancer'], decode_pool=3,
                                       **kw).batches()):
        np.testing.assert_array_equal(p0['slices'], p1['slices'])


def test_cache_evicts_by_bytes(data):
    exam_bytes = 3 * SIZE * SIZE * 6
    reader = records.TFRecordExamReader(data['cancer'],
                                        cache_bytes=exam_bytes + 1)
    first = reader.exam(0)
    assert reader.exam(0) is first and reader._cached_bytes == exam_bytes
    reader.exam(1)           # evicts exam 0: two do not fit
    assert list(reader._cache) == [1]
    assert reader.exam(0) is not first
    np.testing.assert_array_equal(reader.exam(0)['slices'], first['slices'])
    tiny = records.TFRecordExamReader(data['cancer'], cache_bytes=10)
    tiny.exam(0)
    assert not tiny._cache and tiny._cached_bytes == 0


# -- base ------------------------------------------------------------------------------
@pytest.mark.parametrize('include_meta', [False, True])
def test_base_equals_jax(data, include_meta):
    paths = [data['cancer'], data['healthy']]
    kw = dict(output_size=(40, 40), include_meta=include_meta)
    once = list(pipeline.base(paths, normalize_exams=False, **kw))
    want = list(jax_pipeline.base(paths, normalize_exams=False, **kw))
    cycled = itertools.islice(pipeline.base(paths, **kw), 30)
    want_cycled = itertools.islice(jax_pipeline.base(paths, **kw), 30)
    assert len(once) == len(want) == 12
    for got, ref in itertools.chain(zip(once, want), zip(cycled,
                                                         want_cycled)):
        if include_meta:
            np.testing.assert_array_equal(got.pop('slice'), ref.pop('slice'))
            assert got == ref
        else:
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, ref)


# -- the grain loader's counterpart ------------------------------------------------------
def _grain(data, **kw):
    paths = [data['cancer'], data['empty'], data['healthy']]
    opts = dict(TRAIN, batch_size=4, loader='grain', **kw)
    return (pipeline.train_ds(paths, **opts),
            jax_pipeline.train_ds(paths, **opts))


def _multiset(batches):
    return collections.Counter(img.tobytes() for b in batches for img in b)


def test_grain_counterpart_batches(data, caplog):
    ds, ref = _grain(data)
    assert ds.load_resident() is None
    with caplog.at_level(logging.WARNING):
        it = ds.raw_batches(seed=3)
        epoch = [next(it) for _ in range(3)]   # 2 x 6 slices: 3 batches
    assert pipeline.GRAIN_WARNING in [r.getMessage() for r in caplog.records]
    for b in epoch:
        assert b.shape == ds.element_shape == (4, 44, 44, 6)
        assert b.dtype == np.uint8 and b.flags['C_CONTIGUOUS']
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        want = list(itertools.islice(ref.raw_batches(seed=3), 3))
    assert pipeline.GRAIN_WARNING in [r.getMessage() for r in caplog.records]
    assert _multiset(epoch) == _multiset(want)
    # the next epoch is another permutation of the same slices
    again = [next(it) for _ in range(3)]
    assert _multiset(again) == _multiset(epoch)
    assert not all(np.array_equal(a, b) for a, b in zip(again, epoch))


def test_grain_counterpart_ends_after_one_epoch_without_repeat(data):
    ds, ref = _grain(data, repeat=False, normalize_exams=False)
    got = list(ds.raw_batches(seed=0))
    want = list(ref.raw_batches(seed=0))
    assert len(got) == len(want) == 3      # 12 slices, batches of 4
    assert _multiset(got) == _multiset(want)


def test_grain_counterpart_workers_return_the_same_batches(data):
    '''Worker processes (numpy only) give the batches of the main process:
    the permutation is drawn there. (grain batches each worker's share on
    its own, so its epochs with workers hold fewer batches.)'''
    ds, _ = _grain(data, repeat=False, normalize_exams=False)
    serial = list(ds.raw_batches(seed=0))
    ds.grain_workers = 2
    pooled = list(ds.raw_batches(seed=0))
    assert len(pooled) == 3
    assert all(np.array_equal(a, b) for a, b in zip(serial, pooled))

'''The port stands alone: it never imports JAX, OpenCV, orbax, tensorstore,
zstandard or the JAX package (and reads and writes a JAX checkpoint without
them), its host library builds from its own sources into build/torch_host/
and nothing of the root native/ directory is loaded, and it never picks the
CPU when a GPU was asked for and none is visible.'''

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = '''
import contextlib, io, os, sys
import dnncancerannotator_torch
from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch.ckpt import ocdbt, orbax, zarr, zstd
from dnncancerannotator_torch import metrics
from dnncancerannotator_torch.data import (_native, augment, pipeline,
                                           records, tfrecord)
from dnncancerannotator_torch.metrics import pixel, region
from dnncancerannotator_torch.models import (blocks, fastbn, fastconv,
                                             multiresunet, unet)
from dnncancerannotator_torch.ops import (cca, functions, gates, image,
                                          morphology, pooling, raster, warp)
from dnncancerannotator_torch.parallel import mesh, multihost
from dnncancerannotator_torch.ops.kernels import (
    _build, conv_chain, conv_chain_bwd, pool2x2_nhwc, pool2x2_nhwc_bwd,
    stencil_conv, stencil_conv_bwd, stencil_conv_nhwc, tconv2x2_bwd,
    tconv2x2_nhwc, tconv2x2_nhwc_bwd, warp_twopass)
from dnncancerannotator_torch.runs import (evaluate, export, extract,
                                           predict, serve, train)
from dnncancerannotator_torch.runs.__main__ import main
from dnncancerannotator_torch.train import losses, optimizers, schedules
from dnncancerannotator_torch.utils import dump, hostmem, tboard, viz
for command, flag in (('predict', '--device'), ('train', '--device'),
                      ('evaluate', '--device'),
                      ('export_model', '--batch_size'), ('serve', '--device'),
                      ('extract_all', '--num_workers'),
                      ('generate_tfrecords', '--output_size')):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            main(argv=[command, '--help'])
        except SystemExit as exc:
            assert exc.code == 0, exc.code
    assert flag in out.getvalue(), out.getvalue()
repo = os.path.dirname(os.path.dirname(os.path.abspath(
    dnncancerannotator_torch.__file__)))
assert tfrecord.crc32c(b'123456789') == 0xE3069283
src = os.path.realpath(_native.HOST_SRC_DIR)
assert src == os.path.join(repo, 'dnncancerannotator_torch', 'csrc',
                           'host'), src
for name in _native.SOURCES:
    assert os.path.realpath(os.path.join(src, name)).startswith(src + '/')
lib = _native.library_path()
assert lib.startswith(os.path.join(repo, 'build', 'torch_host') + '/'), lib
with open('/proc/self/maps') as fh:
    maps = fh.read()
assert lib in maps, lib
# a JAX package checkpoint, read with none of orbax, tensorstore, zstandard
ckpts = os.path.join(repo, 'tests', 'fixtures_torch', 'orbax', 'unet',
                     'checkpoints')
(ckpt,) = os.listdir(ckpts)
flat = orbax.read_checkpoint(os.path.join(ckpts, ckpt))
assert ckpt == 'ckpt-%d' % int(flat['step'])
assert 'mu/params/last_conv/bias' in flat
# and written back as the JAX engine writes it, with none of them either
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    orbax.write_checkpoint(os.path.join(tmp, 'ckpt-1'), flat,
                           (('count', 'mu', 'nu'), ('count',)))
    again = orbax.read_checkpoint(os.path.join(tmp, 'ckpt-1'))
    assert all(again[k].tobytes() == v.tobytes() for k, v in flat.items())
assert os.path.join(repo, 'native') + '/' not in maps
import torch
from dnncancerannotator_torch import models
for name, opts in (('UNetAnnotator', {'f32_head': True}),
                   ('MulmoUNetAnnotator', {'bn': True}),
                   ('MultiResUnet', {'base_filters': 4})):
    if name != 'MultiResUnet':   # the bf16 paths, end to end on the CPU
        opts = dict(opts, n_filters_first=4, n_downsample=2, rate=2,
                    kernel_size=3, conv_stride=1, padding='same')
    model, _ = models.build_model(name, opts, in_channels=2,
                                  dtype='bfloat16')
    model(torch.rand(1, 16, 16, 2), return_logits=True).sum().backward()
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                       'orbax', 'dnncancerannotator_tpu',
                                       'cv2', 'zstandard', 'tensorstore'))
assert not leaked, leaked
assert mesh.group() is None and multihost.is_primary()
print('isolated')
'''


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith('isolated')


def test_cuda_device_without_gpu_raises(monkeypatch):
    import torch
    from dnncancerannotator_torch import engine

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        engine.resolve_device('cuda')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        engine.Engine({'model': 'UNetAnnotator', 'model_options': {},
                       'deploy_options': {}})
    assert engine.resolve_device('cpu') == torch.device('cpu')


def test_serving_on_cuda_without_gpu_raises(monkeypatch, tmp_path):
    '''Loading an artifact for serving asks for the card by default, and
    without one raises before anything is read.'''
    import torch
    from dnncancerannotator_torch.runs import export, serve

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    path = str(tmp_path / 'model.pt2')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        export.load_exported(path)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        export.load_exported(path, device='cuda')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serve.make_server(path, port=0, device='cuda')


def test_bf16_precision_raises():
    '''precision bfloat16 is no longer refused: the Engine computes in
    bf16. What raises under it is bf16 reaching a kernel entry that has no
    bf16 form: nothing falls back to an upcast copy.'''
    import torch
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.ops.kernels import _build

    eng = engine.Engine({'model': 'UNetAnnotator', 'model_options': {},
                         'deploy_options': {'precision': 'bfloat16'}},
                        device='cpu')
    assert eng.compute_dtype == torch.bfloat16
    for entry in ('dnnca_tconv2x2', 'dnnca_pool2x2_nhwc',
                  'dnnca_tconv2x2_nhwc', 'dnnca_warp_twopass'):
        with pytest.raises(TypeError, match='float32, got torch.bfloat16'):
            _build.form(entry, torch.bfloat16)
    for entry in _build.BF16_FORMS:
        assert _build.form(entry, torch.bfloat16) == (entry + '_bf16',
                                                      torch.bfloat16)
        assert entry + '_bf16' in _build._SIGNATURES


@pytest.mark.parametrize('num_workers', [0, 2])
def test_extract_on_cuda_without_gpu_raises(monkeypatch, tmp_path,
                                            num_workers):
    '''The extractor's corner detector asks for the card by default, and
    without one raises before any collage is read, serially and with the
    pool.'''
    import numpy as np
    import torch
    from dnncancerannotator_torch.ops import raster
    from dnncancerannotator_torch.runs import extract

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    exam = tmp_path / 'cancer' / '1' / '1'
    exam.mkdir(parents=True)
    (tmp_path / 'healthy').mkdir()
    for s in (1, 2):
        raster.imwrite(str(exam / f'0{s}.png'), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        extract.extract_all(str(tmp_path), num_workers=num_workers)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        extract.detect_internals(np.zeros((700, 900, 3), np.uint8))
    assert sorted(p.name for p in exam.iterdir()) == ['01.png', '02.png']

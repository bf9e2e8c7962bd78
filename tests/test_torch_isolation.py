'''The port stands alone: it never imports JAX, and it never picks the CPU
when a GPU was asked for and none is visible.'''

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = '''
import contextlib, io, sys
import dnncancerannotator_torch
from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch import metrics
from dnncancerannotator_torch.data import augment, pipeline
from dnncancerannotator_torch.metrics import pixel, region
from dnncancerannotator_torch.models import fastbn
from dnncancerannotator_torch.ops import (cca, functions, gates, image,
                                          morphology, pooling, warp)
from dnncancerannotator_torch.ops.kernels import (
    conv_chain_bwd, pool2x2_nhwc, pool2x2_nhwc_bwd, stencil_conv_bwd,
    tconv2x2_bwd, tconv2x2_nhwc, tconv2x2_nhwc_bwd, warp_twopass)
from dnncancerannotator_torch.runs import evaluate, predict, train
from dnncancerannotator_torch.runs.__main__ import main
from dnncancerannotator_torch.train import losses, optimizers, schedules
from dnncancerannotator_torch.utils import dump, tboard, viz
for command in ('predict', 'train', 'evaluate'):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            main(argv=[command, '--help'])
        except SystemExit as exc:
            assert exc.code == 0, exc.code
    assert '--device' in out.getvalue(), out.getvalue()
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                       'orbax', 'dnncancerannotator_tpu'))
assert not leaked, leaked
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


def test_bf16_precision_raises():
    from dnncancerannotator_torch import engine

    with pytest.raises(NotImplementedError, match='bfloat16'):
        engine.Engine({'model': 'UNetAnnotator', 'model_options': {},
                       'deploy_options': {'precision': 'bfloat16'}},
                      device='cpu')

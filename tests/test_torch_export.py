'''The port's serving export and HTTP endpoint (runs/export.py,
runs/serve.py) against the JAX package's, on the CPU.

One module fixture writes a JAX run (options.yaml + Orbax checkpoint) and
the port's run with the same weights (params.npz, flax-keyed) for two
models: tests/test_export.py's UNet (2 filters, 2 levels, no BatchNorm: the
fused chain, stencil and transposed-conv routes) and a BatchNorm UNet in
NHWC whose down_1 pool and up_0 transposed conv take the NHWC kernels'
gates (64 first filters, 2 levels, ``pallas_pool`` / ``pallas_tconv`` on).
The port's artifact is held against the JAX artifact of the same weights
(``jax.export`` for the CPU under ``gates.pure_xla()``) to 1e-5, and the
two servers against one table of requests. Small MulmoUNet and
MultiResUnet artifacts are held against the live port model.
'''

import copy
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
import yaml

from dnncancerannotator_torch import engine as torch_engine
from dnncancerannotator_torch.ops import functions, gates
from dnncancerannotator_torch.runs import export as torch_export
from dnncancerannotator_torch.runs import serve as torch_serve
from dnncancerannotator_torch.runs.__main__ import main as torch_main
from tests.test_export import CONFIG
from tests.test_torch_unet import _jax_params, flat_params

HW = 32
BN_CONFIG = copy.deepcopy(CONFIG)
BN_CONFIG['model_options'].update(n_filters_first=64, bn=True)
BN_CONFIG['deploy_options'].update(pallas_pool=True, pallas_tconv=True)
CASES = {'unet': CONFIG, 'unet_bn': BN_CONFIG}
FIXED = 4           # the fixed-batch artifacts' batch
MAX_BATCH = 8       # both servers' max_batch
# the kernel entry points of the port's models (ops/functions.py)
ENTRIES = ('conv_chain', 'tconv2x2', 'stencil_conv', 'pool2x2_nhwc',
           'tconv2x2_nhwc', 'stencil_conv_nhwc')


def _perturb(leaf, value, rng):
    '''Non-zero biases, scales off 1 and moved statistics, so a misplaced
    one shows; other leaves as they are.'''
    shape = np.shape(value)
    if leaf in ('bias', 'mean'):
        value = rng.standard_normal(shape) * 0.1
    elif leaf == 'scale':
        value = 1 + rng.standard_normal(shape) * 0.1
    elif leaf == 'var':
        value = rng.uniform(0.5, 1.5, shape)
    return np.asarray(value, np.float32)


def _perturbed(flat, rng):
    return {key: _perturb(key.rsplit('/', 1)[-1], value, rng)
            for key, value in flat.items()}


def _write_runs(root, name, config):
    '''(JAX save_path, port save_path) carrying the same weights at step
    3. The JAX engine is built without the kernel gates (which change no
    parameter), so its real init runs no Pallas kernel on the CPU.'''
    from dnncancerannotator_tpu import engine as jax_engine
    from dnncancerannotator_tpu.utils import dump

    jax_save = os.path.join(root, f'jax_{name}')
    dump.dump_options(os.path.join(jax_save, 'options.yaml'), config=config,
                      save_path=jax_save, data_path=[])
    build_config = copy.deepcopy(config)
    for gate in ('pallas_pool', 'pallas_tconv'):
        build_config['deploy_options'].pop(gate, None)
    eng = jax_engine.Engine(build_config)
    eng.build((2, HW, HW, 5))
    rng = np.random.default_rng(len(name))
    flat = _perturbed(flat_params(eng.state['params']), rng)
    stats = _perturbed({'batch_stats' + k[len('params'):]: v for k, v in
                        flat_params(eng.state['batch_stats']).items()}, rng)
    eng.state = dict(eng.state, params=_jax_params(flat), batch_stats=(
        _jax_params({'params' + k[len('batch_stats'):]: v
                     for k, v in stats.items()}) if stats else {}))
    eng.save_ckpt(os.path.join(jax_save, 'checkpoints'), 3)
    eng.finalize_checkpoints()

    torch_save = os.path.join(root, f'torch_{name}')
    ckpt = os.path.join(torch_save, 'checkpoints', 'ckpt-3')
    os.makedirs(ckpt)
    shutil.copy(os.path.join(jax_save, 'options.yaml'), torch_save)
    np.savez(os.path.join(ckpt, 'params.npz'), **flat, **stats)
    return jax_save, torch_save


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    '''{case: dict(jax=..., torch=..., jax_art=..., torch_art=...)}: each
    run and its symbolic-batch artifact; the UNet also with FIXED-batch
    artifacts (jax_fixed, torch_fixed).'''
    from dnncancerannotator_tpu.runs import export as jax_export

    root = str(tmp_path_factory.mktemp('torch_export'))
    out = {}
    for name, config in CASES.items():
        jax_save, torch_save = _write_runs(root, name, config)
        case = dict(jax=jax_save, torch=torch_save)
        case['jax_art'] = jax_export.export_model(
            jax_save, os.path.join(root, 'art', f'jax_{name}'),
            platforms=('cpu',))
        case['torch_art'] = torch_export.export_model(
            torch_save, os.path.join(root, 'art', f'torch_{name}'))
        out[name] = case
    unet = out['unet']
    unet['jax_fixed'] = jax_export.export_model(
        unet['jax'], os.path.join(root, 'art', 'jax_fixed'),
        batch_size=FIXED, platforms=('cpu',))
    unet['torch_fixed'] = torch_main(argv=[
        'export_model', '--save_path', unet['torch'], '--output_path',
        os.path.join(root, 'art', 'torch_fixed'), '--batch_size',
        str(FIXED)])
    return out


def _features(b, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, HW, HW, 5),
                                                np.uint8)


@pytest.fixture(scope='module')
def loaded():
    '''path -> the artifact's function, loaded once (the JAX package's for
    a .shlo, the port's on the CPU for a .pt2).'''
    from dnncancerannotator_tpu.runs import export as jax_export

    fns = {}

    def load(path):
        if path not in fns:
            fns[path] = (jax_export.load_exported(path)
                         if path.endswith('.shlo') else
                         torch_export.load_exported(path, device='cpu'))
        return fns[path]
    return load


@pytest.mark.parametrize('batch', [1, 2, 6])
@pytest.mark.parametrize('name', sorted(CASES))
def test_artifact_matches_jax_artifact(runs, loaded, name, batch):
    case = runs[name]
    x = _features(batch, batch)
    want = np.asarray(loaded(case['jax_art'])(x))
    got = loaded(case['torch_art'])(x)
    assert got.dtype == torch.float32 and got.device.type == 'cpu'
    assert got.shape == want.shape == (batch, HW, HW, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('name', sorted(CASES))
def test_export_reads_the_jax_run(runs, loaded, tmp_path, name):
    '''export_model on the JAX save_path itself (its Orbax checkpoint,
    read by the port's ckpt/) gives the artifact of its npz twin, to the
    bit, and the JAX artifact's maps within 1e-5.'''
    case = runs[name]
    art = torch_export.export_model(case['jax'], str(tmp_path / 'art'))
    x = _features(3, 11)
    got = loaded(art)(x)
    assert torch.equal(got, loaded(case['torch_art'])(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        loaded(case['jax_art'])(x)), rtol=0, atol=1e-5)


def _graph(path):
    program = torch.export.load(path)
    return [(node.op, str(node.target)) for node in program.graph.nodes]


def test_gated_routes_forced_off_whatever_the_environment(runs, tmp_path,
                                                          monkeypatch):
    '''The BatchNorm UNet's gated sites take the NHWC kernels outside the
    force-off scope; exported with DNNCA_PPOOL / DNNCA_PTCONV set, its
    graph is the same as without them, and the trace reaches no kernel
    entry.'''
    from dnncancerannotator_torch.ops.kernels import pool2x2_nhwc as PN
    from dnncancerannotator_torch.ops.kernels import tconv2x2_nhwc as TN

    with gates.active(gates.KernelGates(pallas_pool=True, pallas_tconv=True)):
        assert PN.eligible((2, 16, 16, 128), 2, 'NHWC', torch.float32)
        assert TN.eligible((2, 8, 8, 128), (2, 2), (2, 2), 128, 'NHWC',
                           torch.float32)
    calls = _spy_entries(monkeypatch)
    monkeypatch.setenv('DNNCA_PPOOL', '1')
    monkeypatch.setenv('DNNCA_PTCONV', '1')
    path = torch_export.export_model(runs['unet_bn']['torch'],
                                     str(tmp_path / 'env'))
    assert calls == []
    assert _graph(path) == _graph(runs['unet_bn']['torch_art'])


def _spy_entries(monkeypatch):
    '''Record every call of a kernel entry point of ops/functions.py.'''
    calls = []
    for entry in ENTRIES:
        def spy(*args, _entry=entry, _fn=getattr(functions, entry)):
            calls.append(_entry)
            return _fn(*args)
        monkeypatch.setattr(functions, entry, spy)
    return calls


@pytest.mark.parametrize('name,options,want', [
    ('UNetAnnotator', dict(n_filters_first=4, n_downsample=2),
     {'conv_chain', 'tconv2x2', 'stencil_conv'}),
    ('UNetAnnotator', dict(n_filters_first=4, n_downsample=2,
                           activation='elu'), {'stencil_conv', 'tconv2x2'}),
    ('UNetAnnotator', dict(n_filters_first=64, n_downsample=2, bn=True),
     {'pool2x2_nhwc', 'tconv2x2_nhwc'}),
    ('MulmoUNetAnnotator', dict(n_filters_first=4, n_downsample=2, bn=True),
     {'stencil_conv_nhwc'}),
])
def test_library_only_reaches_no_kernel(monkeypatch, name, options, want):
    '''Outside the scope, with every gate on by the environment, the model
    reaches the kernel entries ``want``; inside it, none, and every gate
    reads False.'''
    from dnncancerannotator_torch import models

    options = dict(rate=2, kernel_size=3, conv_stride=1, padding='same',
                   **options)
    model, _ = models.build_model(name, options, in_channels=5)
    x = torch.from_numpy(_features(2, 0)).float() / 255
    for var in gates._ENV.values():
        monkeypatch.setenv(var, '1')
    calls = _spy_entries(monkeypatch)
    model.eval()
    with torch.no_grad():
        outside = model(x)
        assert set(calls) == want
        calls.clear()
        with gates.library_only():
            assert not any(gates.enabled(g) for g in gates._ENV)
            assert gates.forced_off()
            inside = model(x)
        assert calls == []
    assert not gates.forced_off() and gates.enabled('pallas_pool')
    np.testing.assert_allclose(inside.numpy(), outside.numpy(), rtol=0,
                               atol=1e-5)


def test_fixed_batch_artifact_takes_its_batch_only(runs, loaded):
    fn = loaded(runs['unet']['torch_fixed'])
    assert tuple(fn(_features(FIXED, 0)).shape) == (FIXED, HW, HW, 1)
    for b in (FIXED - 1, FIXED + 2):
        with pytest.raises(ValueError, match='artifact takes'):
            fn(_features(b, 0))
    with pytest.raises(ValueError, match='artifact takes'):
        loaded(runs['unet']['torch_art'])(_features(2, 0)[:, :16])


def test_platforms_not_listed_are_refused(runs, tmp_path):
    path = torch_export.export_model(runs['unet']['torch'],
                                     str(tmp_path / 'cuda_only'),
                                     platforms=('cuda',))
    with pytest.raises(ValueError, match='exported for'):
        torch_export.load_exported(path, device='cpu')


_ALONE = '''
import sys
import numpy as np
import torch
x = torch.from_numpy(np.load(sys.argv[1]))
for i, path in enumerate(sys.argv[2:]):
    program = torch.export.load(path)
    with torch.inference_mode():
        np.save(f'y{i}.npy', program.module()(x).numpy())
mods = sorted(m for m in sys.modules if m.startswith('dnncancerannotator'))
assert not mods, mods
print('alone')
'''


@pytest.fixture(scope='module')
def alone(runs, tmp_path_factory):
    '''(features, {case: maps}) from one fresh process that imports torch
    and numpy alone and loads each case's artifact.'''
    tmp = tmp_path_factory.mktemp('alone')
    x = _features(3, 7)
    np.save(tmp / 'x.npy', x)
    names = sorted(CASES)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run(
        [sys.executable, '-c', _ALONE, str(tmp / 'x.npy'),
         *[runs[name]['torch_art'] for name in names]], cwd=str(tmp),
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith('alone')
    return x, {name: np.load(tmp / f'y{i}.npy')
               for i, name in enumerate(names)}


@pytest.mark.parametrize('name', sorted(CASES))
def test_artifact_holds_aten_only_and_runs_alone(runs, loaded, alone, name):
    '''Only aten ops; a fresh process with torch and numpy alone loads and
    runs it (no class of the port unpickled) to the same maps.'''
    path = runs[name]['torch_art']
    assert torch_export.foreign_ops(torch.export.load(path)) == []
    x, maps = alone
    np.testing.assert_array_equal(maps[name], loaded(path)(x).numpy())


def test_sidecar_matches_jax(runs):
    for name, case in runs.items():
        with open(os.path.splitext(case['jax_art'])[0] + '.yaml') as f:
            want = yaml.safe_load(f)
        with open(os.path.splitext(case['torch_art'])[0] + '.yaml') as f:
            got = yaml.safe_load(f)
        assert want.pop('jax_version') == jax.__version__
        assert got.pop('torch_version') == str(torch.__version__)
        assert want.pop('platforms') == ['cpu']
        assert got.pop('platforms') == ['cuda', 'cpu']
        assert got == want, name
        assert got['input']['shape'] == [-1, HW, HW, 5]
        assert got['checkpoint_step'] == 3


@pytest.mark.parametrize('name,options', [
    ('MulmoUNetAnnotator', dict(n_filters_first=4, n_downsample=2, rate=2,
                                kernel_size=3, conv_stride=1, bn=True,
                                padding='same')),
    ('MultiResUnet', dict(height=None, width=None, n_channels=5,
                          base_filters=4)),
])
def test_other_families_export(tmp_path, name, options):
    '''A seeded port run (statistics moved) exported: the artifact equals
    the live model under the force-off scope to 1e-6 and on its usual CPU
    route to 1e-5.'''
    config = dict(model=name, model_options=options,
                  deploy_options=dict(pallas_pool=True, pallas_tconv=True),
                  data_options=dict(eval=dict(output_size=[HW, HW])))
    eng = torch_engine.Engine(config, device='cpu')
    eng.build((2, HW, HW, 5))
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for key, value in eng.model.state_dict().items():
            value.copy_(torch.from_numpy(_perturb(key.rsplit('.', 1)[-1],
                                                  value.numpy(), rng)))
    save = str(tmp_path / 'run')
    os.makedirs(save)
    with open(os.path.join(save, 'options.yaml'), 'w') as f:
        yaml.safe_dump(dict(config=config), f)
    eng.save_ckpt(os.path.join(save, 'checkpoints'), 2)
    eng.finalize_checkpoints()
    fn = torch_export.load_exported(
        torch_export.export_model(save, str(tmp_path / 'art')), device='cpu')
    x = _features(3, 11)
    got = fn(x)
    xf = torch.from_numpy(x).float() / 255
    with torch.no_grad(), eng.scope():
        usual = eng.model(xf)
        with gates.library_only():
            forced = eng.model(xf)
    assert got.shape == (3, HW, HW, 1)
    np.testing.assert_allclose(got.numpy(), forced.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), usual.numpy(), rtol=0, atol=1e-5)


# -- the HTTP endpoint --------------------------------------------------------
@pytest.fixture(scope='module')
def servers(runs):
    '''{(package, 'sym' | 'fixed'): base URL}: the JAX server on the JAX
    artifacts and the port's (device='cpu') on its own, both with
    max_batch MAX_BATCH.'''
    from dnncancerannotator_tpu.runs import serve as jax_serve

    unet = runs['unet']
    made = {
        ('jax', 'sym'): jax_serve.make_server(
            unet['jax_art'], port=0, max_batch=MAX_BATCH),
        ('jax', 'fixed'): jax_serve.make_server(
            unet['jax_fixed'], port=0, max_batch=MAX_BATCH),
        ('torch', 'sym'): torch_serve.make_server(
            unet['torch_art'], port=0, max_batch=MAX_BATCH, device='cpu'),
        ('torch', 'fixed'): torch_serve.make_server(
            unet['torch_fixed'], port=0, max_batch=MAX_BATCH, device='cpu'),
    }
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in made.values()]
    for thread in threads:
        thread.start()
    yield {key: 'http://127.0.0.1:%d' % s.server_address[1]
           for key, s in made.items()}
    for server in made.values():
        server.shutdown()
        server.server_close()
    for thread in threads:
        thread.join(timeout=10)
        assert not thread.is_alive()
    assert not [t for t in threading.enumerate()
                if t.name.startswith(torch_serve.WORKER)]


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


_REQUESTS = {
    'healthz': ('sym', '/healthz', None),
    'spec': ('sym', '/spec', None),
    'unknown get': ('sym', '/nope', None),
    'unknown post': ('sym', '/nope', _npy(_features(2, 0))),
    'garbage body': ('sym', '/predict', b'not an npy'),
    'float32': ('sym', '/predict', _npy(_features(2, 0).astype(np.float32))),
    '3-d': ('sym', '/predict', _npy(_features(1, 0)[0])),
    'wrong hw': ('sym', '/predict', _npy(_features(2, 0)[:, :16])),
    'batch 0': ('sym', '/predict', _npy(_features(0, 0))),
    'over max_batch': ('sym', '/predict', _npy(_features(MAX_BATCH + 1, 0))),
    'predict': ('sym', '/predict', _npy(_features(3, 1))),
    'predict max_batch': ('sym', '/predict', _npy(_features(MAX_BATCH, 2))),
    'fixed over': ('fixed', '/predict', _npy(_features(FIXED + 1, 0))),
    'fixed under': ('fixed', '/predict', _npy(_features(FIXED - 2, 3))),
    'fixed exact': ('fixed', '/predict', _npy(_features(FIXED, 4))),
}


def _ask(url, body):
    try:
        with urllib.request.urlopen(url, body, timeout=120) as resp:
            return resp.status, resp.headers['Content-Type'], resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers['Content-Type'], err.read()


@pytest.mark.parametrize('request_name', list(_REQUESTS))
def test_http_matches_jax_server(servers, request_name):
    kind, path, body = _REQUESTS[request_name]
    want = _ask(servers[('jax', kind)] + path, body)
    got = _ask(servers[('torch', kind)] + path, body)
    assert got[:2] == want[:2]
    if want[1] == 'application/json':
        w, g = json.loads(want[2]), json.loads(got[2])
        if path == '/spec':
            for meta in (w, g):
                for key in ('jax_version', 'torch_version', 'platforms'):
                    meta.pop(key, None)
        assert g == w
        assert want[0] == 200 or 'error' in w
    elif want[0] == 200 and path == '/predict':
        w, g = np.load(io.BytesIO(want[2])), np.load(io.BytesIO(got[2]))
        assert g.dtype == w.dtype == np.float32
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    else:
        assert got[2] == want[2]


def test_concurrent_requests_get_their_own_answers(servers, runs, loaded):
    '''More client threads than cores, each with its own batch, at a
    short switch interval: every answer is its own request's, as the
    artifact computes it alone.'''
    url = servers[('torch', 'sym')] + '/predict'
    fn = loaded(runs['unet']['torch_art'])
    inputs = [_features(1 + i % MAX_BATCH, 100 + i) for i in range(16)]
    want = [fn(x).numpy() for x in inputs]
    got = [None] * len(inputs)

    def ask(i):
        got[i] = _ask(url, _npy(inputs[i]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(inputs))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    for i, (status, _, body) in enumerate(got):
        assert status == 200
        np.testing.assert_array_equal(np.load(io.BytesIO(body)), want[i])

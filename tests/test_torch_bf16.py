'''The port's bf16 compute on the CPU against the JAX package.

(a) Parity: the logits, batch statistics, every parameter gradient and the
    input sensitivity of UNetAnnotator with BatchNorm (8 first filters, 2
    levels) in bf16 and under each policy (``f32_head``, ``f32_level0``),
    unet.yaml's NCHW chain model (3 first filters, 3 levels), MulmoUNet (2
    channels, 4 first filters) and MultiResUnet (base 4), all at 32 x 32,
    against the JAX model in bf16 on the same weights. The JAX values come
    from tests/util_bf16_ref.py, run in processes of their own with
    ``--xla_allow_excess_precision=false``: XLA otherwise keeps f32 inside
    a fusion where the JAX program rounds to bf16, while the port rounds
    wherever the JAX modules cast. Each value is within BF16_TOL of its
    scale (the scale of a bias before a BatchNorm is its layer's weight
    gradient's, as in test_torch_mulmo.py), or else no further from the
    JAX float64 value (the f32 model in x64) than F64_RATIO times the JAX
    bf16 value, by root-mean-square distance: a bf16 BatchNorm network
    amplifies the one-ulp flips that another summation order gives, so
    there neither bf16 result is the truth. The f64 rule alone would pass a
    port that never rounds, so a guard holds the port's bf16 train-mode
    logits at least GUARD_SHARE of JAX's own bf16-f32 gap away from the
    port's f32 logits.
(b) Dtype census: the output dtype of every conv, transposed conv and
    BatchNorm is the JAX module's (flax ``capture_intermediates``), under
    each policy.
(c) Rounded gradients: a parameter's gradient holds only bf16 values in the
    port exactly where it does in JAX (a bf16 layer's weight and bias; not
    a BatchNorm's scale and bias, nor an f32 layer's).
(d) Routing: in bf16 the chain, stencil and NHWC stencil kernels run at
    the sites where the traced JAX model calls its Pallas kernels, and the
    f32-only pool and transposed-conv kernels nowhere, for every shipped
    configuration with bf16.yaml and its policies.
(e) The plain versions of the five bf16 kernel forms against the Pallas
    kernels in interpret mode, with bf16 inputs, to one bf16 ulp of each
    value (plus PALLAS_F32_SLACK of the scale for f32 sums in another
    order).
(f) A bf16 ``train`` (with resume) / ``predict`` / ``evaluate`` run
    through the CLI: float32 checkpoints, finite losses and maps.
'''

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import F64_RATIO
from dnncancerannotator_tpu import models as jax_models
from dnncancerannotator_tpu.ops.pallas import conv_kernel as CK
from dnncancerannotator_tpu.ops.pallas import flatchain as JFC
from dnncancerannotator_tpu.ops.pallas import flattconv as JFT
from dnncancerannotator_tpu.ops.pallas import pool_kernel as JPK
from dnncancerannotator_tpu.ops.pallas import tconv_kernel as JTK
from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch import models as torch_models
from dnncancerannotator_torch.models import fastbn, fastconv
from dnncancerannotator_torch.models import multiresunet as mru
from dnncancerannotator_torch.ops import functions, gates
from dnncancerannotator_torch.ops.kernels import conv_chain as CC
from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB
from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
from dnncancerannotator_torch.ops.kernels import stencil_conv_nhwc as SN
from dnncancerannotator_torch.runs.__main__ import main
from dnncancerannotator_torch.utils import config as config_lib
from tests import test_torch_mulmo as tm
from tests import util_bf16_ref as ref
from tests import util_synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
# (a): a value's error against the JAX bf16 value, relative to its scale:
# a few bf16 ulps (2**-8 each) of rounding at other points of a sum
BF16_TOL = 2e-2
GUARD_SHARE = 0.25
# (e): f32 sums in another order than the Pallas kernel's
PALLAS_F32_SLACK = 1e-5
GATES_ON = gates.KernelGates(pallas_pool=True, pallas_tconv=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- (a), (c): the models against the JAX package ---------------------------------
@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    '''The JAX values of every case (tests/util_bf16_ref.py), from three
    processes run at once.'''
    out = tmp_path_factory.mktemp('bf16_ref')
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    env.pop('DNNCA_PALLAS_INTERPRET', None)
    env['XLA_FLAGS'] = (env.get('XLA_FLAGS', '')
                        + ' --xla_allow_excess_precision=false').strip()
    groups = (('bn', 'bn_f32_head', 'bn_f32_level0'), ('unet', 'mulmo'),
              ('mru',))
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'tests.util_bf16_ref', str(out), *group],
        cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for group in groups]
    for proc in procs:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-4000:]
    return out


def _load(refs, case):
    with np.load(refs / f'{case}.npz') as npz:
        data = {k: npz[k] for k in npz.files}
    part = {}
    for key, value in data.items():
        head, rest = key.split('/', 1)
        part.setdefault(head, {})[rest] = value
    return part


def _port(name, options, shape, weights, dtype):
    port, _ = torch_models.build_model(name, options, in_channels=shape[-1],
                                       dtype=dtype)
    port.load_state_dict(convert.torch_state_from_flax(
        weights, expected=port.state_dict()))
    return port


def _scale(values, key):
    '''The scale a value is held on (test_torch_mulmo's rule).'''
    scale = float(values[key].abs().max())
    if key.startswith('params/') and key.endswith('.bias'):
        layer = key.rsplit('.', 1)[0]
        peer = values.get(layer + '.weight', values.get(layer + '.scale'))
        if peer is not None:
            scale = max(scale, float(peer.abs().max()))
    return scale


def _rms(a, b):
    return float((a.double() - b.double()).pow(2).mean().sqrt())


def _representable(t):
    return torch.equal(t, t.to(BF16).to(t.dtype))


@pytest.mark.parametrize('case', list(ref.CASES))
def test_bf16_matches_jax(refs, case):
    name, options, shape, _, sens = ref.CASES[case]
    part = _load(refs, case)
    x, gmap = _t(part['in']['x']), _t(part['in']['gmap'])
    want = {k: _t(v) for k, v in part['bf16'].items()}
    want64 = {k: _t(v) for k, v in part['f64'].items()}
    port = _port(name, options, shape, part['param'], 'bfloat16')
    got = tm._run_port(port, x, gmap, gates.KernelGates(), sens)
    assert sorted(got) == sorted(want) == sorted(want64)
    held = []
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        assert got[key].dtype == torch.float32, key
        err = float((got[key].double() - value.double()).abs().max())
        if err <= BF16_TOL * _scale(want, key):
            continue
        held.append(key)
        ours, theirs = _rms(got[key], want64[key]), _rms(value, want64[key])
        assert ours <= F64_RATIO * theirs, (key, err, ours, theirs)
    # the eval-mode values hold their tolerance outright (train-mode
    # logits carry the batch statistics' amplified flips)
    assert not {'eval', 'sens'} & set(held), held

    # bf16 is really on: the port's f32 model lands elsewhere
    port32 = _port(name, options, shape, part['param'], None)
    port32.train()
    with torch.no_grad():
        logits32 = port32(x, return_logits=True)
    gap_jax = float((want['train'] - _t(part['f32']['train'])).abs().max())
    gap_port = float((got['train'] - logits32).abs().max())
    assert gap_jax > 0 and gap_port >= GUARD_SHARE * gap_jax, (gap_port,
                                                               gap_jax)

    # (c) the gradients rounded to bf16, exactly where JAX's are (not
    # where the exact gradient is 0: a bias before a BatchNorm, whose f32
    # sum cancels to a value of a few bits on either side)
    for key in want:
        if (key.startswith('params/') and float(want64[key].abs().max())
                > 1e-3 * _scale(want, key)):
            assert _representable(got[key]) == _representable(want[key]), key
    rounded = [k for k in want if k.startswith('params/')
               and _representable(want[k])]
    assert rounded, 'no bf16 layer'


# -- (b) the dtype census -------------------------------------------------------------
_CENSUS = {
    'bn': ('UNetAnnotator', ref.BN),
    'bn_f32_head': ('UNetAnnotator', dict(ref.BN, f32_head=True)),
    'bn_f32_level0': ('UNetAnnotator', dict(ref.BN, f32_level0=True)),
    'unet_f32_level0': ('UNetAnnotator', dict(ref.UNET, f32_level0=True)),
    'mulmo_f32_head': ('MulmoUNetAnnotator', dict(ref.MULMO, f32_head=True,
                                                  f32_level0=True)),
    'mru': ('MultiResUnet', dict(base_filters=4)),
}
_MODULES = (fastconv.Conv2DFast, fastconv.ConvTranspose2DFast,
            fastbn.BatchNormFast, mru.Conv, mru.UpTconv)


def _jax_dtypes(name, options, x):
    '''{module path: output dtype} of the JAX model's modules in bf16
    (traced, not run).'''
    model, _ = jax_models.build_model(name, options, dtype=jnp.bfloat16)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)

    def apply(v):
        return model.apply(v, x, training=True, mutable=['batch_stats',
                                                         'intermediates'],
                           capture_intermediates=True)[1]['intermediates']

    found = {}

    def walk(tree, path):
        for key, value in tree.items():
            if key != '__call__':
                walk(value, path + [key])
            elif hasattr(value[0], 'dtype'):   # not a block's tuple
                found['.'.join(path)] = str(value[0].dtype)

    walk(jax.eval_shape(apply, variables), [])
    return found


@pytest.mark.parametrize('case', list(_CENSUS))
def test_bf16_dtype_census(case):
    name, options = _CENSUS[case]
    x = np.random.default_rng(0).random((1, 16, 16, 2), dtype=np.float32)
    want = _jax_dtypes(name, options, jnp.asarray(x))
    port, _ = torch_models.build_model(name, options, in_channels=2,
                                       dtype='bfloat16')
    got = {}
    for path, module in port.named_modules():
        if isinstance(module, _MODULES):
            module.register_forward_hook(
                lambda m, i, o, path=path: got.__setitem__(path, o.dtype))
    port.train()
    with torch.no_grad():
        port(_t(x))
    # the fused chains run no Conv2DFast module (nor does the JAX chain)
    assert got and set(got) <= set(want), sorted(set(got) - set(want))
    for path, dtype in got.items():
        assert str(dtype).split('.')[-1] == want[path], path
    assert {str(d) for d in got.values()} >= {'torch.bfloat16'}


# -- (d) routing --------------------------------------------------------------------
def _port_sites(model, x):
    '''Sorted (kernel, Ci, Co) of the port's kernel calls in a forward under
    the pallas_decoder gates.'''
    seen = []
    wrapped = {'conv_chain': 'chain', 'stencil_conv': 'stencil',
               'stencil_conv_nhwc': 'stencil_nhwc', 'pool2x2_nhwc': 'pool',
               'tconv2x2': 'tconv', 'tconv2x2_nhwc': 'tconv'}
    real = {n: getattr(functions, n) for n in wrapped}

    def recorder(name):
        def record(*args, **kwargs):
            x_, w = args[0], (args[1] if len(args) > 1 else None)
            if name == 'pool2x2_nhwc':
                seen.append(('pool', x_.shape[-1], x_.shape[-1]))
            elif name.startswith('tconv'):
                seen.append(('tconv', w.shape[0], w.shape[1]))
            else:
                co = (args[3] if name == 'conv_chain' else w).shape[0]
                seen.append((wrapped[name], w.shape[1], co))
            return real[name](*args, **kwargs)
        return record

    try:
        for name in wrapped:
            setattr(functions, name, recorder(name))
        with gates.active(GATES_ON), torch.no_grad():
            model.eval()
            model(x)
    finally:
        for name, fn in real.items():
            setattr(functions, name, fn)
    return sorted(seen)


def _jax_sites(name, options, x, monkeypatch):
    '''The same list for the JAX model in bf16, traced with its kernel
    gates on and every Pallas entry replaced by a recorder.'''
    monkeypatch.setenv('DNNCA_PALLAS_INTERPRET', '1')
    monkeypatch.setenv('DNNCA_PPOOL', '1')
    monkeypatch.setenv('DNNCA_PTCONV', '1')
    seen = []

    def stencil(x_, w, b, pads, relu, nchw, interpret):
        seen.append(('stencil' if nchw else 'stencil_nhwc', w.shape[2],
                     w.shape[3]))
        sp = (2, 3) if nchw else (1, 2)
        oh = x_.shape[sp[0]] + sum(pads[0]) - w.shape[0] + 1
        ow = x_.shape[sp[1]] + sum(pads[1]) - w.shape[1] + 1
        return jnp.zeros((x_.shape[0], w.shape[3], oh, ow) if nchw
                         else (x_.shape[0], oh, ow, w.shape[3]), jnp.float32)

    def chain(x_, w1, b1, w2, b2, pads=None, interpret=False):
        seen.append(('chain', w1.shape[2], w2.shape[3]))
        b, _, h, w = x_.shape
        return (jnp.zeros((b, w1.shape[3], h, w), jnp.float32),
                jnp.zeros((b, w2.shape[3], h, w), jnp.float32))

    def flat_chain(x_, w1, b1, w2, b2, interpret=False):
        return chain(x_, w1, b1, w2, b2)[1]

    def pool(x_, interpret=False):
        seen.append(('pool', x_.shape[-1], x_.shape[-1]))
        b, h, w, c = x_.shape
        return jnp.zeros((b, h // 2, w // 2, c), x_.dtype)

    def tconv_nhwc(x_, w, b, interpret=False):
        seen.append(('tconv', w.shape[2], w.shape[3]))
        bb, h, wd, _ = x_.shape
        return jnp.zeros((bb, 2 * h, 2 * wd, w.shape[3]), jnp.float32)

    def tconv_nchw(x_, w, b, interpret=False):
        seen.append(('tconv', w.shape[2], w.shape[3]))
        bb, _, h, wd = x_.shape
        return jnp.zeros((bb, w.shape[3], 2 * h, 2 * wd), jnp.float32)

    monkeypatch.setattr(CK, 'stencil_conv2d_pallas', stencil)
    monkeypatch.setattr(CK, 'conv_chain_pallas', chain)
    monkeypatch.setattr(JFC, 'conv_chain_flat_nchw', flat_chain)
    monkeypatch.setattr(JPK, 'max_pool2x2_nhwc', pool)
    monkeypatch.setattr(JTK, 'conv_transpose2x2_nhwc', tconv_nhwc)
    monkeypatch.setattr(JFT, 'conv_transpose2x2_flat_nchw', tconv_nchw)
    model, _ = jax_models.build_model(name, options, dtype=jnp.bfloat16)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                               jnp.asarray(x))
    seen.clear()
    jax.eval_shape(lambda v: model.apply(v, jnp.asarray(x)), variables)
    return sorted(seen)


def _config(name, *overlays, **edits):
    paths = [os.path.join(REPO, 'configs', name)] + [
        os.path.join(REPO, 'configs', 'additionals', o) for o in overlays]
    config = config_lib.load_config(paths)
    return config['model'], dict(config['model_options'], **edits)


# the routing table at unet.yaml's 256 x 256 (its flat tconv takes W %
# 128 == 0, so only there does up_2's f32 tconv reach it) and at 32 x 32
# for the others (the channel counts decide; unet_big and MulmoUNet cut to
# 2 levels on the CPU)
_UNET_BF16 = [('chain', 5, 3), ('chain', 3, 6), ('chain', 12, 6),
              ('chain', 6, 3), ('stencil', 6, 12), ('stencil', 3, 1)]
_ROUTING = {
    'unet': (('unet.yaml',), {}, 256, _UNET_BF16),
    'unet_f32_head': (('unet.yaml', 'bf16_f32head.yaml'), {}, 256,
                      _UNET_BF16),
    # down_0's chain and up_2's tconv (row 3) in f32
    'unet_f32_level0': (('unet.yaml', 'bf16_f32level0.yaml'), {}, 256,
                        _UNET_BF16 + [('tconv', 6, 3)]),
    'mulmo': (('mulmo_unet.yaml', 'pallas_decoder.yaml'),
              {'n_downsample': 2}, 32,
              [('stencil_nhwc', 1, 16)] * 2 + [('stencil_nhwc', 16, 1)]),
    'unet_big': (('unet_big.yaml', 'pallas_decoder.yaml'),
                 {'n_downsample': 2}, 32, []),
    'unet_big_f32_level0': (('unet_big.yaml', 'pallas_decoder.yaml',
                             'bf16_f32level0.yaml'), {'n_downsample': 2},
                            32, []),
    'multiresunet': (('multiresunet.yaml',), {'base_filters': 4}, 32, []),
}


@pytest.mark.parametrize('case', list(_ROUTING))
def test_bf16_routing_matches_jax(case, monkeypatch):
    '''The port's kernel sites in bf16 equal the traced JAX model's
    Pallas sites and the table: down_2.conv_1 (12 -> 12, 1296 terms) and
    up_0's chain (24 -> 12 -> 12) run as per-conv library convs, as in
    JAX, and no pool or transposed conv of a bf16 level reaches a kernel.'''
    files, edits, size, table = _ROUTING[case]
    name, options = _config(files[0], 'bf16.yaml', *files[1:], **edits)
    channels = 2 if name == 'MulmoUNetAnnotator' else 5
    x = np.random.default_rng(0).random((1, size, size, channels),
                                        dtype=np.float32)
    port, _ = torch_models.build_model(name, options, in_channels=channels,
                                       dtype='bfloat16')
    got = _port_sites(port, _t(x))
    assert got == _jax_sites(name, options, x, monkeypatch)
    assert got == sorted(table)


# -- (e) the plain versions of the bf16 forms against the Pallas kernels ------------
def _hwio(w_oihw):
    return jnp.asarray(w_oihw.float().numpy().transpose(2, 3, 1, 0),
                       jnp.bfloat16)


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == BF16 else jnp.float32)


def _within_ulp(got, want):
    '''got (torch) within one bf16 ulp of each value of want (numpy f32
    or bf16), plus PALLAS_F32_SLACK of the scale.'''
    want = torch.from_numpy(np.array(want, np.float32))
    got = got.float()
    mag = torch.maximum(got.abs(), want.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
    slack = PALLAS_F32_SLACK * float(want.abs().max())
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= ulp + slack).all()), float(
        ((got - want).abs() - ulp).max())


def _rand16(rng, *shape, scale=1.0):
    return _t((rng.standard_normal(shape) * scale).astype(np.float32)).to(
        BF16)


def test_bf16_chain_plain_matches_pallas():
    '''unet.yaml's down_0 chain class: c1 and c2 f32 from the kernel, c2
    rounded to bf16 on the way out.'''
    rng = np.random.default_rng(30)
    x = _rand16(rng, 1, 5, 16, 16)
    w1, b1 = _rand16(rng, 3, 5, 3, 3, scale=0.3), _rand16(rng, 3)
    w2, b2 = _rand16(rng, 3, 3, 3, 3, scale=0.3), _rand16(rng, 3)
    c1, c2, c2f = CC.conv_chain(x, w1, b1, w2, b2, need_c1=True,
                                need_c2f=True)
    assert (c1.dtype, c2.dtype, c2f.dtype) == (torch.float32, BF16,
                                               torch.float32)
    j1, j2 = CK.conv_chain_pallas(_j(x), _hwio(w1), _j(b1), _hwio(w2),
                                  _j(b2), interpret=True)
    _within_ulp(c1, j1)
    _within_ulp(c2f, j2)
    _within_ulp(c2, j2.astype(jnp.bfloat16))


@pytest.mark.parametrize('need_dx', [False, True])
def test_bf16_chain_bwd_plain_matches_pallas(need_dx):
    rng = np.random.default_rng(31)
    x = _rand16(rng, 1, 5, 16, 16)
    w1, b1 = _rand16(rng, 3, 5, 3, 3, scale=0.3), _rand16(rng, 3)
    w2, b2 = _rand16(rng, 3, 3, 3, 3, scale=0.3), _rand16(rng, 3)
    c1, _, c2 = CC.conv_chain(x, w1, b1, w2, b2, need_c1=True, need_c2f=True)
    g = _rand16(rng, 1, 3, 16, 16)
    got = CCB.conv_chain_bwd(x, c1, c2, g, w1, w2, need_dx=need_dx)
    assert all(t is None or t.dtype == BF16 for t in got)
    dx, dw1, db1, dw2, db2 = CK.conv_chain_bwd_pallas(
        _j(x), _j(c1), _j(c2), _j(g).astype(jnp.float32), _hwio(w1),
        _hwio(w2), interpret=True, need_dx=need_dx)
    for mine, theirs in ((dw1, CCB_OIHW(got[1])), (dw2, CCB_OIHW(got[3]))):
        _within_ulp(theirs, np.asarray(mine.astype(jnp.bfloat16)))
    _within_ulp(got[2], np.asarray(db1.astype(jnp.bfloat16)))
    _within_ulp(got[4], np.asarray(db2.astype(jnp.bfloat16)))
    if need_dx:
        _within_ulp(got[0], np.asarray(dx.astype(jnp.bfloat16)))


def CCB_OIHW(w_oihw):
    '''A port weight gradient [Co, Ci, K, K] in the JAX HWIO layout.'''
    return w_oihw.permute(2, 3, 1, 0)


_STENCILS = [  # a 3x3 relu conv on the stencil route (narrower than
    (2, 3, 3, ((1, 1), (1, 1)), True),    # down_2.conv_0's 6 -> 12: the
    (3, 1, 1, ((0, 0), (0, 0)), False),   # interpreter unrolls each term),
]                                         # and the head (3 -> 1)


@pytest.mark.parametrize('ci,co,k,pads,relu', _STENCILS)
def test_bf16_stencil_plain_matches_pallas(ci, co, k, pads, relu):
    rng = np.random.default_rng(32)
    x, w, b = (_rand16(rng, 2, ci, 8, 8), _rand16(rng, co, ci, k, k),
               _rand16(rng, co))
    got = SC.stencil_conv(x, w, b, pads, relu)
    assert got.dtype == BF16
    want = CK.stencil_conv2d_pallas(_j(x), _hwio(w), _j(b), pads=pads,
                                    relu=relu, nchw=True, interpret=True)
    _within_ulp(got, np.asarray(want.astype(jnp.bfloat16)))
    g = _rand16(rng, *got.shape)
    dx, dw, db = SCB.stencil_conv_bwd(x, g, w, pads)
    jdx, jdw, jdb = CK.stencil_conv2d_bwd_pallas(
        _j(x), _j(g), _hwio(w), pads=pads, nchw=True, interpret=True)
    assert (dx.dtype, dw.dtype, db.dtype) == (BF16,) * 3
    _within_ulp(dx, np.asarray(jdx.astype(jnp.bfloat16)))
    _within_ulp(CCB_OIHW(dw), np.asarray(jdw.astype(jnp.bfloat16)))
    _within_ulp(db, np.asarray(jdb.astype(jnp.bfloat16)))


@pytest.mark.parametrize('ci,co,k,pads,relu', [
    (1, 16, 3, ((1, 1), (1, 1)), True),    # an encoder's conv_0
    (16, 1, 1, ((0, 0), (0, 0)), False),   # the head
])
def test_bf16_stencil_nhwc_plain_matches_pallas(ci, co, k, pads, relu):
    rng = np.random.default_rng(33)
    base = _rand16(rng, 2, 8, 8, ci + 2)
    x = base[..., 1:1 + ci]    # a channel slice, read in place
    w, b = _rand16(rng, co, ci, k, k), _rand16(rng, co)
    got = SN.stencil_conv_nhwc(x, w, b, pads, relu)
    assert got.dtype == BF16
    want = CK.stencil_conv2d_pallas(_j(x.contiguous()), _hwio(w), _j(b),
                                    pads=pads, relu=relu, nchw=False,
                                    interpret=True)
    _within_ulp(got, np.asarray(want.astype(jnp.bfloat16)))


# -- (f) the CLI -------------------------------------------------------------------
@pytest.fixture(scope='module')
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_bf16')
    return list(util_synth.make_tfrecords(str(tmp), size=64, n_slices=2))


def test_bf16_cli_train_resume_predict_evaluate(records, tmp_path):
    '''unet_big.yaml as shipped (bf16; deploy_options.yaml first, since it
    replaces the whole dict, then bf16.yaml) at 2 levels and 32 x 32:
    train 2 + 2 steps, predict, evaluate.'''
    overlay = tmp_path / 'narrow.json'
    overlay.write_text(json.dumps({
        'model_options.n_filters_first': 8,
        'model_options.n_downsample': 2,
        'data_options.train.output_size': [32, 32],
        'data_options.train.batch_size': 2,
        'data_options.eval.output_size': [32, 32],
        'data_options.eval.batch_size': 4,
        'deploy_options.warp_bank_size': 8,
    }))
    configs = [os.path.join(REPO, 'configs', 'unet_big.yaml')] + [
        os.path.join(REPO, 'configs', 'additionals', c) for c in (
            'data_options.yaml', 'deploy_options.yaml', 'bf16.yaml')]
    assert config_lib.load_config(configs)['deploy_options'][
        'precision'] == 'bfloat16'
    save = str(tmp_path / 'run')
    common = ['--save_path', save, '--device', 'cpu']
    for steps in (2, 4):
        res = main(argv=['train', '--config', *configs, str(overlay),
                         *common, '--data_path', *records, '--save_freq',
                         '2', '--seed', '1', '--max_steps', str(steps)])
        assert np.isfinite(res.history['loss']).all()
    saved = engine.read_ckpt(os.path.join(save, 'checkpoints', 'ckpt-4'))
    assert {v.dtype for k, v in saved.items()
            if k not in ('step', 'count')} == {np.dtype(np.float32)}
    out = str(tmp_path / 'pred')
    count = main(argv=['predict', *common, '--data_path', *records,
                       '--output_path', out, '--output_format', 'npy',
                       '--batch_size', '4'])
    maps = [np.load(os.path.join(root, f)) for root, _, files in os.walk(out)
            for f in files if f.endswith('.npy')]
    assert count == len(maps) > 0
    assert all(np.isfinite(m).all() and m.min() >= 0 and m.max() <= 1
               for m in maps)
    main(argv=['evaluate', *common, '--data_path', *records, '--tag', 'val',
               '--export_csv'])
    assert os.path.exists(os.path.join(save, 'tfevents', 'val',
                                       'results.csv'))

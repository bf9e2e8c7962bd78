'''The port's MulmoUNet slice on the CPU against the JAX package: the NHWC
form of the stencil conv (the plain version of the CUDA kernel
stencil_conv_nhwc) against ``stencil_conv2d_pallas(nchw=False)`` in
interpret mode, the routing of mulmo_unet.yaml's convs, the model (logits,
batch_stats, every parameter gradient, the input sensitivity) with the
kernel gates off and with pallas_decoder's on, and the ``train`` /
``predict`` CLI with resume.

Inputs are made with seeded numpy and handed to both packages. Tolerances,
relative to max|ref|: the stencil conv 1e-5 (f32 sums of at most 144
products in another order); train-mode logits 1e-4 (the batch variance
E[x^2] - mean^2 of many BatchNorms in f32), eval-mode logits 2e-5,
batch_stats 1e-5, each gradient 1e-4 of its layer's scale, the input
sensitivity 1e-4. The port's float64 run matches the JAX model's float64
run to F64_MATCH, and a parameter gradient past its tolerance is held to
the JAX float64 value (``check_model_against_jax``).
'''

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnncancerannotator_tpu import models as jax_models
from dnncancerannotator_tpu.models import blocks as jax_blocks
from dnncancerannotator_tpu.models import fastbn as jax_fastbn
from dnncancerannotator_tpu.models import fastconv as jax_fastconv
from dnncancerannotator_tpu.models import multiresunet as jax_multiresunet
from dnncancerannotator_tpu.models import unet as jax_unet
from dnncancerannotator_tpu.ops import gates as jax_gates
from dnncancerannotator_tpu.ops.pallas import conv_kernel as CK
from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch import models as torch_models
from dnncancerannotator_torch.ops import functions, gates
from dnncancerannotator_torch.ops.kernels import stencil_conv_nhwc as SN
from dnncancerannotator_torch.runs.__main__ import main
from dnncancerannotator_torch.utils import config as config_lib
from dnncancerannotator_torch.utils import viz
from tests import util_synth
from tests.test_torch_unet import _jax_params, flat_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULMO = config_lib.load_config(
    [os.path.join(REPO, 'configs', 'mulmo_unet.yaml')])['model_options']
# narrow: every conv of the gates-off run is small enough to be cheap
NARROW = dict(MULMO, n_filters_first=4, n_downsample=2)
# 32 first filters, 3 levels: down_2 pools 128 channels and up_0 takes
# n_channels x 128 -> 128, so the pool and tconv kernels route, as they do
# at mulmo_unet.yaml's 16 filters and 4 levels (the deepest BatchNorms see
# 4 x 4 pixels of each image at 32 x 32, not 2 x 2)
GATED = dict(MULMO, n_filters_first=32, n_downsample=3)
GATES_ON = gates.KernelGates(pallas_pool=True, pallas_tconv=True)
GATES_OFF = gates.KernelGates(pallas_pool=False, pallas_tconv=False)
SAME_3 = ((1, 1), (1, 1))
ZERO = ((0, 0), (0, 0))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def pallas_on(monkeypatch):
    '''The JAX package's pool and tconv gates on, its Pallas kernels in
    interpret mode on the CPU (the stencil conv's too).'''
    monkeypatch.setenv('DNNCA_PPOOL', '1')
    monkeypatch.setenv('DNNCA_PTCONV', '1')
    monkeypatch.setenv('DNNCA_PALLAS_INTERPRET', '1')


# -- the NHWC stencil conv -----------------------------------------------------
# MulmoUNet's two sites at 32 x 32: an encoder's first conv (3x3 SAME, one
# channel of the 5-channel batch -> 16, fused relu) and the head (1x1,
# 16 -> 1)
@pytest.mark.parametrize('site,ci,co,k,pads,relu,channel', [
    ('encoder conv_0', 1, 16, 3, SAME_3, True, 3),
    ('last_conv', 16, 1, 1, ZERO, False, None),
    ('3x3 VALID, 2 -> 3', 2, 3, 3, ZERO, False, None),
    ('2x2 SAME, odd pads', 3, 5, 2, ((0, 1), (0, 1)), True, None),
])
def test_stencil_nhwc_matches_pallas(site, ci, co, k, pads, relu, channel):
    rng = np.random.default_rng(ci * 100 + co)
    x = rng.standard_normal((2, 32, 32, 5 if channel is not None else ci)
                            ).astype(np.float32)
    wk = (rng.standard_normal((k, k, ci, co)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    xs = x[..., channel:channel + 1] if channel is not None else x
    want = np.asarray(CK.stencil_conv2d_pallas(
        jnp.asarray(xs), jnp.asarray(wk), jnp.asarray(bias), pads=pads,
        relu=relu, nchw=False, interpret=True))
    xt = _t(x)[..., channel:channel + 1] if channel is not None else _t(x)
    w = _t(wk.transpose(3, 2, 0, 1))
    got = SN.stencil_conv_nhwc(xt, w, _t(bias), pads, relu)
    assert got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), (site, err)


def test_stencil_nhwc_grads_match_jax():
    '''The autograd Function's backward (the library conv backward on the
    relu-masked cotangent) against jax.grad of the JAX package's stencil
    conv, at the encoder site with a strided channel input.'''
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 5)).astype(np.float32)
    wk = (rng.standard_normal((3, 3, 1, 16)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    g = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)

    def f(x_, w_, b_):
        out = jax_fastconv.stencil_conv2d(x_[..., 2:3], w_, (1, 1), 'SAME',
                                          bias=b_, relu=True)
        return jnp.vdot(out, jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(wk),
                                          jnp.asarray(bias))
    xt = _t(x).requires_grad_()
    w = _t(wk.transpose(3, 2, 0, 1)).requires_grad_()
    b = _t(bias).requires_grad_()
    out = functions.stencil_conv_nhwc(xt[..., 2:3], w, b, SAME_3, True)
    (out * _t(g)).sum().backward()
    for got, ref in ((xt.grad, want[0]),
                     (w.grad, np.asarray(want[1]).transpose(3, 2, 0, 1)),
                     (b.grad, want[2])):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize('ci,co,k,padding,want', [
    (1, 16, 3, 'same', True),     # an encoder's conv_0
    (16, 1, 1, 'same', True),     # the head
    (16, 16, 3, 'same', False),   # 2304 terms
    (32, 32, 1, 'same', True),    # 1024 terms: the bound itself
    (33, 1, 1, 'same', False),
    (1, 33, 1, 'same', False),
    (4, 8, 3, 'valid', True),
    (4, 8, 3, ((1, 1), (1, 1)), False),   # explicit pads: not small
])
def test_stencil_nhwc_route_rule(ci, co, k, padding, want):
    '''The JAX package's small conv and conv_kernel.supported's unroll
    bound (its VMEM bound holds at every case's 32 x 32).'''
    assert SN.eligible(ci, co, k, k, padding) == want
    small = isinstance(padding, str) and max(ci, co) <= 32
    assert want == (small and CK.supported(2, 32, 32, k, k, ci, co))


def _routed_sites(model, x, gate_set):
    '''Module paths whose conv ran through stencil_conv_nhwc in a forward.'''
    names = {id(m.weight): n for n, m in model.named_modules()
             if hasattr(m, 'weight') and isinstance(m.weight, torch.Tensor)}
    seen = []
    real = functions.stencil_conv_nhwc

    def record(x_, w, *args, **kwargs):
        seen.append(names[id(w)])
        return real(x_, w, *args, **kwargs)

    functions.stencil_conv_nhwc = record
    try:
        with gates.active(gate_set), torch.no_grad():
            model.eval()
            model(x)
    finally:
        functions.stencil_conv_nhwc = real
    return seen


def _jax_pallas_sites(name, options, x, monkeypatch):
    '''(Ci, Co, kh, kw) of every NHWC conv that the JAX model sends to
    stencil_conv2d_pallas (traced, not run: interpret mode on, the kernel
    replaced by a recorder).'''
    monkeypatch.setenv('DNNCA_PALLAS_INTERPRET', '1')
    seen = []

    def record(x_, w, b, pads, relu, nchw, interpret):
        if not nchw:
            seen.append(tuple(w.shape[2:]) + tuple(w.shape[:2]))
        sp = (2, 3) if nchw else (1, 2)
        oh = x_.shape[sp[0]] + sum(pads[0]) - w.shape[0] + 1
        ow = x_.shape[sp[1]] + sum(pads[1]) - w.shape[1] + 1
        shape = ((x_.shape[0], w.shape[3], oh, ow) if nchw
                 else (x_.shape[0], oh, ow, w.shape[3]))
        return jnp.zeros(shape, x_.dtype)

    monkeypatch.setattr(CK, 'stencil_conv2d_pallas', record)
    model, _ = jax_models.build_model(name, options)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                               jnp.asarray(x))
    seen.clear()
    jax.eval_shape(lambda v: model.apply(v, jnp.asarray(x)), variables)
    return seen


def test_mulmo_routes_the_jax_sites(monkeypatch):
    '''mulmo_unet.yaml at full width: exactly the five encoders' conv_0 and
    the head run the NHWC stencil kernel, the convs the JAX model sends to
    its Pallas stencil conv.'''
    x = np.random.default_rng(0).random((1, 32, 32, 5), dtype=np.float32)
    model, _ = torch_models.build_model('MulmoUNetAnnotator', MULMO,
                                        in_channels=5)
    got = _routed_sites(model, _t(x), GATES_ON)
    assert sorted(got) == sorted(
        [f'mulmo_unet.encoder_{i}.down_0.convchain.conv_0' for i in range(5)]
        + ['last_conv'])
    modules = dict(model.named_modules())
    shapes = sorted((modules[p].weight.shape[1], modules[p].weight.shape[0],
                     *modules[p].weight.shape[2:]) for p in got)
    assert shapes == sorted(_jax_pallas_sites('MulmoUNetAnnotator', MULMO, x,
                                              monkeypatch))


@pytest.mark.parametrize('config', ['unet.yaml', 'unet_big.yaml'])
def test_other_configs_route_no_nhwc_stencil(config, monkeypatch):
    '''No conv of unet.yaml (NCHW) or unet_big.yaml (64 filters; its head is
    64 -> 1) takes the NHWC stencil kernel, and neither JAX model reaches
    the Pallas stencil conv in NHWC.'''
    options = config_lib.load_config(
        [os.path.join(REPO, 'configs', config)])['model_options']
    options = dict(options, n_downsample=2)
    x = np.random.default_rng(0).random((1, 16, 16, 5), dtype=np.float32)
    model, _ = torch_models.build_model('UNetAnnotator', options,
                                        in_channels=5)
    assert _routed_sites(model, _t(x), GATES_ON) == []
    assert _jax_pallas_sites('UNetAnnotator', options, x, monkeypatch) == []


# -- the model ------------------------------------------------------------------------
def model_case(name, options, shape, seed):
    '''(JAX model, x, G, params, batch_stats): seeded inputs and a
    cotangent map, and the JAX model's initial weights with non-trivial
    biases, BatchNorm scales and running statistics.'''
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    gmap = rng.standard_normal(shape[:3] + (1,)).astype(np.float32)
    model, _ = jax_models.build_model(name, options)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.asarray(x[:1]))
    flat = flat_params(variables['params'])
    for key in flat:
        if key.endswith(('/bias', '/scale')):
            base = 1.0 if key.endswith('/scale') else 0.0
            flat[key] = (base + rng.standard_normal(flat[key].shape) * 0.1
                         ).astype(np.float32)
    stats = {}
    for key, v in flat_params(variables['batch_stats']).items():
        key = 'batch_stats' + key[len('params'):]
        stats[key] = (rng.uniform(0.5, 1.5, v.shape) if key.endswith('/var')
                      else rng.standard_normal(v.shape) * 0.1
                      ).astype(np.float32)
    return model, x, gmap, flat, stats


def _jax_tree(stats):
    return _jax_params({'params' + k[len('batch_stats'):]: v
                        for k, v in stats.items()})


def _run_port(port, x, gmap, gate_set, sens=True):
    '''The port's eval-mode logits and input sensitivity, then its
    train-mode logits, updated batch_stats and the parameter gradients of
    sum(logits * G).'''
    with gates.active(gate_set):
        port.eval()
        with torch.no_grad():
            out = {'eval': port(x, return_logits=True)}
        if sens:
            out['sens'] = viz.input_sensitivity(port, x)[1]
        port.train()
        logits = port(x, return_logits=True)
        (logits * gmap).sum().backward()
    out['train'] = logits.detach()
    out.update({'params/' + n: p.grad for n, p in port.named_parameters()})
    out.update({'batch_stats/' + n: b for n, b in port.named_buffers()})
    return out


class _F64Numpy:
    '''jax.numpy with ``float32`` read as ``float64``: in the JAX modules it
    replaces, every explicit float32 cast (BatchNorm statistics, conv
    accumulators, the logits) becomes a float64 one.'''
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


# the JAX modules on the models' XLA routes that cast to float32
_F32_CASTS = (jax_blocks, jax_fastbn, jax_fastconv, jax_multiresunet,
              jax_unet)
# the port's float64 run against the JAX model's, relative to the scale
# a value is held on: both sum the same float64 terms in other orders
F64_MATCH = 1e-9


def _jax_values(model, x, gmap, flat, stats, sens):
    '''{key: tensor} of the JAX model on ``flat`` and ``stats``: the
    train- and eval-mode logits, the parameter gradients of
    sum(logits * G) in train mode, the updated batch_stats and, with
    ``sens``, the eval-mode input sensitivity; keyed as ``_run_port``.'''
    xj = jnp.asarray(x)
    params = _jax_params(flat)
    variables = {'params': params, 'batch_stats': _jax_tree(stats)}

    def logits_train(p):
        out, upd = model.apply({**variables, 'params': p}, xj, training=True,
                               return_logits=True, mutable=['batch_stats'])
        return jnp.vdot(out, jnp.asarray(gmap)), (out, upd['batch_stats'])

    grads, (want_train, new_stats) = jax.jit(
        jax.grad(logits_train, has_aux=True))(params)
    want = {'train': want_train, 'eval': jax.jit(
        lambda v: model.apply(v, xj, return_logits=True))(variables)}
    if sens:
        dprobs = jax.jit(jax.grad(
            lambda x_: jnp.sum(model.apply(variables, x_))))(xj)
        summed = np.abs(np.asarray(dprobs)).sum((1, 2))
        want['sens'] = summed / summed.sum(1, keepdims=True)
    want = {k: torch.as_tensor(np.array(v)) for k, v in want.items()}
    for key, value in _port_state(flat_params(grads)).items():
        want['params/' + key] = value
    for key, value in flat_params(new_stats).items():
        want['batch_stats/' + key[len('params/'):].replace('/', '.')] = \
            torch.as_tensor(np.array(value))
    return want


def _port_state(flat):
    '''``convert.torch_state_from_flax`` in the leaves' own dtype: it casts
    to float32, so a float64 leaf goes through as its float32 high and low
    parts (each rearranged exactly; together within 2**-48 of the leaf).'''
    hi = {k: np.asarray(v, np.float32) for k, v in flat.items()}
    lo = {k: (np.asarray(v, np.float64) - hi[k]).astype(np.float32)
          for k, v in flat.items()}
    wide = np.asarray(next(iter(flat.values()))).dtype == np.float64
    dtype = torch.float64 if wide else torch.float32
    return {k: (v.double() + w.double()).to(dtype) for (k, v), w in zip(
        convert.torch_state_from_flax(hi).items(),
        convert.torch_state_from_flax(lo).values())}


def _jax_values_f64(model, x, gmap, flat, stats, sens):
    '''``_jax_values`` in float64: x64 on, every kernel gate off (the XLA
    routes, as ``gates.pure_xla`` takes them) and the float32 casts of
    ``_F32_CASTS`` read as float64.'''
    def f64(tree):
        return {k: np.asarray(v, np.float64) for k, v in tree.items()}

    with pytest.MonkeyPatch.context() as mp, jax_gates.pure_xla(), \
            jax.enable_x64(True):
        for module in _F32_CASTS:
            mp.setattr(module, 'jnp', _F64Numpy())
        return _jax_values(model, x.astype(np.float64),
                           gmap.astype(np.float64), f64(flat), f64(stats),
                           sens)


def check_model_against_jax(name, options, case, gate_set, sens=True):
    '''Train- and eval-mode logits, the updated batch_stats, every
    parameter gradient of sum(logits * G) in train mode and (with
    ``sens``) the eval-mode input sensitivity of the port (under
    ``gate_set``) against the JAX model on the same weights. Returns the
    keys that took the float64 rule.

    The port's float64 run must match the JAX model's float64 run
    (``_jax_values_f64``) to F64_MATCH of each value's scale: the port's
    wiring is JAX's, whatever the float32 rounding. Each float32 value of
    the port must be within its tolerance (module docstring) of the JAX
    float32 one, or else no further from the JAX float64 value than
    F64_RATIO times the JAX float32 one (chip_smoke.py's rule). A sum that
    cancels to about 0 (the gradient of a bias whose BatchNorm output
    reaches the next BatchNorm only through a max pool, as in the encoders
    whose skips the decoder does not read, is exactly 0) holds the
    rounding of every term on both sides, and a BatchNorm over few values
    (the deepest level at 32 x 32) amplifies it; there neither float32
    result is the truth.'''
    from chip_smoke import F64_RATIO
    model, x, gmap, flat, stats = case
    want = _jax_values(model, x, gmap, flat, stats, sens)
    want64 = _jax_values_f64(model, x, gmap, flat, stats, sens)

    port, _ = torch_models.build_model(name, options, in_channels=x.shape[-1])
    port.load_state_dict(convert.torch_state_from_flax(
        {**flat, **stats}, expected=port.state_dict()))
    port64 = copy.deepcopy(port).double()
    got = _run_port(port, _t(x), _t(gmap), gate_set, sens)
    exact = _run_port(port64, _t(x).double(), _t(gmap).double(), gate_set,
                      sens)
    assert sorted(got) == sorted(want) == sorted(want64)
    fallbacks = []
    for key, ref in want.items():
        tol = {'train': 1e-4, 'eval': 2e-5, 'sens': 1e-4}.get(
            key, 1e-5 if key.startswith('batch_stats/') else 1e-4)
        scale = float(ref.abs().max())
        if key.endswith('.bias') and key.startswith('params/'):
            # a bias right before a BatchNorm (a tconv's) has an exact
            # gradient of 0: a bias is held on the scale of its layer's
            # weight (or BatchNorm scale) gradient
            layer = key.rsplit('.', 1)[0]
            peer = want.get(layer + '.weight', want.get(layer + '.scale', ref))
            scale = max(scale, float(peer.abs().max()))
        assert got[key].shape == ref.shape == want64[key].shape, key
        err64 = float((exact[key] - want64[key]).abs().max())
        assert err64 <= F64_MATCH * scale, (key, err64, scale)
        err = float((got[key] - ref).abs().max())
        if err <= tol * scale:
            continue
        fallbacks.append(key)
        ours, theirs = (float((t.double() - want64[key]).abs().max())
                        for t in (got[key], ref))
        assert ours <= F64_RATIO * theirs, (key, err, tol * scale, ours,
                                            theirs)
    return fallbacks


def test_mulmo_matches_jax_gates_off():
    '''Three channels, 4 first filters, 2 levels, BN, 32 x 32: the JAX model
    on its XLA routes, the port on its plain versions.'''
    case = model_case('MulmoUNetAnnotator', NARROW, (2, 32, 32, 3), 3)
    held = check_model_against_jax('MulmoUNetAnnotator', NARROW, case,
                                   GATES_OFF)
    # 8 here: the bn_1 bias and scale gradients of the two encoders whose
    # skips the decoder does not read
    assert all(key.startswith('params/') for key in held), held


def test_mulmo_matches_jax_pallas_decoder(pallas_on):
    '''32 first filters and 3 levels on two channels at 32 x 32 with the
    pool and tconv gates on: the JAX model runs its Pallas stencil conv, pool and
    tconv in interpret mode, the port the plain versions of its kernels.'''
    case = model_case('MulmoUNetAnnotator', GATED, (2, 32, 32, 2), 4)
    held = check_model_against_jax('MulmoUNetAnnotator', GATED, case,
                                   GATES_ON, sens=False)
    # 6 here: encoder_1's bn_1 bias and scale gradients at each level
    assert all(key.startswith('params/') for key in held), held


def test_mulmo_reference_index_and_names():
    '''Skips come from encoder ``reference_index``; the parameter names are
    the flax paths.'''
    model, x, _, flat, stats = model_case(
        'MulmoUNetAnnotator', dict(NARROW, reference_index=2),
        (1, 16, 16, 3), 5)
    port, _ = torch_models.build_model(
        'MulmoUNetAnnotator', dict(NARROW, reference_index=2), in_channels=3)
    assert sorted(convert.flax_from_torch_state(port.state_dict())) == \
        sorted({**flat, **stats})
    port.load_state_dict(convert.torch_state_from_flax({**flat, **stats}))
    port.eval()
    with torch.no_grad():
        got = port(_t(x), return_logits=True).numpy()
    want = np.asarray(model.apply({'params': _jax_params(flat),
                                   'batch_stats': _jax_tree(stats)},
                                  jnp.asarray(x), return_logits=True))
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


def test_mulmo_converter_round_trip():
    _, _, _, flat, stats = model_case('MulmoUNetAnnotator', NARROW,
                                      (1, 16, 16, 2), 6)
    both = {**flat, **stats}
    back = convert.flax_from_torch_state(convert.torch_state_from_flax(both))
    assert sorted(back) == sorted(both)
    for key in both:
        np.testing.assert_array_equal(back[key], both[key])


# -- the CLI --------------------------------------------------------------------------
@pytest.fixture(scope='module')
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_mulmo')
    return list(util_synth.make_tfrecords(str(tmp), size=64, n_slices=2))


def test_mulmo_train_resume_predict_cli(records, tmp_path):
    '''mulmo_unet.yaml (narrowed) through the train CLI: 2 + 2 steps with a
    resume equal 4 in one call, batch_stats move, and predict from the
    last checkpoint writes finite maps in [0, 1].'''
    overlay = tmp_path / 'narrow.json'
    overlay.write_text(json.dumps({
        'model_options.n_filters_first': 4,
        'model_options.n_downsample': 2,
        'data_options.train.output_size': [32, 32],
        'data_options.train.batch_size': 2,
        'data_options.eval.output_size': [32, 32],
        'data_options.eval.batch_size': 4,
        'deploy_options.warp_bank_size': 8,
        'deploy_options.steps_per_call': 2,
    }))
    configs = [os.path.join(REPO, 'configs', c) for c in (
        'mulmo_unet.yaml', 'additionals/data_options.yaml',
        'additionals/deploy_options.yaml', 'additionals/pallas_decoder.yaml')]

    def run(save, max_steps):
        return main(argv=['train', '--config', *configs, str(overlay),
                          '--save_path', save, '--data_path', *records,
                          '--save_freq', '2', '--seed', '1', '--device',
                          'cpu', '--max_steps', str(max_steps)])

    def ckpt(save, step):
        return engine.read_ckpt(os.path.join(
            save, 'checkpoints', f'ckpt-{step}'), opt_state=False)

    a, b = str(tmp_path / 'a'), str(tmp_path / 'b')
    res = run(a, 4)
    assert res.epoch == [1, 2, 3, 4] and np.isfinite(res.history['loss']).all()
    run(b, 2)
    assert run(b, 4).epoch == [3, 4]
    unbroken, resumed, first = ckpt(a, 4), ckpt(b, 4), ckpt(b, 2)
    assert sorted(unbroken) == sorted(resumed)
    for key in unbroken:
        np.testing.assert_array_equal(unbroken[key], resumed[key], key)
    moved = [k for k, v in first.items() if k.startswith('batch_stats/')
             and not np.allclose(v, 1.0 if k.endswith('/var') else 0.0)]
    assert moved and len(moved) == sum(k.startswith('batch_stats/')
                                       for k in first)
    out = str(tmp_path / 'maps')
    count = main(argv=['predict', '--save_path', a, '--data_path', *records,
                       '--output_path', out, '--output_format', 'npy',
                       '--device', 'cpu'])
    assert count > 0
    for root, _, files in os.walk(out):
        for f in files:
            m = np.load(os.path.join(root, f))
            assert np.isfinite(m).all() and m.min() >= 0 and m.max() <= 1

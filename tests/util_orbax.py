'''Orbax checkpoints written by the JAX package, for the port's reader
(dnncancerannotator_torch/ckpt/): the JAX engine's own ``build`` and
``save_ckpt`` with seeded optimizer state, the ten optimizers' chains, and
the flat interim layout. Used by tests/test_torch_orbax.py,
tests/test_torch_orbax_write.py (which also restores the port's checkpoints
with Orbax, ``restore``) and by
tools/make_torch_orbax_fixture.py, which writes the committed fixtures under
tests/fixtures_torch/orbax/. Imports JAX: never imported by the port.'''

import os

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, 'tests', 'fixtures_torch', 'orbax')
INPUT_SHAPE = (1, 64, 64, 5)
_CFG = os.path.join(REPO, 'configs')
UNET_CONFIGS = [os.path.join(_CFG, 'unet.yaml'),
                os.path.join(_CFG, 'additionals', 'deploy_options.yaml'),
                os.path.join(_CFG, 'additionals', 'data_options.yaml')]
BIG_CONFIGS = [os.path.join(_CFG, 'unet_big.yaml'),
               os.path.join(_CFG, 'additionals', 'data_options.yaml')]
# fixture name -> (config files, n_filters_first or None to keep)
FIXTURE_SPECS = {'unet': (UNET_CONFIGS, None), 'bn': (BIG_CONFIGS, 4)}
# state fields that hold squares (kept positive when seeded)
_POSITIVE = {'nu', 'var', 'sum_of_squares', 'e_g', 'e_x'}


def load_config(paths, n_filters_first=None):
    from dnncancerannotator_tpu.utils import config as jax_config
    config = jax_config.load_config(paths)
    if n_filters_first is not None:
        config['model_options']['n_filters_first'] = n_filters_first
    return config


def _key(k):
    for attr in ('key', 'name', 'idx'):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(f'unsupported key path entry: {k!r}')


def _seeded(path, leaf, rng, step):
    '''A seeded value for one state leaf: counts at ``step``, second
    moments and variances positive. Each value is a 9-bit integer times a
    power of two: every element differs from its neighbours, and the
    fixtures stay small (the low mantissa bytes compress).'''
    names = [_key(k) for k in path]
    arr = np.asarray(leaf)
    if names[-1] == 'count':
        return np.asarray(step, arr.dtype)
    if not np.issubdtype(arr.dtype, np.floating):
        return arr
    if _POSITIVE.intersection(names):
        return (rng.integers(1, 512, arr.shape) * 2.0 ** -20).astype(
            arr.dtype)
    return (rng.integers(-511, 512, arr.shape) * 2.0 ** -12).astype(
        arr.dtype)


def seed_state(state, seed):
    '''``state`` (the JAX engine's) with its opt_state, batch_stats and
    step drawn from a seeded numpy generator, so no moment is zero.'''
    rng = np.random.default_rng(seed)
    step = int(rng.integers(100, 1000))
    out = dict(state)
    for part in ('opt_state', 'batch_stats'):
        out[part] = jax.tree_util.tree_map_with_path(
            lambda p, l: _seeded(p, l, rng, step), state[part])
    out['step'] = np.asarray(step, np.int32)
    return out, step


def expected_flat(view):
    '''The param-tree view of a state as the port's flat dict: the reader's
    contract (ckpt/orbax.py), written out independently of it.'''
    flat, counts = {}, []
    for path, leaf in jax.tree_util.tree_flatten_with_path(view)[0]:
        names = [_key(k) for k in path]
        arr = np.asarray(leaf)
        if names[0] in ('params', 'batch_stats'):
            flat['/'.join(names)] = arr
        elif names == ['step']:
            flat['step'] = arr
        elif names[-1] == 'count':
            counts.append(arr)
        else:
            field = names[2]
            flat['/'.join([field, 'params'] + names[3:])] = arr
    if counts:
        assert len({int(c) for c in counts}) == 1
        flat['count'] = counts[0]
    return flat


def seeded_engine(config, seed=0):
    '''The JAX engine built at INPUT_SHAPE, its state seeded; returns
    (engine, step).'''
    from dnncancerannotator_tpu import engine as jax_engine
    engine = jax_engine.Engine(config)
    engine.build(INPUT_SHAPE)
    engine.state, step = seed_state(
        jax.tree.map(np.asarray, engine.state), seed)
    engine.state = jax.device_put(engine.state, engine._rep)
    return engine, step


def write_run(run_dir, config, seed=0, recorded_path=None):
    '''A JAX save_path: options.yaml (its ``save_path`` entry
    ``recorded_path``, else ``run_dir``) and ``checkpoints/ckpt-<step>``
    saved by the JAX engine. Returns (checkpoint dir, the expected flat
    dict).'''
    from dnncancerannotator_tpu.utils import dump
    os.makedirs(run_dir, exist_ok=True)
    dump.dump_options(os.path.join(run_dir, 'options.yaml'), config=config,
                      save_path=recorded_path or run_dir, data_path=[])
    engine, step = seeded_engine(config, seed)
    engine.save_ckpt(os.path.join(run_dir, 'checkpoints'), step)
    engine.finalize_checkpoints()
    expected = expected_flat(jax.tree.map(np.asarray, engine._ckpt_view()))
    return os.path.join(run_dir, 'checkpoints', f'ckpt-{step}'), expected


def write_flat_layout(path, config, seed=0):
    '''The JAX engine's runtime state (opt_state as optax.flatten's
    vectors), saved as is: the interim layout. Returns the expected flat
    dict of its param-tree view.'''
    import orbax.checkpoint as ocp
    engine, _ = seeded_engine(config, seed)
    state = jax.tree.map(np.asarray, engine.state)
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(path), state)
    return expected_flat(jax.tree.map(np.asarray,
                                      engine._param_tree_view(state)))


def small_params(seed=0):
    rng = np.random.default_rng(seed)
    return {'conv': {'kernel': rng.standard_normal((3, 3, 2, 4), np.float32),
                     'bias': rng.standard_normal(4, np.float32)},
            'head': {'kernel': rng.standard_normal((1, 1, 4, 1), np.float32),
                     'bias': rng.standard_normal(1, np.float32)}}


def optimizer_view(optimizer, seed=0):
    '''A state with the small params and ``optimizer``'s chain (a registry
    name or spec of the JAX engine, optax.flatten-ed as the engine runs
    it), seeded, in the engine's param-tree view. Returns (view, the
    expected flat dict).'''
    import optax
    from dnncancerannotator_tpu import engine as jax_engine
    from dnncancerannotator_tpu.train import optimizers as jax_optimizers
    tx, _ = jax_optimizers.solve_optimizer(optimizer)
    params = small_params(seed)
    state = {'params': params, 'batch_stats': {},
             'opt_state': optax.flatten(tx).init(params),
             'step': np.zeros((), np.int32)}
    state, _ = seed_state(jax.tree.map(np.asarray, state), seed)
    view = jax.tree.map(np.asarray, jax_engine.Engine._param_tree_view(state))
    return view, expected_flat(view)


def write_optimizer_state(path, optimizer, seed=0):
    '''``optimizer_view``'s state saved with StandardCheckpointer. Returns
    the expected flat dict.'''
    import orbax.checkpoint as ocp
    view, expected = optimizer_view(optimizer, seed)
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(path), view)
    return expected


def restore(path, view):
    '''Orbax's StandardCheckpointer restore of ``path`` with the template
    the JAX engine's ``load`` builds from a state like ``view``: each leaf's
    shape and dtype, replicated on the engine's mesh.'''
    import orbax.checkpoint as ocp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ('data', 'model'))
    rep = NamedSharding(mesh, PartitionSpec())
    template = jax.tree.map(
        lambda l: jax.ShapeDtypeStruct(np.shape(l), np.asarray(l).dtype,
                                       sharding=rep), view)
    with ocp.StandardCheckpointer() as ckptr:
        return jax.tree.map(np.asarray, ckptr.restore(
            os.path.abspath(path), template))


def write_fixture(name, out_dir=FIXTURES, seed=0):
    '''Fixture ``name`` of FIXTURE_SPECS: the run directory
    ``<out_dir>/<name>/`` and ``<out_dir>/<name>.expected.npz``.'''
    import shutil
    paths, width = FIXTURE_SPECS[name]
    run_dir = os.path.join(out_dir, name)
    shutil.rmtree(run_dir, ignore_errors=True)
    _, expected = write_run(run_dir, load_config(paths, width), seed,
                            os.path.relpath(run_dir, REPO))
    np.savez_compressed(os.path.join(out_dir, f'{name}.expected.npz'),
                        **expected)
    return run_dir

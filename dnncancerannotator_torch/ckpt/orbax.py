'''The JAX package's Orbax checkpoints as the port's flat dicts, read and
written.

The JAX engine saves ``ckpt-<step>`` with Orbax's StandardCheckpointHandler:
``_METADATA`` (JSON: every leaf of the saved tree by key path),
``_CHECKPOINT_METADATA`` (written last, when the save commits), and an OCDBT
store (``manifest.ocdbt``, ckpt/ocdbt.py) holding one zarr v2 array per leaf
(ckpt/zarr.py), named by the key path joined with ``.``. The tree is the
JAX engine's state: ``params`` and ``batch_stats`` (flax trees), ``step``,
and ``opt_state``, an optax chain: a tuple of states whose fields are
``count`` or a moment named by optax (``mu``, ``nu``, ``trace``, ``e_g``,
``e_x``, ``sum_of_squares``) over the params tree, or, in the flat interim
layout the JAX engine's ``load`` also takes, one ``(n,)`` vector per moment
in ``jax.flatten_util.ravel_pytree``'s order (the params tree's sorted
paths).

``read_checkpoint`` returns what the port's own checkpoint holds
(engine.py): ``params/<flax path>`` and ``batch_stats/<flax path>``
(convert.torch_state_from_flax), ``<optax name>/params/<flax path>`` for
each moment (the engine's ``_opt_state_flat``), ``step``, and ``count``,
the optimizer's update count, which every ``count`` of the chain holds. A
leaf it cannot place, an optax name that two states of the chain hold,
counts that disagree, a checkpoint that never committed, or a layout other
than OCDBT with zarr v2 raise ValueError.

``write_checkpoint`` is its inverse: it writes a flat dict as the JAX
engine's ``save_ckpt`` does, so that ``StandardCheckpointer().restore`` with
the JAX engine's template, and so its ``load``, take it. ``params`` and
``batch_stats`` become flax trees (an empty ``batch_stats`` the
``{"value_type": "Dict", "skip_deserialize": true}`` leaf), the moments and
``count`` go into the optimizer's optax chain (``chain``: one tuple of
field names per state, () for an empty state, which Orbax records as a
``None`` leaf; train/optimizers.py: ``chain``), ``step`` and each ``count``
are int32. Every array is a ``jax.Array`` leaf with its ``write_shape`` in
``_METADATA``. Orbax's restore reads neither ``_sharding`` nor
``array_metadatas/`` when the template gives every leaf's sharding, as the
JAX engine's does, so neither is written. The directory is written under
``<path>.orbax-checkpoint-tmp``, ``_CHECKPOINT_METADATA`` last, then renamed
to ``path``: a name that ``ckpt-<step>`` never matches until the save
commits. A failed write removes the temporary directory and raises.
'''

import json
import os
import shutil
import time

import numpy as np

from . import ocdbt
from . import zarr

METADATA = '_METADATA'
COMMIT_METADATA = '_CHECKPOINT_METADATA'
OPTAX_NAMES = ('mu', 'nu', 'trace', 'e_g', 'e_x', 'sum_of_squares')
HANDLER = ('orbax.checkpoint._src.handlers.standard_checkpoint_handler.'
           'StandardCheckpointHandler')
TMP_SUFFIX = '.orbax-checkpoint-tmp'
_SEQUENCE_KEY = 1  # key_type of a tuple or list index in _METADATA
_DICT_KEY = 2      # key_type of a dict key or a named field
_ARRAY_TYPES = ('jax.Array', 'np.ndarray')


def is_checkpoint(path):
    '''Whether ``path`` holds an Orbax checkpoint in OCDBT form.'''
    return (os.path.isfile(os.path.join(path, METADATA)) and
            os.path.isfile(os.path.join(path, ocdbt.MANIFEST)))


def _leaves(path):
    '''[(keys, key types, value metadata)] of the saved tree.'''
    with open(os.path.join(path, METADATA)) as fh:
        meta = json.load(fh)
    for key, want in (('use_ocdbt', True), ('use_zarr3', False)):
        if meta.get(key, want) != want:
            raise ValueError(f'{path}: Orbax {key}={meta[key]} is not read '
                             f'(the reader takes OCDBT with zarr v2)')
    out = []
    try:
        for entry in meta['tree_metadata'].values():
            keys = [str(k['key']) for k in entry['key_metadata']]
            types = [k['key_type'] for k in entry['key_metadata']]
            out.append((keys, types, entry['value_metadata']))
    except (KeyError, TypeError, AttributeError) as exc:
        raise ValueError(f'{path}: malformed {METADATA}: {exc!r}') from exc
    return out


def _place_opt(keys, types):
    '''(chain position, optax field, flax path or None) of an opt_state
    leaf.'''
    i = 1
    while i < len(keys) and types[i] == _SEQUENCE_KEY:
        i += 1
    if i == len(keys):
        return None
    field, rest = keys[i], keys[i + 1:]
    if field == 'count' and not rest:
        return tuple(keys[1:i]), field, None
    if field in OPTAX_NAMES:
        return tuple(keys[1:i]), field, '/'.join(rest) or None
    return None


def _unravel(name, vector, params):
    '''Split a flat interim moment into the params tree's leaves, in
    ravel_pytree's order (the sorted flax paths).'''
    order = sorted(params, key=lambda k: tuple(k.split('/')))
    sizes = [params[k].size for k in order]
    if vector.shape != (sum(sizes),):
        raise ValueError(f'flat opt_state {name!r} has shape {vector.shape}, '
                         f'the params hold {sum(sizes)} values')
    out, start = {}, 0
    for key, size in zip(order, sizes):
        out[f'{name}/{key}'] = vector[start:start + size].reshape(
            params[key].shape)
        start += size
    return out


def read_checkpoint(path, opt_state=True):
    '''The checkpoint at ``path`` as a flat dict of numpy arrays; the
    optimizer's entries only with ``opt_state``.'''
    path = os.path.abspath(path)
    if not os.path.isfile(os.path.join(path, COMMIT_METADATA)):
        raise ValueError(f'{path}: no {COMMIT_METADATA}, the Orbax save never '
                         'committed')
    leaves = _leaves(path)
    store = ocdbt.OcdbtStore(path)
    flat, counts, flat_moments, owner = {}, {}, {}, {}
    for keys, types, value in leaves:
        if value.get('value_type') not in _ARRAY_TYPES:
            if value.get('skip_deserialize') and \
                    value.get('value_type') in ('Dict', 'List', 'None'):
                continue  # an empty node, such as unet.yaml's batch_stats
            raise ValueError(f'{path}: leaf {keys} of type '
                             f'{value.get("value_type")!r} cannot be placed')
        top = keys[0]
        if top in ('params', 'batch_stats') and len(keys) > 1:
            flat['/'.join(keys)] = zarr.read_array(store, '.'.join(keys))
        elif keys == ['step']:
            flat['step'] = zarr.read_array(store, 'step')
        elif top == 'opt_state':
            placed = _place_opt(keys, types)
            if placed is None:
                raise ValueError(f'{path}: opt_state leaf {keys} cannot be '
                                 'placed')
            position, field, flax_path = placed
            if field != 'count' and owner.setdefault(field, position) != \
                    position:
                raise ValueError(
                    f'{path}: optax name {field!r} appears twice in the '
                    f'chain (at {owner[field]} and {position})')
            if not opt_state:
                continue
            arr = zarr.read_array(store, '.'.join(keys))
            if field == 'count':
                counts['.'.join(keys)] = arr
            elif flax_path is None:
                flat_moments[field] = arr
            else:
                flat[f'{field}/params/{flax_path}'] = arr
        else:
            raise ValueError(f'{path}: leaf {keys} cannot be placed')
    if counts:
        values = {int(v) for v in counts.values()}
        if len(values) != 1:
            raise ValueError(f'{path}: the chain\'s counts disagree: {counts}')
        flat['count'] = next(iter(counts.values()))
    if flat_moments:
        params = {k[len('params/'):]: v for k, v in flat.items()
                  if k.startswith('params/')}
        for field, vector in flat_moments.items():
            unravelled = _unravel(f'{field}/params', vector, params)
            flat.update(unravelled)
    return flat


# -- the writer ---------------------------------------------------------------

def _subtree(flat, prefix):
    '''{path tuple: array} of the keys of ``flat`` under ``prefix/``.'''
    n = len(prefix) + 1
    return {tuple(k[n:].split('/')): v for k, v in flat.items()
            if k.startswith(prefix + '/')}


def _tree_leaves(flat, chain):
    '''[(keys, key types, array or the value_type of an empty node)] of the
    JAX engine's state, in its flatten order; every key of ``flat`` placed
    once.'''
    placed = set()

    def take(prefix):
        tree = _subtree(flat, prefix)
        placed.update(f'{prefix}/' + '/'.join(p) for p in tree)
        return tree

    params = take('params')
    if not params:
        raise ValueError('a checkpoint to write needs params/...')
    leaves = []
    stats = take('batch_stats')
    if not stats:
        leaves.append((('batch_stats',), (_DICT_KEY,), 'Dict'))
    for path in sorted(stats):
        leaves.append((('batch_stats',) + path, (_DICT_KEY,) * (
            1 + len(path)), stats[path]))
    count = flat.get('count', flat.get('step'))
    placed.update(('count', 'step'))
    for i, fields in enumerate(chain):
        head = ('opt_state', str(i))
        types = (_DICT_KEY, _SEQUENCE_KEY)
        if not fields:
            leaves.append((head, types, 'None'))
        for field in fields:
            if field == 'count':
                leaves.append((head + ('count',), types + (_DICT_KEY,),
                               np.asarray(count, np.int32)))
                continue
            moment = take(f'{field}/params')
            if sorted(moment) != sorted(params):
                raise ValueError(
                    f'moment {field!r} holds {len(moment)} of the '
                    f'{len(params)} parameters (missing: '
                    f'{sorted(set(params) - set(moment))[:3]})')
            for path in sorted(moment):
                leaves.append((head + (field,) + path, types + (
                    _DICT_KEY,) * (1 + len(path)), moment[path]))
    for path in sorted(params):
        leaves.append((('params',) + path, (_DICT_KEY,) * (1 + len(path)),
                       params[path]))
    leaves.append((('step',), (_DICT_KEY,), np.asarray(flat['step'],
                                                        np.int32)))
    unplaced = sorted(set(flat) - placed)
    if unplaced:
        raise ValueError(f'{unplaced[0]!r} has no place in the optimizer '
                         f'chain {chain}')
    return leaves


def write_checkpoint(path, flat, chain):
    '''Write ``flat`` (read_checkpoint's form, with ``step``) as the JAX
    engine's Orbax checkpoint ``path``, its optimizer's state in the optax
    chain ``chain``; replaces a checkpoint already at ``path``. Returns the
    bytes written.'''
    path = os.path.abspath(path)
    started = time.time_ns()
    leaves = _tree_leaves(flat, chain)
    tmp = path + TMP_SUFFIX
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        os.makedirs(tmp)
        store, tree = {}, {}
        for keys, types, value in leaves:
            entry = {'key_metadata': [{'key': k, 'key_type': t}
                                      for k, t in zip(keys, types)]}
            if isinstance(value, str):
                entry['value_metadata'] = {'value_type': value,
                                           'skip_deserialize': True}
            else:
                zarr.write_array(store, '.'.join(keys), value)
                entry['value_metadata'] = {
                    'value_type': 'jax.Array', 'skip_deserialize': False,
                    'write_shape': list(np.shape(value))}
            tree[str(keys)] = entry
        written = ocdbt.write_store(tmp, store)
        for name, content in (
                (METADATA, {'tree_metadata': tree, 'use_ocdbt': True,
                            'use_zarr3': False,
                            'store_array_data_equal_to_fill_value': True,
                            'custom_metadata': None}),
                (COMMIT_METADATA, {'item_handlers': HANDLER, 'metrics': {},
                                   'performance_metrics': {},
                                   'init_timestamp_nsecs': started,
                                   'commit_timestamp_nsecs': time.time_ns(),
                                   'custom_metadata': {}})):
            with open(os.path.join(tmp, name), 'w') as fh:
                written += fh.write(json.dumps(content))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return written

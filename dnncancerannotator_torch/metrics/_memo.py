'''Weakref-identity memo for per-batch metric computations (counterpart of
dnncancerannotator_tpu.metrics._memo; torch tensors and numpy arrays are
both weakref-able).

A metric suite routinely holds many instances with identical parameters
(configs/additionals/metrics.yaml: 9 region + 6 pixel metrics; the
Visualizer PR-curve suites likewise), and callers feed every instance the
same batch arrays. Entries are keyed by (params, identity of the input
arrays) and held via weakrefs, so they die with their batch and a reused
object id can never produce a stale hit (the ref is compared against the
live object, not its id).
'''

import weakref


def lookup(cache, key, arrays):
    '''Return the memoized value for (key, arrays) or None; prunes dead
    entries in place.'''
    alive = []
    hit = None
    for ent in cache:
        objs = [r() for r in ent[0]]
        if any(o is None for o in objs):
            continue
        alive.append(ent)
        if ent[1] == key and len(objs) == len(arrays) and \
                all(o is a for o, a in zip(objs, arrays)):
            hit = ent[2]
    del cache[:]
    cache.extend(alive)
    return hit


def store(cache, key, arrays, value, limit=8):
    '''Memoize value for (key, arrays); silently skips non-weakref-able
    inputs (plain lists, scalars).'''
    try:
        refs = tuple(weakref.ref(a) for a in arrays)
    except TypeError:
        return
    cache.append((refs, key, value))
    del cache[:-limit]

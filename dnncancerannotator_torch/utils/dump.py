'''Dump run options and training results (counterpart of
dnncancerannotator_tpu.utils.dump).

- ``dump_options`` never overwrites: while the target exists, an underscore
  is appended to the file's stem (``x.yaml`` -> ``x_.yaml`` -> ...).
- ``dump_train_results`` writes {epoch, history, params, model} as pickle or
  yaml.

PyYAML is imported only when YAML is written.
'''

import json
import pathlib
import pickle


def _yaml_dump(obj, fh):
    import yaml
    yaml.safe_dump(obj, fh, default_flow_style=False)


_WRITERS = {
    'json': ('w', json.dump),
    'yaml': ('w', _yaml_dump),
    'pickle': ('wb', pickle.dump),
}


def _free_path(path):
    '''First non-existing variant of ``path``, growing the stem by "_".'''
    p = pathlib.Path(path)
    stem = p.stem
    while p.exists():
        stem += '_'
        p = p.with_name(stem + p.suffix)
    return p


def _write(obj, path, fmt):
    if fmt not in _WRITERS:
        raise NotImplementedError(f'Unimplemented format {fmt}')
    mode, writer = _WRITERS[fmt]
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, mode) as fh:
        writer(obj, fh)


def dump_options(path, avoid_overwrite=False, **options):
    '''Dump run options in the format of the file's extension, renaming on
    collision (``avoid_overwrite`` is kept for API parity: a collision is
    always renamed); returns the path written.'''
    del avoid_overwrite
    target = _free_path(path)
    _write(options, target, target.suffix.lstrip('.'))
    return str(target)


def dump_train_results(path, train_results, format_='pickle'):
    '''Dump training results ({epoch, history, params, model}) as pickle or
    yaml (``format_``, not the extension).'''
    fmt = format_.lower()
    if fmt not in ('pickle', 'yaml'):
        raise NotImplementedError(f'Unimplemented format {fmt}')
    content = dict(
        epoch=list(train_results.epoch),
        history={name: list(map(float, series))
                 for name, series in train_results.history.items()},
        params=train_results.params,
        model=train_results.model_name,
    )
    _write(content, pathlib.Path(path), fmt)

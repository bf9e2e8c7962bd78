'''Config loading / stacking (counterpart of dnncancerannotator_tpu.utils.config).

``load_config`` accepts a single path or a list: the first file is the base
config, later files overlay it, and overlay keys may be dotted
(``a.b.c: v`` creates/updates nested dicts). Formats are selected by
extension: yaml / json / pickle.

PyYAML is imported only when a YAML file that is not plain JSON is read.
JSON is a subset of YAML, so an ``options.yaml`` written as JSON (as the
port's own tools write it) reads without PyYAML.
'''

import json
import os
import pickle


def _load_yaml(fh):
    text = fh.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        import yaml
        return yaml.safe_load(text)


_LOADERS = {
    'json': ('r', json.load),
    'yaml': ('r', _load_yaml),
    'pickle': ('rb', pickle.load),
}


def load_config(path):
    '''Load one or more config files, overlaying later files onto the first.

    Args:
        path: a single config path or a list of paths. With a list, the
            first entry is the base config and every following file is
            merged on top (dotted keys supported).

    Returns:
        The stacked config (typically a dict).
    '''
    paths = [path] if isinstance(path, str) else list(path)
    if not paths:
        raise ValueError('need at least one config file')
    config = _read_one(paths[0])
    for overlay_path in paths[1:]:
        config = apply_config(config, _read_one(overlay_path))
    return config


def apply_config(base_config, add_config):
    '''Merge ``add_config`` into ``base_config``, expanding dotted keys.

    ``{'a.b.c': v}`` walks (and creates) the nested dicts ``a`` then ``b``
    and sets ``c``; sibling keys under ``a``/``b`` are preserved.
    '''
    for dotted, value in add_config.items():
        node = base_config
        *parents, leaf = dotted.split('.')
        for segment in parents:
            node = node.setdefault(segment, {})
        node[leaf] = value
    return base_config


def _read_one(path):
    ext = os.path.splitext(path)[1].lstrip('.')
    if ext not in _LOADERS:
        raise NotImplementedError(f'Unexpected extension {ext}')
    mode, loader = _LOADERS[ext]
    with open(path, mode) as fh:
        return loader(fh)

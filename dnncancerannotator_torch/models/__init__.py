'''Model registry (counterpart of dnncancerannotator_tpu.models).'''

from .multiresunet import MultiResUnet
from .unet import MulmoUNetAnnotator, UNet, UNetAnnotator
from . import blocks, fastconv  # noqa: F401

_REGISTRY = {
    'UNetAnnotator': UNetAnnotator,
    'MulmoUNetAnnotator': MulmoUNetAnnotator,
    'MultiResUnet': MultiResUnet,
}


def get_model(name):
    '''Resolve a model class by its config name.'''
    if name not in _REGISTRY:
        raise KeyError(
            f'Unknown model {name!r}. Available: {sorted(_REGISTRY)}')
    return _REGISTRY[name]


def build_model(name, model_options, in_channels, generator=None,
                dtype=None):
    '''Instantiate a model from config options for ``in_channels`` input
    channels; returns (model, kernel_regularizer spec) like the JAX
    registry (the regularizer only matters to training). ``dtype`` (the
    engine's compute dtype) is a default for the model's ``dtype`` option,
    as in the JAX registry (models/__init__.py:26-37).'''
    options = dict(model_options or {})
    regularizer = options.pop('kernel_regularizer', None)
    if dtype is not None:
        options.setdefault('dtype', dtype)
    model = get_model(name)(in_channels=in_channels, generator=generator,
                            **options)
    return model, regularizer

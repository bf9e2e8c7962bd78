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


def build_model(name, model_options, in_channels, generator=None):
    '''Instantiate a model from config options for ``in_channels`` input
    channels; returns (model, kernel_regularizer spec) like the JAX
    registry (the regularizer only matters to training).'''
    options = dict(model_options or {})
    regularizer = options.pop('kernel_regularizer', None)
    model = get_model(name)(in_channels=in_channels, generator=generator,
                            **options)
    return model, regularizer

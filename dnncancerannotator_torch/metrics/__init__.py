'''Metric registry (counterpart of dnncancerannotator_tpu.metrics).

``solve_metric`` resolves a metric spec from the config, either a plain
class name or a one-item dict ``{ClassName: {options...}}``, to an
instance.
'''

from .pixel import (
    AUC, FalseNegatives, FalsePositives, FBetaScore, Precision, Recall,
    TrueNegatives, TruePositives,
)
from .region import (
    RegionBasedConfusionMatrix, RegionBasedFalseNegatives,
    RegionBasedFalsePositives, RegionBasedFBetaScore, RegionBasedPrecision,
    RegionBasedRecall, RegionBasedTruePositives, region_confusion_batch,
)

_REGISTRY = {
    'Precision': Precision,
    'Recall': Recall,
    'AUC': AUC,
    'TruePositives': TruePositives,
    'FalsePositives': FalsePositives,
    'TrueNegatives': TrueNegatives,
    'FalseNegatives': FalseNegatives,
    'FBetaScore': FBetaScore,
    'RegionBasedPrecision': RegionBasedPrecision,
    'RegionBasedRecall': RegionBasedRecall,
    'RegionBasedTruePositives': RegionBasedTruePositives,
    'RegionBasedFalsePositives': RegionBasedFalsePositives,
    'RegionBasedFalseNegatives': RegionBasedFalseNegatives,
    'RegionBasedFBetaScore': RegionBasedFBetaScore,
    'RegionBasedConfusionMatrix': RegionBasedConfusionMatrix,
}


def solve_metric(metric_spec):
    '''Resolve a metric spec (str or {name: options}) to an instance.'''
    if isinstance(metric_spec, str):
        name, options = metric_spec, {}
    elif isinstance(metric_spec, dict) and len(metric_spec) == 1:
        name, options = next(iter(metric_spec.items()))
        options = options or {}
    else:
        raise ValueError(f'Bad metric spec: {metric_spec!r}')
    if name not in _REGISTRY:
        raise KeyError(f'Unknown metric {name!r}. Available: '
                       f'{sorted(_REGISTRY)}')
    return _REGISTRY[name](**options)

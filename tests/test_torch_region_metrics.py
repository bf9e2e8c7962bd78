'''The region-metric behavioural spec (tests/test_region_metrics.py, 68
cases over four classes, plus its two capacity-overflow cases) run against
the port's metrics: each class below subclasses the spec's and points the
spec module's ``custom_metrics`` at ``dnncancerannotator_torch.metrics``
for the duration of each test. The spec's assertions are exact counts.
'''

from dnncancerannotator_torch import metrics as port_metrics
from tests import test_region_metrics as spec


class _PortMetrics:
    def setUp(self):
        self.addCleanup(setattr, spec, 'custom_metrics', spec.custom_metrics)
        spec.custom_metrics = port_metrics
        super().setUp()


class TestTorchRegionMetricsSingleThreshold(
        _PortMetrics, spec.TestRegionMetricsSingleThreshold):
    pass


class TestTorchRegionMetricsMultiThreshold(
        _PortMetrics, spec.TestRegionMetricsMultiThreshold):
    pass


class TestTorchRegionMetricsSingleThresholdShrinked(
        _PortMetrics, spec.TestRegionMetricsSingleThresholdShrinked):
    pass


class TestTorchRegionMetricsMultiThresholdShrinked(
        _PortMetrics, spec.TestRegionMetricsMultiThresholdShrinked):
    pass


class TestTorchRegionCapacityOverflow(
        _PortMetrics, spec.TestRegionCapacityOverflow):
    pass

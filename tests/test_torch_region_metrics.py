'''The region-metric behavioural spec (tests/test_region_metrics.py, 68
cases over four classes, plus its two capacity-overflow cases) run against
the port's metrics: each class below subclasses the spec's and points the
spec module's ``custom_metrics`` at ``dnncancerannotator_torch.metrics``
for the duration of each test. The spec's assertions are exact counts.

The module runs torch on one thread: its calls are many small ops, which
torch's thread pool slows down many times over when the test run's other
workers hold the cores (the file took 734 s of a worker in a 6-worker
run with the default threads, against 23-60 s alone). The counts are
exact at any thread count.
'''

import pytest
import torch

from dnncancerannotator_torch import metrics as port_metrics
from tests import test_region_metrics as spec


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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

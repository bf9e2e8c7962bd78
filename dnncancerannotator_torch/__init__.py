'''DNNCancerAnnotator on PyTorch and CUDA: the port of the JAX package
``dnncancerannotator_tpu`` (which stays the reference) to an NVIDIA H100.

This slice runs the prediction path: config stacking, the .tfrecords
eval pipeline, the UNetAnnotator forward with hand-written CUDA kernels
(csrc/, bound by ops/kernels) and the ``predict`` CLI. Module names mirror
the JAX package's. The package imports ``torch`` and never ``jax``.
'''

__version__ = '0.1.0'

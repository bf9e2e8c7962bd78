'''DNNCancerAnnotator on PyTorch and CUDA: the port of the JAX package
``dnncancerannotator_tpu`` (which stays the reference) to an NVIDIA H100.

It runs the training and prediction paths of unet.yaml: config stacking,
the .tfrecords pipelines, the augmentation chain with the banked
thin-plate warp, the UNetAnnotator forward and backward, the loss, Adam,
checkpoints, and the ``train`` and ``predict`` CLI, with hand-written CUDA
kernels (csrc/, bound by ops/kernels) for every kernel of those paths.
Module names mirror the JAX package's. The package imports ``torch`` and
never ``jax``.
'''

__version__ = '0.1.0'

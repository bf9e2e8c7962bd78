from . import kernels, pooling  # noqa: F401

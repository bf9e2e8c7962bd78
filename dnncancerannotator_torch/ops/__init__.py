'''Operations of the port: the kernels' wrappers (``ops.kernels``), their
autograd functions and the plain image, warp, pooling, morphology,
component and raster operations. Each submodule is imported where it is
used: ``ops.raster`` imports no torch, so the extractor's pool workers
start without it.'''

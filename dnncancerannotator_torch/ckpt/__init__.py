'''Reading the JAX package's Orbax checkpoints without orbax, tensorstore or
a zstd module: ``zstd`` (the host library's decoder), ``ocdbt`` (the
key-value store), ``zarr`` (its arrays) and ``orbax`` (the checkpoint as the
port's flat dicts). Engine.load dispatches to ``orbax.read_checkpoint`` for
a directory that holds ``_METADATA`` and ``manifest.ocdbt``.'''

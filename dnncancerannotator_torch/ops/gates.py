'''Kernel gates: which optional kernels a model routes to (counterpart of
dnncancerannotator_tpu.ops.gates).

- ``KernelGates`` is an immutable per-Engine gate set built from
  ``deploy_options``; a field left ``None`` takes the default.
- The Engine enters ``active(gates)`` around its model's forward, so two
  Engines with different gates coexist in one process. The routing is
  decided in the forward; the backward runs the kernel the forward chose
  (autograd may run it on another thread, outside the scope).
- ``DNNCA_*`` environment variables override: a set one beats the scope and
  the default, an unset or empty one is not read.

The defaults are the JAX package's: the NHWC pool and transposed-conv
kernels off, the fused crop + warp off, the warp bank on. The JAX package's
TPU-only machinery (the interpret switch, the SPMD wrappers, the force-off
scope for export) has no counterpart here.
'''

import contextlib
import contextvars
import dataclasses
import os
from typing import Optional

_DEFAULTS = {
    'pallas_pool': False,
    'pallas_tconv': False,
    'fused_aug': False,
    'warp_bank': True,
}

_ENV = {
    'pallas_pool': 'DNNCA_PPOOL',
    'pallas_tconv': 'DNNCA_PTCONV',
    'fused_aug': 'DNNCA_FUSEDAUG',
    'warp_bank': 'DNNCA_WARPBANK',
}


@dataclasses.dataclass(frozen=True)
class KernelGates:
    '''Per-Engine kernel gate set; ``None`` fields take the default.'''
    pallas_pool: Optional[bool] = None
    pallas_tconv: Optional[bool] = None
    fused_aug: Optional[bool] = None
    warp_bank: Optional[bool] = None

    @classmethod
    def from_deploy_options(cls, deploy):
        '''The gate keys of a deploy_options dict (which is not changed).'''
        return cls(**{f.name: deploy.get(f.name)
                      for f in dataclasses.fields(cls)})


_active = contextvars.ContextVar('dnnca_torch_kernel_gates', default=None)


@contextlib.contextmanager
def active(gates):
    '''Make ``gates`` the gate set read within the block.'''
    token = _active.set(gates)
    try:
        yield
    finally:
        _active.reset(token)


def enabled(name):
    '''Resolve one gate: env override > active scope > default.'''
    env = os.environ.get(_ENV[name])
    if env:
        return env not in ('0', 'false', 'False')
    gates = _active.get()
    if gates is not None:
        value = getattr(gates, name)
        if value is not None:
            return bool(value)
    return _DEFAULTS[name]

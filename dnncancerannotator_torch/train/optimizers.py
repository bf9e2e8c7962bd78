'''Optimizer resolution from Keras-style config specs (counterpart of
dnncancerannotator_tpu.train.optimizers).

A spec is a name (any case) or ``{'class_name': ..., 'config': {...}}`` with
Keras argument names. Only optimizers whose ``torch.optim`` class computes
the same update as the JAX package's optax transform are ported:

- ``adam``: ``torch.optim.Adam`` with eps 1e-7 by default, the Keras value
  the JAX package uses (torch's default is 1e-8); eps sits outside the
  square root in both;
- ``adamw``: ``torch.optim.AdamW``, weight decay 4e-3 by default (optax
  adds ``wd * param`` to the Adam update; torch decays the parameter by
  ``lr * wd`` first, the same step);
- ``sgd``: ``torch.optim.SGD`` with optional momentum and nesterov.

The others of the JAX registry (rmsprop puts eps inside the square root in
optax, adamax, nadam, adagrad, adadelta, lamb, lion) raise.

The learning rate is the engine's schedule: the engine sets it before every
step. Without a schedule it is the config's ``learning_rate`` or the Keras
default, as a constant schedule.
'''

import torch

from . import schedules as schedules_lib

_DEFAULT_LR = {'adam': 1e-3, 'adamw': 1e-3, 'sgd': 1e-2}
_NOT_PORTED = ('adamax', 'nadam', 'rmsprop', 'adagrad', 'adadelta', 'lamb',
               'lion')


def _adam(params, lr, cfg):
    return torch.optim.Adam(params, lr=lr, betas=(cfg.get('beta_1', 0.9),
                                                  cfg.get('beta_2', 0.999)),
                            eps=cfg.get('epsilon', 1e-7))


def _adamw(params, lr, cfg):
    return torch.optim.AdamW(params, lr=lr, betas=(cfg.get('beta_1', 0.9),
                                                   cfg.get('beta_2', 0.999)),
                             eps=cfg.get('epsilon', 1e-7),
                             weight_decay=cfg.get('weight_decay', 4e-3))


def _sgd(params, lr, cfg):
    return torch.optim.SGD(params, lr=lr, momentum=cfg.get('momentum', 0.0),
                           nesterov=cfg.get('nesterov', False))


_REGISTRY = {'adam': _adam, 'adamw': _adamw, 'sgd': _sgd}


def solve_optimizer(spec, params, schedule=None):
    '''Resolve an optimizer spec into ``(torch optimizer, lr schedule)``
    over ``params``.'''
    if isinstance(spec, str):
        name, cfg = spec, {}
    elif isinstance(spec, dict):
        name = spec.get('class_name') or spec.get('name')
        if not name:
            raise ValueError(f'optimizer dict spec needs class_name: {spec!r}')
        cfg = dict(spec.get('config') or {})
    else:
        raise ValueError(f'Cannot resolve optimizer spec: {spec!r}')
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f'optimizer {name!r} is not ported: torch.optim does not compute '
            f'the same update as the JAX package; ported: {sorted(_REGISTRY)}')
    if key not in _REGISTRY:
        raise ValueError(f'Unknown optimizer {name!r}; available: '
                         f'{sorted(_REGISTRY)}')
    if schedule is None:
        schedule = schedules_lib.constant(float(
            cfg.get('learning_rate', cfg.get('lr', _DEFAULT_LR[key]))))
    return _REGISTRY[key](params, schedule(0), cfg), schedule

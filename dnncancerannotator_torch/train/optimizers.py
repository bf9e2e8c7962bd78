'''Optimizer resolution from Keras-style config specs (counterpart of
dnncancerannotator_tpu.train.optimizers).

A spec is a name (any case) or ``{'class_name': ..., 'config': {...}}`` with
Keras argument names and the JAX package's defaults. Each optimizer
computes the update of the JAX engine's ``optax.flatten(<optax
transform>)``, which runs over all parameters as one vector:

- ``adam``: ``torch.optim.Adam`` with eps 1e-7 by default, the Keras value
  the JAX package uses (torch's default is 1e-8); eps sits outside the
  square root in both;
- ``adamw``: ``torch.optim.AdamW``, weight decay 4e-3 by default (optax
  adds ``wd * param`` to the Adam update; torch decays the parameter by
  ``lr * wd`` first, the same step);
- ``sgd``: ``torch.optim.SGD`` with optional momentum and nesterov;
- ``adamax`` and ``adadelta``: ``torch.optim.Adamax`` and
  ``torch.optim.Adadelta``, which compute optax's updates;
- ``nadam``, ``rmsprop``, ``adagrad``, ``lamb`` and ``lion`` are written
  here in tensor ops, because torch's classes compute other updates:
  optax's nadam is Adam with a Nesterov term and no momentum-decay
  schedule; its rmsprop puts eps inside the square root and keeps a
  ``trace`` of the scaled update (momentum 0 by default); its adagrad
  starts the sum of squares at 0.1 and takes ``rsqrt(sum + eps)``; lamb's
  trust ratio is one ratio over all parameters as one vector (the flatten);
  torch has no lion.

Each optimizer's per-parameter state has optax's names (``state_names``)
and ``step``, the update count. A checkpoint holds them as the JAX engine's
``opt_state``: the optax chain of that optimizer (``chain``), whose states
hold the moments and each its own ``count``. The learning rate is the engine's schedule: the engine sets
it before every step. Without a schedule it is the config's
``learning_rate`` or the Keras default, as a constant schedule.
'''

import numpy as np
import torch

from . import schedules as schedules_lib

_DEFAULT_LR = {
    'adam': 1e-3, 'adamw': 1e-3, 'adamax': 1e-3, 'nadam': 1e-3,
    'rmsprop': 1e-3, 'adagrad': 1e-3, 'adadelta': 1e-3,
    'sgd': 1e-2, 'lamb': 1e-3, 'lion': 1e-4,
}


def _bias(decay, count):
    '''``1 - decay ** count`` in f32, as optax's bias correction computes
    it (0.999 is 0.99900001 in f32, so this is 1.3e-5 from 0.001 at step
    1; torch's Adam classes compute it in f64).'''
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class _Optax(torch.optim.Optimizer):
    '''Base of the optimizers written here: the state of each parameter is
    ``step`` and the tensors named in ``STATE`` (optax's names), made on
    its first step with the values of ``INITIAL`` (else 0). A subclass's
    ``_update`` returns the update before the learning rate, which the
    step subtracts times ``lr``.'''

    STATE = ()
    INITIAL = {}

    def __init__(self, params, lr, **hyper):
        super().__init__(params, dict(lr=lr, **hyper))

    def _states(self, params):
        states = []
        for p in params:
            state = self.state[p]
            if not state:
                state['step'] = torch.tensor(0.0)
                for name in self.STATE:
                    state[name] = torch.full_like(
                        p, self.INITIAL.get(name, 0.0),
                        memory_format=torch.preserve_format)
            state['step'] += 1
            states.append(state)
        return states

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group['params'] if p.grad is not None]
            if params:
                self._group_step(group, params, self._states(params))
        return loss

    def _group_step(self, group, params, states):
        for p, state in zip(params, states):
            p.add_(self._update(group, p, p.grad, state), alpha=-group['lr'])


class NAdam(_Optax):
    '''``optax.nadam``: ``scale_by_adam(nesterov=True)``.'''

    STATE = ('mu', 'nu')

    def _update(self, group, p, g, state):
        b1, b2, eps = group['b1'], group['b2'], group['eps']
        t = float(state['step'])
        mu, nu = state['mu'], state['nu']
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        mu_hat = b1 * (mu / _bias(b1, t + 1)) + (1 - b1) * (g / _bias(b1, t))
        return mu_hat / ((nu / _bias(b2, t)).sqrt() + eps)


class RMSprop(_Optax):
    '''``optax.rmsprop``: eps inside the square root, optionally centered;
    then the learning rate, then ``trace(momentum)`` of the scaled update
    (a trace of decay 0 when momentum is 0, as the JAX package builds it).'''

    STATE = ('nu', 'trace')

    def __init__(self, params, lr, centered=False, **hyper):
        self.STATE = ('mu', 'nu', 'trace') if centered else ('nu', 'trace')
        super().__init__(params, lr, centered=centered, **hyper)

    def _group_step(self, group, params, states):
        decay, eps = group['decay'], group['eps']
        for p, state in zip(params, states):
            g, nu = p.grad, state['nu']
            nu.mul_(decay).addcmul_(g, g, value=1 - decay)
            if group['centered']:
                mu = state['mu']
                mu.mul_(decay).add_(g, alpha=1 - decay)
                scale = torch.rsqrt(nu - mu * mu + eps)
            else:
                scale = torch.rsqrt(nu + eps)
            trace = state['trace']
            trace.mul_(group['momentum']).add_(scale * g, alpha=-group['lr'])
            p.add_(trace)


class Adagrad(_Optax):
    '''``optax.adagrad``: the sum of squares starts at
    ``initial_accumulator_value``; the update is ``g * rsqrt(sum + eps)``
    where the sum is positive, else 0.'''

    STATE = ('sum_of_squares',)

    def __init__(self, params, lr, initial_accumulator_value=0.1, **hyper):
        self.INITIAL = {'sum_of_squares': initial_accumulator_value}
        super().__init__(params, lr, **hyper)

    def _update(self, group, p, g, state):
        total = state['sum_of_squares']
        total.addcmul_(g, g)
        scale = torch.where(total > 0, torch.rsqrt(total + group['eps']),
                            torch.zeros_like(total))
        return scale * g


class Lamb(_Optax):
    '''``optax.lamb`` under ``optax.flatten``: the Adam update plus
    ``weight_decay * param``, scaled by one trust ratio, |params| / |update|
    over all parameters as one vector (1 where either norm is 0).'''

    STATE = ('mu', 'nu')

    def _group_step(self, group, params, states):
        b1, b2, eps = group['b1'], group['b2'], group['eps']
        updates = []
        for p, state in zip(params, states):
            g, mu, nu = p.grad, state['mu'], state['nu']
            t = float(state['step'])
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            update = (mu / _bias(b1, t)) / ((nu / _bias(b2, t)).sqrt() + eps)
            updates.append(update.add_(p, alpha=group['weight_decay']))
        p_norm = torch.stack([p.norm() for p in params]).norm()
        u_norm = torch.stack([u.norm() for u in updates]).norm()
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        for p, update in zip(params, updates):
            p.add_(update * ratio, alpha=-group['lr'])


class Lion(_Optax):
    '''``optax.lion``: ``sign((1 - b1) g + b1 mu)`` plus ``weight_decay *
    param``; then ``mu = (1 - b2) g + b2 mu``.'''

    STATE = ('mu',)

    def _update(self, group, p, g, state):
        b1, b2, mu = group['b1'], group['b2'], state['mu']
        update = torch.sign((1 - b1) * g + b1 * mu)
        mu.mul_(b2).add_(g, alpha=1 - b2)
        return update.add_(p, alpha=group['weight_decay'])


def _adam(params, lr, cfg):
    return torch.optim.Adam(params, lr=lr, betas=(cfg.get('beta_1', 0.9),
                                                  cfg.get('beta_2', 0.999)),
                            eps=cfg.get('epsilon', 1e-7))


def _adamw(params, lr, cfg):
    return torch.optim.AdamW(params, lr=lr, betas=(cfg.get('beta_1', 0.9),
                                                   cfg.get('beta_2', 0.999)),
                             eps=cfg.get('epsilon', 1e-7),
                             weight_decay=cfg.get('weight_decay', 4e-3))


def _adamax(params, lr, cfg):
    return torch.optim.Adamax(params, lr=lr,
                              betas=(cfg.get('beta_1', 0.9),
                                     cfg.get('beta_2', 0.999)),
                              eps=cfg.get('epsilon', 1e-7))


def _nadam(params, lr, cfg):
    return NAdam(params, lr, b1=cfg.get('beta_1', 0.9),
                 b2=cfg.get('beta_2', 0.999), eps=cfg.get('epsilon', 1e-7))


def _sgd(params, lr, cfg):
    return torch.optim.SGD(params, lr=lr, momentum=cfg.get('momentum', 0.0),
                           nesterov=cfg.get('nesterov', False))


def _rmsprop(params, lr, cfg):
    return RMSprop(params, lr, decay=cfg.get('rho', 0.9),
                   eps=cfg.get('epsilon', 1e-7),
                   momentum=cfg.get('momentum', 0.0),
                   centered=cfg.get('centered', False))


def _adagrad(params, lr, cfg):
    return Adagrad(params, lr, initial_accumulator_value=cfg.get(
        'initial_accumulator_value', 0.1), eps=cfg.get('epsilon', 1e-7))


def _adadelta(params, lr, cfg):
    return torch.optim.Adadelta(params, lr=lr, rho=cfg.get('rho', 0.95),
                                eps=cfg.get('epsilon', 1e-7))


def _lamb(params, lr, cfg):
    return Lamb(params, lr, b1=cfg.get('beta_1', 0.9),
                b2=cfg.get('beta_2', 0.999), eps=cfg.get('epsilon', 1e-6),
                weight_decay=cfg.get('weight_decay', 0.0))


def _lion(params, lr, cfg):
    return Lion(params, lr, b1=cfg.get('beta_1', 0.9),
                b2=cfg.get('beta_2', 0.99),
                weight_decay=cfg.get('weight_decay', 0.0))


_REGISTRY = {
    'adam': _adam, 'adamw': _adamw, 'adamax': _adamax, 'nadam': _nadam,
    'sgd': _sgd, 'rmsprop': _rmsprop, 'adagrad': _adagrad,
    'adadelta': _adadelta, 'lamb': _lamb, 'lion': _lion,
}

# the torch classes' state keys -> optax's names
_TORCH_STATE = {
    torch.optim.Adam: {'exp_avg': 'mu', 'exp_avg_sq': 'nu'},
    torch.optim.AdamW: {'exp_avg': 'mu', 'exp_avg_sq': 'nu'},
    torch.optim.SGD: {'momentum_buffer': 'trace'},
    torch.optim.Adamax: {'exp_avg': 'mu', 'exp_inf': 'nu'},
    torch.optim.Adadelta: {'square_avg': 'e_g', 'acc_delta': 'e_x'},
}


def state_names(optimizer):
    '''{state key of ``optimizer``: optax's name of that state}.'''
    if isinstance(optimizer, _Optax):
        return {name: name for name in optimizer.STATE}
    return _TORCH_STATE[type(optimizer)]


# the optax chain of each optimizer as the JAX package builds it
# (optax.flatten of its registry's transform, the learning rate a schedule,
# so the chain ends in scale_by_schedule's count): one tuple of field names
# per state, () for an empty state (add_decayed_weights, trust ratio,
# identity); the entries of sgd and rmsprop depend on the first param group
_CHAINS = {
    torch.optim.Adam: (('count', 'mu', 'nu'), ('count',)),
    torch.optim.AdamW: (('count', 'mu', 'nu'), (), ('count',)),
    torch.optim.Adamax: (('count', 'mu', 'nu'), ('count',)),
    NAdam: (('count', 'mu', 'nu'), ('count',)),
    # trace(momentum), or identity when momentum is 0 (the JAX registry
    # passes None)
    torch.optim.SGD: lambda group: (
        ('trace',) if group['momentum'] else (), ('count',)),
    # scale_by_rms (scale_by_stddev: mu and nu when centered), the
    # schedule, then trace
    RMSprop: lambda group: (
        ('mu', 'nu') if group['centered'] else ('nu',), ('count',),
        ('trace',)),
    Adagrad: (('sum_of_squares',), ('count',)),
    torch.optim.Adadelta: ((), ('e_g', 'e_x'), ('count',)),
    Lamb: (('count', 'mu', 'nu'), (), (), ('count',)),
    Lion: (('count', 'mu'), (), ('count',)),
}


def chain(optimizer):
    '''The optax chain of ``optimizer``'s JAX counterpart (see _CHAINS).'''
    layout = _CHAINS[type(optimizer)]
    return layout(optimizer.param_groups[0]) if callable(layout) else layout


def initial_value(optimizer, key):
    '''The value of state ``key`` before ``optimizer``'s first step.'''
    return getattr(optimizer, 'INITIAL', {}).get(key, 0.0)


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
    if key not in _REGISTRY:
        raise ValueError(f'Unknown optimizer {name!r}; available: '
                         f'{sorted(_REGISTRY)}')
    if schedule is None:
        schedule = schedules_lib.constant(float(
            cfg.get('learning_rate', cfg.get('lr', _DEFAULT_LR[key]))))
    return _REGISTRY[key](params, schedule(0), cfg), schedule

'''Learning-rate schedules (counterpart of
dnncancerannotator_tpu.train.schedules).

The config gives the schedule as a Keras lambda string, e.g.
``"lambda epoch, current_lr: 0.001 * 0.96 ** (epoch // 1000)"``. It is
parsed into a declarative schedule, never ``eval``'ed. Dict specs
``{'kind': ..., ...}`` and constants are accepted too. A schedule maps the
0-based optimizer step to the learning rate of that step.
'''

import re

_NUM = r'[0-9.eE+-]+'
_LAMBDA_HEAD = r'^\s*lambda\s+\w+\s*,\s*\w+\s*:\s*'
_LAMBDA_STEP_RE = re.compile(
    _LAMBDA_HEAD + rf'({_NUM})\s*\*\s*({_NUM})\s*\*\*\s*'
    r'\(\s*\w+\s*//\s*([0-9]+)\s*\)\s*$')
_LAMBDA_EXP_RE = re.compile(
    _LAMBDA_HEAD + rf'({_NUM})\s*\*\s*({_NUM})\s*\*\*\s*\w+\s*$')
_LAMBDA_CONST_RE = re.compile(_LAMBDA_HEAD + rf'({_NUM})\s*$')


def exponential_step_decay(initial, rate, interval):
    '''lr(step) = initial * rate ** (step // interval).'''
    def schedule(step):
        return initial * rate ** (int(step) // interval)
    schedule.spec = dict(kind='exponential_step_decay', initial=initial,
                         rate=rate, interval=interval)
    return schedule


def constant(value):
    def schedule(step):
        del step
        return value
    schedule.spec = dict(kind='constant', value=value)
    return schedule


def solve_schedule(spec):
    '''Resolve an LR schedule spec into ``fn(step) -> lr``: None, a number,
    a dict spec, or the lambda string forms
    ``A * B ** (epoch // C)``, ``A * B ** epoch`` and ``A``.'''
    if spec is None:
        return None
    if isinstance(spec, (int, float)):
        return constant(float(spec))
    if isinstance(spec, dict):
        kind = spec.get('kind', 'exponential_step_decay')
        if kind == 'constant':
            return constant(float(spec['value']))
        if kind == 'exponential_step_decay':
            return exponential_step_decay(
                float(spec['initial']), float(spec['rate']),
                int(spec['interval']))
        raise ValueError(f'Unknown schedule kind {kind!r}')
    if isinstance(spec, str):
        m = _LAMBDA_STEP_RE.match(spec)
        if m:
            return exponential_step_decay(
                float(m.group(1)), float(m.group(2)), int(m.group(3)))
        m = _LAMBDA_EXP_RE.match(spec)
        if m:
            return exponential_step_decay(
                float(m.group(1)), float(m.group(2)), interval=1)
        m = _LAMBDA_CONST_RE.match(spec)
        if m:
            return constant(float(m.group(1)))
        raise ValueError(
            'LR schedule strings are parsed, not eval\'ed; supported forms: '
            '"lambda epoch, current_lr: A * B ** (epoch // C)", '
            '"... : A * B ** epoch", "... : A"; got: ' + repr(spec))
    raise ValueError(f'Cannot resolve schedule spec: {spec!r}')

'''Docstring-driven CLI builder.

The reference builds its CLI automatically from function docstrings via
``dsargparse`` (reference: annotator/runs/__main__.py:21-28). This module
provides the same user-facing behavior without the dependency: each function
parameter becomes a ``--flag``; types are inferred from docstring annotations
like ``name (list[str]): ...`` or from default values; parameters without
defaults are required.
'''

import argparse
import inspect
import re


_ARG_RE = re.compile(r'^(\w+)(?:\s*\(([^)]*)\))?\s*:\s*(.*)$')


def _parse_docstring(doc):
    '''Split a Google-style docstring into (summary, {arg: (type_str, help)}).'''
    if not doc:
        return '', {}
    lines = [line.rstrip() for line in doc.strip().splitlines()]
    summary_lines = []
    args = {}
    in_args = False
    current = None
    arg_indent = None  # indent level of arg-name lines (continuations deeper)
    for line in lines:
        stripped = line.strip()
        if stripped in ('Args:', 'Arguments:'):
            in_args = True
            continue
        if stripped in ('Returns:', 'Raises:', 'Yields:', 'Examples:', 'Example:'):
            in_args = False
            current = None
            continue
        if in_args:
            indent = len(line) - len(line.lstrip())
            m = _ARG_RE.match(stripped)
            if m and (arg_indent is None or indent <= arg_indent):
                arg_indent = indent if arg_indent is None else arg_indent
                current = m.group(1)
                args[current] = (m.group(2), m.group(3))
            elif current is not None and stripped:
                type_str, help_str = args[current]
                args[current] = (type_str, help_str + ' ' + stripped)
        else:
            summary_lines.append(stripped)
    summary = ' '.join(s for s in summary_lines if s).strip()
    return summary, args


def _infer_type(type_str, default):
    '''Return (type_callable, nargs, is_bool) for an argument.'''
    if type_str:
        t = type_str.strip().lower()
        if t.startswith('list') or t.startswith('tuple'):
            inner = 'str'
            m = re.search(r'\[(\w+)\]', t)
            if m:
                inner = m.group(1)
            elem = {'str': str, 'int': int, 'float': float}.get(inner, str)
            return elem, '+', False
        if t == 'int':
            return int, None, False
        if t == 'float':
            return float, None, False
        if t == 'bool':
            return None, None, True
        if t == 'str':
            return str, None, False
    if default is not inspect.Parameter.empty and default is not None:
        if isinstance(default, bool):
            return None, None, True
        if isinstance(default, int):
            return int, None, False
        if isinstance(default, float):
            return float, None, False
        if isinstance(default, (list, tuple)):
            elem = type(default[0]) if len(default) else str
            if elem not in (str, int, float):
                elem = str
            return elem, '+', False
    return str, None, False


def add_command(subparsers, func, name=None):
    '''Register ``func`` as a subcommand whose flags mirror its signature.'''
    name = name or func.__name__
    summary, doc_args = _parse_docstring(func.__doc__)
    parser = subparsers.add_parser(name, help=summary, description=summary)
    sig = inspect.signature(func)
    for pname, param in sig.parameters.items():
        if param.kind in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD):
            continue
        type_str, help_str = doc_args.get(pname, (None, None))
        required = param.default is inspect.Parameter.empty
        default = None if required else param.default
        type_fn, nargs, is_bool = _infer_type(type_str, param.default)
        flag = f'--{pname}'
        if is_bool:
            parser.add_argument(
                flag, action=argparse.BooleanOptionalAction,
                default=bool(default) if default is not None else False, help=help_str)
        else:
            parser.add_argument(
                flag, type=type_fn, nargs=nargs, required=required,
                default=default, help=help_str)
    parser.set_defaults(_func=func, _param_names=list(sig.parameters))
    return parser


def run(parser, argv=None):
    '''Parse args and dispatch to the selected subcommand function.'''
    ns = parser.parse_args(argv)
    func = getattr(ns, '_func', None)
    if func is None:
        parser.print_help()
        return None
    kwargs = {k: getattr(ns, k) for k in ns._param_names if hasattr(ns, k)}
    return func(**kwargs)

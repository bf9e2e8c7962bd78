'''Serving export (counterpart of dnncancerannotator_tpu.runs.export):
package a trained run as a self-contained ``torch.export`` artifact.

The exported program maps raw feature slices (uint8 [B, H, W, C-1], the
label channel excluded, the layout ``predict`` feeds the model) to sigmoid
probability maps float32 [B, H, W, 1], the /255 normalization included.
The trained weights ride in the artifact, so a serving process needs only
``torch``: no model class, no config stack, nothing of this package. The
batch dimension is symbolic unless ``batch_size`` fixes it.

The trace runs inside ``gates.library_only()``: the program holds library
(``aten``) ops alone and no kernel of this package, as the JAX artifact
holds no Pallas kernel, so that it loads on every listed platform with
nothing but the framework. It runs on the CPU: the weights go into the
artifact as host tensors, as the JAX package's go in as ``np.asarray``
constants, the trace computes nothing on a device, and ``load_exported``
moves the program to the device it serves on.

Artifact layout: ``<out>.pt2`` (``torch.export.save``) and ``<out>.yaml``
(input and output spec, model, checkpoint step, platforms, torch version).
'''

import logging
import os

import numpy as np
import torch
import yaml
from torch.export.passes import move_to_device_pass

from .. import engine as engine_lib
from ..ops import gates
from ..utils import config as config_lib

logger = logging.getLogger(__name__)


class _Infer(torch.nn.Module):
    '''uint8 features -> float32 /255 -> model logits -> sigmoid.'''

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, features):
        x = features.to(torch.float32) / 255.0
        return torch.sigmoid(self.model(x, return_logits=True))


def foreign_ops(program):
    '''The ops of an exported program outside the ``aten`` namespace (empty
    for a program that needs nothing but torch).'''
    found = set()
    for node in program.graph.nodes:
        if node.op != 'call_function':
            continue
        namespace = getattr(node.target, 'namespace', None)
        if namespace is None:   # a Python callable such as operator.getitem
            namespace = getattr(node.target, '__module__', '')
            if namespace in ('_operator', 'operator'):
                continue
        if namespace != 'aten':
            found.add(str(node.target))
    return sorted(found)


def _input_shape(program):
    '''The user input's shape: ints, None for a symbolic dimension.'''
    names = program.graph_signature.user_inputs
    node = next(n for n in program.graph.nodes
                if n.op == 'placeholder' and n.name == names[0])
    return tuple(d if isinstance(d, int) else None
                 for d in node.meta['val'].shape)


def export_model(
    save_path,
    output_path,
    config=None,
    batch_size=None,
    platforms=('cuda', 'cpu'),
):
    '''
    Export the latest checkpoint as a self-contained serving artifact.

    Args:
        save_path: training run directory (options.yaml + checkpoints)
        output_path: artifact path; writes <output_path>.pt2 and .yaml
        config (list[str]): extra configuration overlays
        batch_size (int): fix the batch dimension; default exports a
            symbolic batch (one artifact, any batch size)
        platforms (list[str]): device types the artifact may be loaded on
            (default cuda+cpu)

    Returns:
        path of the written .pt2 artifact.
    '''
    saved_config = os.path.join(save_path, 'options.yaml')
    saved_config = config_lib.load_config(saved_config)['config']
    if config:
        saved_config = config_lib.apply_config(
            saved_config, config_lib.load_config(config))

    eval_opts = saved_config['data_options']['eval']
    slice_types = tuple(eval_opts.get(
        'slice_types',
        ('TRA', 'ADC', 'DWI', 'DCEE', 'DCEL', 'label')))
    h, w = (int(d) for d in eval_opts.get('output_size', (512, 512)))
    n_features = len(slice_types) - 1

    eng = engine_lib.Engine(saved_config, device='cpu')
    # a symbolic batch is traced at 2: an example of 1 specialises it
    example_batch = int(batch_size) if batch_size else 2
    eng.build((example_batch, h, w, n_features))
    ckpts = eng.get_ckpts(os.path.join(save_path, 'checkpoints'))
    if not ckpts:
        raise FileNotFoundError(f'no checkpoints under {save_path}')
    step = max(ckpts)
    eng.load(ckpts[step])

    example = torch.zeros((example_batch, h, w, n_features),
                          dtype=torch.uint8)
    dynamic = None if batch_size else ({0: torch.export.Dim('batch')},)
    with eng.scope(), gates.library_only():
        program = torch.export.export(_Infer(eng.model), (example,),
                                      dynamic_shapes=dynamic, strict=False)
    foreign = foreign_ops(program)
    if foreign:
        raise RuntimeError(f'the exported program holds ops outside aten: '
                           f'{foreign}')

    pt2_path = f'{output_path}.pt2'
    os.makedirs(os.path.dirname(os.path.abspath(pt2_path)), exist_ok=True)
    torch.export.save(program, pt2_path)
    batch = int(batch_size) if batch_size else -1
    meta = dict(
        input=dict(shape=[batch, h, w, n_features], dtype='uint8',
                   slice_types=list(slice_types[:-1])),
        output=dict(shape=[batch, h, w, 1], dtype='float32',
                    semantics='sigmoid probability'),
        model=saved_config['model'],
        checkpoint_step=int(step),
        platforms=list(platforms),
        torch_version=str(torch.__version__),
    )
    with open(f'{output_path}.yaml', 'w') as f:
        yaml.safe_dump(meta, f)
    logger.info('Exported step-%d %s to %s (%d bytes)', step,
                saved_config['model'], pt2_path, os.path.getsize(pt2_path))
    return pt2_path


def load_exported(path, device='cuda'):
    '''Load a ``.pt2`` artifact onto ``device`` as a callable
    ``fn(features_uint8) -> float32 probabilities`` (a tensor on that
    device). ``device`` is 'cuda' (default; raises when no GPU is
    visible, and turns TF32 off as the Engine does), 'cuda:N' or 'cpu';
    a device type the sidecar's ``platforms`` does not list is refused.
    ``fn`` takes a host array and raises ValueError on a shape the
    program does not take (a fixed batch's other sizes).'''
    meta_path = os.path.splitext(path)[0] + '.yaml'
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            platforms = yaml.safe_load(f).get('platforms')
        if platforms and torch.device(device).type not in platforms:
            raise ValueError(f'the artifact is exported for {platforms}, '
                             f'not {device!r}')
    dev = engine_lib.resolve_device(device)
    program = torch.export.load(path)
    program = move_to_device_pass(program, dev)
    want = _input_shape(program)
    module = program.module()

    def infer(features):
        x = torch.from_numpy(np.ascontiguousarray(features))
        if x.dim() != len(want) or any(
                d is not None and d != n for d, n in zip(want, x.shape)):
            shape = tuple(-1 if d is None else d for d in want)
            raise ValueError(f'the artifact takes {shape}, got '
                             f'{tuple(x.shape)}')
        with torch.inference_mode():
            return module(x.to(dev))

    return infer

'''Prediction engine (counterpart of the predict half of
dnncancerannotator_tpu.engine).

``Engine`` builds the configured model on an explicit device, enumerates
and loads step-indexed checkpoints (``ckpt-<step>`` directories, the JAX
package's names and ordering) and runs the forward step of evaluation:
uint8 slices -> /255 -> drop the label channel -> model logits -> sigmoid.

A checkpoint directory holds ``params.npz``: the flax parameter paths and
HWIO kernels (convert.py), readable without JAX or Orbax. Reading the JAX
package's Orbax checkpoints is not ported yet.
'''

import copy
import logging
import os
import re
from collections import OrderedDict

import numpy as np
import torch

from . import convert
from . import models as models_lib
from .data import augment as augment_mod

logger = logging.getLogger(__name__)

PARAMS_FILE = 'params.npz'


def resolve_device(device):
    '''The torch.device for a device name ('cuda', 'cuda:1', 'cpu').

    A CUDA device needs a visible GPU: without one this raises, and nothing
    falls back to the CPU; pass 'cpu' to run the plain PyTorch path there.
    Selecting a CUDA device turns TF32 off for cuDNN and matmuls, so the
    plain versions compared with the kernels on the card run in full f32.
    '''
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                f'device {device!r} requested but no CUDA device is '
                'available; pass --device cpu to run on the CPU')
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {device!r} (cuda or cpu)')
    return dev


class Engine:
    '''A model plus its prediction machinery on one device.'''

    CKPT_PATTERN = re.compile(r'^ckpt-(\d+)$')

    def __init__(self, model_config, seed=0, device='cuda'):
        for key in ('model', 'model_options', 'deploy_options'):
            if key not in model_config:
                raise KeyError(f'model config lacks {key!r}')
        self.model_config = copy.deepcopy(model_config)
        self.seed = seed
        precision = model_config['deploy_options'].get('precision')
        if precision in ('bfloat16', 'bf16'):
            raise NotImplementedError(
                'precision bfloat16 is not ported yet; the port computes in '
                'float32 (ROADMAP.md queue 2)')
        self.model_name = model_config['model']
        self.device = resolve_device(device)
        self.model = None

    def build(self, input_shape):
        '''Build the model for [B, H, W, C] inputs with seeded glorot
        weights (idempotent).'''
        if self.model is not None:
            return
        generator = torch.Generator().manual_seed(self.seed)
        model, _ = models_lib.build_model(
            self.model_name, self.model_config['model_options'],
            in_channels=input_shape[-1], generator=generator)
        self.model = model.to(self.device).eval()
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info('Initialized %s: %d params on %s', self.model_name,
                    n_params, self.device)

    # -- checkpointing ---------------------------------------------------
    def get_ckpts(self, base_path):
        '''Step-indexed checkpoint directories, in step order.'''
        if not os.path.isdir(base_path):
            return OrderedDict()
        found = []
        for name in os.listdir(base_path):
            m = self.CKPT_PATTERN.match(name)
            if m and os.path.isdir(os.path.join(base_path, name)):
                found.append((int(m.group(1)), os.path.join(base_path, name)))
        return OrderedDict(sorted(found))

    def save_ckpt(self, base_path, step):
        '''Write ``ckpt-<step>/params.npz`` in the flat flax-keyed form.'''
        path = os.path.join(base_path, f'ckpt-{step}')
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, PARAMS_FILE),
                 **convert.flax_from_torch_state(self.model.state_dict()))
        return path

    def load(self, path):
        '''Load a checkpoint directory into the built model.'''
        if self.model is None:
            raise RuntimeError('call build() before load()')
        with np.load(os.path.join(path, PARAMS_FILE)) as npz:
            flat = {key: npz[key] for key in npz.files}
        state = convert.torch_state_from_flax(
            flat, expected=self.model.state_dict())
        self.model.load_state_dict(state)
        return self

    # -- forward -----------------------------------------------------------
    def _make_eval_step(self, slice_types):
        '''The forward step of evaluation: uint8 [B, H, W, C] host batch ->
        probabilities [B, H, W, 1] on the device.'''
        model, device = self.model, self.device
        slice_types = tuple(slice_types)

        @torch.no_grad()
        def step(raw_batch):
            images = torch.from_numpy(np.asarray(raw_batch)).to(device)
            images = images.to(torch.float32) / 255.0
            x, _ = augment_mod.to_feature_label(images, slice_types)
            return torch.sigmoid(model(x, return_logits=True))

        return step

    def predict(self, dataset):
        '''Predict probabilities for every element of an EvalDataset.'''
        self.build(dataset.feature_shape)
        eval_step = self._make_eval_step(dataset.slice_types)
        outputs = [eval_step(batch['slices']).cpu().numpy()
                   for batch in dataset.batches()]
        return np.concatenate(outputs, 0) if outputs else np.zeros((0,))

'''Training and prediction engine (counterpart of
dnncancerannotator_tpu.engine).

``Engine`` builds the configured model on an explicit device, trains it,
enumerates, saves and loads step-indexed checkpoints (``ckpt-<step>``
directories, the JAX package's names and ordering) and predicts.

Training (``train``) follows the JAX engine's device-resident path:
- the whole uint8 training set sits on the device, and each step samples
  its batch there (equal probability per source with ``normalize_exams``);
- the step: uint8 -> /255 -> augmentation chain -> feature/label split ->
  forward -> weighted BCE -> backward (the kernels' autograd Functions) ->
  optimizer step at the schedule's learning rate for that step;
- ``steps_per_call`` steps run per chunk, a chunk never crosses a
  ``save_freq`` boundary, and each chunk's losses come back to the host in
  one read, where a non-finite loss stops the run;
- at every ``save_freq`` step (and the last) a checkpoint is written; a
  new ``train`` call resumes from the newest one.
The warp bank is solved once per Engine. The sampler and the augmentation
draw from device generators reseeded at every step from (seed, step), so a
resumed run draws what an unbroken one would. Not ported yet (they raise
or are not offered): validation and early stopping, train metrics, the
visualizer, the profiler window, SIGTERM draining, host streaming, the
kernel regularizer, ``fused_aug``.

A checkpoint directory holds ``params.npz`` (the flax parameter paths with
HWIO kernels, convert.py) and, once trained, ``opt_state.npz``: the
optimizer's moments under optax's names by flax path (``mu/<path>``,
``nu/<path>`` for Adam, ``trace/<path>`` for SGD momentum) in the same
layout, and ``step``. numpy reads both without JAX; reading the JAX
package's Orbax checkpoints is not ported yet.
'''

import copy
import logging
import math
import os
import re
import shutil
import time
from collections import OrderedDict

import numpy as np
import torch

from . import convert
from . import models as models_lib
from .data import augment as augment_mod
from .train import losses as losses_lib
from .train import optimizers as optimizers_lib
from .train import schedules as schedules_lib

logger = logging.getLogger(__name__)

PARAMS_FILE = 'params.npz'
OPT_STATE_FILE = 'opt_state.npz'
# torch optimizer state keys <-> optax's names in opt_state.npz
_OPT_KEYS = {'exp_avg': 'mu', 'exp_avg_sq': 'nu', 'momentum_buffer': 'trace'}
# random streams of an Engine, each seeded from (seed, stream[, step])
_BANK, _SAMPLE, _AUGMENT = 0x77a5, 1, 2
_NOT_PORTED = 'is not ported yet (ROADMAP.md queue 1)'


def _stream_seed(*words):
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


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


class TrainResults:
    '''Per-step history of a ``train`` call (for dump_train_results).'''

    def __init__(self, model_name, params):
        self.epoch = []
        self.history = {}
        self.params = params
        self.model_name = model_name

    def append(self, step, logs):
        self.epoch.append(step)
        for k, v in logs.items():
            self.history.setdefault(k, []).append(float(v))


class Engine:
    '''A model plus its training and prediction machinery on one device.'''

    CKPT_PATTERN = re.compile(r'^ckpt-(\d+)$')

    def __init__(self, model_config, seed=0, device='cuda'):
        for key in ('model', 'model_options', 'deploy_options'):
            if key not in model_config:
                raise KeyError(f'model config lacks {key!r}')
        self.model_config = copy.deepcopy(model_config)
        self.seed = seed
        deploy = self.model_config['deploy_options']
        if deploy.get('precision') in ('bfloat16', 'bf16'):
            raise NotImplementedError(
                'precision bfloat16 is not ported yet; the port computes in '
                'float32 (ROADMAP.md queue 2)')
        self.schedule = schedules_lib.solve_schedule(
            deploy.get('LearningRateScheduler'))
        self.steps_per_call = int(deploy.get('steps_per_call', 1))
        self.max_checkpoints_to_keep = deploy.get('max_checkpoints_to_keep')
        self.warp_bank_size = int(deploy.get('warp_bank_size', 512))
        self.model_name = model_config['model']
        self.device = resolve_device(device)
        self.model = None
        self.optimizer = None
        self.loss = None
        self.current_step = 0
        self._bank_cache = {}

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
        '''Write ``ckpt-<step>/params.npz`` in the flat flax-keyed form, and
        ``opt_state.npz`` when the engine has an optimizer; the directory
        appears whole (written under another name, then renamed). Keeps the
        newest ``max_checkpoints_to_keep`` checkpoints.'''
        path = os.path.join(base_path, f'ckpt-{step}')
        tmp = path + '.tmp'
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, PARAMS_FILE),
                 **convert.flax_from_torch_state(self.model.state_dict()))
        if self.optimizer is not None:
            np.savez(os.path.join(tmp, OPT_STATE_FILE),
                     **self._opt_state_flat(step))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        self._prune_ckpts(base_path)
        return path

    def _prune_ckpts(self, base_path):
        if not self.max_checkpoints_to_keep:
            return
        ckpts = self.get_ckpts(base_path)
        for step in list(ckpts)[:max(
                len(ckpts) - int(self.max_checkpoints_to_keep), 0)]:
            shutil.rmtree(ckpts[step], ignore_errors=True)
            logger.info('Pruned checkpoint %s', ckpts[step])

    def _opt_state_flat(self, step):
        '''The optimizer's per-parameter state by optax name and flax path,
        plus the step.'''
        names = {p: n for n, p in self.model.named_parameters()}
        flat = {'step': np.asarray(step, np.int64)}
        for key, optax_name in _OPT_KEYS.items():
            state = {names[p]: st[key]
                     for p, st in self.optimizer.state.items()
                     if torch.is_tensor(st.get(key))}
            for path, value in convert.flax_from_torch_state(state).items():
                flat[f'{optax_name}/{path}'] = value
        return flat

    def _load_opt_state(self, path):
        params = dict(self.model.named_parameters())
        with np.load(path) as npz:
            flat = {key: npz[key] for key in npz.files}
        step = float(flat.pop('step'))
        for key, optax_name in _OPT_KEYS.items():
            group = {k.split('/', 1)[1]: v for k, v in flat.items()
                     if k.split('/', 1)[0] == optax_name}
            if not group:
                continue
            state = convert.torch_state_from_flax(
                group, expected=self.model.state_dict())
            for name, value in state.items():
                entry = self.optimizer.state[params[name]]
                entry[key] = value.to(self.device)
                if key == 'exp_avg':
                    entry['step'] = torch.tensor(step)

    def load(self, path):
        '''Load a checkpoint directory into the built model, and its
        optimizer state when it has one and the engine is set up to
        train.'''
        if self.model is None:
            raise RuntimeError('call build() before load()')
        with np.load(os.path.join(path, PARAMS_FILE)) as npz:
            flat = {key: npz[key] for key in npz.files}
        state = convert.torch_state_from_flax(
            flat, expected=self.model.state_dict())
        self.model.load_state_dict(state)
        opt_path = os.path.join(path, OPT_STATE_FILE)
        if self.optimizer is not None and os.path.exists(opt_path):
            self._load_opt_state(opt_path)
        return self

    def _auto_resume(self, base_path):
        ckpts = self.get_ckpts(base_path)
        if not ckpts:
            return
        latest = max(ckpts)
        self.load(ckpts[latest])
        self.current_step = latest
        logger.warning('Resumed from step %d', latest)

    # -- training ----------------------------------------------------------
    def _setup_training(self, dataset):
        '''Build the model, loss, optimizer, warp bank and augmentation
        chain for ``dataset``; raises for what the port does not run.'''
        deploy = self.model_config['deploy_options']
        unported = [name for name, on in (
            ('train metrics', deploy.get('metrics')),
            ('fused_aug', deploy.get('fused_aug')),
            ('kernel_regularizer',
             self.model_config['model_options'].get('kernel_regularizer')))
            if on]
        if unported:
            raise NotImplementedError(
                f'{", ".join(unported)} {_NOT_PORTED}')
        self.build(dataset.feature_shape)
        self.model.train()
        if self.loss is None:
            self.loss = losses_lib.solve_loss(
                deploy.get('loss', 'WeightedCrossentropy'))
        if self.optimizer is None:
            self.optimizer, self.schedule = optimizers_lib.solve_optimizer(
                deploy.get('optimizer', 'adam'), self.model.parameters(),
                self.schedule)
        self._augment = augment_mod.build_augment_fn(
            dataset.augment_methods, warp_bank=self._warp_bank(dataset))
        self._slice_types = dataset.slice_types

    def _warp_bank(self, dataset):
        '''The warp bank (solved once per Engine and chain) when
        ``deploy_options.warp_bank`` is on (the default) and the chain crops
        before a two-pass warp, else None.'''
        methods = dataset.augment_methods
        key = repr(methods)
        if key not in self._bank_cache:
            bank = None
            names = [n for n, _ in methods]
            if (self.model_config['deploy_options'].get('warp_bank', True)
                    and 'random_warp' in names and 'random_crop' in names
                    and names.index('random_crop') < names.index(
                        'random_warp')):
                crop_o = methods[names.index('random_crop')][1]
                warp_o = dict(methods[names.index('random_warp')][1])
                if warp_o.get('method', 'two_pass') == 'two_pass':
                    logger.info('Solving the warp bank: %d fields at %s',
                                self.warp_bank_size, crop_o['output_size'])
                    gen = torch.Generator(device=self.device).manual_seed(
                        _stream_seed(self.seed, _BANK))
                    bank = augment_mod.build_warp_bank(
                        gen, self.warp_bank_size, crop_o['output_size'],
                        **warp_o)
            self._bank_cache[key] = bank
        return self._bank_cache[key]

    def _resident(self, dataset):
        '''The training set on the device (cached on the dataset):
        (uint8 pool [N, h, w, C], starts, counts, balanced).'''
        cached = getattr(dataset, '_device_pool', None)
        if cached is None or cached[0].device != self.device:
            host = dataset.load_resident()
            logger.info('Device-resident input: %d slices (%.1f MB)',
                        host['data'].shape[0], host['data'].nbytes / 1e6)
            cached = (torch.from_numpy(host['data']).to(self.device),
                      torch.from_numpy(host['starts']).to(self.device),
                      torch.from_numpy(host['counts']).to(self.device),
                      bool(host['balanced']) and len(host['starts']) > 1)
            dataset._device_pool = cached
        return cached

    def sample_batch(self, resident, b, gen):
        '''Draw a uint8 batch [b, h, w, C] from the resident pool: a source
        uniformly, then a slice of it, when balanced; else a slice
        uniformly.'''
        pool, starts, counts, balanced = resident
        if balanced:
            f = torch.randint(0, len(starts), (b,), generator=gen,
                              device=self.device)
            u = torch.rand(b, generator=gen, device=self.device)
            idx = starts[f] + torch.minimum((u * counts[f]).long(),
                                            counts[f] - 1)
        else:
            idx = torch.randint(0, pool.shape[0], (b,), generator=gen,
                                device=self.device)
        return pool[idx]

    def train_step(self, raw, step, gen):
        '''One optimizer step on a uint8 batch [B, h, w, C] on the device,
        with the augmentation drawn from ``gen``; returns the loss (a
        device scalar).'''
        images = self._augment(raw.float() / 255.0, gen)
        x, y = augment_mod.to_feature_label(images, self._slice_types)
        for group in self.optimizer.param_groups:
            group['lr'] = self.schedule(step)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(y, self.model(x, return_logits=True))
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train(self, dataset, save_path=None, save_freq=100, max_steps=None,
              auto_resume=True, log_every=50, steps_per_call=None):
        '''Train for ``max_steps`` steps in all (1 step == 1 reference
        "epoch"), checkpointing under ``save_path`` every ``save_freq``
        steps; returns TrainResults of this call's steps.'''
        if max_steps is None:
            raise ValueError('train needs max_steps')
        self._setup_training(dataset)
        ckpt_dir = os.path.join(save_path, 'checkpoints') if save_path \
            else None
        if auto_resume and ckpt_dir:
            self._auto_resume(ckpt_dir)
        resident = self._resident(dataset)
        spc = int(steps_per_call or self.steps_per_call)
        results = TrainResults(
            self.model_name,
            dict(save_freq=save_freq, max_steps=max_steps, seed=self.seed))
        sample_gen = torch.Generator(device=self.device)
        aug_gen = torch.Generator(device=self.device)
        step = self.current_step
        t_start = time.perf_counter()
        while step < max_steps:
            boundary = min(max_steps, (step // save_freq + 1) * save_freq)
            chunk = []
            for s in range(step, min(step + spc, boundary)):
                sample_gen.manual_seed(_stream_seed(self.seed, _SAMPLE, s))
                aug_gen.manual_seed(_stream_seed(self.seed, _AUGMENT, s))
                raw = self.sample_batch(resident, dataset.batch_size,
                                        sample_gen)
                chunk.append(self.train_step(raw, s, aug_gen))
            losses = torch.stack(chunk).tolist()  # the chunk's one host read
            if not all(map(math.isfinite, losses)):
                raise FloatingPointError(
                    f'non-finite loss in steps {step + 1}-'
                    f'{step + len(losses)}: {losses}')
            for loss in losses:
                step += 1
                results.append(step, {'loss': loss,
                                      'lr': self.schedule(step - 1)})
                if step % log_every == 0 or step == max_steps:
                    rate = len(results.epoch) / (time.perf_counter() -
                                                 t_start)
                    logger.info('step %d/%d loss=%.4f (%.2f steps/s)', step,
                                max_steps, loss, rate)
            self.current_step = step
            if ckpt_dir and (step % save_freq == 0 or step == max_steps):
                self.save_ckpt(ckpt_dir, step)
        return results

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

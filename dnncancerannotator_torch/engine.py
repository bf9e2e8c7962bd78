'''Training, evaluation and prediction engine (counterpart of
dnncancerannotator_tpu.engine).

``Engine`` builds the configured model on an explicit device, trains it,
evaluates it, enumerates, saves and loads step-indexed checkpoints
(``ckpt-<step>`` directories, the JAX package's names and ordering) and
predicts.

Training (``train``) follows the JAX engine's device-resident path:
- the whole uint8 training set sits on the device, and each step samples
  its batch there (equal probability per source with ``normalize_exams``);
- the step: uint8 -> /255 -> augmentation chain -> feature/label split ->
  forward -> weighted BCE -> backward (the kernels' autograd Functions) ->
  optimizer step at the schedule's learning rate for that step;
- ``steps_per_call`` steps run per chunk, a chunk never crosses a
  ``save_freq`` boundary, and each chunk's losses come back to the host in
  one read, where a non-finite loss stops the run;
- with ``deploy_options.metrics``, every step's metrics are computed on its
  own probabilities and labels (reset, update, result) and logged;
- at every ``save_freq`` step (and the last): validation on ``val_data``
  (``val_*`` logs), a checkpoint, and the Visualizer passes; early stopping
  when ``val_loss`` has not improved for ``early_stop_steps`` steps;
- the logs go to ``save_path/tfevents/train`` as scalars; a new ``train``
  call resumes from the newest checkpoint.
The kernel gates come from ``deploy_options`` (ops/gates.py) and are in
scope wherever the Engine runs its model (``Engine.scope``): in training
mode for the train step, in eval mode (BatchNorm on its running statistics)
for validation, evaluation, prediction and the Visualizer.
The warp bank is solved once per Engine. The sampler and the augmentation
draw from device generators reseeded at every step from (seed, step), so a
resumed run draws what an unbroken one would. Not ported yet (they raise or
are not offered): the profiler window, SIGTERM draining, host streaming,
the kernel regularizer, ``fused_aug``.

Evaluation (``eval``) runs the metrics and the Visualizer over a dataset for
every checkpoint of a run, and writes ``results.csv`` and
``casewise_results.csv``.

A checkpoint directory holds ``params.npz`` (the flax parameter paths with
HWIO kernels, and a BatchNorm model's ``batch_stats/...`` running
statistics, convert.py) and, once trained, ``opt_state.npz``: the
optimizer's moments under optax's names by flax parameter path
(``mu/<path>``, ``nu/<path>`` for Adam, ``trace/<path>`` for SGD momentum)
in the same layout, and ``step``. numpy reads both without JAX; reading the JAX
package's Orbax checkpoints is not ported yet.
'''

import contextlib
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
from . import metrics as metrics_lib
from . import models as models_lib
from .data import augment as augment_mod
from .ops import gates as gates_lib
from .train import losses as losses_lib
from .train import optimizers as optimizers_lib
from .train import schedules as schedules_lib
from .utils import tboard
from .utils import viz as viz_lib

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
        self.metric_specs = deploy.get('metrics') or []
        self.max_checkpoints_to_keep = deploy.get('max_checkpoints_to_keep')
        self.warp_bank_size = int(deploy.get('warp_bank_size', 512))
        self.gates = gates_lib.KernelGates.from_deploy_options(deploy)
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

    def gate(self, name):
        '''This Engine's kernel gate ``name`` (env override first).'''
        with gates_lib.active(self.gates):
            return gates_lib.enabled(name)

    @contextlib.contextmanager
    def scope(self, training=False):
        '''Within the block the model is in training (or eval) mode and
        reads this Engine's kernel gates; its previous mode comes back
        after.'''
        was_training = self.model.training
        self.model.train(training)
        try:
            with gates_lib.active(self.gates):
                yield
        finally:
            self.model.train(was_training)

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
        expected = {name: p.detach() for name, p in params.items()}
        with np.load(path) as npz:
            flat = {key: npz[key] for key in npz.files}
        step = float(flat.pop('step'))
        for key, optax_name in _OPT_KEYS.items():
            group = {k.split('/', 1)[1]: v for k, v in flat.items()
                     if k.split('/', 1)[0] == optax_name}
            if not group:
                continue
            state = convert.torch_state_from_flax(group, expected=expected)
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
            ('fused_aug', self.gate('fused_aug')),
            ('kernel_regularizer',
             self.model_config['model_options'].get('kernel_regularizer')))
            if on]
        if unported:
            raise NotImplementedError(
                f'{", ".join(unported)} {_NOT_PORTED}')
        self.build(dataset.feature_shape)
        self._solve_loss()
        if self.optimizer is None:
            self.optimizer, self.schedule = optimizers_lib.solve_optimizer(
                deploy.get('optimizer', 'adam'), self.model.parameters(),
                self.schedule)
        self._augment = augment_mod.build_augment_fn(
            dataset.augment_methods, warp_bank=self._warp_bank(dataset))
        self._slice_types = dataset.slice_types

    def _solve_loss(self):
        if self.loss is None:
            self.loss = losses_lib.solve_loss(
                self.model_config['deploy_options'].get(
                    'loss', 'WeightedCrossentropy'))
        return self.loss

    def _build_metrics(self):
        return [metrics_lib.solve_metric(s) for s in self.metric_specs]

    def _warp_bank(self, dataset):
        '''The warp bank (solved once per Engine and chain) when the
        ``warp_bank`` gate is on (the default) and the chain crops
        before a two-pass warp, else None.'''
        methods = dataset.augment_methods
        key = repr(methods)
        if key not in self._bank_cache:
            bank = None
            names = [n for n, _ in methods]
            if (self.gate('warp_bank') and 'random_warp' in names
                    and 'random_crop' in names
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

    def train_step(self, raw, step, gen, outputs=False):
        '''One optimizer step on a uint8 batch [B, h, w, C] on the device,
        with the augmentation drawn from ``gen``; returns the loss (a
        device scalar), and with ``outputs`` also the step's probabilities
        and labels [B, h, w] (for the train metrics).'''
        images = self._augment(raw.float() / 255.0, gen)
        x, y = augment_mod.to_feature_label(images, self._slice_types)
        for group in self.optimizer.param_groups:
            group['lr'] = self.schedule(step)
        self.optimizer.zero_grad(set_to_none=True)
        with self.scope(training=True):
            logits = self.model(x, return_logits=True)
        loss = self.loss(y, logits)
        loss.backward()
        self.optimizer.step()
        if outputs:
            return loss.detach(), torch.sigmoid(logits.detach()[..., 0]), y
        return loss.detach()

    def train(self, dataset, val_data=None, save_path=None, save_freq=100,
              max_steps=None, early_stop_steps=None, visualization=None,
              auto_resume=True, log_every=50, steps_per_call=None):
        '''Train for ``max_steps`` steps in all (1 step == 1 reference
        "epoch"), checkpointing under ``save_path`` every ``save_freq``
        steps, validating on ``val_data`` there and running the Visualizer
        of each ``visualization`` {tag: EvalDataset}; returns TrainResults
        of this call's steps.'''
        if max_steps is None:
            raise ValueError('train needs max_steps')
        self._setup_training(dataset)
        ckpt_dir = os.path.join(save_path, 'checkpoints') if save_path \
            else None
        if auto_resume and ckpt_dir:
            self._auto_resume(ckpt_dir)
        resident = self._resident(dataset)
        spc = int(steps_per_call or self.steps_per_call)
        train_metrics = self._build_metrics()
        eval_step = self._make_eval_step(dataset.slice_types)
        results = TrainResults(
            self.model_name,
            dict(save_freq=save_freq, max_steps=max_steps, seed=self.seed))
        writer, viz_callbacks = None, []
        if save_path:
            tb_dir = os.path.join(save_path, 'tfevents')
            writer = tboard.SummaryWriter(os.path.join(tb_dir, 'train'))
            viz_callbacks = [viz_lib.Visualizer(tag, viz_ds, save_freq, tb_dir)
                             for tag, viz_ds in (visualization or {}).items()]
        sample_gen = torch.Generator(device=self.device)
        aug_gen = torch.Generator(device=self.device)
        step = self.current_step
        best_val, best_step = float('inf'), step
        stop = False
        t_start = time.perf_counter()
        try:
            while step < max_steps:
                boundary = min(max_steps, (step // save_freq + 1) * save_freq)
                chunk = []
                for s in range(step, min(step + spc, boundary)):
                    sample_gen.manual_seed(_stream_seed(self.seed, _SAMPLE, s))
                    aug_gen.manual_seed(_stream_seed(self.seed, _AUGMENT, s))
                    raw = self.sample_batch(resident, dataset.batch_size,
                                            sample_gen)
                    chunk.append(self.train_step(
                        raw, s, aug_gen, outputs=bool(train_metrics)))
                outs = chunk if train_metrics else [(c,) for c in chunk]
                # the chunk's one host read
                losses = torch.stack([o[0] for o in outs]).tolist()
                if not all(map(math.isfinite, losses)):
                    raise FloatingPointError(
                        f'non-finite loss in steps {step + 1}-'
                        f'{step + len(losses)}: {losses}')
                for out, loss in zip(outs, losses):
                    step += 1
                    logs = {'loss': loss, 'lr': self.schedule(step - 1)}
                    for metric in train_metrics:
                        metric.reset_state()
                        metric.update_state(out[2], out[1])
                        value = metric.result()
                        if np.ndim(value) == 0:
                            logs[metric.name] = float(value)
                    at_save = step % save_freq == 0 or step == max_steps
                    if at_save and val_data is not None:
                        val = self._eval_dataset(eval_step, val_data,
                                                 self._build_metrics())
                        logs.update({f'val_{k}': v for k, v in val.items()
                                     if np.ndim(v) == 0})
                        if logs['val_loss'] < best_val:
                            best_val, best_step = logs['val_loss'], step
                    results.append(step, logs)
                    if writer:
                        for key, value in logs.items():
                            writer.scalar('epoch_loss' if key == 'loss'
                                          else key, value, step)
                    if step % log_every == 0 or step == max_steps:
                        rate = len(results.epoch) / (time.perf_counter() -
                                                     t_start)
                        logger.info('step %d/%d loss=%.4f (%.2f steps/s)',
                                    step, max_steps, loss, rate)
                    self.current_step = step
                    if at_save and ckpt_dir:
                        self.save_ckpt(ckpt_dir, step)
                    if at_save:
                        for callback in viz_callbacks:
                            callback.on_step(self, step)
                if stop:
                    break
                if early_stop_steps is not None and val_data is not None \
                        and step - best_step >= early_stop_steps:
                    logger.warning('Early stopping at step %d (best %d)',
                                   step, best_step)
                    if step == boundary:
                        break
                    # the JAX engine has already issued the next chunk when
                    # it reads this one's losses, and runs it before it
                    # stops
                    stop = True
        finally:
            if writer:
                writer.close()
            for callback in viz_callbacks:
                callback.close()
        return results

    # -- evaluation and prediction ---------------------------------------------
    def _make_eval_step(self, slice_types):
        '''The forward step of evaluation: uint8 [B, H, W, C] host batch ->
        (per-slice loss [B], probabilities [B, H, W, 1], labels [B, H, W]),
        on the device. The batch is not padded, so a short last batch gives
        the per-slice losses of the JAX step, which pads and masks it.'''
        model, device = self.model, self.device
        slice_types = tuple(slice_types)
        loss = self._solve_loss()

        @torch.no_grad()
        def step(raw_batch):
            images = torch.from_numpy(np.asarray(raw_batch)).to(device)
            images = images.to(torch.float32) / 255.0
            x, y = augment_mod.to_feature_label(images, slice_types)
            with self.scope():
                logits = model(x, return_logits=True)
            return loss.per_sample(y, logits), torch.sigmoid(logits), y

        return step

    def _eval_dataset(self, eval_step, dataset, metrics):
        '''One pass over an EvalDataset: {'loss': mean per-slice loss,
        metric name: result}.'''
        losses = []
        for batch in dataset.batches():
            loss_vec, probs, y = eval_step(batch['slices'])
            losses.append(loss_vec.cpu().numpy())
            for metric in metrics:
                metric.update_state(y, probs)
        results = {'loss': float(np.concatenate(losses).mean())
                   if losses else float('nan')}
        for metric in metrics:
            value = metric.result()
            results[metric.name] = (
                float(value) if np.ndim(value) == 0 else np.asarray(value))
        return results

    def eval(self, dataset, save_path, viz_ds=None, tag='val',
             avoid_overwrite=False, export_path=None, export_images=False,
             visualize_sensitivity=False, export_csv=False, min_interval=1,
             step_range=None, overlay=False, export_casewise_metrics=False):
        '''Evaluate every checkpoint under ``save_path/checkpoints`` in
        ``step_range`` (both ends included) and at least ``min_interval``
        steps after the last one evaluated: the metrics over ``dataset``,
        then the Visualizer over ``viz_ds``, into ``export_path/<tag>``
        (default ``save_path/tfevents/<tag>``; an existing tag raises, or
        gets '_' appended with ``avoid_overwrite``). Returns {step: scalar
        results}; with ``export_csv`` also writes ``results.csv`` (one row
        a step) and ``casewise_results.csv`` (one row a slice and step).'''
        self.build(dataset.feature_shape)
        ckpt_path = os.path.join(save_path, 'checkpoints')
        export_path = export_path or os.path.join(save_path, 'tfevents')
        while os.path.exists(os.path.join(export_path, tag)):
            if not avoid_overwrite:
                raise ValueError(f'tag: {tag} already exists.')
            tag += '_'
        if step_range is None:
            step_range = (0, float('inf'))
        elif len(step_range) != 2 or not 0 <= step_range[0] <= step_range[1]:
            raise ValueError(f'bad step_range {step_range}')
        eval_step = self._make_eval_step(dataset.slice_types)
        viz_callback = None
        casewise = [] if export_csv else None
        if viz_ds is not None:
            viz_callback = viz_lib.Visualizer(
                tag, viz_ds, 1, save_dir=export_path, ignore_test=False,
                export_images=export_images, export_csv=export_csv,
                visualize_sensitivity=visualize_sensitivity, overlay=overlay,
                # as in the JAX package, casewise rows are computed when
                # export_csv consumes them or when asked for
                export_casewise_metrics=export_casewise_metrics or export_csv,
                casewise_metrics_container=casewise)
        result_rows = {}
        previous_step = None
        try:
            for ckpt_step, ckpt_dir in self.get_ckpts(ckpt_path).items():
                if not step_range[0] <= ckpt_step <= step_range[1]:
                    continue
                if previous_step is not None and \
                        ckpt_step - previous_step < min_interval:
                    logger.warning('Ignored %s due to min_interval:%s.',
                                   ckpt_dir, min_interval)
                    continue
                previous_step = ckpt_step
                self.load(ckpt_dir)
                results = self._eval_dataset(eval_step, dataset,
                                             self._build_metrics())
                result_rows[ckpt_step] = {k: v for k, v in results.items()
                                          if np.ndim(v) == 0}
                logger.info('ckpt step %d: %s', ckpt_step,
                            result_rows[ckpt_step])
                if viz_callback is not None:
                    viz_callback.on_test(self, ckpt_step)
        finally:
            if viz_callback is not None:
                viz_callback.close()
        if export_csv:
            out_dir = os.path.join(export_path, tag)
            _write_frame(os.path.join(out_dir, 'results.csv'), 'step',
                         result_rows)
            _write_frame(os.path.join(out_dir, 'casewise_results.csv'), '',
                         dict(enumerate(casewise)))
        return result_rows

    def predict(self, dataset):
        '''Predict probabilities for every element of an EvalDataset.'''
        self.build(dataset.feature_shape)
        eval_step = self._make_eval_step(dataset.slice_types)
        outputs = [eval_step(batch['slices'])[1].cpu().numpy()
                   for batch in dataset.batches()]
        return np.concatenate(outputs, 0) if outputs else np.zeros((0,))


def _csv_field(value):
    if isinstance(value, float) and math.isnan(value):
        return ''
    return value


def _write_frame(path, index_name, rows):
    '''{index: {column: value}} as pandas' ``DataFrame.from_dict(rows,
    orient='index').to_csv(path)`` writes it: the columns in order of first
    appearance, NaN and missing values empty, and ``""`` for no rows.'''
    columns = list(dict.fromkeys(k for row in rows.values() for k in row))
    table = [[index_name, *columns]] if rows else [['']]
    table += [[index, *(_csv_field(row.get(c, float('nan'))) for c in columns)]
              for index, row in rows.items()]
    viz_lib.write_csv(path, table)

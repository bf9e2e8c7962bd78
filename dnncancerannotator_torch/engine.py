'''Training, evaluation and prediction engine (counterpart of
dnncancerannotator_tpu.engine).

``Engine`` builds the configured model on an explicit device, trains it,
evaluates it, enumerates, saves and loads step-indexed checkpoints
(``ckpt-<step>`` directories, the JAX package's names and ordering) and
predicts.

Training (``train``) follows the JAX engine's two input paths:
- device-resident: the whole uint8 training set sits on the device, and
  each step samples its batch there (equal probability per source with
  ``normalize_exams``);
- host streaming, where ``load_resident`` returns None (past its budget,
  ``device_cache: false``, ``loader: grain``): each step takes the next
  batch of ``raw_batches(seed)`` in stream order through a ``_Prefetcher``
  (a producer thread; on a CUDA device pinned host buffers copied on a side
  stream); every ``train`` call restarts the stream from the seed, as the
  JAX engine does;
- the step: uint8 -> /255 -> augmentation chain -> feature/label split ->
  forward -> weighted BCE -> backward (the kernels' autograd Functions) ->
  optimizer step at the schedule's learning rate for that step;
- the loss is the configured loss (label smoothing blurs the labels
  first), plus ``l2 * sum(kernel**2)`` over the conv and transposed-conv
  kernels under ``model_options.kernel_regularizer``; the logged ``loss``
  is the data loss alone;
- ``steps_per_call`` steps run per chunk, a chunk never crosses a
  ``save_freq`` boundary, and each chunk's losses come back to the host in
  one read, where a non-finite loss stops the run; with
  ``deploy_options.debug_asserts`` the loss's checks (utils/checks.py) come
  back in the same read, and a failed one stops the run naming its step;
- with ``deploy_options.metrics``, every step's metrics are computed on its
  own probabilities and labels (reset, update, result) and logged;
- at every ``save_freq`` step (and the last): validation on ``val_data``
  (``val_*`` logs), a checkpoint, and the Visualizer passes; early stopping
  when ``val_loss`` has not improved for ``early_stop_steps`` steps;
- the logs go to ``save_path/tfevents/train`` as scalars; a new ``train``
  call resumes from the newest checkpoint;
- on SIGTERM (with the handler installed from the main thread) the
  chunk in flight finishes, a checkpoint is written at that step unless it
  was just saved, and ``train`` returns; the next call resumes from it;
- with ``profile``, a torch.profiler window over steps [start + 200, start
  + 210) of the call (PROFILE_START, PROFILE_STEPS) is written under
  ``save_path/tfevents/profile``.
The kernel gates come from ``deploy_options`` (ops/gates.py) and are in
scope wherever the Engine runs its model (``Engine.scope``): in training
mode for the train step, in eval mode (BatchNorm on its running statistics)
for validation, evaluation, prediction and the Visualizer.
The augmentation routes by the gates in that scope too (``fused_aug``: the
crop-fused chain; else the warp bank, solved once per Engine, or the
per-step spline solve). The sampler and the augmentation draw from device
generators reseeded at every step from (seed, step), so a resumed run draws
what an unbroken one would (the streamed batches excepted: a resumed call
starts the stream again).

Data parallelism (``deploy_options.enable_multigpu``, default True, as in
the JAX package): in a process group (parallel/multihost.py: one process a
card, NCCL) the Engine is one rank of a data-parallel ``Group``
(parallel/mesh.py) and gives the numbers of one device running the global
batch, up to the order of a sum:
- every rank draws the global batch's indices and augmentation from the
  same generators, seeded from (seed, stream, step), and keeps its rows
  [floor(r B / n), floor((r + 1) B / n)) (a streamed set: every rank reads
  the same global batch and keeps its rows), so a run at any world size,
  and a resume under another one, walks the data of one card;
- a rank's loss is its rows' share of the global mean, and the parameter
  gradients and the loss are summed over the ranks in one all_reduce (the
  kernel regularizer enters once, on rank 0); the positive rate of the loss
  and BatchNorm's statistics and backward sums are the global batch's
  (train/losses.py, models/fastbn.py), and so are the ``debug_asserts``
  checks and the train metrics (the outputs gathered);
- the preempted flag is reduced over the ranks at each chunk's end, so
  every rank stops at the same step;
- evaluation and prediction pad each batch to a multiple of the ranks,
  each rank runs its rows, and the outputs are gathered to every rank;
  rank 0 alone runs the metrics;
- rank 0 alone writes (checkpoints, with every rank waiting for them, the
  logs, the Visualizer's exports, the CSVs, the profile), and every rank
  loads a checkpoint to resume.
At one rank the arithmetic is the one-device arithmetic: the shares are 1.0
and each sum over the ranks is the rank's own value. Without a process
group (or with ``enable_multigpu: false``) there is no Group.

Spatial partitioning (``deploy_options.spatial_partition: N``, the JAX
engine's ``(data, model)`` mesh): the world's ranks form data groups of N
(parallel/mesh.py), each data group takes its rows of every batch as above,
and its N ranks split the image rows in blocks of the model's
``row_block`` (``mesh.split_rows``); a world that N does not divide, a
layout that cannot be split, N > 1 with ``enable_multigpu: false`` or with
no process group raise ValueError:
- augmentation runs on the data group's whole images on every rank of it,
  with the same draws, and the label blur of label smoothing on whole
  planes (``loss.prepare``); then each rank takes its image rows;
- every SAME conv and conv chain of the model exchanges its halo rows
  (models/fastconv.py, blocks.py); the loss is a rank's pixels' share of
  the global mean, and the gradient sum, the positive rate, BatchNorm, the
  checks and the preempted flag span every rank;
- evaluation, prediction, validation, the train metrics and the
  Visualizer (every rank runs its passes, rank 0 writes) gather each
  model group's rows into whole planes before anything reads them;
- checkpoints hold whole parameters: a run resumes under another N.

Evaluation (``eval``) runs the metrics and the Visualizer over a dataset for
every checkpoint of a run, and writes ``results.csv`` and
``casewise_results.csv``; its batches are decoded and copied to the device
by a ``_Prefetcher`` while the one before them computes.

A checkpoint directory ``ckpt-<step>`` is the JAX engine's own: Orbax's
StandardCheckpointHandler layout (ckpt/orbax.py), an OCDBT store of zarr v2
arrays in zstd frames with ``_METADATA`` and, written last when the save
commits, ``_CHECKPOINT_METADATA``. It holds the JAX engine's state tree:
``params`` and ``batch_stats`` (flax paths, HWIO kernels, convert.py),
``step``, and ``opt_state``, the optimizer's optax chain (train/optimizers.py:
``chain``) with its moments under optax's names in the params tree (``mu``
and ``nu`` for Adam, AdamW, Adamax, NAdam and LAMB, ``trace`` for SGD
momentum, ``nu`` and ``trace`` (and ``mu`` when centered) for RMSprop,
``sum_of_squares`` for Adagrad, ``e_g`` and ``e_x`` for Adadelta, ``mu`` for
Lion) and each state's ``count``. So the JAX package's ``load``,
``evaluate``, ``predict`` and ``train`` (resume) take a run the port trained,
and the port's take the JAX package's (``read_ckpt``, without orbax,
tensorstore or a zstd module). ``save_ckpt`` saves in the background as the
JAX engine's AsyncCheckpointer does: it copies the state to host memory,
then a writer thread writes and commits the directory while training goes
on; at most one save is in flight, and ``finalize_checkpoints`` (before
every load, save, resume and evaluate, and at the end of ``train``) waits
for it and raises what its writer raised. ``read_ckpt`` still reads the
port's earlier form, ``params.npz`` and ``opt_state.npz`` (the same flat
keys in numpy archives); nothing writes it any more.
'''

import contextlib
import copy
import functools
import itertools
import logging
import math
import os
import queue
import re
import shutil
import signal
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from . import convert
from . import metrics as metrics_lib
from . import models as models_lib
from .ckpt import orbax as orbax_lib
from .data import augment as augment_mod
from .ops import gates as gates_lib
from .parallel import mesh as mesh_lib
from .parallel import multihost
from .train import losses as losses_lib
from .train import optimizers as optimizers_lib
from .train import schedules as schedules_lib
from .utils import checks as checks_lib
from .utils import tboard
from .utils import viz as viz_lib

logger = logging.getLogger(__name__)

PARAMS_FILE = 'params.npz'
OPT_STATE_FILE = 'opt_state.npz'
# random streams of an Engine, each seeded from (seed, stream[, step])
_BANK, _SAMPLE, _AUGMENT = 0x77a5, 1, 2
# the profiler window of ``train(profile=True)``: steps [start +
# PROFILE_START, start + PROFILE_START + PROFILE_STEPS) of the call, from
# the first chunk that starts inside it to the first that ends past it
PROFILE_START, PROFILE_STEPS = 200, 10


def _stream_seed(*words):
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


def solve_regularizer(spec):
    '''The L2 scale of a ``kernel_regularizer`` spec: 0 for none, ``l2``
    (default 0.01) for ``{'class_name': 'L2' or 'l2', 'config': {...}}``;
    any other spec raises ValueError.'''
    if spec is None:
        return 0.0
    if isinstance(spec, dict) and spec.get('class_name') in ('L2', 'l2'):
        return float((spec.get('config') or {}).get('l2', 0.01))
    raise ValueError(f'Unsupported kernel_regularizer: {spec!r}')


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


class _Prefetcher:
    '''Host -> device pipeline: a producer thread turns the items of
    ``iterator`` into device tensors up to DEPTH ahead of the consumer, so
    host decode and batch assembly overlap the device's work.

    ``to_host(item)`` is the uint8 array of an item; iterating yields
    ``(item, tensor)``. On a CUDA device the producer fills a pinned host
    buffer (one of a ring of DEPTH + 2, each refilled only after its
    last copy has completed) and copies it with ``non_blocking=True`` on a
    side stream; the consumer's stream waits on that copy's event and the
    tensor is ``record_stream``-ed to it, so the caching allocator does not
    hand its memory back while the consumer still reads it. On the CPU the
    tensor shares the host array. An exception of the producer is raised in
    the consumer; ``close()`` (idempotent) stops the producer, closes the
    iterator and joins the thread, and must run on every exit path.'''

    _DONE = object()
    DEPTH = 3
    THREAD_NAME = 'dnnca-prefetch'

    def __init__(self, iterator, device, to_host=lambda item: item):
        self._iterator = iterator
        self._device = torch.device(device)
        self._to_host = to_host
        self._q = queue.Queue(maxsize=self.DEPTH)
        # (pinned buffer, the event of its last copy)
        self._slots = [[None, None] for _ in range(self.DEPTH + 2)]
        self._err = None
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.THREAD_NAME)
        self._thread.start()

    def _put(self, item):
        # bounded put that gives up once the consumer has closed, so the
        # producer never blocks forever holding batch buffers
        while not self._stop:
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, host, slot, side):
        host = np.ascontiguousarray(host)
        if host.dtype != np.uint8:
            raise TypeError(f'prefetched batches are uint8, got {host.dtype}')
        if self._device.type != 'cuda':
            return torch.from_numpy(host), None
        buf, event = self._slots[slot]
        if event is not None:
            event.synchronize()   # this buffer's last copy has completed
        if buf is None or buf.numel() < host.nbytes:
            buf = torch.empty(host.nbytes, dtype=torch.uint8, pin_memory=True)
        pinned = buf[:host.nbytes].view(host.shape)
        np.copyto(pinned.numpy(), host)
        with torch.cuda.stream(side):
            tensor = torch.empty(host.shape, dtype=torch.uint8,
                                 device=self._device)
            tensor.copy_(pinned, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        self._slots[slot] = [buf, event]
        return tensor, event

    def _run(self):
        try:
            side = None
            guard = contextlib.nullcontext()
            if self._device.type == 'cuda':
                guard = torch.cuda.device(self._device)
            with guard:
                if self._device.type == 'cuda':
                    side = torch.cuda.Stream(self._device)
                for n, item in enumerate(self._iterator):
                    if self._stop:
                        return
                    tensor, event = self._to_device(
                        self._to_host(item), n % len(self._slots), side)
                    if not self._put((item, tensor, event)):
                        return
        except BaseException as exc:   # raised again in the consumer
            self._err = exc
        finally:
            close = getattr(self._iterator, 'close', None)
            if close is not None:
                close()
            self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        got = self._q.get()
        if got is self._DONE:
            self._q.put(self._DONE)   # every later call ends too
            if self._err is not None:
                raise self._err
            raise StopIteration
        item, tensor, event = got
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            tensor.record_stream(stream)
        return item, tensor

    def close(self):
        '''Stop the producer, drop the queued batches and join the thread.'''
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30)


class _Save(threading.Thread):
    '''A checkpoint writer: runs ``write`` once and keeps what it raised.
    Not a daemon, so a process that ends with a save in flight waits for it
    to commit.'''

    def __init__(self, path, write):
        super().__init__(name=f'save {os.path.basename(path)}')
        self.path = path
        self._write = write
        self.error = None

    def run(self):
        try:
            self._write()
        except BaseException as exc:  # raised by finalize_checkpoints
            self.error = exc


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


def read_ckpt(path, opt_state=True):
    '''The checkpoint directory ``path`` as one flat dict of numpy arrays
    (the flax-keyed params, and with ``opt_state`` the optimizer's entries
    and ``step``): an Orbax checkpoint (ckpt/orbax.py), as the JAX engine
    and the port save them, or the port's earlier ``params.npz`` and
    ``opt_state.npz``.'''
    params_path = os.path.join(path, PARAMS_FILE)
    if os.path.isfile(params_path):
        with np.load(params_path) as npz:
            flat = {key: npz[key] for key in npz.files}
        opt_path = os.path.join(path, OPT_STATE_FILE)
        if opt_state and os.path.isfile(opt_path):
            with np.load(opt_path) as npz:
                flat.update((key, npz[key]) for key in npz.files)
        return flat
    if orbax_lib.is_checkpoint(path):
        return orbax_lib.read_checkpoint(path, opt_state=opt_state)
    raise ValueError(
        f'{path} holds neither checkpoint format: the port\'s '
        f'({PARAMS_FILE}) or the JAX package\'s Orbax checkpoint '
        f'({orbax_lib.METADATA} and {orbax_lib.ocdbt.MANIFEST})')


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
        # compute precision of the conv stack; parameters, optimizer state,
        # BatchNorm statistics and checkpoints stay f32 (engine.py:151-154)
        self.compute_dtype = (torch.bfloat16 if deploy.get('precision') in (
            'bfloat16', 'bf16') else None)
        self.debug_asserts = bool(deploy.get('debug_asserts', False))
        self.enable_multigpu = bool(deploy.get('enable_multigpu', True))
        self.spatial = int(deploy.get('spatial_partition', 1))
        self.schedule = schedules_lib.solve_schedule(
            deploy.get('LearningRateScheduler'))
        self.steps_per_call = int(deploy.get('steps_per_call', 1))
        self.metric_specs = deploy.get('metrics') or []
        self.max_checkpoints_to_keep = deploy.get('max_checkpoints_to_keep')
        self.warp_bank_size = int(deploy.get('warp_bank_size', 512))
        self.gates = gates_lib.KernelGates.from_deploy_options(deploy)
        self.l2_scale = solve_regularizer(
            self.model_config['model_options'].get('kernel_regularizer'))
        self.model_name = model_config['model']
        self.device = resolve_device(device)
        # the group (None: one rank, no collectives; raises for a
        # spatial_partition it cannot run), this data group's rows (lo, hi)
        # of a training batch of B rows, (lo, hi, B), and the split of its
        # image rows over the model group (set by _setup_training)
        self.group = mesh_lib.group(self.enable_multigpu, self.spatial)
        self._rows = self._bounds = None
        self.model = None
        self.optimizer = None
        self.loss = None
        self.current_step = 0
        self._bank_cache = {}
        # (step, check messages, device vector) of each train step's
        # debug_asserts checks, read with its chunk's losses
        self._check_log = []
        # the checkpoint save in flight (a _Save), and whether a save was
        # started since the last finalize_checkpoints (on every rank)
        self._save = None
        self._save_pending = False

    def build(self, input_shape):
        '''Build the model for [B, H, W, C] inputs with seeded glorot
        weights (idempotent).'''
        if self.model is not None:
            return
        generator = torch.Generator().manual_seed(self.seed)
        model, _ = models_lib.build_model(
            self.model_name, self.model_config['model_options'],
            in_channels=input_shape[-1], generator=generator,
            dtype=self.compute_dtype)
        self.model = model.to(self.device).eval()
        if self.group is not None:
            # every rank starts from rank 0's weights
            self.group.broadcast_([t.detach() for t in itertools.chain(
                self.model.parameters(), self.model.buffers())])
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
        '''Save ``ckpt-<step>`` under ``base_path`` as the JAX engine does,
        in the background: the model's and the optimizer's state are copied
        to host memory here, the one blocking part (blocking copies, so
        nothing the next step does reaches them), then a writer thread
        writes the Orbax checkpoint (ckpt/orbax.py) while training goes on.
        At most one save is in flight: this first waits for the one before
        (finalize_checkpoints), then removes the committed checkpoints past
        the newest ``max_checkpoints_to_keep`` counting this one. In a
        process group every rank calls this at the same steps and rank 0
        writes. Returns the checkpoint's path.'''
        self.finalize_checkpoints()
        path = os.path.join(base_path, f'ckpt-{step}')
        self._save_pending = True
        if multihost.is_primary():
            snapshot = self._snapshot(step)
            self._prune_ckpts(base_path, step)
            self._save = _Save(path, functools.partial(
                self._write_ckpt, path, snapshot))
            self._save.start()
        return path

    def finalize_checkpoints(self):
        '''Wait until the save in flight commits; an error of its writer
        raises here. In a process group every rank then meets at a barrier
        (after a save, as each rank knows), so no rank reads a checkpoint
        before it commits.'''
        save, self._save = self._save, None
        pending, self._save_pending = self._save_pending, False
        if save is not None:
            save.join()
        if pending and self.group is not None:
            self.group.barrier(self.device)
        if save is not None and save.error is not None:
            raise save.error

    def save(self, path):
        '''Write the current state to ``path`` as the JAX engine's Orbax
        checkpoint, synchronously (the JAX engine's ``save``). An engine
        that has not trained writes its optimizer's initial state.'''
        if self.model is None:
            raise RuntimeError('nothing to save; call build() first')
        self.finalize_checkpoints()
        if multihost.is_primary():
            self._write_ckpt(path, self._snapshot(self.current_step))
        if self.group is not None:
            self.group.barrier(self.device)
        return self

    def _snapshot(self, step):
        '''What a checkpoint of ``step`` holds, copied to host memory:
        (step, model state_dict, optimizer, {param name: {state key:
        tensor}} of every parameter, the update count or None). The writer
        thread reads nothing else of the engine.'''
        def host(t):
            return t.detach().to('cpu', copy=True)

        optimizer = self.optimizer
        if optimizer is None:
            # not set up to train: the config's optimizer gives the chain
            # and the initial state
            optimizer, _ = optimizers_lib.solve_optimizer(
                self.model_config['deploy_options'].get('optimizer', 'adam'),
                self.model.parameters(), self.schedule)
        keys = optimizers_lib.state_names(optimizer)
        names = {p: n for n, p in self.model.named_parameters()}
        state, counts = {n: {} for n in names.values()}, []
        for p, st in optimizer.state.items():
            state[names[p]] = {k: host(st[k]) for k in keys
                               if torch.is_tensor(st.get(k))}
            if 'step' in st:
                counts.append(int(st['step']))
        model = {k: host(v) for k, v in self.model.state_dict().items()}
        return (step, model, optimizer, state,
                counts[0] if counts else None)

    def _write_ckpt(self, path, snapshot):
        step, model, optimizer, _, _ = snapshot
        flat = convert.flax_from_torch_state(model)
        flat.update(self._opt_state_flat(step, snapshot))
        orbax_lib.write_checkpoint(path, flat, optimizers_lib.chain(
            optimizer))
        logger.info('Saved checkpoint %s', path)

    def _prune_ckpts(self, base_path, step):
        '''Remove the oldest committed checkpoints, leaving room for the
        save of ``step`` within ``max_checkpoints_to_keep`` (a checkpoint
        being written is not yet listed).'''
        if not self.max_checkpoints_to_keep:
            return
        ckpts = self.get_ckpts(base_path)
        ckpts.pop(step, None)   # the save replaces it
        for old in list(ckpts)[:max(
                len(ckpts) - int(self.max_checkpoints_to_keep) + 1, 0)]:
            shutil.rmtree(ckpts[old], ignore_errors=True)
            logger.info('Pruned checkpoint %s', ckpts[old])

    def _opt_state_flat(self, step, snapshot=None):
        '''The optimizer's per-parameter state by optax name and flax path
        (a parameter it has no state for yet at the state's initial value),
        ``count`` (the update count) and the step; of ``snapshot``, else
        of the live optimizer.'''
        if snapshot is None:
            snapshot = self._snapshot(step)
        _, model, optimizer, state, count = snapshot
        flat = {'step': np.asarray(step, np.int32),
                'count': np.asarray(step if count is None else count,
                                    np.int32)}
        for key, optax_name in optimizers_lib.state_names(optimizer).items():
            init = optimizers_lib.initial_value(optimizer, key)
            values = {n: st.get(key) for n, st in state.items()}
            values = {n: torch.full_like(model[n], init) if v is None else v
                      for n, v in values.items()}
            for path, value in convert.flax_from_torch_state(values).items():
                flat[f'{optax_name}/{path}'] = value
        return flat

    def _load_opt_state(self, flat):
        '''Set the optimizer's state from a checkpoint's flat dict: its
        ``<optax name>/params/...`` moments, at ``count`` (an Orbax
        checkpoint's update count) or else ``step``.'''
        params = dict(self.model.named_parameters())
        expected = {name: p.detach() for name, p in params.items()}
        step = float(flat['count'] if 'count' in flat else flat['step'])
        for key, optax_name in optimizers_lib.state_names(
                self.optimizer).items():
            group = {k.split('/', 1)[1]: v for k, v in flat.items()
                     if k.split('/', 1)[0] == optax_name}
            if not group:
                continue
            state = convert.torch_state_from_flax(group, expected=expected)
            for name, value in state.items():
                entry = self.optimizer.state[params[name]]
                entry[key] = value.to(self.device)
                entry['step'] = torch.tensor(step)

    def load(self, path):
        '''Load a checkpoint directory (the port's or the JAX package's,
        ``read_ckpt``) into the built model, and its optimizer state when it
        has one and the engine is set up to train.'''
        if self.model is None:
            raise RuntimeError('call build() before load()')
        self.finalize_checkpoints()
        flat = read_ckpt(path, opt_state=self.optimizer is not None)
        model_flat = {k: v for k, v in flat.items()
                      if k.split('/', 1)[0] in ('params', 'batch_stats')}
        state = convert.torch_state_from_flax(
            model_flat, expected=self.model.state_dict())
        self.model.load_state_dict(state)
        opt_flat = {k: v for k, v in flat.items() if k not in model_flat}
        if self.optimizer is not None and opt_flat:
            self._load_opt_state(opt_flat)
        return self

    def _auto_resume(self, base_path):
        self.finalize_checkpoints()
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
        chain for ``dataset``.'''
        deploy = self.model_config['deploy_options']
        self.build(dataset.feature_shape)
        self._solve_loss()
        if self.optimizer is None:
            self.optimizer, self.schedule = optimizers_lib.solve_optimizer(
                deploy.get('optimizer', 'adam'), self.model.parameters(),
                self.schedule)
        if self.group is not None:
            self._rows = (*self.group.shard_rows(dataset.batch_size),
                          dataset.batch_size)
            self._bounds = self._split(dataset.feature_shape[1])
        self._augment = augment_mod.build_augment_fn(
            dataset.augment_methods, warp_bank=self._warp_bank(dataset),
            rows=self._rows)
        self._slice_types = dataset.slice_types

    def _split(self, h):
        '''The boundaries of ``h`` image rows over this rank's model group
        (``mesh.split_rows`` by the model's block), or None at N = 1.'''
        if self.spatial == 1:
            return None
        return mesh_lib.split_rows(h, self.model.row_block, self.spatial)

    def _shard(self, valid, total, h):
        '''The Shard of a step on ``valid`` real of this data group's
        batch rows, of ``total``, with planes of ``h`` rows.'''
        return mesh_lib.Shard(self.group, valid, total, self._split(h))

    def _solve_loss(self):
        if self.loss is None:
            self.loss = losses_lib.solve_loss(
                self.model_config['deploy_options'].get(
                    'loss', 'WeightedCrossentropy'))
        return self.loss

    def regularization(self):
        '''``l2 * sum(w**2)`` over the parameters whose flax path ends in
        ``kernel`` (the conv and transposed-conv kernels, not biases or
        BatchNorm), on the parameters' own (f32) values; None without a
        kernel regularizer.'''
        if not self.l2_scale:
            return None
        kernels = [p for name, p in self.model.named_parameters()
                   if convert.flax_key(name).endswith('/kernel')]
        return self.l2_scale * torch.stack([p.square().sum()
                                            for p in kernels]).sum()

    def _build_metrics(self):
        return [metrics_lib.solve_metric(s) for s in self.metric_specs]

    def _warp_bank(self, dataset):
        '''The warp bank (solved once per Engine and chain) when the
        ``warp_bank`` gate is on (the default) and the chain crops
        before a two-pass warp, else None. None too when the chain will run
        fused (the ``fused_aug`` gate on and the chain eligible), which
        reads no bank: the JAX engine solves one there all the same and
        never uses it. The bank draws from its own generator stream, so
        skipping it changes no other draw.'''
        methods = dataset.augment_methods
        with gates_lib.active(self.gates):
            if augment_mod.routes_fused(methods, dataset.element_shape):
                return None
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
                    if self.group is not None:
                        # one bank for every rank: the spline solve's last
                        # bits may differ between processes
                        self.group.broadcast_([bank['flows']])
            self._bank_cache[key] = bank
        return self._bank_cache[key]

    def _resident(self, dataset):
        '''The training set on the device (cached on the dataset):
        (uint8 pool [N, h, w, C], starts, counts, balanced); None where
        ``load_resident`` returns None and the set streams from the host
        (remembered on the dataset too).'''
        cached = getattr(dataset, '_device_pool', None)
        if cached is False:
            return None
        if cached is None or cached[0].device != self.device:
            host = dataset.load_resident()
            if host is None:
                logger.info('Streaming the training set from the host')
                dataset._device_pool = False
                return None
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
        and labels [B, h, w] (for the train metrics). In a data-parallel
        run ``raw`` is this data group's rows of the global batch, and the
        loss, the gradients and the outputs are the global batch's; under
        ``spatial_partition`` the rank augments the whole images and runs
        its image rows.'''
        for group in self.optimizer.param_groups:
            group['lr'] = self.schedule(step)
        self.optimizer.zero_grad(set_to_none=True)
        shard = None
        if self.group is not None:
            lo, hi, b = self._rows
            shard = mesh_lib.Shard(self.group, hi - lo, b, self._bounds)
        take = shard.take if shard is not None else (lambda t: t)
        with mesh_lib.active(shard):
            with self.scope(training=True):
                images = self._augment(raw.float() / 255.0, gen)
                x, y = augment_mod.to_feature_label(images,
                                                    self._slice_types)
                logits = self.model(take(x), return_logits=True)
            with checks_lib.collect(self.debug_asserts) as found:
                # the label blur on whole planes, then this rank's rows
                loss = self.loss(take(self.loss.prepare(y)), logits,
                                 prepared=True)
        if found:
            self._check_log.append((step + 1, [m for m, _ in found],
                                    torch.cat([v for _, v in found])))
        if shard is None:
            reg = self.regularization()
        else:
            # this rank's share of the global mean; the regularizer once
            loss = loss * shard.share()
            reg = self.regularization() if self.group.rank == 0 else None
        (loss if reg is None else loss + reg).backward()
        if shard is not None:
            loss = self._sum_gradients(loss)
        self.optimizer.step()
        if not outputs:
            return loss.detach()
        probs = torch.sigmoid(logits.detach()[..., 0])
        if shard is not None:
            y = take(y)
            image = shard.rows if shard.spatial else None
            probs, y = (self.group.gather(t, lo, b, image)
                        for t in (probs, y))
        return loss.detach(), probs, y

    def _sum_gradients(self, loss):
        '''Sum every parameter's gradient and ``loss`` over every rank (the
        data groups' and, within each, the model group's) in one all_reduce
        of a flat buffer; returns the summed loss. (Every rank runs the
        same graph, so the same parameters have gradients.)'''
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        flat = self.group.all_reduce_sum(torch.cat(
            [g.reshape(-1) for g in grads] + [loss.detach().reshape(1)]))
        summed = flat[:-1].split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [s.view_as(g)
                                     for s, g in zip(summed, grads)])
        return flat[-1]

    def train(self, dataset, val_data=None, save_path=None, save_freq=100,
              max_steps=None, early_stop_steps=None, visualization=None,
              auto_resume=True, log_every=50, steps_per_call=None,
              profile=False):
        '''Train for ``max_steps`` steps in all (1 step == 1 reference
        "epoch"), checkpointing under ``save_path`` every ``save_freq``
        steps, validating on ``val_data`` there and running the Visualizer
        of each ``visualization`` {tag: EvalDataset}; with ``profile``,
        a torch.profiler trace of the window PROFILE_START.. of the call
        under ``save_path/tfevents/profile``. Returns TrainResults of this
        call's steps.'''
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
        group, primary = self.group, multihost.is_primary()
        writer, viz_callbacks = None, []
        tb_dir = os.path.join(save_path, 'tfevents') if save_path else None
        if save_path and primary:
            writer = tboard.SummaryWriter(os.path.join(tb_dir, 'train'))
        if save_path and (primary or self.spatial > 1):
            # under spatial_partition every rank runs the passes' forwards
            viz_callbacks = [viz_lib.Visualizer(tag, viz_ds, save_freq, tb_dir,
                                                follower=not primary)
                             for tag, viz_ds in (visualization or {}).items()]
        sample_gen = torch.Generator(device=self.device)
        aug_gen = torch.Generator(device=self.device)
        start_step = step = self.current_step
        best_val, best_step = float('inf'), step
        saved_at = step if ckpt_dir and step in self.get_ckpts(ckpt_dir) \
            else None
        stop = profiled = False
        window = None   # (profiler, its first step) while it records
        # preemption: SIGTERM lets the chunk in flight finish, then stops
        # at a checkpoint (a handler can only be installed from the main
        # thread; elsewhere save_freq alone bounds the loss); in a group
        # every rank stops after the chunk at whose end any rank had it
        preempted = []
        stopping = preempted if group is None else []
        on_main = threading.current_thread() is threading.main_thread()
        if on_main:
            old_handler = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM, lambda *_: preempted.append(True))
        # host streaming: each train call starts the stream from the seed
        # (in a group every rank reads the global batch and keeps its rows)
        stream = None
        if resident is None and step < max_steps:
            stream = _Prefetcher(
                dataset.raw_batches(seed=self.seed), self.device,
                to_host=((lambda batch: batch) if self._rows is None else
                         (lambda batch: batch[self._rows[0]:self._rows[1]])))
        t_start = time.perf_counter()
        try:
            while step < max_steps and not stopping:
                if profile and save_path and primary and not profiled and \
                        step >= start_step + PROFILE_START:
                    window, profiled = (self._start_profiler(), step), True
                boundary = min(max_steps, (step // save_freq + 1) * save_freq)
                chunk = []
                self._check_log = []
                for s in range(step, min(step + spc, boundary)):
                    aug_gen.manual_seed(_stream_seed(self.seed, _AUGMENT, s))
                    if stream is not None:
                        raw = self._next_streamed(stream, s)
                    else:
                        sample_gen.manual_seed(
                            _stream_seed(self.seed, _SAMPLE, s))
                        raw = self.sample_batch(resident, dataset.batch_size,
                                                sample_gen)
                        if self._rows is not None:   # this rank's rows
                            raw = raw[self._rows[0]:self._rows[1]]
                    chunk.append(self.train_step(
                        raw, s, aug_gen, outputs=bool(train_metrics)))
                outs = chunk if train_metrics else [(c,) for c in chunk]
                # the chunk's one host read: its losses and its checks (in a
                # group the global batch's, and whether any rank was
                # preempted, last)
                checks = [v for _, _, v in self._check_log]
                if group is not None:
                    checks = [checks_lib.span_ranks(
                        group, torch.cat(checks) if checks else torch.zeros(
                            0, device=self.device), [bool(preempted)])]
                values = torch.cat([torch.stack([o[0] for o in outs])] +
                                   checks).tolist()
                if group is not None and values.pop():
                    stopping.append(True)
                losses = values[:len(outs)]
                checks_lib.raise_failed(
                    [(at, names) for at, names, _ in self._check_log],
                    values[len(outs):])
                if not all(map(math.isfinite, losses)):
                    raise FloatingPointError(
                        f'non-finite loss in steps {step + 1}-'
                        f'{step + len(losses)}: {losses}')
                for out, loss in zip(outs, losses):
                    step += 1
                    logs = {'loss': loss, 'lr': self.schedule(step - 1)}
                    for metric in train_metrics if primary else ():
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
                        saved_at = step
                    if at_save:
                        for callback in viz_callbacks:
                            callback.on_step(self, step)
                if window and step >= (start_step + PROFILE_START +
                                       PROFILE_STEPS):
                    self._stop_profiler(*window, step, save_path)
                    window = None
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
            if stream is not None:
                stream.close()
            if on_main:
                signal.signal(signal.SIGTERM, signal.SIG_DFL
                              if old_handler is None else old_handler)
            if window:
                self._stop_profiler(*window, step, save_path)
            self._check_log = []
            if writer:
                writer.close()
            for callback in viz_callbacks:
                callback.close()
        if stopping and ckpt_dir and saved_at != step:
            logger.warning('Preempted (SIGTERM) at step %d: saving a '
                           'checkpoint', step)
            self.save_ckpt(ckpt_dir, step)
        self.finalize_checkpoints()
        return results

    @staticmethod
    def _next_streamed(stream, step):
        '''The next batch of a training stream, for step ``step`` (0-based).'''
        try:
            return next(stream)[1]
        except StopIteration:
            raise RuntimeError(
                f'the training stream ended before step {step + 1} '
                '(data_options.train.repeat is false)') from None

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, first, last, save_path):
        '''Stop the window over steps (first, last] and write its trace
        (Chrome JSON, which TensorBoard's profiler plugin reads) under
        ``save_path/tfevents/profile``.'''
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        profiler.stop()
        out_dir = os.path.join(save_path, 'tfevents', 'profile')
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f'steps-{first + 1}-{last}.pt.trace.json')
        profiler.export_chrome_trace(path)
        logger.info('Wrote the profiler trace %s', path)

    # -- evaluation and prediction ---------------------------------------------
    def _make_eval_step(self, slice_types):
        '''The forward step of evaluation: uint8 [B, H, W, C] batch (host
        array or tensor) ->
        (per-slice loss [B], probabilities [B, H, W, 1], labels [B, H, W]),
        on the device. The batch is not padded, so a short last batch gives
        the per-slice losses of the JAX step, which pads and masks it. In a
        data-parallel run the batch is padded to a multiple of the data
        groups, each rank runs its rows (the loss's positive rate over the
        real rows of all), and every rank gets the whole batch's outputs;
        under ``spatial_partition`` a rank runs its image rows of them, and
        the outputs come back as whole planes (the per-slice loss the sum
        of the ranks' shares).'''
        model, device, group = self.model, self.device, self.group
        slice_types = tuple(slice_types)
        loss = self._solve_loss()

        @torch.no_grad()
        def step(raw_batch):
            images = raw_batch if torch.is_tensor(raw_batch) else \
                torch.from_numpy(np.asarray(raw_batch))
            n, shard = images.shape[0], None
            if group is not None:
                images, valid = group.shard_batch(images)
                shard = self._shard(valid, n, images.shape[1])
            images = images.to(device).to(torch.float32) / 255.0
            x, y = augment_mod.to_feature_label(images, slice_types)
            if shard is None:
                with self.scope():
                    logits = model(x, return_logits=True)
                return (loss.per_sample(y, logits), torch.sigmoid(logits), y)
            with mesh_lib.active(shard):
                with self.scope():
                    logits = model(shard.take(x), return_logits=True)
                per_sample = loss.per_sample(shard.take(loss.prepare(y)),
                                             logits, prepared=True)
            per, image = y.shape[0], None
            if shard.spatial:
                lo, hi, h = image = shard.rows
                per_sample = per_sample * ((hi - lo) / h)
            return tuple(group.gather(t, group.part * per, per * group.parts,
                                      i)[:n]
                         for t, i in ((per_sample, None),
                                      (torch.sigmoid(logits), image),
                                      (shard.take(y), image)))

        return step

    def visual_batch(self, raw, slice_types, sensitivity=False):
        '''(features, labels, probabilities [B, H, W, 1], per-channel
        sensitivity [B, C] or zeros) of a uint8 batch, on the device, in
        eval mode: the Visualizer's forward. Under ``spatial_partition``
        each rank of a model group runs its image rows of the whole batch
        (every rank must call this), and the probabilities and the input
        gradient come back as whole planes before the sensitivity's
        sums.'''
        images = torch.from_numpy(np.asarray(raw)).to(self.device)
        x, y = augment_mod.to_feature_label(images.float() / 255.0,
                                            slice_types)
        shard = None
        if self.spatial > 1:
            shard = self._shard(x.shape[0], x.shape[0], x.shape[1])
        take = shard.take if shard is not None else (lambda t: t)
        with mesh_lib.active(shard), self.scope():
            if sensitivity:
                probs, grad = viz_lib.input_gradient(self.model, take(x))
            else:
                with torch.no_grad():
                    probs = self.model(take(x))
        if shard is not None:
            gather = functools.partial(self.group.gather, start=0,
                                       total=x.shape[0], image=shard.rows,
                                       group=self.group.model_group)
            probs = gather(probs)
            grad = gather(grad) if sensitivity else None
        sens = viz_lib.sensitivity(grad) if sensitivity else torch.zeros(
            x.shape[0], x.shape[-1])
        return x, y, probs, sens

    def _eval_dataset(self, eval_step, dataset, metrics):
        '''One pass over an EvalDataset: {'loss': mean per-slice loss,
        metric name: result}. A ``_Prefetcher`` decodes the next batch and
        copies it to the device while this one computes; the short last
        batch stays as it is.'''
        losses = []
        # in a group every rank gets the whole batch's outputs, and rank 0
        # alone runs the metrics
        metrics = metrics if multihost.is_primary() else []
        batches = _Prefetcher(dataset.batches(), self.device,
                              to_host=lambda batch: batch['slices'])
        try:
            for _batch, raw in batches:
                loss_vec, probs, y = eval_step(raw)
                losses.append(loss_vec.cpu().numpy())
                for metric in metrics:
                    metric.update_state(y, probs)
        finally:
            # a failing step or metric must not leave the producer running
            batches.close()
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
        self.finalize_checkpoints()   # a save of this engine still in flight
        ckpt_path = os.path.join(save_path, 'checkpoints')
        export_path = export_path or os.path.join(save_path, 'tfevents')
        while os.path.exists(os.path.join(export_path, tag)):
            if not avoid_overwrite:
                raise ValueError(f'tag: {tag} already exists.')
            tag += '_'
        primary = multihost.is_primary()
        if self.group is not None:
            # every rank has chosen the tag before rank 0 writes under it
            self.group.barrier(self.device)
        if step_range is None:
            step_range = (0, float('inf'))
        elif len(step_range) != 2 or not 0 <= step_range[0] <= step_range[1]:
            raise ValueError(f'bad step_range {step_range}')
        eval_step = self._make_eval_step(dataset.slice_types)
        viz_callback = None
        casewise = [] if export_csv else None
        if viz_ds is not None and (primary or self.spatial > 1):
            viz_callback = viz_lib.Visualizer(
                tag, viz_ds, 1, save_dir=export_path, ignore_test=False,
                export_images=export_images, export_csv=export_csv,
                visualize_sensitivity=visualize_sensitivity, overlay=overlay,
                # as in the JAX package, casewise rows are computed when
                # export_csv consumes them or when asked for
                export_casewise_metrics=export_casewise_metrics or export_csv,
                casewise_metrics_container=casewise, follower=not primary)
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
        if export_csv and primary:
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

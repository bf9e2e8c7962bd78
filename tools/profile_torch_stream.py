'''Where the streamed train step loses time against the resident one, on
one GPU: python3 tools/profile_torch_stream.py [--calls 3]

Trains chip_smoke.py phase 5's configuration (the unet.yaml stack, B=8 of
256 x 256 crops of seeded 512 x 512 exams, banked warp, steps_per_call 25)
and prints the train throughput of each input route, measured as phase 5
measures it (the difference of 25- and 100-step ``Engine.train`` calls,
each the minimum of ``--calls``, the routes in turns):

- ``resident``: the set on the device, the batch gathered there;
- ``streamed``: ``raw_batches(seed)`` through ``engine._Prefetcher`` as
  shipped (pinned buffers, a side stream, ``record_stream``);
- ``streamed, cached batches``: the prefetcher over batches made before
  the call (no decode, shuffle or stack on the host during it);
- ``streamed, inline``: the stream read and copied on the training thread
  (no producer thread);
- ``streamed, switch 0.5 ms``: as shipped with the interpreter's switch
  interval at 0.5 ms instead of 5 ms;
- ``streamed, no record_stream``: as shipped without ``record_stream`` (the
  caching allocator's cross-stream events; unsafe in general, measured
  only);
- ``streamed, consumer copy``: the producer fills the pinned buffers only,
  and the training thread copies each one on its own stream when it takes
  it (no side stream, no event between streams, no ``record_stream``; a
  buffer is refilled after its copy's event).

Then the host producer alone (``raw_batches`` on the host, ms a batch),
and with ``--cprofile`` the training thread's functions by own time over
100 steps of the resident and the streamed route (cProfile). Every line
carries the card's name and power limit.
'''

import argparse
import contextlib
import itertools
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


class _Cached:
    '''An endless cycle over batches made before the call.'''

    def __init__(self, batches):
        self.batches = batches

    def raw_batches(self, seed=None):
        del seed
        return itertools.cycle(self.batches)


def _consumer_copy(engine):
    '''A _Prefetcher whose producer only fills pinned buffers; the consumer
    copies each on its own stream and records the event its buffer's
    refill waits on (a buffer comes round again only after depth + 1
    later items, so its copy has been issued by then).'''

    class ConsumerCopy(engine._Prefetcher):
        def _to_device(self, host, slot, side):
            host = np.ascontiguousarray(host)
            buf, event = self._slots[slot]
            if event is not None:
                event.synchronize()
            if buf is None or buf.numel() < host.nbytes:
                buf = torch.empty(host.nbytes, dtype=torch.uint8,
                                  pin_memory=True)
            pinned = buf[:host.nbytes].view(host.shape)
            np.copyto(pinned.numpy(), host)
            event = torch.cuda.Event()
            self._slots[slot] = [buf, event]
            return pinned, event

        def __next__(self):
            got = self._q.get()
            if got is self._DONE:
                self._q.put(self._DONE)
                if self._err is not None:
                    raise self._err
                raise StopIteration
            item, pinned, event = got
            tensor = pinned.to(self._device, non_blocking=True)
            event.record()
            return item, tensor

    return ConsumerCopy


@contextlib.contextmanager
def _switch_interval(seconds):
    old = sys.getswitchinterval()
    sys.setswitchinterval(seconds)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


@contextlib.contextmanager
def _no_record_stream():
    record = torch.Tensor.record_stream
    torch.Tensor.record_stream = lambda self, stream: None
    try:
        yield
    finally:
        torch.Tensor.record_stream = record


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--calls', type=int, default=3)
    parser.add_argument('--cprofile', action='store_true')
    args = parser.parse_args()
    smi = cs.environment()
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    device = engine.resolve_device('cuda')
    cs.build()
    os.makedirs(cs.WORK, exist_ok=True)
    paths = cs.write_records(os.path.join(cs.WORK, 'stream_data'),
                             cs.EXAM_SIZE, cs.TRAIN_EXAMS, cs.TRAIN_SLICES)
    config = cs._config(cs.CONFIGS)
    config['deploy_options']['steps_per_call'] = cs.STEPS_PER_CALL
    opts = config['data_options']['train']

    def streamed():
        return pipeline.train_ds(paths, **dict(opts, device_cache=False))

    host = list(itertools.islice(streamed().raw_batches(cs.SEED), 64))
    cached = streamed()
    cached.raw_batches = _Cached(host).raw_batches
    inline = contextlib.nullcontext
    routes = {
        'resident': (pipeline.train_ds(paths, **opts), inline),
        'streamed': (streamed(), inline),
        'streamed, cached batches': (cached, inline),
        'streamed, inline': (streamed(), lambda: cs._swapped(
            engine, '_Prefetcher', cs._InlineBatches)),
        'streamed, switch 0.5 ms': (streamed(),
                                    lambda: _switch_interval(5e-4)),
        'streamed, no record_stream': (streamed(), _no_record_stream),
        'streamed, consumer copy': (streamed(), lambda: cs._swapped(
            engine, '_Prefetcher', _consumer_copy(engine))),
    }
    engines = {}
    for name, (ds, scope) in routes.items():
        eng = engine.Engine(config, seed=cs.SEED, device=device)
        if engines:
            eng._bank_cache = next(iter(engines.values()))._bank_cache
        with scope():
            eng.train(ds, max_steps=10, save_freq=1 << 30)
        engines[name] = eng
    short, long = 25, 100
    times = {}
    for n in (short, long):
        for _ in range(args.calls):
            for name, (ds, scope) in routes.items():
                eng = engines[name]
                with scope():
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    eng.train(ds, max_steps=eng.current_step + n,
                              save_freq=1 << 30)
                    torch.cuda.synchronize()
                times.setdefault((name, n), []).append(
                    time.perf_counter() - start)
    base = None
    for name in routes:
        rate = (long - short) * cs.TRAIN_BATCH / (
            min(times[name, long]) - min(times[name, short]))
        base = base or rate
        step_ms = (min(times[name, long]) - min(times[name, short])) / (
            long - short) * 1e3
        print(f'{name:28s} {rate:8.2f} slices/s  {step_ms:6.3f} ms a step  '
              f'{rate / base:.3f} of resident  [{smi}]', flush=True)

    it = streamed().raw_batches(cs.SEED)
    next(it)
    start = time.perf_counter()
    for _ in range(200):
        next(it)
    print(f'host producer alone: '
          f'{(time.perf_counter() - start) / 200 * 1e3:.3f} ms a batch '
          f'[{smi}]', flush=True)
    if args.cprofile:
        import cProfile
        import pstats
        for name in ('resident', 'streamed'):
            ds, scope = routes[name]
            eng = engines[name]
            prof = cProfile.Profile()
            with scope():
                torch.cuda.synchronize()
                prof.enable()
                eng.train(ds, max_steps=eng.current_step + 100,
                          save_freq=1 << 30)
                torch.cuda.synchronize()
                prof.disable()
            print(f'-- {name}: the training thread, 100 steps, by own time '
                  f'[{smi}]', flush=True)
            pstats.Stats(prof, stream=sys.stdout).sort_stats(
                'tottime').print_stats(18)


if __name__ == '__main__':
    main()

'''Where a served request's time goes, on one GPU:
python3 tools/profile_torch_serve.py [--batches 1 8 64] [--runs 10]

Exports a seeded unet.yaml run (chip_smoke.py's ``write_save_path``: the
unet.yaml stack, 256 x 256, non-zero biases) with ``export_model``, loads
it on the card and times, at each batch of phase 4's first record slices,
in turns (host clock, the median of ``--runs`` after one warm-up):

- ``direct``: ``load_exported``'s function on the main thread, the maps
  copied to the host (``.cpu().numpy()``);
- ``fresh thread``: the same on a new thread a call, as the threading
  server runs each request;
- ``npy``: ``np.save`` of the request and ``np.load`` of it, and the same
  of the answer: the serialisation both ends do;
- ``http``: ``urlopen(...).read()`` of a POST /predict to the server as
  shipped (one worker thread runs the device work);
- ``http, a thread a request``: the same server with the device work run
  on the request's own thread under a lock, as the JAX server runs it;
- ``http, TCP_NODELAY``: the shipped server with Nagle's algorithm off
  on its sockets;
- ``http, refused``: a body of the same size with one wrong dimension,
  which the server answers with a 400 after ``np.load`` and before any
  device work: the transport and parsing alone.

Every line carries the card's name and power limit.
'''

import argparse
import concurrent.futures
import contextlib
import io
import os
import shutil
import statistics
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


class _OnCaller:
    '''An executor that runs each call on the submitting thread, one at a
    time.'''

    def __init__(self):
        self.lock = threading.Lock()

    def submit(self, fn):
        future = concurrent.futures.Future()
        with self.lock:
            future.set_result(fn())
        return future

    def shutdown(self):
        pass


@contextlib.contextmanager
def _server(path, nodelay=False, on_caller=False):
    from dnncancerannotator_torch.runs.serve import make_server
    server = make_server(path, port=0, device='cuda')
    server.RequestHandlerClass.disable_nagle_algorithm = nodelay
    if on_caller:
        server.worker.shutdown()
        server.worker = _OnCaller()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f'http://127.0.0.1:{server.server_address[1]}/predict'
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def _ask(url, body):
    try:
        with urllib.request.urlopen(url, body, timeout=300) as resp:
            return resp.read()
    except urllib.error.HTTPError as err:
        return err.read()


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--batches', type=int, nargs='+', default=[1, 8, 64])
    parser.add_argument('--runs', type=int, default=10)
    args = parser.parse_args()

    smi = cs.environment()
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.runs.export import export_model, \
        load_exported
    device = engine.resolve_device('cuda')
    work = os.path.join(cs.WORK, 'profile_serve')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        data_paths = cs.write_records(os.path.join(work, 'data'))
        save = os.path.join(work, 'run')
        cs.write_save_path(save, data_paths, device)
        path = export_model(save, os.path.join(work, 'unet'))
        infer = load_exported(path, device='cuda')
        ds = pipeline.predict_ds(data_paths, output_size=(cs.SIZE, cs.SIZE),
                                 batch_size=max(args.batches))
        features = np.ascontiguousarray(
            next(iter(ds.batches()))['slices'][..., :5])

        for b in args.batches:
            x = features[:b]
            body = _npy(x)
            refused = _npy(features[:b, :, :-1])
            probs = infer(x).cpu().numpy()

            def fresh(x=x):
                thread = threading.Thread(
                    target=lambda: infer(x).cpu().numpy())
                thread.start()
                thread.join()

            def npy(x=x, probs=probs):
                np.load(io.BytesIO(_npy(x)))
                np.load(io.BytesIO(_npy(probs)))

            with _server(path) as url, \
                    _server(path, on_caller=True) as caller_url, \
                    _server(path, nodelay=True) as nodelay_url:
                variants = {
                    'direct': lambda x=x: infer(x).cpu().numpy(),
                    'fresh thread': fresh,
                    'npy': npy,
                    'http': lambda url=url, body=body: _ask(url, body),
                    'http, a thread a request': lambda u=caller_url,
                    body=body: _ask(u, body),
                    'http, TCP_NODELAY': lambda u=nodelay_url, body=body:
                        _ask(u, body),
                    'http, refused': lambda url=url, r=refused: _ask(url, r),
                }
                times = {name: [] for name in variants}
                for run in range(args.runs + 1):
                    for name, fn in variants.items():
                        torch.cuda.synchronize()
                        start = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        if run:
                            times[name].append(time.perf_counter() - start)
            print(f'B={b} ({smi}): ' + ', '.join(
                f'{name} {1e3 * statistics.median(t):.3f} ms'
                for name, t in times.items()) +
                f' (host clock, median of {args.runs}, in turns)',
                flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == '__main__':
    main()

'''Serving endpoint (counterpart of dnncancerannotator_tpu.runs.serve): run
an exported artifact behind an HTTP API.

The serving host loads a ``.pt2`` artifact (a ``torch.export`` program with
the weights in it, see runs/export.py) onto its device and answers
prediction requests; the protocol, the order of the checks, the status
codes and the error strings are the JAX server's.

Protocol (stdlib HTTP, binary .npy bodies):

  GET  /healthz   -> 200 'ok' once the artifact is loaded
  GET  /spec      -> the artifact's sidecar metadata as JSON
  POST /predict   -> body: ``.npy``-serialized uint8 [B, H, W, C] feature
                     slices; response: ``.npy`` float32 [B, H, W, 1]
                     sigmoid probability maps

Client example:

  buf = io.BytesIO(); np.save(buf, features_u8)
  r = urllib.request.urlopen('http://host:port/predict', buf.getvalue())
  probs = np.load(io.BytesIO(r.read()))

Fixed-batch artifacts are padded per request and the response sliced back;
symbolic-batch artifacts (the export default) take any batch size as-is.
The server answers each connection on a thread of its own, and one worker
thread runs the device work of them all, one request at a time (the JAX
server's lock): a forward on a fresh thread takes 25-35 ms more than on
a thread that has run it before (an H100 at unet.yaml's 256 x 256,
tools/profile_torch_serve.py), most likely PyTorch's per-thread cuDNN
plans.
'''

import io
import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import yaml

from .export import load_exported

logger = logging.getLogger(__name__)
WORKER = 'dnnca-serve-device'


def _load_spec(artifact):
    '''Sidecar metadata written by export_model (None if absent).'''
    meta_path = os.path.splitext(artifact)[0] + '.yaml'
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return yaml.safe_load(f)


def make_server(artifact, host='127.0.0.1', port=8000, max_batch=256,
                device='cuda'):
    '''Build (but do not start) the HTTP server for an artifact, loaded
    onto ``device`` ('cuda', the default, raises when no GPU is visible;
    'cuda:N' or 'cpu').'''
    infer = load_exported(artifact, device=device)
    spec = _load_spec(artifact)

    fixed_batch = None
    expect_shape = None  # (H, W, C) when the sidecar is present
    if spec:
        in_shape = spec['input']['shape']
        fixed_batch = None if in_shape[0] == -1 else int(in_shape[0])
        expect_shape = tuple(int(d) for d in in_shape[1:])

    class Handler(BaseHTTPRequestHandler):

        def log_message(self, fmt, *args):  # route through logging, quiet
            logger.debug('%s ' + fmt, self.address_string(), *args)

        def _reply(self, code, body, ctype='application/octet-stream'):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code, message):
            self._reply(code, json.dumps({'error': message}).encode(),
                        'application/json')

        def do_GET(self):
            if self.path == '/healthz':
                self._reply(200, b'ok', 'text/plain')
            elif self.path == '/spec':
                self._reply(200, json.dumps(spec).encode(),
                            'application/json')
            else:
                self._error(404, f'unknown path {self.path}')

        def do_POST(self):
            if self.path != '/predict':
                self._error(404, f'unknown path {self.path}')
                return
            try:
                length = int(self.headers.get('Content-Length', 0))
                arr = np.load(io.BytesIO(self.rfile.read(length)),
                              allow_pickle=False)
            except Exception as exc:
                self._error(400, f'body is not a loadable .npy: {exc}')
                return
            if arr.ndim != 4 or arr.dtype != np.uint8:
                self._error(400, 'expected uint8 [B, H, W, C], got '
                            f'{arr.dtype} {arr.shape}')
                return
            if expect_shape and tuple(arr.shape[1:]) != expect_shape:
                self._error(400, f'expected per-slice shape {expect_shape}, '
                            f'got {tuple(arr.shape[1:])}')
                return
            b = arr.shape[0]
            if b == 0 or b > max_batch:
                self._error(400, f'batch size {b} outside [1, {max_batch}]')
                return
            if fixed_batch is not None:
                if b > fixed_batch:
                    self._error(400, f'artifact has fixed batch '
                                f'{fixed_batch}; got {b}')
                    return
                if b < fixed_batch:
                    pad = np.zeros((fixed_batch - b, *arr.shape[1:]),
                                   arr.dtype)
                    arr = np.concatenate([arr, pad], axis=0)
            try:
                probs = self.server.worker.submit(
                    lambda: infer(arr)[:b].cpu().numpy()).result()
            except Exception as exc:
                logger.exception('inference failed')
                self._error(500, f'inference failed: {exc}')
                return
            buf = io.BytesIO()
            np.save(buf, probs)
            self._reply(200, buf.getvalue())

    return _Server((host, port), Handler)


class _Server(ThreadingHTTPServer):
    '''ThreadingHTTPServer with the one worker thread that runs the
    device work of every request (``worker``), shut down on close.'''

    def __init__(self, address, handler):
        super().__init__(address, handler)
        self.worker = ThreadPoolExecutor(1, thread_name_prefix=WORKER)

    def server_close(self):
        super().server_close()
        self.worker.shutdown()


def serve(
    artifact,
    host='127.0.0.1',
    port=8000,
    max_batch=256,
    device='cuda',
):
    '''
    Serve an exported model artifact over HTTP.

    Args:
        artifact: path to the .pt2 artifact written by export_model
        host: bind address
        port (int): TCP port (0 picks an ephemeral port)
        max_batch (int): reject requests with a larger batch dimension
        device (str): 'cuda' (default; raises when no GPU is visible),
            'cuda:N', or 'cpu'
    '''
    server = make_server(artifact, host=host, port=int(port),
                         max_batch=int(max_batch), device=device)
    bound_host, bound_port = server.server_address[:2]
    logger.info('Serving %s on http://%s:%d (POST /predict)',
                artifact, bound_host, bound_port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()

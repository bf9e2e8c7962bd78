'''Carry weights between the JAX package's flax parameters and the port.

The flat form is {flax path: array}, e.g.
``params/unet/encoder/down_0/convchain/conv_0/kernel`` or
``params/last_conv/bias``: the port's checkpoint
(``<save_path>/checkpoints/ckpt-<step>/params.npz``) holds exactly that,
with flax's HWIO kernels, so numpy reads it anywhere.

Layouts:

- conv kernels: flax HWIO [kh, kw, Ci, Co] <-> PyTorch OIHW [Co, Ci, kh, kw];
- transposed-conv kernels (the ``tconv`` modules): flax HWIO, which
  ``lax.conv_transpose`` applies spatially flipped (output phase (dy, dx)
  takes k[kh-1-dy, kw-1-dx]) <-> PyTorch ConvTranspose2d [Ci, Co, kh, kw],
  applied unflipped (phase (dy, dx) takes w[:, :, dy, dx]). So the flip
  happens here, once: w = k[::-1, ::-1].transpose(2, 3, 0, 1);
- biases are the same vector in both; so are BatchNorm's ``scale`` and
  ``bias`` (flax ``params``) and its running ``mean`` and ``var`` (flax
  ``batch_stats``, buffers in the port).

A PyTorch state_dict key is the flax path without its collection
(``params/`` or ``batch_stats/``), with dots, and ``weight`` for
``kernel``.
'''

import numpy as np
import torch


# the leaves of each flax collection the port carries
_LEAVES = {'params': ('kernel', 'bias', 'scale'),
           'batch_stats': ('mean', 'var')}
_COLLECTION = {leaf: col for col, leaves in _LEAVES.items()
               for leaf in leaves}


def _is_tconv(module_path):
    return module_path[-1] == 'tconv'


def torch_state_from_flax(flat, expected=None):
    '''Convert a flat flax-keyed dict into a PyTorch state_dict.

    Every leaf is consumed exactly once. Keys that are not
    ``params/.../{kernel,bias,scale}`` or ``batch_stats/.../{mean,var}``
    raise KeyError. With ``expected`` (a model's state_dict, or its
    parameters alone), keys missing from ``flat``, keys the model does not
    have, and shape mismatches raise too.
    '''
    state = {}
    for key, value in flat.items():
        parts = key.split('/')
        if len(parts) < 3 or parts[-1] not in _LEAVES.get(parts[0], ()):
            raise KeyError(f'unknown checkpoint key {key!r}')
        module_path, leaf = parts[1:-1], parts[-1]
        arr = np.asarray(value, np.float32)
        if leaf == 'kernel':
            if arr.ndim != 4:
                raise ValueError(f'{key}: expected a 4-D kernel, '
                                 f'got shape {arr.shape}')
            if _is_tconv(module_path):
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                arr = arr.transpose(3, 2, 0, 1)
            leaf = 'weight'
        name = '.'.join(module_path + [leaf])
        state[name] = torch.from_numpy(arr.copy())  # contiguous, writable
    if expected is not None:
        missing = sorted(set(expected) - set(state))
        unknown = sorted(set(state) - set(expected))
        if missing or unknown:
            raise KeyError(f'checkpoint does not match the model: missing '
                           f'{missing}, unknown {unknown}')
        for name, tensor in state.items():
            if tuple(tensor.shape) != tuple(expected[name].shape):
                raise ValueError(
                    f'{name}: checkpoint shape {tuple(tensor.shape)}, '
                    f'model shape {tuple(expected[name].shape)}')
    return state


def flax_from_torch_state(state):
    '''Inverse of ``torch_state_from_flax``: a PyTorch state_dict to the
    flat flax-keyed dict of numpy arrays.'''
    flat = {}
    for name, tensor in state.items():
        *module_path, leaf = name.split('.')
        arr = tensor.detach().cpu().numpy().astype(np.float32)
        if leaf == 'weight':
            if _is_tconv(module_path):
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                arr = arr.transpose(2, 3, 1, 0)
            leaf = 'kernel'
        elif leaf not in _COLLECTION:
            raise KeyError(f'unknown state_dict key {name!r}')
        flat['/'.join([_COLLECTION[leaf], *module_path, leaf])] = \
            np.ascontiguousarray(arr)
    return flat

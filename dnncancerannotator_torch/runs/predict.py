'''The predict run (counterpart of dnncancerannotator_tpu.runs.predict):
load the latest checkpoint and write one probability map per slice;
data-parallel and spatially partitioned as ``train`` (each batch's rows
over the data groups, its image rows over a model group, rank 0 writing
the maps).'''

import logging
import os

import numpy as np

from .. import data as data_lib
from .. import engine as engine_lib
from ..parallel import multihost
from ..utils import config as config_lib
from ..utils import tboard

logger = logging.getLogger(__name__)


def predict(
    save_path,
    data_path,
    output_path,
    config=None,
    threshold=None,
    batch_size=1,
    output_format='png',
    device='cuda',
):
    '''
    Predict segmentation maps with the latest checkpoint; on every visible
    card with deploy_options.enable_multigpu, as train.

    Args:
        save_path: where to find weights/configs
        data_path (list[str]): .tfrecords files or exam directory trees
            to predict
        output_path: directory for the predicted maps
        config (list[str]): extra configuration overlays
        threshold (float): optional binarization threshold for the output
        batch_size (int): slices per forward pass
        output_format (str): 'png' (8-bit grayscale probability map),
            'npy' (raw float32 probabilities), or 'png16' (16-bit PNG,
            probability scaled to [0, 65535])
        device (str): 'cuda' (default; raises when no GPU is visible),
            'cuda:N', or 'cpu'
    '''
    if output_format not in ('png', 'npy', 'png16'):
        raise ValueError(f'unknown output_format {output_format!r}')
    saved_config = os.path.join(save_path, 'options.yaml')
    saved_config = config_lib.load_config(saved_config)['config']
    if config:
        add_config = config_lib.load_config(config)
        saved_config = config_lib.apply_config(saved_config, add_config)
    return multihost.launch(
        _predict, (saved_config, save_path, data_path, output_path,
                   threshold, batch_size, output_format, device),
        saved_config['deploy_options'].get('enable_multigpu', True), device,
        saved_config['deploy_options'].get('spatial_partition', 1))


def _predict(saved_config, save_path, data_path, output_path, threshold,
             batch_size, output_format, device):
    ds = data_lib.predict_ds(
        data_path,
        slice_types=saved_config['data_options']['eval'].get(
            'slice_types', data_lib.records.DEFAULT_SLICE_TYPES),
        output_size=saved_config['data_options']['eval'].get(
            'output_size', (512, 512)),
        batch_size=batch_size)

    model = engine_lib.Engine(saved_config, device=device)
    model.build(ds.feature_shape)
    ckpts = model.get_ckpts(os.path.join(save_path, 'checkpoints'))
    if not ckpts:
        raise FileNotFoundError(f'no checkpoints under {save_path}')
    latest = max(ckpts)
    model.load(ckpts[latest])
    logger.info('Predicting with checkpoint step %d on %s', latest,
                model.device)

    # every rank runs its rows of each batch; rank 0 writes the maps
    primary = multihost.is_primary()
    if primary:
        os.makedirs(output_path, exist_ok=True)
    count = 0
    eval_step = model._make_eval_step(ds.slice_types)
    ext = 'npy' if output_format == 'npy' else 'png'
    for batch in ds.batches():
        probs = eval_step(batch['slices'])[1].cpu().numpy()
        for i, meta in enumerate(batch['meta'] if primary else ()):
            pred = probs[i, :, :, 0]
            if threshold is not None:
                pred = (pred > threshold).astype(np.float32)
            parts = meta['path'].split('/')[-3:]
            out = os.path.join(
                output_path, *parts, f"{meta['sliceID']:02d}.{ext}")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            if output_format == 'npy':
                np.save(out, pred.astype(np.float32))
            elif output_format == 'png16':
                with open(out, 'wb') as f:
                    f.write(tboard.encode_png(
                        np.clip(pred, 0, 1) * 65535, bitdepth=16))
            else:
                with open(out, 'wb') as f:
                    f.write(tboard.encode_png(pred))
            count += 1
    logger.info('Wrote %d predictions to %s', count, output_path)
    return count

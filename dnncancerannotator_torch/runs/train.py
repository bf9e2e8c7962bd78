'''The train run (counterpart of dnncancerannotator_tpu.runs.train): record
the resolved options, train, and write the results pickle.'''

import os

from .. import data as data_lib
from .. import engine as engine_lib
from ..utils import config as config_lib
from ..utils import dump as dump_lib


def train(
    config,
    save_path,
    data_path,
    max_steps,
    save_freq=500,
    seed=0,
    device='cuda',
):
    '''
    Run a training job: record the resolved options under save_path,
    fit the model, and write the final results pickle. A save_path that
    holds checkpoints resumes from the newest one.

    Args:
        config (list[str]): one or more YAML/JSON config files; the first
            is the base and each later file is overlaid onto it
            (dotted keys merge into nested sections)
        save_path: output directory for checkpoints, options and results
        data_path (list[str]): training data (.tfrecords files)
        max_steps (int): stop after this many optimizer steps in all
        save_freq (int): checkpoint every N steps (default 500)
        seed (int): seed of the weight init, the warp bank, the batch
            sampler and the augmentation draws
        device (str): 'cuda' (default; raises when no GPU is visible),
            'cuda:N', or 'cpu'
    '''
    config = config_lib.load_config(config)
    dump_lib.dump_options(
        os.path.join(save_path, 'options.yaml'),
        avoid_overwrite=True,
        config=config,
        save_path=save_path,
        data_path=data_path,
    )
    ds = data_lib.train_ds(data_path, **config['data_options']['train'])
    model = engine_lib.Engine(config, seed=seed, device=device)
    results = model.train(ds, save_path=save_path, max_steps=max_steps,
                          save_freq=save_freq)
    dump_lib.dump_train_results(
        os.path.join(save_path, 'results.pkl'), results, format_='pickle')
    return results

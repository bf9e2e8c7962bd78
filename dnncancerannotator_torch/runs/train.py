'''The train run (counterpart of dnncancerannotator_tpu.runs.train): record
the resolved options, train, and write the results pickle; data-parallel
over every visible card with ``deploy_options.enable_multigpu``
(parallel/multihost.py: ``launch``), each plane's rows split over model
groups of ``deploy_options.spatial_partition`` ranks, rank 0 writing.'''

import os

from .. import data as data_lib
from .. import engine as engine_lib
from ..parallel import multihost
from ..utils import config as config_lib
from ..utils import dump as dump_lib


def train(
    config,
    save_path,
    data_path,
    max_steps,
    early_stop_steps=None,
    save_freq=500,
    validate=False,
    val_data_path=None,
    visualize=False,
    profile=False,
    seed=0,
    device='cuda',
):
    '''
    Run a training job: record the resolved options under save_path,
    fit the model, and write the final results pickle. A save_path that
    holds checkpoints resumes from the newest one. With
    deploy_options.enable_multigpu (default true) and more than one
    visible card it trains data-parallel on every card, one process a
    card (NCCL); with DNNCA_MULTIHOST=1 (torchrun's environment) it joins
    the launcher's group.

    Args:
        config (list[str]): one or more YAML/JSON config files; the first
            is the base and each later file is overlaid onto it
            (dotted keys merge into nested sections)
        save_path: output directory for checkpoints, options and results
        data_path (list[str]): training data: .tfrecords files, or exam
            directory trees (path/{cancer,healthy}/patientID/examID/
            <slice_type>/*.png); a set past the device-resident budget
            (or with data_options.train.device_cache false) streams from
            the host
        max_steps (int): stop after this many optimizer steps in all
        early_stop_steps (int): stop when the validation loss has not
            improved for this many steps; disabled when None (default)
        save_freq (int): checkpoint every N steps (default 500)
        validate (bool): evaluate on val_data_path at every checkpoint
        val_data_path (list[str]): validation data (.tfrecords files or
            exam directory trees)
        visualize (bool): write image and PR-curve summaries of the
            training data (and of the validation data, when given) at every
            checkpoint
        profile (bool): write a torch.profiler trace of steps 201-210 of
            this call under save_path/tfevents/profile (nothing when the
            call runs fewer steps)
        seed (int): seed of the weight init, the warp bank, the batch
            sampler and the augmentation draws
        device (str): 'cuda' (default; raises when no GPU is visible),
            'cuda:N', or 'cpu'
    '''
    config = config_lib.load_config(config)
    return multihost.launch(
        _train, (config, save_path, data_path, max_steps, early_stop_steps,
                 save_freq, validate, val_data_path, visualize, profile,
                 seed, device),
        config['deploy_options'].get('enable_multigpu', True), device,
        config['deploy_options'].get('spatial_partition', 1))


def _train(config, save_path, data_path, max_steps, early_stop_steps,
           save_freq, validate, val_data_path, visualize, profile, seed,
           device):
    if multihost.is_primary():
        dump_lib.dump_options(
            os.path.join(save_path, 'options.yaml'),
            avoid_overwrite=True,
            config=config,
            save_path=save_path,
            data_path=data_path,
        )
    ds = data_lib.train_ds(data_path, **config['data_options']['train'])
    eval_options = config['data_options']['eval']
    val_ds = None
    if validate:
        if val_data_path is None:
            raise ValueError('validate needs val_data_path')
        val_ds = data_lib.eval_ds(val_data_path, **eval_options)
    visualization = {}
    if visualize:
        visualization['train'] = data_lib.eval_ds(
            data_path, **eval_options, include_meta=True)
        if val_data_path is not None:
            visualization['validation'] = data_lib.eval_ds(
                val_data_path, **eval_options, include_meta=True)
    model = engine_lib.Engine(config, seed=seed, device=device)
    results = model.train(ds, val_data=val_ds, save_path=save_path,
                          max_steps=max_steps,
                          early_stop_steps=early_stop_steps,
                          save_freq=save_freq, visualization=visualization,
                          profile=profile)
    if multihost.is_primary():
        dump_lib.dump_train_results(
            os.path.join(save_path, 'results.pkl'), results,
            format_='pickle')
    return results

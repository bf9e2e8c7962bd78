'''The evaluate run (counterpart of dnncancerannotator_tpu.runs.evaluate):
every checkpoint of a training run, with the options it recorded;
data-parallel and spatially partitioned as ``train`` (rank 0 runs the
metrics and writes).'''

import os

from .. import data as data_lib
from .. import engine as engine_lib
from ..parallel import multihost
from ..utils import config as config_lib


def evaluate(
    save_path,
    data_path,
    tag,
    config=None,
    avoid_overwrite=False,
    export_path=None,
    export_images=False,
    export_csv=False,
    visualize_sensitivity=False,
    min_interval=1,
    step_range=None,
    overlay=False,
    skip_visualization=False,
    export_casewise_metrics=False,
    device='cuda',
):
    '''
    Evaluate every checkpoint of a finished (or running) training job,
    reusing the options.yaml recorded at train time; on every visible
    card with deploy_options.enable_multigpu, as train.

    Args:
        save_path: training output directory holding checkpoints and
            options.yaml
        data_path (list[str]): evaluation data (.tfrecords files or exam
            directory trees)
        tag: name of the results subdirectory under tfevents/
        config (list[str]): optional config overlays applied on top of the
            recorded training options
        avoid_overwrite (bool): rename tag when it already exists
        export_path (str): alternate root for exported artifacts
        export_images (bool): write per-slice PNG grids
        export_csv (bool): write results.csv and casewise_results.csv
        visualize_sensitivity (bool): add input-sensitivity charts (needs
            matplotlib)
        min_interval (int): skip checkpoints closer than this many steps
        step_range (list[int]): only evaluate checkpoints inside
            "start end"
        overlay (bool): blend the predicted mask over the input image
        skip_visualization (bool): metrics only, no visualizer pass
        export_casewise_metrics (bool): also collect per-slice region counts
            (written to casewise_results.csv with export_csv)
        device (str): 'cuda' (default; raises when no GPU is visible),
            'cuda:N', or 'cpu'
    '''
    saved = config_lib.load_config(
        os.path.join(save_path, 'options.yaml'))['config']
    if config:
        saved = config_lib.apply_config(saved, config_lib.load_config(config))
    if step_range is not None:
        step_range = tuple(map(int, step_range))
    return multihost.launch(
        _evaluate, (saved, save_path, data_path, tag, avoid_overwrite,
                    export_path, export_images, export_csv,
                    visualize_sensitivity, min_interval, step_range, overlay,
                    skip_visualization, export_casewise_metrics, device),
        saved['deploy_options'].get('enable_multigpu', True), device,
        saved['deploy_options'].get('spatial_partition', 1))


def _evaluate(saved, save_path, data_path, tag, avoid_overwrite, export_path,
              export_images, export_csv, visualize_sensitivity, min_interval,
              step_range, overlay, skip_visualization,
              export_casewise_metrics, device):
    eval_options = saved['data_options']['eval']
    ds = data_lib.eval_ds(data_path, **eval_options)
    viz_ds = None if skip_visualization else data_lib.eval_ds(
        data_path, **eval_options, include_meta=True)
    model = engine_lib.Engine(saved, device=device)
    return model.eval(
        ds, viz_ds=viz_ds, tag=tag, save_path=save_path,
        avoid_overwrite=avoid_overwrite, export_path=export_path,
        export_images=export_images, export_csv=export_csv,
        visualize_sensitivity=visualize_sensitivity,
        min_interval=min_interval, step_range=step_range, overlay=overlay,
        export_casewise_metrics=export_casewise_metrics)

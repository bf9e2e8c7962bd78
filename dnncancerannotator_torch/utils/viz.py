'''The visualization and export pass (counterpart of
dnncancerannotator_tpu.utils.viz).

``Visualizer`` runs the model over a dataset at a step and writes:
- one image grid per slice (feature channels | label | prediction, or an
  RGB overlay), resized by ``ratio``, as a TensorBoard image with the tag
  ``path:<exam path>,sliceID:<n>``, and as a PNG under
  ``save_dir/<tag>/images/<last path parts>/<slice>/step_<step>.png`` when
  ``export_images``;
- pixel and region PR curves at the thresholds i / 99 (the region curve at
  ``resize_factor = ratio``) as raw ``pr_curves`` summaries;
- input sensitivity, |d(sum of probabilities)/d(input)| summed per channel
  and normalized per slice, by autograd through the model's kernels (the
  chain backward then computes dx at the first chain); as a bar chart PNG
  (matplotlib, imported only then) and a CSV;
- casewise rows of per-slice region counts, into a shared container and as
  per-slice CSVs.
The forwards go through the engine (``Engine.visual_batch``): under
``spatial_partition`` every rank runs its image rows of them (the other
ranks' Visualizers as ``follower``s, which write nothing) and the
probabilities and the input gradient come back as whole planes before the
sums.

CSV files are written with the standard library in pandas' layout.
'''

import csv
import os

import numpy as np
import torch

from ..metrics import pixel as pixel_metrics
from ..metrics import region as region_metrics
from . import tboard

# the pixel and the region PR curves' thresholds, i / 99, 0 through 1
PR_THRESHOLDS = [i / 99.0 for i in range(100)]
PR_IOU_THRESHOLD = 0.30
EXPORT_PATH_DEPTH = 3   # trailing parts of an exam's path kept in exports


def input_gradient(model, x):
    '''Probabilities [B, H, W, 1] of ``model`` at NHWC features x, and
    d(sum of probs)/dx. Through a bf16 model the gradient comes back in x's
    f32 through the first conv's cast, as jax.grad gives it
    (utils/viz.py:118).'''
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        probs = model(x)
        (grad,) = torch.autograd.grad(probs.sum(), x)
    return probs.detach(), grad


def sensitivity(grad):
    '''The per-slice normalized sum over pixels of |grad| [B, C], in f32
    for an f32 gradient.'''
    summed = grad.abs().sum(dim=(1, 2))
    return summed / summed.sum(dim=1, keepdim=True).clamp(min=1e-12)


def input_sensitivity(model, x):
    '''Probabilities [B, H, W, 1] of ``model`` at NHWC features x, and the
    per-slice normalized sum over pixels of |d(sum of probs)/dx| [B, C].'''
    probs, grad = input_gradient(model, x)
    return probs, sensitivity(grad)


def write_csv(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w', newline='') as fh:
        csv.writer(fh, lineterminator='\n').writerows(rows)


class Visualizer:
    def __init__(
        self,
        tag,
        data,
        freq,
        save_dir,
        ratio=0.5,
        ignore_test=True,
        export_images=False,
        export_csv=False,
        visualize_sensitivity=False,
        overlay=False,
        export_casewise_metrics=False,
        casewise_metrics_container=None,
        follower=False,
    ):
        self.tag = tag
        self.data = data
        self.freq = freq
        self.save_dir = save_dir
        self.ratio = ratio
        self.export_images = export_images
        self.export_csv = export_csv
        self.show_sensitivity = visualize_sensitivity
        self.overlay = overlay
        self.export_casewise_metrics = export_casewise_metrics
        self.casewise_metrics_container = casewise_metrics_container
        self.ignore_test = ignore_test
        # a rank other than 0 under spatial_partition: it runs its image
        # rows of every pass's forwards with rank 0 and writes nothing
        self.follower = follower
        self._writer = None

    @property
    def writer(self):
        '''The event-file writer of ``save_dir/<tag>``, opened on first
        use.'''
        if self._writer is None:
            self._writer = tboard.SummaryWriter(
                os.path.join(self.save_dir, self.tag))
        return self._writer

    def _viz_batch(self, engine, raw):
        '''(x, y, probs, sensitivity) of a uint8 batch, on the device
        (``Engine.visual_batch``).'''
        return engine.visual_batch(raw, self.data.slice_types,
                                   self.show_sensitivity)

    def on_step(self, engine, step):
        '''The pass at a training step, on the ``freq`` cadence.'''
        if self.freq and step % self.freq != 0:
            return
        self._run(engine, step)

    def on_test(self, engine, step):
        '''The pass at an evaluated checkpoint, unless ``ignore_test``.'''
        if self.ignore_test:
            return
        self._run(engine, step)

    def _run(self, engine, step):
        pixel_suite = {
            name: cls(PR_THRESHOLDS) for name, cls in (
                ('true_positive_counts', pixel_metrics.TruePositives),
                ('true_negative_counts', pixel_metrics.TrueNegatives),
                ('false_positive_counts', pixel_metrics.FalsePositives),
                ('false_negative_counts', pixel_metrics.FalseNegatives),
                ('recall', pixel_metrics.Recall),
                ('precision', pixel_metrics.Precision))}
        region_cm = region_metrics.RegionBasedConfusionMatrix(
            PR_THRESHOLDS, PR_IOU_THRESHOLD, resize_factor=self.ratio)

        if self.follower:
            for batch in self.data.batches():
                self._viz_batch(engine, batch['slices'])
            return
        for batch in self.data.batches():
            n = len(batch['meta'])
            x, y, probs, sens = self._viz_batch(engine, batch['slices'])
            for metric in pixel_suite.values():
                metric.update_state(y, probs)
            if self.export_casewise_metrics:
                casewise = region_cm.update_state_raw(y, probs)
            else:
                region_cm.update_state(y, probs)
            x, y = x.cpu().numpy(), y.cpu().numpy()
            probs, sens = probs.cpu().numpy(), sens.cpu().numpy()
            for i in range(n):
                meta = batch['meta'][i]
                tag = f"path:{meta['path']},sliceID:{meta['sliceID']}"
                image = self._resize(self._generate_image(x[i], y[i],
                                                          probs[i]))
                png = tboard.encode_png(image)   # once for both outputs
                self.writer.image(tag, image, step, png=png)
                self._export_files(
                    meta, png, step,
                    sens[i] if self.show_sensitivity else None,
                    (*(c[i] for c in casewise), tag)
                    if self.export_casewise_metrics else None)

        self._record_pr_curves(pixel_suite, region_cm, step)
        self.writer.flush()

    def _generate_image(self, features, label, output):
        '''features [h, w, C], label [h, w], output [h, w, 1] -> the grid.'''
        horizontal = np.concatenate(
            [features[..., c] for c in range(features.shape[-1])], axis=1)
        pred = output[..., 0]
        if self.overlay:
            horizontal = np.tile(horizontal[..., None], [1, 1, 3])
            f0 = features[..., 0]
            pred = np.stack([pred, f0, f0], axis=-1)
            lab = np.stack([label, f0, f0], axis=-1)
            return np.concatenate([horizontal, lab, pred], axis=1)
        return np.concatenate([horizontal, label, pred], axis=1)

    def _resize(self, image):
        if self.ratio == 1.0:
            return image
        from PIL import Image
        arr = np.clip(image * 255.0, 0, 255).astype(np.uint8)
        h = int(arr.shape[0] * self.ratio)
        w = int(arr.shape[1] * self.ratio)
        img = Image.fromarray(arr).resize((w, h), Image.BILINEAR)
        return np.asarray(img).astype(np.float32) / 255.0

    def _export_files(self, meta, png, step, sensitivity, casewise):
        parts = meta['path'].split('/')[-EXPORT_PATH_DEPTH:]
        slice_dir = os.path.join(*parts, f"{int(meta['sliceID']):02d}")
        stem = f'step_{int(step):08d}'
        names = [t for t in meta['slice_types'] if t != 'label']
        if self.export_images:
            path = os.path.join(self.save_dir, self.tag, 'images', slice_dir,
                                f'{stem}.png')
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, 'wb') as f:
                f.write(png)
            if sensitivity is not None:
                with open(path[:-4] + '_sensitivity.png', 'wb') as f:
                    f.write(tboard.encode_png(
                        self._sensitivity_chart(sensitivity, names)))
        csv_dir = os.path.join(self.save_dir, self.tag, 'csv', slice_dir)
        if self.export_csv and sensitivity is not None:
            write_csv(os.path.join(csv_dir, f'{stem}_sensitivity.csv'),
                      [['', '0']] + [[name, value] for name, value in
                                     zip(names, sensitivity[:len(names)])])
        if casewise is not None:
            tp, fn, fp, tag = casewise
            row = dict(
                **{f'region_tp@PixelThreshold{t:.2}': int(v)
                   for t, v in zip(PR_THRESHOLDS, tp)},
                **{f'region_fn@PixelThreshold{t:.2}': int(v)
                   for t, v in zip(PR_THRESHOLDS, fn)},
                **{f'region_fp@PixelThreshold{t:.2}': int(v)
                   for t, v in zip(PR_THRESHOLDS, fp)},
                tag=tag,
            )
            if self.casewise_metrics_container is not None:
                self.casewise_metrics_container.append(row)
            if self.export_csv:
                write_csv(os.path.join(csv_dir, f'{stem}_metrics.csv'),
                          [['', '0']] + [[k, v] for k, v in row.items()])

    @staticmethod
    def _sensitivity_chart(sensitivity, names):
        '''Bar chart of per-channel sensitivity -> RGB image array.'''
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure
        fig = Figure()
        canvas = FigureCanvasAgg(fig)
        ax = fig.gca()
        ax.bar(range(len(names)), sensitivity[:len(names)], tick_label=names)
        ax.set_ylim(0, 1)
        ax.set_xlabel('modality')
        ax.set_ylabel('normalized sensitivity')
        canvas.draw()
        return np.asarray(canvas.buffer_rgba())[:, :, :3]

    def _record_pr_curves(self, pixel_suite, region_cm, step):
        pixel = {k: np.asarray(m.result()) for k, m in pixel_suite.items()}
        self.writer.pr_curve_raw(
            'pixel/PR_curve', pixel['true_positive_counts'],
            pixel['false_positive_counts'], pixel['true_negative_counts'],
            pixel['false_negative_counts'], pixel['precision'],
            pixel['recall'], len(PR_THRESHOLDS), step)
        region = region_cm.result_dict()
        self.writer.pr_curve_raw(
            'region/PR_curve', region['true_positive_counts'],
            region['false_positive_counts'],
            np.zeros(len(PR_THRESHOLDS)),
            region['false_negative_counts'], region['precision'],
            region['recall'], len(PR_THRESHOLDS), step)

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None

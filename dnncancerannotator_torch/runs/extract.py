'''Screenshot extraction: clinical collage -> per-sequence PNG tree
(counterpart of dnncancerannotator_tpu.runs.extract).

Clinical screenshots are 2x3 grids of MRI sequences plus a hand-annotated
label pane. As in the JAX package:

1. the grid geometry comes from an orthogonal-corner detector: the
   binarised collage correlated with two 25 x 25 filters (an upper-left
   corner and its flip); here the correlation runs on the device
   (``corner_response``), exactly, as int32 sums of an integral image,
   so the thresholds and the lexicographic minimum of the candidates
   see the same integers as scipy's convolution;
2. the six panes map to {label, DCEE, DCEL, DWI, ADC, TRA};
3. for cancer exams the coloured annotation becomes a filled binary mask:
   ruler lines found by the probabilistic Hough transform are erased, the
   central disc kept, each 8-connected component closed, the outer
   contours filled (``ops/raster.py``: OpenCV's operations without cv2);
4. ``extract_all`` walks ``path/{healthy,cancer}/patientID/examID/*.png``
   and writes ``<exam>/<kind>/<slice>.png`` in place.

In ``extract_all`` the calling process owns the device and runs every
correlation; a pool of spawned processes, which import no torch and never
touch CUDA, decodes the collages, extracts the labels and writes the
PNGs. ``num_workers=0`` runs serially.
'''

import logging
import os
import time
from glob import glob

import numpy as np

from ..ops import raster

logger = logging.getLogger(__name__)

def get_orthogonal_detector(size=200, non_orthogonal_penalty=10):
    '''Conv filter responding to an upper-left orthogonal corner of a bright
    grid line.'''
    filt = np.zeros([size, size], np.float32)
    filt[1, :] = -non_orthogonal_penalty
    filt[:, 1] = -non_orthogonal_penalty
    filt[0, :] = 1
    filt[:, 0] = 1
    return filt


def corner_response(binary, filt, device='cuda'):
    '''The valid correlation (no flip) of ``binary`` with ``filt``, exactly.

    ``binary``: 0/1 [H, W] (numpy or a torch tensor; numpy is moved to
    ``device``), ``filt``: an integer-valued [K, K'] array. Returns an int32
    tensor [H - K + 1, W - K' + 1] on the device: a weighted sum of shifted
    reads of an int32 integral image, weighted by the filter's second
    difference (non-zero only at the corners of its constant rectangles: 9
    for the orthogonal detector), so every value is the integer scipy's
    ``convolve2d(binary, flip(filt), 'valid')`` computes.
    '''
    import torch
    from ..engine import resolve_device

    if not isinstance(binary, torch.Tensor):
        binary = torch.from_numpy(np.ascontiguousarray(binary)).to(
            resolve_device(device))
    h, w = binary.shape
    kh, kw = np.shape(filt)
    ho, wo = h - kh + 1, w - kw + 1
    if ho < 1 or wo < 1:
        raise ValueError(f'a {kh} x {kw} filter has no valid position on '
                         f'{h} x {w}')
    integral = torch.zeros((h + 1, w + 1), dtype=torch.int32,
                           device=binary.device)
    integral[1:, 1:] = binary.to(torch.int32).cumsum(
        0, dtype=torch.int32).cumsum(1, dtype=torch.int32)
    weights = np.diff(np.diff(np.pad(filt, 1), axis=0), axis=1)
    out = torch.zeros((ho, wo), dtype=torch.int32, device=binary.device)
    for r, c in zip(*np.nonzero(weights)):
        out.add_(integral[r:r + ho, c:c + wo], alpha=int(weights[r, c]))
    return out


def _gray(collective_img):
    '''Channel 0 of the collage with its last row and column set to 255.'''
    gray = collective_img[:, :, 0].copy()
    gray[-1, :] = 255
    gray[:, -1] = 255
    return gray


def _candidates(gray, conv_filter_size, separator_value, device):
    '''(start, end) corner candidates of a gray [H, W], each an int64
    [M, 2] array of (row, col) in raster order where the response reaches
    its rank-th largest value (rank 1 for the upper-left filter, 3 for its
    flip, whose positions shift by the filter size).'''
    import torch

    binary = torch.from_numpy(gray).to(device) >= separator_value
    filt = get_orthogonal_detector(conv_filter_size)
    found = []
    for f, adjust, rank in ((filt, 0, 1),
                            (np.flip(filt), conv_filter_size, 3)):
        response = corner_response(binary, f, device)
        if response.numel() < rank:
            raise ValueError(f'{response.numel()} corner responses, fewer '
                             f'than {rank}')
        thr = response.flatten().topk(rank).values[-1]
        found.append((response >= thr).nonzero().cpu().numpy() + adjust)
    return found


def _find_top_left_fallback(gray):
    '''Scanline fallback when conv corner detection fails.'''
    row = 120
    while np.sum(gray[row, 100:700]) != 0:
        row += 1
    col = 120
    while np.sum(gray[250:800, col]) != 0:
        col -= 1
    return row + 3, col - 75


def _boxes(gray, start_candidates, end_candidates, num_internals,
           nboxes_horizontal, min_box_size):
    '''detect_internals' geometry from the corner candidates.'''
    box_size = None
    if len(start_candidates) and len(end_candidates):
        start = start_candidates[0].copy()       # raster order: the minimum
        inside = np.all(end_candidates > start + min_box_size, axis=1)
        if not inside.any():
            raise ValueError(
                f'Failed to detect end corner. start={start}, '
                f'ends={[tuple(e) for e in end_candidates.tolist()]}')
        end = end_candidates[inside][0]
        box_size = end - start
        if (box_size.min() <= min_box_size
                or (box_size[0] * 2) * 0.96 > gray.shape[0]
                or (box_size[1] * 3) * 0.96 > gray.shape[1]):
            raise ValueError(
                f'Invalid box size {box_size} (start={start}, end={end})')
        while start[0] > 200:
            start[0] -= box_size[0]
        while start[1] > 60:
            start[1] -= box_size[1]
        start = np.maximum(start, 0)
    else:
        start = np.array(_find_top_left_fallback(gray))
        logger.warning(
            'Corner detection fell back to scanline; start=(%d, %d)',
            start[0], start[1])
        if start.min() < 0:
            raise ValueError('Failed to detect corners')

    anchor = start.copy()
    boxes = []
    for i in range(num_internals):
        boxes.append((*anchor, *(anchor + box_size)))
        if (i + 1) % nboxes_horizontal == 0:
            anchor = np.array((start[0] + box_size[0], start[1]))
        else:
            anchor = np.array((anchor[0], anchor[1] + box_size[1]))
    return boxes


def detect_internals(
    collective_img,
    num_internals=6,
    conv_filter_size=25,
    separator_value=100,
    nboxes_horizontal=3,
    min_box_size=500,
    device='cuda',
):
    '''Locate the 6 internal panes; returns boxes (startx, starty, endx, endy).

    The corner correlations run on ``device`` ('cuda' by default, 'cpu'
    for the CPU); without a GPU 'cuda' raises.'''
    from ..engine import resolve_device

    gray = _gray(collective_img)
    starts, ends = _candidates(gray, conv_filter_size, separator_value,
                               resolve_device(device))
    return _boxes(gray, starts, ends, num_internals, nboxes_horizontal,
                  min_box_size)


def _monochrome_mask(img):
    return np.logical_and(
        img[:, :, 0] == img[:, :, 1], img[:, :, 1] == img[:, :, 2])


def _center_mask(shape, radius=130):
    mask = np.zeros(shape, np.uint8)
    raster.fill_circle(mask, (shape[1] // 2, shape[0] // 2), radius, 255)
    return mask


def label_exists(label_img):
    '''True if the label pane has colored (annotated) pixels near center.'''
    color = np.logical_not(_monochrome_mask(label_img))
    masked = np.logical_and(
        _center_mask(label_img.shape[:2] + (1,))[..., 0] > 0, color)
    return masked.sum() > 0


def extract_label(label_img, line_eraser_thickness=3, minLineLength=100,
                  kernel_size=9, iterations=1):
    '''Colored annotation -> filled binary mask [H, W, 1] (0 or 255).'''
    color = (np.logical_not(_monochrome_mask(label_img))[..., None]
             .astype(np.uint8) * 255)
    nolines = color.copy()
    for x0, y0, x1, y1 in raster.hough_lines_p(
            color, 0.5, np.pi / 1800, 50, min_line_length=minLineLength,
            max_line_gap=2):
        raster.draw_line(nolines, (x0, y0), (x1, y1), 0,
                         line_eraser_thickness)

    masked = np.logical_and(
        _center_mask(nolines.shape) > 0, nolines > 0).astype(np.uint8) * 255

    nmarkers, markers = raster.connected_components8(masked[..., 0])
    closed = np.zeros(masked.shape[:2], np.uint8)
    for marker_id in range(1, nmarkers):
        comp = (markers == marker_id).astype(np.uint8) * 255
        # a wrapping uint8 sum, as the JAX package sums OpenCV's results
        closed = closed + raster.close_rect(comp, kernel_size, iterations)
    return raster.fill_outer_contours(closed)[..., None]


def _read(path):
    try:
        return raster.imread_bgr(path)
    except OSError as exc:
        raise AssertionError(f'failed to load {path}') from exc


def _result(path, img, boxes, include_label, include_label_comparison,
            kernel_size, iterations):
    '''The panes of ``img`` under ``boxes`` by kind, with the label.'''
    panes = [img[sx:ex, sy:ey] for sx, sy, ex, ey in boxes]

    result = {'DCEE': panes[1], 'DCEL': panes[2],
              'DWI': panes[3], 'ADC': panes[4], 'TRA': panes[5]}
    if include_label:
        if not label_exists(panes[0]):
            raise AssertionError(f"{path} doesn't seem to have a label")
        result['label'] = extract_label(
            panes[0], kernel_size=kernel_size, iterations=iterations)
    elif label_exists(panes[0]):
        raise AssertionError(f'{path} has a label but is not a cancer exam')

    if include_label_comparison:
        if not include_label:
            raise AssertionError('a label comparison needs the label')
        gray = raster.bgr_to_gray(panes[0])[..., None]
        result['label_comparison'] = np.concatenate(
            [gray, result['label']], axis=1)
    return result


def extract(path, output, include_label=False,
            include_label_comparison=False, kernel_size=5, iterations=7,
            device='cuda'):
    '''Extract one collage into per-sequence images; writes
    ``output/<kind>.png`` where ``output`` is not None.'''
    img = _read(path)
    try:
        boxes = detect_internals(img, device=device)
    except ValueError as exc:
        raise ValueError(f'Failed to detect corners: {path}') from exc
    result = _result(path, img, boxes, include_label,
                     include_label_comparison, kernel_size, iterations)
    if output is not None:
        os.makedirs(output, exist_ok=True)
        for tag, out_img in result.items():
            raster.imwrite(os.path.join(output, f'{tag}.png'), out_img)
    return result


def _write(exam, slice_, results):
    for kind, img in results.items():
        kind_dir = os.path.join(exam, kind)
        os.makedirs(kind_dir, exist_ok=True)
        raster.imwrite(os.path.join(kind_dir, slice_), img)


def process_slice(args):
    (slice_, exam, dry, include_label, debug, kernel_size, iterations,
     device) = args
    results = extract(
        os.path.join(exam, slice_), None,
        include_label=include_label, include_label_comparison=debug,
        kernel_size=kernel_size, iterations=iterations, device=device)
    if not dry:
        _write(exam, slice_, results)


def _read_gray(task):
    '''Pool work: decode one collage; its gray plane for the detector.'''
    return _gray(_read(os.path.join(task[1], task[0])))


def _finish_slice(task, boxes):
    '''Pool work: decode one collage again, cut its panes under ``boxes``,
    extract the label and write the PNGs.'''
    slice_, exam, dry, include_label, debug, kernel_size, iterations = task
    path = os.path.join(exam, slice_)
    results = _result(path, _read(path), boxes, include_label, debug,
                      kernel_size, iterations)
    if not dry:
        _write(exam, slice_, results)


def _run_pool(tasks, dev, num_workers):
    '''The pool route of extract_all: a worker decodes each collage for its
    gray plane, this process finds its boxes on the device, a collage at a
    time, and a worker decodes it again to cut, label and write it. Only
    gray planes and boxes cross between the processes.'''
    import multiprocessing

    def boxes(task, gray):
        try:
            return _boxes(gray, *_candidates(gray, 25, 100, dev), 6, 3, 500)
        except ValueError as exc:
            raise ValueError('Failed to detect corners: '
                             f'{os.path.join(task[1], task[0])}') from exc

    # spawned, not forked from a process with CUDA and threads; the workers
    # import numpy, scipy and PIL only
    ctx = multiprocessing.get_context('spawn')
    with ctx.Pool(num_workers) as pool:
        jobs = [pool.apply_async(_finish_slice, (task, boxes(task, gray)))
                for task, gray in zip(tasks, pool.imap(_read_gray, tasks))]
        for job in jobs:
            job.get()


def list_exams(path, extension='png'):
    path = path.rstrip(os.path.sep)

    def supported(name):
        return os.path.splitext(name)[1][1:].lower() == extension

    return {
        exam: sorted(filter(supported, os.listdir(exam)))
        for exam in glob(os.path.join(path, '*', '*'))
        if any(map(supported, os.listdir(exam)))
    }


def extract_all(path, dry=False, debug=False, kernel_size=5, iterations=7,
                num_workers=None, device='cuda'):
    '''
    Extract individual images (TRA, ADC, etc.) from the screenshots
    under the specified directory.

    Args:
        path: directory which contains screenshots, structured as
            path/{healthy,cancer}/patientID/examID/<sliceID>.png
        dry (bool): dry run; make no changes to disk
        debug (bool): also output a label-comparison debug image
        kernel_size (int): kernel size for segmentation-map inference
        iterations (int): iterations of dilate/erode ops
        num_workers (int): process-pool size (default: cpu count; 0 runs
            serially)
        device (str): device of the corner detector ('cuda' or 'cpu')
    '''
    from ..engine import resolve_device

    start = time.perf_counter()
    if not os.path.exists(path):
        raise FileNotFoundError(f'{path} does not exist')
    healthy_path = os.path.join(path, 'healthy')
    cancer_path = os.path.join(path, 'cancer')
    if not (os.path.exists(healthy_path) and os.path.exists(cancer_path)):
        raise FileNotFoundError(f'{path} needs healthy/ and cancer/')

    tasks = []
    for exam, slices in list_exams(healthy_path).items():
        for s in slices:
            tasks.append((s, exam, dry, False, False, kernel_size,
                          iterations))
    for exam, slices in list_exams(cancer_path).items():
        for s in slices:
            tasks.append((s, exam, dry, True, debug, kernel_size,
                          iterations))

    dev = resolve_device(device)
    if num_workers == 0 or len(tasks) <= 1:
        for t in tasks:
            process_slice(t + (dev,))
    else:
        _run_pool(tasks, dev, num_workers or os.cpu_count())
    logger.info('Extracted %d slices in %.2f s', len(tasks),
                time.perf_counter() - start)

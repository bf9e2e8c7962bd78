'''The port's screenshot extractor against OpenCV and the JAX package, all
exact: every ops/raster.py function against its cv2 call on seeded
inputs, the corner responses against scipy, ``detect_internals`` against
the JAX package's jitted path, ``label_exists`` / ``extract_label`` on
seeded label panes, ``extract`` / ``extract_all`` trees file for file, and
the extracted tree's .tfrecords byte for byte.

cv2 5 returns ``HoughLinesP``'s lines as [N, 4], where OpenCV 4 returned
[N, 1, 4]; the JAX package's ``extract_label`` squeezes axis 1 and so
raises on any pane where a line is found. The JAX calls here run with
``cv2.HoughLinesP`` wrapped to OpenCV 4's shape (``jax_hough``); the port
reads [N, 4].
'''

import os
import shutil

import numpy as np
import pytest

from chip_smoke import annotation, screenshot
from dnncancerannotator_torch.ops import raster
from dnncancerannotator_torch.runs import extract as ex

PANE = 521      # a label pane as screenshot()'s grid cuts it


@pytest.fixture(scope='module')
def cv2():
    return pytest.importorskip('cv2')


@pytest.fixture
def jax_hough(cv2, monkeypatch):
    '''cv2.HoughLinesP in OpenCV 4's [N, 1, 4] shape, for the JAX calls.'''
    hough = cv2.HoughLinesP

    def v4(*args, **kwargs):
        lines = hough(*args, **kwargs)
        return None if lines is None else lines.reshape(-1, 1, 4)

    monkeypatch.setattr(cv2, 'HoughLinesP', v4)


def _cv2_lines(cv2, binary, *args, **kwargs):
    lines = cv2.HoughLinesP(binary, *args, **kwargs)
    return np.zeros((0, 4), np.int32) if lines is None else lines


# -- image files --------------------------------------------------------------
@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'L', 'LA', 'P'])
def test_imread_matches_cv2(cv2, tmp_path, mode):
    from PIL import Image
    rng = np.random.default_rng(len(mode))
    rgba = rng.integers(0, 256, (37, 53, 4), np.uint8)
    img = Image.fromarray(rgba, 'RGBA')
    img = img.convert(mode) if mode != 'P' else img.convert('RGB').convert(
        'P', palette=Image.Palette.ADAPTIVE, colors=64)
    path = str(tmp_path / 'x.png')
    img.save(path)
    want = cv2.imread(path)
    got = raster.imread_bgr(path)
    assert got.dtype == np.uint8 and got.shape == want.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape', [(41, 29, 3), (41, 29, 1), (41, 29)])
def test_imwrite_decodes_as_cv2s(cv2, tmp_path, shape):
    arr = np.random.default_rng(3).integers(0, 256, shape, np.uint8)
    ours, theirs = str(tmp_path / 'a.png'), str(tmp_path / 'b.png')
    raster.imwrite(ours, arr)
    cv2.imwrite(theirs, arr)
    a = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(a, cv2.imread(theirs, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(raster.imread_bgr(ours), cv2.imread(theirs))


def test_imread_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        raster.imread_bgr(str(tmp_path / 'none.png'))


# -- drawing ------------------------------------------------------------------
@pytest.mark.parametrize('h,w', [(520, 520), (521, 519), (301, 300),
                                 (60, 90)])
def test_fill_circle_matches_cv2(cv2, h, w):
    for center, radius in (((w // 2, h // 2), 130), ((5, 7), 40),
                           ((w - 3, h + 4), 25), ((w // 2, h // 2), 0),
                           ((w // 2, h // 2), 1), ((-20, h // 2), 60)):
        want = np.zeros((h, w, 1), np.uint8)
        cv2.circle(want, center, radius, color=255, thickness=-1)
        got = raster.fill_circle(np.zeros((h, w, 1), np.uint8), center,
                                 radius)
        np.testing.assert_array_equal(got, want)


_LINES = {
    'horizontal': [((10, 40), (150, 40)), ((150, 3), (-5, 3))],
    'vertical': [((70, 5), (70, 115)), ((0, 100), (0, 10))],
    'diagonal': [((10, 10), (110, 110)), ((120, 5), (20, 105))],
    'near_vertical': [((60, 2), (63, 117)), ((90, 110), (86, 0))],
    'off_image': [((-30, 20), (80, 140)), ((150, -10), (190, 60)),
                  ((-40, -40), (-5, 200)), ((170, 5), (400, 90))],
}


@pytest.mark.parametrize('kind', sorted(_LINES))
@pytest.mark.parametrize('thickness', [1, 3])
def test_draw_line_matches_cv2(cv2, kind, thickness):
    for p0, p1 in _LINES[kind]:
        want = np.zeros((120, 160), np.uint8)
        cv2.line(want, p0, p1, 255, thickness)
        got = raster.draw_line(np.zeros((120, 160), np.uint8), p0, p1, 255,
                               thickness)
        np.testing.assert_array_equal(got, want, err_msg=f'{p0} {p1}')


@pytest.mark.parametrize('thickness', [1, 2, 3, 5])
def test_draw_line_matches_cv2_on_random_ends(cv2, thickness):
    rng = np.random.default_rng(thickness)
    for _ in range(150):
        p0, p1 = (tuple(int(v) for v in rng.integers(-40, 200, 2))
                  for _ in range(2))
        want = np.zeros((120, 160, 1), np.uint8)
        cv2.line(want, p0, p1, 255, thickness)
        got = raster.draw_line(np.zeros((120, 160, 1), np.uint8), p0, p1,
                               255, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f'{p0} {p1}')


# -- the probabilistic Hough transform ----------------------------------------
def _hough_pane(cv2, seed, n_lines, ring):
    rng = np.random.default_rng(seed)
    img = np.zeros((520, 520), np.uint8)
    if ring:
        cv2.circle(img, (260 + int(rng.integers(-20, 20)), 260),
                   int(rng.integers(50, 100)), 255, 3)
    for _ in range(n_lines):
        p0, p1 = (tuple(int(v) for v in rng.integers(0, 520, 2))
                  for _ in range(2))
        cv2.line(img, p0, p1, 255, 1)
    return img


@pytest.mark.parametrize('n_lines,ring', [(0, False), (1, False), (3, False),
                                          (0, True), (1, True), (3, True)])
def test_hough_lines_p_matches_cv2(cv2, n_lines, ring):
    '''The extractor's parameters: the same lines in the same order.'''
    for seed in range(3):
        img = _hough_pane(cv2, seed, n_lines, ring)
        want = _cv2_lines(cv2, img, 0.5, np.pi / 1800, 50,
                          minLineLength=100, maxLineGap=2)
        got = raster.hough_lines_p(img)
        assert got.dtype == np.int32 and got.shape[1:] == (4,)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(raster.hough_lines_p(img[..., None]),
                                      want)
    if n_lines:
        assert len(got)


@pytest.mark.parametrize('params', [(1, np.pi / 180, 20, 10, 3),
                                    (2.0, np.pi / 360, 10, 5, 0)])
def test_hough_lines_p_matches_cv2_on_noise(cv2, params):
    '''Other parameters, noise and thick lines crossing the border.'''
    rho, theta, threshold, length, gap = params
    for seed in range(6):
        rng = np.random.default_rng(100 + seed)
        h, w = (int(v) for v in rng.integers(60, 200, 2))
        img = (rng.random((h, w)) < 0.03).astype(np.uint8) * 255
        for _ in range(4):
            p0, p1 = (tuple(int(v) for v in rng.integers(-10, 210, 2))
                      for _ in range(2))
            cv2.line(img, p0, p1, 255, int(rng.integers(1, 3)))
        want = _cv2_lines(cv2, img, rho, theta, threshold,
                          minLineLength=length, maxLineGap=gap)
        got = raster.hough_lines_p(img, rho, theta, threshold, length, gap)
        np.testing.assert_array_equal(got, want)


# -- components and morphology ------------------------------------------------
def _component_sets(labels, n):
    return sorted(tuple(np.flatnonzero(labels == i)) for i in range(1, n))


def test_connected_components8_sets_match_cv2(cv2):
    rng = np.random.default_rng(0)
    for density in (0.05, 0.1, 0.3, 0.6):
        for _ in range(10):
            mask = (rng.random((60, 70)) < density).astype(np.uint8) * 255
            n, labels = cv2.connectedComponents(mask)
            n2, labels2 = raster.connected_components8(mask)
            assert labels2.dtype == np.int32 and n2 == n
            assert _component_sets(labels2, n2) == _component_sets(labels, n)


def _blob_masks(seed, n=12):
    '''Sparse masks of discs and strokes, several touching the border.'''
    rng = np.random.default_rng(seed)
    masks = []
    for i in range(n):
        mask = np.zeros((90, 110), np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            y, x = rng.integers(-5, 95, 2)
            r = int(rng.integers(1, 9))
            mask[max(y - r, 0):y + r, max(x - r, 0):x + r] = 255
        mask[rng.random(mask.shape) < 0.004] = 255
        if i % 3 == 0:
            mask[:, :2] = 255 * (rng.random((90, 2)) < 0.5)
        masks.append(mask)
    return masks


@pytest.mark.parametrize('k', [5, 9])
@pytest.mark.parametrize('iterations', [1, 7])
def test_close_rect_matches_cv2(cv2, k, iterations):
    kernel = np.ones((k, k), np.uint8)
    for mask in _blob_masks(k * 10 + iterations):
        want = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel,
                                iterations=iterations)
        np.testing.assert_array_equal(raster.close_rect(mask, k, iterations),
                                      want)


@pytest.mark.parametrize('k,iterations', [(4, 1), (4, 2), (6, 3)])
def test_close_rect_matches_cv2_at_even_sizes(cv2, k, iterations):
    '''An even square's anchor sits off centre and scales with the passes.'''
    kernel = np.ones((k, k), np.uint8)
    for mask in _blob_masks(k):
        want = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel,
                                iterations=iterations)
        np.testing.assert_array_equal(raster.close_rect(mask, k, iterations),
                                      want)


def _ring(mask, cy, cx, r, width):
    yy, xx = np.mgrid[:mask.shape[0], :mask.shape[1]]
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    mask[(d2 <= r * r) & (d2 > (r - width) ** 2)] = 255


def _contour_cases():
    rings = np.zeros((80, 80), np.uint8)
    _ring(rings, 40, 40, 30, 2)
    _ring(rings, 10, 70, 12, 1)            # cut by the border
    nested = np.zeros((80, 80), np.uint8)
    for r in (36, 26, 16, 6):
        _ring(nested, 40, 40, r, 2)
    nested[40, 40] = 255
    pinch = np.zeros((40, 60), np.uint8)
    pinch[5:15, 5:15] = 255
    pinch[15:25, 15:25] = 255              # touches diagonally
    pinch[6:14, 6:14] = 0                  # a hole in the first square
    pinch[30, 40:50] = 255
    pinch[31, 50] = 255                    # a one-pixel diagonal step
    diagonal = np.zeros((30, 30), np.uint8)
    for i in range(10):                    # a closed diamond, 1 px thick
        for y in (5 + i, 24 - i):
            diagonal[y, 15 + i] = diagonal[y, 15 - i] = 255
    rng = np.random.default_rng(7)
    noise = [(rng.random((50, 60)) < p).astype(np.uint8) * 255
             for p in (0.1, 0.3, 0.5, 0.7)]
    return {'rings': [rings], 'nested': [nested], 'pinch': [pinch],
            'diagonal': [diagonal], 'noise': noise}


@pytest.mark.parametrize('case', ['rings', 'nested', 'pinch', 'diagonal',
                                  'noise'])
def test_fill_outer_contours_matches_cv2(cv2, case):
    for mask in _contour_cases()[case]:
        contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        want = np.zeros_like(mask)
        cv2.fillPoly(want, contours, 255)
        np.testing.assert_array_equal(raster.fill_outer_contours(mask), want)


def test_bgr_to_gray_matches_cv2(cv2):
    img = np.random.default_rng(0).integers(0, 256, (90, 120, 3), np.uint8)
    np.testing.assert_array_equal(raster.bgr_to_gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


# -- the corner detector ------------------------------------------------------
@pytest.mark.parametrize('size,penalty', [(25, 10), (7, 3), (4, 1)])
def test_corner_response_equals_scipy(size, penalty):
    from scipy import signal
    rng = np.random.default_rng(size)
    filt = ex.get_orthogonal_detector(size, penalty)
    for density in (0.05, 0.5):
        binary = (rng.random((61, 77)) < density).astype(np.uint8)
        for f in (filt, np.flip(filt)):
            got = ex.corner_response(binary, f, 'cpu')
            assert got.dtype.is_floating_point is False
            want = signal.convolve2d(binary.astype(np.float32), np.flip(f),
                                     'valid')
            np.testing.assert_array_equal(got.numpy(), want)


def test_corner_response_any_integer_filter():
    from scipy import signal
    rng = np.random.default_rng(1)
    filt = rng.integers(-3, 4, (5, 6)).astype(np.float32)
    binary = (rng.random((40, 50)) < 0.4).astype(np.uint8)
    np.testing.assert_array_equal(
        ex.corner_response(binary, filt, 'cpu').numpy(),
        signal.convolve2d(binary, np.flip(filt), 'valid'))
    with pytest.raises(ValueError, match='no valid position'):
        ex.corner_response(binary[:3], filt, 'cpu')


@pytest.mark.parametrize('seed', [0, 1])
def test_detect_internals_matches_jax(seed):
    from dnncancerannotator_tpu.runs import extract as jax_ex
    img, boxes, _ = screenshot(seed, annotate=True, ruler=True)
    want = jax_ex.detect_internals(img, use_jax=True)
    got = ex.detect_internals(img, device='cpu')
    assert [tuple(map(int, b)) for b in got] == \
        [tuple(map(int, b)) for b in want] == boxes
    binary = (ex._gray(img) >= 100).astype(np.float32)
    filt = ex.get_orthogonal_detector(25)
    for f in (filt, np.flip(filt)):
        np.testing.assert_array_equal(
            ex.corner_response(binary, f, 'cpu').numpy(),
            jax_ex._conv2d_valid(binary, f, use_jax=True))


def test_detect_internals_failure_raises_like_jax():
    from dnncancerannotator_tpu.runs import extract as jax_ex
    blank = np.full((700, 900, 3), 30, np.uint8)
    with pytest.raises(ValueError) as want:
        jax_ex.detect_internals(blank, use_jax=True)
    with pytest.raises(ValueError) as got:
        ex.detect_internals(blank, device='cpu')
    assert str(got.value).split('.')[0] == str(want.value).split('.')[0]


# -- the label pane -----------------------------------------------------------
def _label_pane(seed, ruler, cv2):
    '''A seeded 521^2 label pane: monochrome texture, one annotation of
    chip_smoke.annotation, with ``ruler`` a 1-px line across it drawn by
    cv2 at any angle (300-480 px: at rho 0.5 a slanted line's votes spread
    over neighbouring bins, and a shorter one may not reach 50).'''
    rng = np.random.default_rng(seed)
    pane = np.repeat(rng.integers(30, 90, (PANE, PANE, 1), np.uint8), 3, 2)
    outline, _, (cy, cx) = annotation(rng, PANE, ruler)
    pane[outline] = ((0, 0, 255), (0, 255, 0), (40, 200, 220))[seed % 3]
    if ruler:
        angle = rng.uniform(0, 2 * np.pi)
        length = rng.uniform(300, 480)
        p0 = (int(cx - length / 2 * np.cos(angle)),
              int(cy - length / 2 * np.sin(angle)))
        p1 = (int(cx + length / 2 * np.cos(angle)),
              int(cy + length / 2 * np.sin(angle)))
        cv2.line(pane, p0, p1, (0, 255, 255), 1)
    return pane


@pytest.mark.parametrize('seed', range(8))
@pytest.mark.parametrize('ruler', [False, True])
def test_extract_label_matches_jax(cv2, jax_hough, seed, ruler):
    from dnncancerannotator_tpu.runs import extract as jax_ex
    pane = _label_pane(seed, ruler, cv2)
    assert ex.label_exists(pane) == jax_ex.label_exists(pane) == True  # noqa
    for kernel_size, iterations in ((5, 7), (9, 1)):
        want = jax_ex.extract_label(pane, kernel_size=kernel_size,
                                    iterations=iterations)
        got = ex.extract_label(pane, kernel_size=kernel_size,
                               iterations=iterations)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_label_panes_with_rulers_have_lines(cv2):
    '''The ruler panes above reach the line eraser: Hough finds a line on
    most of them.'''
    found = [len(raster.hough_lines_p(
        (~ex._monochrome_mask(_label_pane(seed, True, cv2))).astype(
            np.uint8)[..., None] * 255)) for seed in range(8)]
    assert sum(n > 0 for n in found) >= 6, found


def test_label_exists_matches_jax(cv2):
    from dnncancerannotator_tpu.runs import extract as jax_ex
    for shape in ((520, 520), (521, 519), (301, 300)):
        pane = np.full(shape + (3,), 60, np.uint8)
        assert not ex.label_exists(pane) and not jax_ex.label_exists(pane)
        for y, x in ((shape[0] // 2, shape[1] // 2 + 129),
                     (shape[0] // 2, shape[1] // 2 + 131),
                     (shape[0] // 2 - 93, shape[1] // 2 + 93)):
            marked = pane.copy()
            marked[y, x] = (0, 0, 255)
            assert ex.label_exists(marked) == jax_ex.label_exists(marked)


def test_jax_extract_label_squeeze_fault_on_cv2_5(cv2):
    '''With cv2 5's [N, 4] lines the JAX package's extract_label raises
    wherever Hough finds a line (OpenCV 4's [N, 1, 4] it reads); the port
    reads [N, 4].'''
    from dnncancerannotator_tpu.runs import extract as jax_ex
    pane = _label_pane(0, True, cv2)
    color = (~ex._monochrome_mask(pane)).astype(np.uint8)[..., None] * 255
    lines = cv2.HoughLinesP(color, 0.5, np.pi / 1800, 50, minLineLength=100,
                            maxLineGap=2)
    assert lines is not None
    if lines.ndim == 2:
        with pytest.raises(ValueError, match='squeeze'):
            jax_ex.extract_label(pane, kernel_size=5, iterations=7)
    else:
        np.testing.assert_array_equal(
            ex.extract_label(pane, kernel_size=5, iterations=7),
            jax_ex.extract_label(pane, kernel_size=5, iterations=7))
    np.testing.assert_array_equal(raster.hough_lines_p(color),
                                  lines.reshape(-1, 4))
    assert ex.extract_label(pane, kernel_size=5, iterations=7).any()


# -- extract and extract_all --------------------------------------------------
def _collage_tree(root):
    '''root/{cancer,healthy}/1/1/0{1,2}.png: screenshot() collages, the
    second cancer one with a ruler.'''
    for category in ('cancer', 'healthy'):
        exam = os.path.join(root, category, '1', '1')
        os.makedirs(exam)
        for s in (1, 2):
            img = screenshot(10 * s + (category == 'cancer'),
                             annotate=category == 'cancer', ruler=s == 2)[0]
            raster.imwrite(os.path.join(exam, f'{s:02d}.png'), img)
    return root


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    '''A 2 + 2 collage tree and the JAX package's extract_all of a copy
    (use_jax=True, serial, debug).'''
    cv2 = pytest.importorskip('cv2')
    from dnncancerannotator_tpu.runs import extract as jax_ex
    base = tmp_path_factory.mktemp('torch_extract')
    source = _collage_tree(str(base / 'source'))
    jax_tree = str(base / 'jax')
    shutil.copytree(source, jax_tree)
    hough = cv2.HoughLinesP
    cv2.HoughLinesP = lambda *a, **k: (lambda lines: None if lines is None
                                       else lines.reshape(-1, 1, 4))(
        hough(*a, **k))
    try:
        jax_ex.extract_all(jax_tree, debug=True, use_jax=True, num_workers=0)
    finally:
        cv2.HoughLinesP = hough
    return dict(source=source, jax=jax_tree, base=base)


@pytest.mark.parametrize('num_workers', [0, 2])
def test_extract_all_matches_jax(cv2, trees, tmp_path, num_workers):
    ours = str(tmp_path / 'tree')
    shutil.copytree(trees['source'], ours)
    ex.extract_all(ours, debug=True, num_workers=num_workers, device='cpu')
    files = _files(ours)
    assert files == _files(trees['jax'])
    assert len(files) == 4 + 4 * 5 + 2 * 2
    assert not os.path.exists(os.path.join(ours, 'healthy', '1', '1',
                                           'label'))
    for rel in files:
        want = cv2.imread(os.path.join(trees['jax'], rel),
                          cv2.IMREAD_UNCHANGED)
        got = cv2.imread(os.path.join(ours, rel), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, want, err_msg=rel)


def test_extract_matches_jax(cv2, jax_hough, trees, tmp_path):
    from dnncancerannotator_tpu.runs import extract as jax_ex
    path = os.path.join(trees['source'], 'cancer', '1', '1', '02.png')
    want = jax_ex.extract(path, str(tmp_path / 'jax'), include_label=True,
                          include_label_comparison=True, use_jax=True)
    got = ex.extract(path, str(tmp_path / 'ours'), include_label=True,
                     include_label_comparison=True, device='cpu')
    assert sorted(got) == sorted(want) == sorted(
        ['DCEE', 'DCEL', 'DWI', 'ADC', 'TRA', 'label', 'label_comparison'])
    for kind in want:
        np.testing.assert_array_equal(got[kind], want[kind], err_msg=kind)
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / 'ours' / f'{kind}.png'),
                       cv2.IMREAD_UNCHANGED),
            cv2.imread(str(tmp_path / 'jax' / f'{kind}.png'),
                       cv2.IMREAD_UNCHANGED))


def test_extract_label_checks_raise(trees, tmp_path):
    '''A cancer collage without a label and a healthy one with a label
    raise, with the JAX package's message where it has one.'''
    cancer = os.path.join(trees['source'], 'cancer', '1', '1', '01.png')
    healthy = os.path.join(trees['source'], 'healthy', '1', '1', '01.png')
    with pytest.raises(AssertionError, match="doesn't seem to have a label"):
        ex.extract(healthy, None, include_label=True, device='cpu')
    with pytest.raises(AssertionError, match='has a label'):
        ex.extract(cancer, None, device='cpu')
    with pytest.raises(AssertionError, match='failed to load'):
        ex.extract(str(tmp_path / 'none.png'), None, device='cpu')
    with pytest.raises(FileNotFoundError):
        ex.extract_all(str(tmp_path / 'none'), device='cpu')


def test_extract_all_dry_writes_nothing(trees, tmp_path):
    ours = str(tmp_path / 'tree')
    shutil.copytree(trees['source'], ours)
    before = _files(ours)
    ex.extract_all(ours, dry=True, num_workers=2, device='cpu')
    assert _files(ours) == before


def test_extract_all_cli(trees, tmp_path):
    from dnncancerannotator_torch.runs.__main__ import main
    ours = str(tmp_path / 'tree')
    shutil.copytree(trees['source'], ours)
    main(argv=['extract_all', '--path', ours, '--num_workers', '0',
               '--device', 'cpu'])
    assert _files(ours) == [f for f in _files(trees['jax'])
                            if 'label_comparison' not in f]


@pytest.mark.parametrize('category', ['cancer', 'healthy'])
def test_extracted_tree_tfrecords_byte_equal_to_jax_chain(trees, tmp_path,
                                                          category):
    '''tests/test_full_chain.py's handoff: extract_all then
    generate_tfrecords, the port's chain against the JAX package's.'''
    from dnncancerannotator_tpu.data import generate_tfrecords as jax_gen
    from dnncancerannotator_torch.data.records import generate_tfrecords
    tree = str(tmp_path / 'tree')      # a record holds its exam's path
    shutil.copytree(trees['source'], tree)
    ex.extract_all(tree, num_workers=0, device='cpu')
    a, b = str(tmp_path / 'ours.tfrecords'), str(tmp_path / 'jax.tfrecords')
    assert generate_tfrecords(tree, a, category=category,
                              output_size=(256, 256)) == 1
    shutil.rmtree(tree)
    shutil.copytree(trees['jax'], tree)
    assert jax_gen(tree, b, category=category, output_size=(256, 256)) == 1
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        assert fa.read() == fb.read()

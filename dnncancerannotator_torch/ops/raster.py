'''Host raster operations of the screenshot extractor, without OpenCV.

The JAX package's extractor (dnncancerannotator_tpu/runs/extract.py) calls
OpenCV for its image I/O and for the label pane's clean-up. This module
holds the port's counterparts, in numpy and scipy.ndimage, each giving
OpenCV's pixels exactly (tests/test_torch_extract.py holds each one
against its cv2 call):

- ``imread_bgr`` / ``imwrite``: ``cv2.imread`` (IMREAD_COLOR: 3 channels,
  BGR) and ``cv2.imwrite`` of PNGs, through PIL;
- ``fill_circle``: ``cv2.circle(..., thickness=-1)``, OpenCV's midpoint
  circle;
- ``draw_line``: ``cv2.line`` with LINE_8: at thickness 1 the
  8-connected line iterator; thicker, the segment clipped to the image
  grown by the thickness, then a convex quadrilateral in 16-bit fixed
  point with round caps;
- ``hough_lines_p``: ``cv2.HoughLinesP``, OpenCV's progressive
  probabilistic Hough transform step for step (its random generator, its
  float32 tables, its fixed-point walk), so the same lines in the same
  order; ``[N, 4]`` int32 rows ``(x0, y0, x1, y1)``;
- ``connected_components8``: the 8-connected components of
  ``cv2.connectedComponents`` (the same sets; the numbering may differ);
- ``close_rect``: ``cv2.morphologyEx(MORPH_CLOSE)`` with a k x k square
  and ``iterations``;
- ``fill_outer_contours``: ``cv2.findContours(RETR_EXTERNAL)`` followed by
  ``cv2.fillPoly`` of those contours: the mask with its holes filled;
- ``bgr_to_gray``: ``cv2.cvtColor(COLOR_BGR2GRAY)`` in OpenCV's fixed
  point.

Every function works on uint8 arrays and draws in place where OpenCV does.
'''

import math

import numpy as np
from scipy import ndimage

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


# -- image files --------------------------------------------------------------
def imread_bgr(path):
    '''``cv2.imread(path)``: the image as [H, W, 3] uint8 in BGR order.

    8-bit grayscale (with or without alpha), RGB, RGBA and palette images
    decode to OpenCV's pixels: gray is repeated over the three channels,
    alpha is dropped, a palette is expanded. Raises OSError where the file
    is missing or not an image, and ValueError for a pixel format OpenCV
    would convert otherwise (16-bit, 1-bit, CMYK...).
    '''
    from PIL import Image
    with Image.open(path) as img:
        mode = img.mode
        if mode == 'P':
            arr = np.asarray(img.convert('RGB'))
        elif mode in ('L', 'LA', 'RGB', 'RGBA'):
            arr = np.asarray(img)
        else:
            raise ValueError(f'{path}: unsupported pixel format {mode}')
    if mode in ('L', 'LA'):
        gray = arr if arr.ndim == 2 else arr[..., 0]
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(arr[..., 2::-1])


def imwrite(path, arr):
    '''``cv2.imwrite(path, arr)`` for PNGs: [H, W, 3] BGR is written as an
    RGB PNG, [H, W, 1] and [H, W] as grayscale, at zlib level 1 (OpenCV's
    default PNG compression).'''
    from PIL import Image
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f'imwrite takes uint8, got {arr.dtype}')
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if arr.ndim == 3 and arr.shape[2] == 3:
        arr = arr[..., ::-1]
    elif arr.ndim != 2:
        raise ValueError(f'imwrite takes [H, W], [H, W, 1] or [H, W, 3], '
                         f'got {arr.shape}')
    Image.fromarray(np.ascontiguousarray(arr)).save(
        path, format='PNG', compress_level=1)


# -- drawing ------------------------------------------------------------------
def _hline(img, y, x0, x1, value):
    '''Pixels x0..x1 (inclusive) of row y, clipped to the image.'''
    h, w = img.shape[:2]
    if 0 <= y < h:
        x0, x1 = max(x0, 0), min(x1, w - 1)
        if x0 <= x1:
            img[y, x0:x1 + 1] = value


def _filled_circle(img, cx, cy, radius, value):
    '''OpenCV's midpoint circle (drawing.cpp: Circle) with fill: four
    spans a step, clipped to the image.'''
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, x0, x1 in ((cy - dy, cx - dx, cx + dx),
                          (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy),
                          (cy + dx, cx - dy, cx + dy)):
            _hline(img, y, x0, x1, value)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def fill_circle(mask, center, radius, value=255):
    '''``cv2.circle(mask, center, radius, value, thickness=-1)`` in place on
    [H, W] or [H, W, 1] uint8; returns ``mask``.'''
    cx, cy = map(int, center)
    _filled_circle(mask, cx, cy, int(radius), value)
    return mask


def _clip_line(w, h, x1, y1, x2, y2):
    '''OpenCV's clipLine to [0, w) x [0, h): (inside, x1, y1, x2, y2),
    the cut points by its double-precision quotients, truncated.'''
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _trunc_div(a, b):
    '''C's integer division (toward zero).'''
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line_int(img, p1, p2, value):
    '''OpenCV's Line: the 8-connected LineIterator between integer ends,
    walked left to right.'''
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = _clip_line(w, h, *p1, *p2)
    if not inside:
        return
    step_x = step_y = 1
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    # the major axis always steps; the minor one where err goes negative
    major = (0, step_y) if vert else (step_x, 0)
    minor = (step_x, 0) if vert else (0, step_y)
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        mask = -1 if err < 0 else 0
        err += minus_delta + (plus_delta & mask)
        x += major[0] + (minor[0] & mask)
        y += major[1] + (minor[1] & mask)


def _line_fixed(img, p1, p2, value):
    '''OpenCV's Line2: a LINE_8 line between fixed-point (16-bit) ends.'''
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT,
                                        p1[0], p1[1], p2[0], p2[1])
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        if j:
            x1, y1, x2, y2 = x2, y2, x1, y1
        dy = (dy ^ j) - j
        y_step = _trunc_div(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if i:
            x1, y1, x2, y2 = x2, y2, x1, y1
        dx = (dx ^ i) - i
        x_step = _trunc_div(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = value

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(img, v, value):
    '''OpenCV's FillConvexPoly (LINE_8, points in 16-bit fixed point):
    the outline by Line2, then one span a row between the two edges.'''
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    for p in v:
        _line_fixed(img, p0, p, value)
        p0 = p
    xmin = (min(xs) + delta) >> XY_SHIFT
    xmax = (max(xs) + delta) >> XY_SHIFT
    ymin = (min(ys) + delta) >> XY_SHIFT
    ymax = (max(ys) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e['ye']:
                idx0, di = e['idx'], e['di']
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        x_s, x_e = v[idx0][0], v[idx][0]
                        e['ye'] = ty
                        e['dx'] = _trunc_div((x_e - x_s) * 2 + (ty - y),
                                             2 * (ty - y))
                        e['x'] = x_s
                        e['idx'] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]['x'] > edge[1]['x'] else (0, 1)
            xx1 = (edge[left]['x'] + delta) >> XY_SHIFT
            xx2 = (edge[right]['x'] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, xx1, xx2, value)
        edge[0]['x'] += edge[0]['dx']
        edge[1]['x'] += edge[1]['dx']
        y += 1
        if y > ymax:
            break


def _round_half_even(x):
    '''cvRound of a double: round half to even.'''
    return int(np.rint(x))


def draw_line(img, p0, p1, value=255, thickness=1):
    '''``cv2.line(img, p0, p1, value, thickness)`` with LINE_8 in place on
    [H, W] or [H, W, 1] uint8; returns ``img``.'''
    p0, p1 = tuple(map(int, p0)), tuple(map(int, p1))
    if thickness <= 1:
        _line_int(img, p0, p1, value)
        return img
    # OpenCV first clips the segment to the image grown by the thickness
    h, w = img.shape[:2]
    t = thickness
    inside, x0, y0, x1, y1 = _clip_line(w + 2 * t, h + 2 * t, p0[0] + t,
                                        p0[1] + t, p1[0] + t, p1[1] + t)
    if not inside:
        return img
    x0, y0, x1, y1 = ((c - t) << XY_SHIFT for c in (x0, y0, x1, y1))
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (thick + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx = _round_half_even(dy * r)
        dpy = _round_half_even(dx * r)
        _fill_convex_poly(img, [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                                (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)],
                          value)
    radius = (thick + (XY_ONE >> 1)) >> XY_SHIFT
    for x, y in ((x0, y0), (x1, y1)):
        _filled_circle(img, (x + (XY_ONE >> 1)) >> XY_SHIFT,
                       (y + (XY_ONE >> 1)) >> XY_SHIFT, radius, value)
    return img


# -- the probabilistic Hough transform ----------------------------------------
def _num_angles(theta):
    '''OpenCV's computeNumangle over [0, pi) for a float32 step.'''
    n = math.floor(math.pi / theta) + 1
    if n > 1 and abs(math.pi - (n - 1) * theta) < theta / 2:
        n -= 1
    return n


def _rng_draws():
    '''cv::RNG(2^64 - 1): multiply-with-carry, 32-bit draws.'''
    state = (1 << 64) - 1
    while True:
        state = (state & 0xFFFFFFFF) * 4164903690 + (state >> 32)
        yield state & 0xFFFFFFFF


def hough_lines_p(binary, rho=0.5, theta=np.pi / 1800, threshold=50,
                  min_line_length=100, max_line_gap=2):
    '''``cv2.HoughLinesP(binary, rho, theta, threshold, minLineLength=...,
    maxLineGap=...)``: [N, 4] int32 rows (x0, y0, x1, y1) in OpenCV's
    order, or an empty [0, 4] array.

    OpenCV's HoughLinesProbabilistic, step for step: the non-zero points in
    raster order are drawn at random (cv::RNG seeded with 2^64 - 1, the
    drawn point swapped with the last); a point still in the mask votes
    for every angle of the float32 tables cos(n theta) / rho and
    sin(n theta) / rho (votes rounded half to even, offset by (numrho -
    1) / 2); where its best angle reaches ``threshold``, the line through
    it is walked both ways in 16-bit fixed point until a gap longer than
    ``max_line_gap``; a segment at least ``min_line_length`` long in x or
    y is kept, its points taking their votes back; every walked point
    leaves the mask.
    '''
    binary = np.asarray(binary)
    if binary.ndim == 3:
        binary = binary[..., 0]
    height, width = binary.shape
    rho, theta = np.float32(rho), np.float32(theta)
    irho = np.float32(1) / rho
    numangle = _num_angles(float(theta))
    numrho = _round_half_even(np.float32((width + height) * 2 + 1) / rho)
    offset = (numrho - 1) // 2
    # the C library's cos and sin in double, as OpenCV's tables
    cos_t = np.array([math.cos(n * float(theta)) * float(irho)
                      for n in range(numangle)], np.float32)
    sin_t = np.array([math.sin(n * float(theta)) * float(irho)
                      for n in range(numangle)], np.float32)
    rows = np.arange(numangle, dtype=np.int64) * numrho
    accum = np.zeros(numangle * numrho, np.int32)
    line_length = _round_half_even(min_line_length)
    line_gap = _round_half_even(max_line_gap)
    shift = 16

    mask = binary != 0
    ys, xs = np.nonzero(mask)
    nzloc = list(zip(xs.tolist(), ys.tolist()))

    def cells(x, y):
        r = np.rint(np.float32(x) * cos_t + np.float32(y) * sin_t)
        return rows + r.astype(np.int64) + offset

    lines = []
    draws = _rng_draws()
    for count in range(len(nzloc), 0, -1):
        idx = next(draws) % count
        j, i = nzloc[idx]
        nzloc[idx] = nzloc[count - 1]
        if not mask[i, j]:
            continue
        at = cells(j, i)
        accum[at] += 1
        votes = accum[at]
        max_n = int(np.argmax(votes))
        if votes[max_n] < threshold:
            continue

        a = -sin_t[max_n]
        b = cos_t[max_n]
        x0, y0 = j, i
        if abs(a) > abs(b):
            xflag = True
            dx0 = 1 if a > 0 else -1
            dy0 = _round_half_even(np.float32(b * np.float32(1 << shift))
                                   / abs(a))
            y0 = (y0 << shift) + (1 << (shift - 1))
        else:
            xflag = False
            dy0 = 1 if b > 0 else -1
            dx0 = _round_half_even(np.float32(a * np.float32(1 << shift))
                                   / abs(b))
            x0 = (x0 << shift) + (1 << (shift - 1))

        def walk(k):
            x, y = x0, y0
            dx, dy = (dx0, dy0) if k == 0 else (-dx0, -dy0)
            while True:
                if xflag:
                    yield x, y >> shift
                else:
                    yield x >> shift, y
                x += dx
                y += dy

        line_end = [None, None]
        for k in range(2):
            gap = 0
            for j1, i1 in walk(k):
                if j1 < 0 or j1 >= width or i1 < 0 or i1 >= height:
                    break
                if mask[i1, j1]:
                    gap = 0
                    line_end[k] = (j1, i1)
                else:
                    gap += 1
                    if gap > line_gap:
                        break

        good_line = (abs(line_end[1][0] - line_end[0][0]) >= line_length
                     or abs(line_end[1][1] - line_end[0][1]) >= line_length)

        for k in range(2):
            for j1, i1 in walk(k):
                if mask[i1, j1]:
                    if good_line:
                        accum[cells(j1, i1)] -= 1
                    mask[i1, j1] = False
                if (j1, i1) == line_end[k]:
                    break

        if good_line:
            lines.append((*line_end[0], *line_end[1]))
    return np.array(lines, np.int32).reshape(-1, 4)


# -- components and morphology ------------------------------------------------
_EIGHT = np.ones((3, 3), bool)


def connected_components8(binary):
    '''The 8-connected components of the non-zero pixels of [H, W]:
    (count including the background label 0, int32 labels). The sets equal
    ``cv2.connectedComponents``'; the numbering may differ.'''
    labels, n = ndimage.label(np.asarray(binary) != 0, structure=_EIGHT)
    return n + 1, labels.astype(np.int32)


def close_rect(binary, kernel_size, iterations=1):
    '''``cv2.morphologyEx(binary, MORPH_CLOSE, ones((k, k)), iterations=n)``
    on a 0/255 uint8 [H, W] mask: OpenCV merges the n passes into one
    square of side (k - 1) n + 1 (anchor scaled by n), dilates with a
    background border and erodes with a foreground border.'''
    k, n = int(kernel_size), int(iterations)
    side = (k - 1) * n + 1
    anchor = (k // 2) * n
    origin = anchor - side // 2
    fg = np.asarray(binary) != 0
    dilated = ndimage.maximum_filter(fg, size=side, mode='constant',
                                     cval=False, origin=origin)
    closed = ndimage.minimum_filter(dilated, size=side, mode='constant',
                                    cval=True, origin=origin)
    return closed.astype(np.uint8) * 255


def fill_outer_contours(binary):
    '''``cv2.fillPoly`` of ``cv2.findContours(binary, RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE)``: every non-zero pixel, and every background
    pixel no 4-connected path of background links to the border. A 0/255
    uint8 mask of the input's shape.'''
    binary = np.asarray(binary)
    filled = ndimage.binary_fill_holes(binary != 0)
    return filled.astype(np.uint8) * 255


def bgr_to_gray(img):
    '''``cv2.cvtColor(img, COLOR_BGR2GRAY)`` on [H, W, 3] uint8: OpenCV's
    15-bit fixed-point weights (B 3735, G 19235, R 9798), rounded.'''
    img = np.asarray(img).astype(np.int32)
    gray = (img[..., 0] * 3735 + img[..., 1] * 19235 + img[..., 2] * 9798
            + (1 << 14)) >> 15
    return gray.astype(np.uint8)

'''Thin-plate-spline warp of the augmentation chain (counterpart of
dnncancerannotator_tpu.ops.warp).

A polyharmonic (thin-plate, order 2) spline interpolates a flow field from
control-point displacements; the image is resampled at ``grid - flow``. As
in the JAX package:

- the spline is solved in f32 in [0, 1]-normalised coordinates (the
  pixel-scale kernel matrix is catastrophically ill-conditioned in f32);
  displacement values stay in pixels;
- ``method='two_pass'``: the flow is evaluated on a coarse grid of stride
  ``flow_grid_stride``, clamped to +-max_displacement, and corrected for
  the two-pass composition (the vertical pass takes fy at the source
  column, so fy is evaluated there), then upsampled bilinearly by two
  small matmuls and resampled by the two-pass kernel
  (ops/kernels/warp_twopass.py);
- ``method='exact'``: the flow is evaluated at every pixel and the image
  resampled by a bilinear gather with edge clamping (``dense_image_warp``).

``sparse_image_warp`` is the per-step warp; ``coarse_twopass_flow`` is the
warp-bank solve and ``warp_with_coarse_flow`` resamples a batch at bank
flows; ``sparse_image_warp_cropped`` is the fused chain's warp, with the
crop folded into the resample (ops/kernels/warp_crop.py).
'''

import functools

import numpy as np
import torch

from .kernels import warp_crop as warp_crop_mod
from .kernels import warp_twopass as warp_mod


def _phi_order2(r2):
    '''Thin-plate kernel on squared distances: r^2 log(r) = 0.5 r^2 log(r^2).'''
    return 0.5 * r2 * torch.log(torch.clamp(r2, min=1e-10))


def _solve_spline(train_points, train_values, regularization=0.0):
    '''Fit spline weights for a batch: train_points [B, N, 2], train_values
    [B, N, D] -> (w [B, N, D], v [B, 3, D]) radial and affine weights.'''
    b, n, _ = train_points.shape
    d2 = ((train_points[:, :, None, :] - train_points[:, None, :, :]) ** 2
          ).sum(-1)
    a = _phi_order2(d2)
    if regularization:
        a = a + regularization * torch.eye(n, dtype=a.dtype, device=a.device)
    ones = torch.ones(b, n, 1, dtype=a.dtype, device=a.device)
    bm = torch.cat([ones, train_points], dim=2)                  # [B, N, 3]
    zeros = torch.zeros(b, 3, 3, dtype=a.dtype, device=a.device)
    lhs = torch.cat([torch.cat([a, bm], dim=2),
                     torch.cat([bm.transpose(1, 2), zeros], dim=2)], dim=1)
    rhs = torch.cat([train_values, torch.zeros(
        b, 3, train_values.shape[2], dtype=a.dtype, device=a.device)], dim=1)
    sol = torch.linalg.solve(lhs, rhs)
    return sol[:, :n], sol[:, n:]


def _evaluate_spline(query_points, train_points, w, v):
    '''Evaluate fitted splines at query points [B, M, 2] -> [B, M, D].'''
    d2 = ((query_points[:, :, None, :] - train_points[:, None, :, :]) ** 2
          ).sum(-1)
    ones = torch.ones(*query_points.shape[:2], 1, dtype=query_points.dtype,
                      device=query_points.device)
    return _phi_order2(d2) @ w + torch.cat([ones, query_points], dim=2) @ v


def _flow_from_points(train_pts, train_vals, gy, gx, scale, regularization,
                      clamp, d, two_pass):
    '''Coarse spline flows [B, hc, wc, 2] from pixel-space control points
    [B, N, 2] and their displacements [B, N, 2]; gy, gx are the [hc, wc]
    pixel coordinates of the coarse grid.'''
    b = train_pts.shape[0]
    hc, wc = gy.shape
    tp = train_pts.float() * scale
    wgt, v = _solve_spline(tp, train_vals, regularization)
    grid = torch.stack([gy.reshape(-1), gx.reshape(-1)], dim=-1) * scale
    fl = _evaluate_spline(grid.expand(b, -1, -1), tp, wgt, v)
    fl = fl.reshape(b, hc, wc, 2)
    if clamp:
        fl = fl.clamp(-d, d)
    if two_pass:
        # the horizontal pass reads the vertically resampled image at the
        # source column x' = x - fx, so the vertical pass must use the flow
        # of the target column x ~ x' + fx: evaluate fy there
        qpts = torch.stack([gy.reshape(-1).expand(b, -1),
                            (gx + fl[..., 1]).reshape(b, -1)], dim=-1) * scale
        fy = _evaluate_spline(qpts, tp, wgt, v)[..., 0].reshape(b, hc, wc)
        fl = torch.stack([fy, fl[..., 1]], dim=-1)
    return fl


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_fine, stride, n_coarse, device=None):
    '''Exact 1D bilinear-upsampling matrix [n_fine, n_coarse] for coarse
    samples at coordinates ``i * stride`` (made once per shape and device:
    every train step's warp uses the same two).'''
    m = np.zeros((n_fine, n_coarse), np.float32)
    for i in range(n_fine):
        t = i / stride
        i0 = int(np.floor(t))
        f = t - i0
        m[i, i0] += 1.0 - f
        if f > 0.0:
            m[i, i0 + 1] += f
    return torch.from_numpy(m).to(device)


def _upsample_flow(flow, h, w, stride):
    '''Bilinearly upsample coarse flows [B, hc, wc, 2] to [B, h, w, 2].'''
    my = _interp_matrix(h, stride, flow.shape[1], flow.device)
    mx = _interp_matrix(w, stride, flow.shape[2], flow.device)
    flow = torch.einsum('yh,bhwc->bywc', my, flow)
    return torch.einsum('xw,bywc->byxc', mx, flow)


def _coarse_grid(h, w, stride, device):
    '''Pixel coordinates (gy, gx) [hc, wc] of the stride-spaced grid that
    covers [0, h-1] x [0, w-1] (its last sample may lie past the edge).'''
    hc = -(-(h - 1) // stride) + 1
    wc = -(-(w - 1) // stride) + 1
    gy = torch.arange(hc, dtype=torch.float32, device=device) * stride
    gx = torch.arange(wc, dtype=torch.float32, device=device) * stride
    return (gy[:, None].expand(hc, wc).contiguous(),
            gx[None, :].expand(hc, wc).contiguous())


def coarse_twopass_flow(source_control_points, dest_control_points, out_size,
                        regularization=0.0, max_displacement=8,
                        flow_grid_stride=4):
    '''The clamped, composition-corrected coarse flows [B, hc, wc, 2] of the
    two-pass warp of out_size images for these control points ([B, N, 2],
    (y, x)): the warp-bank solve.'''
    h, w = out_size
    stride = int(flow_grid_stride)
    values = (dest_control_points - source_control_points).float()
    gy, gx = _coarse_grid(h, w, stride, values.device)
    return _flow_from_points(dest_control_points, values, gy, gx,
                             1.0 / float(max(h, w)), regularization, True,
                             float(max_displacement), True)


def warp_with_coarse_flow(image, coarse_flow, max_displacement=8,
                          flow_grid_stride=4):
    '''Two-pass warp of [B, H, W, C] at coarse flows
    (``coarse_twopass_flow`` output): bilinear upsample, then the resample
    kernel.'''
    image = image.float()
    _, h, w, _ = image.shape
    flow = coarse_flow.float()
    stride = int(flow_grid_stride)
    if stride > 1:
        flow = _upsample_flow(flow, h, w, stride)
    return warp_mod.warp_twopass(image.contiguous(), flow.contiguous(),
                                 max_displacement)


def dense_image_warp(image, flow):
    '''Resample [B, H, W, C] at ``grid - flow`` (flow [B, H, W, 2] as (dy,
    dx)) bilinearly, each tap index clamped to the edge: JAX's
    ``map_coordinates(order=1, mode='nearest')`` per channel, with its
    weights (wy * wx) and its order of summation.'''
    b, h, w, c = image.shape
    gy = torch.arange(h, dtype=torch.float32, device=image.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=image.device)[None, :]

    def taps(q, n):
        q0 = torch.floor(q)
        r = q - q0
        i = q0.long()
        return ((i.clamp(0, n - 1), 1 - r), ((i + 1).clamp(0, n - 1), r))

    flat = image.reshape(b, h * w, c)
    out = None
    for yi, wy in taps(gy - flow[..., 0], h):
        for xi, wx in taps(gx - flow[..., 1], w):
            idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
            term = (wy * wx)[..., None] * torch.gather(flat, 1, idx).reshape(
                b, h, w, c)
            out = term if out is None else out + term
    return out


def sparse_image_warp(image, source_control_points, dest_control_points,
                      regularization=0.0, method='exact', max_displacement=8,
                      clamp_flow=False, flow_grid_stride=1):
    '''Warp [B, H, W, C] so that the pixels at the source control points
    ([B, N, 2], (y, x)) land on the dest points. ``method``: 'exact' (the
    flow at every pixel, ``dense_image_warp``) or 'two_pass' (the coarse,
    composition-corrected flow of stride ``flow_grid_stride`` and the
    two-pass resample, which clamps to +-max_displacement); ``clamp_flow``
    clips the interpolated flow to +-max_displacement for both.'''
    if method not in ('exact', 'two_pass'):
        raise ValueError(f"method must be 'exact' or 'two_pass', got "
                         f'{method!r}')
    image = image.float()
    _, h, w, _ = image.shape
    stride = int(flow_grid_stride) if method == 'two_pass' else 1
    values = (dest_control_points - source_control_points).float()
    gy, gx = _coarse_grid(h, w, stride, values.device)
    flow = _flow_from_points(dest_control_points, values, gy, gx,
                             1.0 / float(max(h, w)), regularization,
                             clamp_flow, float(max_displacement),
                             method == 'two_pass')
    if method == 'two_pass':
        return warp_with_coarse_flow(image, flow, max_displacement, stride)
    return dense_image_warp(image, flow)


def _upsample_plane(plane, h, w, stride):
    '''Bilinearly upsample one coarse flow component [B, hc, wc] to
    [B, h, w].'''
    my = _interp_matrix(h, stride, plane.shape[1], plane.device)
    mx = _interp_matrix(w, stride, plane.shape[2], plane.device)
    plane = torch.einsum('yh,bhw->byw', my, plane)
    return torch.einsum('xw,byw->byx', mx, plane)


def cropped_twopass_flows(source_control_points, dest_control_points,
                          crop_offset, in_size, out_size, regularization=0.0,
                          max_displacement=8, clamp_flow=True,
                          flow_grid_stride=4):
    '''The flows of the crop-fused two-pass warp of in_size windows cropped
    at ``crop_offset`` ([B, 2], (oy, ox)) to out_size, for control points in
    the crop frame: (fy_ext [B, h_out, w_in] in the window's column frame,
    fx [B, h_out, w_out] in the crop frame). One spline solve per image
    serves three evaluations: both components on the window's coarse
    columns at crop x = j - ox (E1), fy at the source column j - ox + fx
    there (E2, the two-pass composition correction), fx on the crop's own
    coarse grid (E3).'''
    h_out, w_out = out_size
    b = dest_control_points.shape[0]
    stride = int(flow_grid_stride)
    d = float(max_displacement)
    values = (dest_control_points - source_control_points).float()
    scale = 1.0 / float(max(h_out, w_out))   # the crop frame
    gy_e, gx_e = _coarse_grid(h_out, int(in_size[1]), stride, values.device)
    gy_c, gx_c = _coarse_grid(h_out, w_out, stride, values.device)
    tp = dest_control_points.float() * scale
    wgt, v = _solve_spline(tp, values, regularization)

    hc, wce = gy_e.shape
    gy_b = gy_e.expand(b, hc, wce)
    gx_b = gx_e - crop_offset[:, 1].float()[:, None, None]
    q = torch.stack([gy_b, gx_b], dim=-1).reshape(b, -1, 2) * scale
    fl = _evaluate_spline(q, tp, wgt, v).reshape(b, hc, wce, 2)
    if clamp_flow:
        fl = fl.clamp(-d, d)
    q = torch.stack([gy_b, gx_b + fl[..., 1]], dim=-1).reshape(b, -1, 2)
    q = q * scale
    fy = _evaluate_spline(q, tp, wgt, v)[..., 0].reshape(b, hc, wce)
    q = torch.stack([gy_c, gx_c], dim=-1).reshape(1, -1, 2) * scale
    fx = _evaluate_spline(q.expand(b, -1, -1), tp, wgt, v)[..., 1].reshape(
        b, *gy_c.shape)
    if clamp_flow:
        fx = fx.clamp(-d, d)
    if stride > 1:
        fy = _upsample_plane(fy, h_out, int(in_size[1]), stride)
        fx = _upsample_plane(fx, h_out, w_out, stride)
    return fy, fx


def sparse_image_warp_cropped(image, source_control_points,
                              dest_control_points, crop_offset, out_size,
                              regularization=0.0, max_displacement=8,
                              clamp_flow=True, flow_grid_stride=4):
    '''Crop [B, h_in, w_in, C] windows at per-image integer ``crop_offset``
    ([B, 2], (oy, ox), 0 <= off <= in - out) to out_size and warp the crops
    as ``sparse_image_warp(method='two_pass')`` would, in one resample that
    never writes the crop (ops/kernels/warp_crop.py). Control points are in
    the crop frame. At stride 1 the flow equals the composed path's; at
    stride > 1 the coarse grids of the two differ by the crop shift mod
    stride, and both approximate the same spline within the sub-0.15 px
    interpolation bound.'''
    image = image.float()
    fy, fx = cropped_twopass_flows(
        source_control_points, dest_control_points, crop_offset,
        image.shape[1:3], out_size, regularization, max_displacement,
        clamp_flow, flow_grid_stride)
    return warp_crop_mod.warp_crop(
        image.contiguous(), fy.contiguous(), fx.contiguous(),
        crop_offset.to(torch.int32).contiguous(), max_displacement)

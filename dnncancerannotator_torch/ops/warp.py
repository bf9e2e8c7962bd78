'''Thin-plate-spline warp of the augmentation chain (counterpart of the
two-pass parts of dnncancerannotator_tpu.ops.warp).

A polyharmonic (thin-plate, order 2) spline interpolates a flow field from
control-point displacements; the image is resampled at ``grid - flow`` by
the two-pass bilinear resample (ops/kernels/warp_twopass.py). As in the JAX
package:

- the spline is solved in f32 in [0, 1]-normalised coordinates (the
  pixel-scale kernel matrix is catastrophically ill-conditioned in f32);
  displacement values stay in pixels;
- the flow is evaluated on a coarse grid of stride ``flow_grid_stride``,
  clamped to +-max_displacement, and corrected for the two-pass
  composition (the vertical pass takes fy at the source column, so fy is
  evaluated there), then upsampled bilinearly by two small matmuls.

``coarse_twopass_flow`` is the warp-bank solve; ``warp_with_coarse_flow``
resamples a batch at bank flows. The per-step ``sparse_image_warp`` and the
gather-based exact resample are not ported yet.
'''

import functools

import numpy as np
import torch

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

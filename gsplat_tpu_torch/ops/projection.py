"""Per-Gaussian screen-space preprocessing (projection, EWA cov2D, SH color).

Counterpart of `gsplat_tpu/ops/projection.py` in plain PyTorch, so autograd
comes free. Every expression keeps the JAX package's operation order, so the
two agree to float32 rounding; the integer outputs (radius, tile rects,
tiles touched, mask) agree exactly. Semantics (`forward.cu:155-272`):

- near cull at view z <= 0.2, homogeneous divide guard `1/(w + 1e-7)`;
- EWA with the focal Jacobian and 1.3*tan_fov frustum clamping;
- +0.3 pixel dilation and the antialiasing opacity rescale;
- radius = ceil(3*sqrt(max eigenvalue)), eigenvalue floor 0.1;
- tile rect by truncating division by the 16px tile (`.to(torch.int32)`
  truncates toward zero, as `astype(int32)` does), then clamped;
- under `tight_cull`, the opacity-aware emission rect and the cull
  threshold `cull_qmax` that binning reads.
"""

from __future__ import annotations

import dataclasses

import torch

from gsplat_tpu_torch.core import activations as act
from gsplat_tpu_torch.core import sh as sh_lib
from gsplat_tpu_torch.core.types import Camera, GaussianParams, RenderSettings


@dataclasses.dataclass(frozen=True)
class ScreenGaussians:
    """Per-Gaussian screen-space quantities (the GeometryState analogue)."""

    mean2d: torch.Tensor  # (N, 2) pixel-space center
    conic: torch.Tensor  # (N, 3) inverse 2D covariance [a, b, c]
    opacity: torch.Tensor  # (N,) effective opacity (AA-rescaled)
    rgb: torch.Tensor  # (N, 3) SH-evaluated color
    depth: torch.Tensor  # (N,) view-space z
    radius: torch.Tensor  # (N,) int32 screen radius in pixels
    cull_qmax: torch.Tensor  # (N,) tight-cull conic-Q threshold
    rect_min: torch.Tensor  # (N, 2) int32 (tile_x, tile_y) inclusive
    rect_max: torch.Tensor  # (N, 2) int32 (tile_x, tile_y) exclusive
    tiles_touched: torch.Tensor  # (N,) int32
    mask: torch.Tensor  # (N,) bool, survives culling

    def detach(self) -> "ScreenGaussians":
        return ScreenGaussians(
            **{f.name: getattr(self, f.name).detach() for f in dataclasses.fields(self)}
        )


def ndc2pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


def compute_cov2d(p_view, focal_x, focal_y, tan_fovx, tan_fovy, cov3d, world_view):
    """EWA projection of the 3D covariance to screen space, as [xx, xy, yy].

    cov2D = J W Sigma W^T J^T with J the perspective Jacobian at the
    frustum-clamped view point (`forward.cu:74-109`). `p_view` must have a
    strictly positive z.
    """
    W = world_view[:3, :3]
    t = p_view

    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tz = t[:, 2]
    txtz = torch.clamp(t[:, 0] / tz, min=-limx, max=limx)
    tytz = torch.clamp(t[:, 1] / tz, min=-limy, max=limy)
    tx = txtz * tz
    ty = tytz * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2

    w00, w01, w02 = W[0, 0], W[0, 1], W[0, 2]
    w10, w11, w12 = W[1, 0], W[1, 1], W[1, 2]
    w20, w21, w22 = W[2, 0], W[2, 1], W[2, 2]

    # T = J @ W
    t00 = j00 * w00 + j02 * w20
    t01 = j00 * w01 + j02 * w21
    t02 = j00 * w02 + j02 * w22
    t10 = j11 * w10 + j12 * w20
    t11 = j11 * w11 + j12 * w21
    t12 = j11 * w12 + j12 * w22

    c0, c1, c2, c3, c4, c5 = (cov3d[:, i] for i in range(6))
    u0 = c0 * t00 + c1 * t01 + c2 * t02
    u1 = c1 * t00 + c3 * t01 + c4 * t02
    u2 = c2 * t00 + c4 * t01 + c5 * t02
    v0 = c0 * t10 + c1 * t11 + c2 * t12
    v1 = c1 * t10 + c3 * t11 + c4 * t12
    v2 = c2 * t10 + c4 * t11 + c5 * t12

    cov_xx = t00 * u0 + t01 * u1 + t02 * u2
    cov_xy = t10 * u0 + t11 * u1 + t12 * u2
    cov_yy = t10 * v0 + t11 * v1 + t12 * v2
    return torch.stack([cov_xx, cov_xy, cov_yy], dim=-1)


def preprocess(
    params: GaussianParams,
    alive,
    camera: Camera,
    settings: RenderSettings,
    grid_x: int,
    grid_y: int,
    mean2d_offset=None,
) -> ScreenGaussians:
    """Project all Gaussians to screen space, batched over (N,) columns.

    Args:
      params: model parameters (pre-activation).
      alive: (N,) bool mask of live rows.
      camera: the view, on the same device as `params`.
      settings: render settings (tile size, AA flag, active SH degree,
        tight cull).
      grid_x, grid_y: tile-grid dimensions.
      mean2d_offset: optional (N, 2) tensor added to the pixel-space center;
        its gradient is the densification signal.
    """
    xyz = params.xyz
    tile = settings.tile

    scales = act.scaling_activation(params.scaling)
    quats = act.normalize_rotation(params.rotation)
    opacities = act.opacity_activation(params.opacity)[:, 0]

    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    def affine3(m):
        return torch.stack(
            [m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3] for i in range(3)],
            dim=-1,
        )

    p_view = affine3(camera.world_view)
    depth = p_view[:, 2]
    valid = alive & (depth > 0.2)

    fp = camera.full_proj
    p_hom = affine3(fp)
    w_hom = fp[3, 0] * x + fp[3, 1] * y + fp[3, 2] * z + fp[3, 3]
    # sanitize culled rows so 1/(w+1e-7) stays finite forward and backward
    w_safe = torch.where(valid, w_hom, torch.ones_like(w_hom))
    p_w = 1.0 / (w_safe + 1e-7)
    p_proj = p_hom * p_w[:, None]

    cov3d = act.covariance_from_scaling_rotation(scales, settings.scale_modifier, quats)

    # sanitize z of culled rows before the 1/tz math (NaN-free cotangents)
    safe_depth = torch.where(valid, depth, torch.ones_like(depth))
    p_view_safe = torch.cat([p_view[:, :2], safe_depth[:, None]], dim=-1)
    cov = compute_cov2d(
        p_view_safe, camera.focal_x, camera.focal_y, camera.tan_fovx,
        camera.tan_fovy, cov3d, camera.world_view,
    )
    cov = torch.where(valid[:, None], cov, cov.new_tensor([1.0, 0.0, 1.0]))

    h_var = 0.3
    det_cov = cov[:, 0] * cov[:, 2] - cov[:, 1] * cov[:, 1]
    covd = torch.stack([cov[:, 0] + h_var, cov[:, 1], cov[:, 2] + h_var], dim=-1)
    det_covd = covd[:, 0] * covd[:, 2] - covd[:, 1] * covd[:, 1]
    if settings.antialiasing:
        h_conv_scaling = torch.sqrt(torch.clamp(det_cov / det_covd, min=2.5e-5))
    else:
        h_conv_scaling = torch.ones_like(det_cov)

    det = det_covd
    valid = valid & (det != 0.0)
    det_inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    conic = torch.stack(
        [covd[:, 2] * det_inv, -covd[:, 1] * det_inv, covd[:, 0] * det_inv], dim=-1
    )

    mid = 0.5 * (covd[:, 0] + covd[:, 2])
    lam_term = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + lam_term
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=1e-20)))
    radius = radius_f.to(torch.int32)

    point_image = torch.stack(
        [ndc2pix(p_proj[:, 0], camera.width), ndc2pix(p_proj[:, 1], camera.height)],
        dim=-1,
    )
    if mean2d_offset is not None:
        point_image = point_image + mean2d_offset

    # tight-cull threshold: an instance whose conic-Q minimum over its tile
    # exceeds cull_qmax ~ ln(255*op_eff) has alpha < 1/255 at every pixel;
    # the margin keeps the cull conservative under float32 rounding
    op_eff = opacities * h_conv_scaling
    ln_term = torch.log(torch.clamp(op_eff * 255.0, min=1e-12))
    cull_qmax = ln_term + 0.03125 + 0.0078125 * torch.abs(ln_term)

    # getRect (auxiliary.h:45-55): C-style truncating casts, then clamp
    def rect_counts(rx, ry):
        px, py = point_image[:, 0], point_image[:, 1]
        rmin_x = torch.clamp(((px - rx) / tile).to(torch.int32), 0, grid_x)
        rmin_y = torch.clamp(((py - ry) / tile).to(torch.int32), 0, grid_y)
        rmax_x = torch.clamp(((px + rx + tile - 1) / tile).to(torch.int32), 0, grid_x)
        rmax_y = torch.clamp(((py + ry + tile - 1) / tile).to(torch.int32), 0, grid_y)
        return rmin_x, rmin_y, rmax_x, rmax_y

    ref_min_x, ref_min_y, ref_max_x, ref_max_y = rect_counts(radius_f, radius_f)
    tiles_ref = (ref_max_x - ref_min_x) * (ref_max_y - ref_min_y)
    valid = valid & (tiles_ref > 0)

    zero = torch.zeros_like(tiles_ref)
    if settings.tight_cull:
        # opacity-aware ellipse AABB: every pixel with
        # |dx| > sqrt(2*cov_xx*ln(255*op_eff)) blends to exactly zero; +1px
        # for the truncating exclusive-max rect formula
        vis = op_eff * 255.0 >= 0.999999
        rx2 = 2.0 * covd[:, 0] * ln_term
        ry2 = 2.0 * covd[:, 2] * ln_term
        rx = torch.minimum(
            radius_f,
            1.0 + torch.sqrt(torch.clamp(rx2 + 4.0 + 0.0625 * torch.abs(rx2), min=0.0)),
        )
        ry = torch.minimum(
            radius_f,
            1.0 + torch.sqrt(torch.clamp(ry2 + 4.0 + 0.0625 * torch.abs(ry2), min=0.0)),
        )
        rmin_x, rmin_y, rmax_x, rmax_y = rect_counts(rx, ry)
        tiles_touched = torch.where(
            valid & vis, (rmax_x - rmin_x) * (rmax_y - rmin_y), zero
        )
    else:
        rmin_x, rmin_y, rmax_x, rmax_y = ref_min_x, ref_min_y, ref_max_x, ref_max_y
        tiles_touched = torch.where(valid, tiles_ref, zero)

    features = torch.cat([params.features_dc, params.features_rest], dim=1)
    dirs = xyz - camera.camera_center
    rgb, _clamped = sh_lib.eval_sh_color(settings.sh_degree, features, dirs)

    radius = torch.where(valid, radius, torch.zeros_like(radius))

    return ScreenGaussians(
        mean2d=point_image,
        conic=conic,
        opacity=op_eff,
        rgb=rgb,
        depth=depth,
        radius=radius,
        cull_qmax=cull_qmax,
        rect_min=torch.stack([rmin_x, rmin_y], dim=-1),
        rect_max=torch.stack([rmax_x, rmax_y], dim=-1),
        tiles_touched=tiles_touched.to(torch.int32),
        mask=valid,
    )

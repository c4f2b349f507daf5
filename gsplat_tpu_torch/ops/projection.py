"""Per-Gaussian screen-space preprocessing (projection, EWA cov2D, SH color).

Counterpart of `gsplat_tpu/ops/projection.py`, whose `preprocess` XLA
compiles into a few fusions. Eager PyTorch cannot fuse it, so on the card
`preprocess` runs two hand-written kernels (`csrc/projection.cu`): the
forward `gs_project_fwd` and, under autograd, the backward `gs_project_bwd`
(`ProjectFunction`), one thread per row each, as the CUDA rasterizer does
(`preprocessCUDA`/`computeColorFromSH` forward, `computeCov2DCUDA`/
`preprocessCUDA` backward). On CPU tensors the plain twins run:
`preprocess_torch` (autograd-differentiable) and `preprocess_bwd_torch`
(its VJP written out in the kernel's order). On the card each kernel equals
its twin bit for bit; `preprocess_torch` keeps the JAX package's operation
order, so the port agrees with JAX to float32 rounding and the integer
outputs (radius, tile rects, tiles touched, mask) agree exactly.

Semantics (`forward.cu:155-272`):

- near cull at view z <= 0.2, homogeneous divide guard `1/(w + 1e-7)`;
- EWA with the focal Jacobian and 1.3*tan_fov frustum clamping;
- +0.3 pixel dilation and the antialiasing opacity rescale;
- radius = ceil(3*sqrt(max eigenvalue)), eigenvalue floor 0.1;
- tile rect by truncating division by the 16px tile (`.to(torch.int32)`
  truncates toward zero, as `astype(int32)` does), then clamped;
- under `tight_cull`, the opacity-aware emission rect and the cull
  threshold `cull_qmax` that binning reads.

Deliberate differences from autograd of the JAX function: a dead row
(`alive` false) gets zero gradients, and on the card its parameters are
never read (its float outputs are 0, its mask false, its radius, rects and
tile count 0). At ties the gradient follows torch: `clamp` passes it at
equality, `torch.where` gives none to the branch not taken.
"""

from __future__ import annotations

import ctypes
import dataclasses
from types import SimpleNamespace

import torch

from gsplat_tpu_torch.core import activations as act
from gsplat_tpu_torch.core import sh as sh_lib
from gsplat_tpu_torch.core.types import Camera, GaussianParams, RenderSettings
from gsplat_tpu_torch.profiling import span


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


def preprocess_torch(
    params: GaussianParams,
    alive,
    camera: Camera,
    settings: RenderSettings,
    grid_x: int,
    grid_y: int,
    mean2d_offset=None,
) -> ScreenGaussians:
    """Plain twin of the forward kernel: project all Gaussians to screen
    space, batched over (N,) columns, differentiable by autograd.

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


def _sh_dir_grad(degree, x, y, z, db):
    """d color / d (unit direction), summed over the basis in ascending k:
    `db[k]` is the cotangent of basis function k, the partials are those of
    `sh_lib.sh_basis`. The kernel sums the same terms in the same order."""
    c1, c2, c3, c4 = sh_lib.SH_C1, sh_lib.SH_C2, sh_lib.SH_C3, sh_lib.SH_C4
    zero = torch.zeros_like(x)
    gx, gy, gz = zero, zero, zero
    if degree >= 1:
        gy = gy + db[1] * -c1
        gz = gz + db[2] * c1
        gx = gx + db[3] * -c1
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        gx = gx + db[4] * (c2[0] * y)
        gy = gy + db[4] * (c2[0] * x)
        gy = gy + db[5] * (c2[1] * z)
        gz = gz + db[5] * (c2[1] * y)
        gx = gx + db[6] * (c2[2] * (-2.0 * x))
        gy = gy + db[6] * (c2[2] * (-2.0 * y))
        gz = gz + db[6] * (c2[2] * (4.0 * z))
        gx = gx + db[7] * (c2[3] * z)
        gz = gz + db[7] * (c2[3] * x)
        gx = gx + db[8] * (c2[4] * (2.0 * x))
        gy = gy + db[8] * (c2[4] * (-2.0 * y))
    if degree >= 3:
        gx = gx + db[9] * (c3[0] * (6.0 * xy))
        gy = gy + db[9] * (c3[0] * (3.0 * xx - 3.0 * yy))
        gx = gx + db[10] * (c3[1] * yz)
        gy = gy + db[10] * (c3[1] * xz)
        gz = gz + db[10] * (c3[1] * xy)
        gx = gx + db[11] * (c3[2] * (-2.0 * xy))
        gy = gy + db[11] * (c3[2] * (4.0 * zz - xx - 3.0 * yy))
        gz = gz + db[11] * (c3[2] * (8.0 * yz))
        gx = gx + db[12] * (c3[3] * (-6.0 * xz))
        gy = gy + db[12] * (c3[3] * (-6.0 * yz))
        gz = gz + db[12] * (c3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy))
        gx = gx + db[13] * (c3[4] * (4.0 * zz - 3.0 * xx - yy))
        gy = gy + db[13] * (c3[4] * (-2.0 * xy))
        gz = gz + db[13] * (c3[4] * (8.0 * xz))
        gx = gx + db[14] * (c3[5] * (2.0 * xz))
        gy = gy + db[14] * (c3[5] * (-2.0 * yz))
        gz = gz + db[14] * (c3[5] * (xx - yy))
        gx = gx + db[15] * (c3[6] * (3.0 * xx - 3.0 * yy))
        gy = gy + db[15] * (c3[6] * (-6.0 * xy))
    if degree >= 4:
        gx = gx + db[16] * (c4[0] * (y * (3.0 * xx - yy)))
        gy = gy + db[16] * (c4[0] * (x * (xx - 3.0 * yy)))
        gx = gx + db[17] * (c4[1] * ((6.0 * xy) * z))
        gy = gy + db[17] * (c4[1] * (z * (3.0 * xx - 3.0 * yy)))
        gz = gz + db[17] * (c4[1] * (y * (3.0 * xx - yy)))
        gx = gx + db[18] * (c4[2] * (y * (7.0 * zz - 1.0)))
        gy = gy + db[18] * (c4[2] * (x * (7.0 * zz - 1.0)))
        gz = gz + db[18] * (c4[2] * ((14.0 * xy) * z))
        gy = gy + db[19] * (c4[3] * (z * (7.0 * zz - 3.0)))
        gz = gz + db[19] * (c4[3] * (y * (21.0 * zz - 3.0)))
        gz = gz + db[20] * (c4[4] * (z * (140.0 * zz - 60.0)))
        gx = gx + db[21] * (c4[5] * (z * (7.0 * zz - 3.0)))
        gz = gz + db[21] * (c4[5] * (x * (21.0 * zz - 3.0)))
        gx = gx + db[22] * (c4[6] * ((2.0 * x) * (7.0 * zz - 1.0)))
        gy = gy + db[22] * (c4[6] * ((-2.0 * y) * (7.0 * zz - 1.0)))
        gz = gz + db[22] * (c4[6] * ((xx - yy) * (14.0 * z)))
        gx = gx + db[23] * (c4[7] * (z * (3.0 * xx - 3.0 * yy)))
        gy = gy + db[23] * (c4[7] * ((-6.0 * xy) * z))
        gz = gz + db[23] * (c4[7] * (x * (xx - 3.0 * yy)))
        gx = gx + db[24] * (c4[8] * ((4.0 * x) * (xx - 3.0 * yy)))
        gy = gy + db[24] * (c4[8] * ((4.0 * y) * (yy - 3.0 * xx)))
    return gx, gy, gz


def _normalize_bwd(q, n, dq):
    """Cotangent of `q_in` for `q = q_in / n`, n = |q_in|, given the
    cotangent `dq` of the unit vector `q` (lists of columns)."""
    dot = q[0] * dq[0]
    for qi, di in zip(q[1:], dq[1:]):
        dot = dot + qi * di
    return [(di - qi * dot) / n for qi, di in zip(q, dq)]


def preprocess_bwd_torch(params, alive, camera: Camera, settings: RenderSettings, cotangents):
    """Plain twin of the backward kernel: the VJP of `preprocess_torch`,
    written out in the kernel's order (`csrc/projection.cu`, which it
    equals bit for bit on the card).

    Args:
      params, alive, camera, settings: as `preprocess_torch` was called.
      cotangents: (d mean2d (N, 2), d conic (N, 3), d opacity (N,),
        d rgb (N, 3), d depth (N,)); any may be None (zero).

    Returns:
      the gradients of xyz (N, 3), scaling (N, 3), rotation (N, 4),
      opacity (N, 1), features_dc (N, 1, 3), features_rest (N, K-1, 3) and
      mean2d_offset (N, 2). Dead rows (`alive` false) get exactly 0 and so do
      the coefficients above the active SH degree. The culled rows follow
      the forward's `torch.where` sanitising (no gradient through the
      replaced values); `torch.clamp` passes the gradient at equality,
      `torch.where` none on the branch not taken.
    """
    xyz, n = params.xyz, params.xyz.shape[0]
    zeros = torch.zeros(n, dtype=xyz.dtype, device=xyz.device)

    def cols(t, k):
        return [zeros] * k if t is None else [t[:, i] for i in range(k)] if k > 1 else [t]

    gmx, gmy = cols(cotangents[0], 2)
    gca, gcb, gcc = cols(cotangents[1], 3)
    (gop,) = cols(cotangents[2], 1)
    grgb = cols(cotangents[3], 3)
    (gdep,) = cols(cotangents[4], 1)
    # the camera's 0-d values, by the same torch expressions as preprocess_torch's
    W, P, cc = camera.world_view, camera.full_proj, camera.camera_center
    fx, fy = camera.focal_x, camera.focal_y
    limx, limy = 1.3 * camera.tan_fovx, 1.3 * camera.tan_fovy
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    # --- the forward's intermediates, recomputed as `preprocess_torch` does
    s = [torch.exp(params.scaling[:, i]) for i in range(3)]
    q0 = [params.rotation[:, i] for i in range(4)]
    n0 = torch.sqrt(((q0[0] * q0[0] + q0[1] * q0[1]) + q0[2] * q0[2]) + q0[3] * q0[3] + 0.0)
    qa = [qi / n0 for qi in q0]
    n1 = torch.sqrt(((qa[0] * qa[0] + qa[1] * qa[1]) + qa[2] * qa[2]) + qa[3] * qa[3] + 0.0)
    qr, qx, qy, qz = (qi / n1 for qi in qa)
    op = torch.sigmoid(params.opacity[:, 0])
    S = [settings.scale_modifier * si for si in s]
    v = [Si * Si for Si in S]
    R = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qr * qz), 2 * (qx * qz + qr * qy)],
         [2 * (qx * qy + qr * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qr * qx)],
         [2 * (qx * qz - qr * qy), 2 * (qy * qz + qr * qx), 1 - 2 * (qx * qx + qy * qy)]]

    def sym(a, b):  # Sigma[a][b] = sum_k v_k R[a][k] R[b][k]
        return (v[0] * R[a][0] * R[b][0] + v[1] * R[a][1] * R[b][1]) + v[2] * R[a][2] * R[b][2]

    c = [sym(0, 0), sym(0, 1), sym(0, 2), sym(1, 1), sym(1, 2), sym(2, 2)]

    def affine(m, i):
        return m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]

    pvx, pvy, pvz = affine(W, 0), affine(W, 1), affine(W, 2)
    v0 = alive & (pvz > 0.2)
    ph0, ph1, wh = affine(P, 0), affine(P, 1), affine(P, 3)
    pw = 1.0 / (torch.where(v0, wh, torch.ones_like(wh)) + 1e-7)
    tz = torch.where(v0, pvz, torch.ones_like(pvz))
    rxr, ryr = pvx / tz, pvy / tz
    txtz = torch.clamp(rxr, min=-limx, max=limx)
    tytz = torch.clamp(ryr, min=-limy, max=limy)
    in_x = (rxr >= -limx) & (rxr <= limx)
    in_y = (ryr >= -limy) & (ryr <= limy)
    txp, typ = txtz * tz, tytz * tz
    itz = 1.0 / tz
    itz2 = itz * itz
    nfx, nfy = -fx, -fy
    j00, j02 = fx * itz, nfx * txp * itz2
    j11, j12 = fy * itz, nfy * typ * itz2
    t0 = [j00 * W[0, i] + j02 * W[2, i] for i in range(3)]
    t1 = [j11 * W[1, i] + j12 * W[2, i] for i in range(3)]
    u = [c[0] * t0[0] + c[1] * t0[1] + c[2] * t0[2],
         c[1] * t0[0] + c[3] * t0[1] + c[4] * t0[2],
         c[2] * t0[0] + c[4] * t0[1] + c[5] * t0[2]]
    w = [c[0] * t1[0] + c[1] * t1[1] + c[2] * t1[2],
         c[1] * t1[0] + c[3] * t1[1] + c[4] * t1[2],
         c[2] * t1[0] + c[4] * t1[1] + c[5] * t1[2]]
    one = torch.ones_like(pvz)
    cxx = torch.where(v0, t0[0] * u[0] + t0[1] * u[1] + t0[2] * u[2], one)
    cxy = torch.where(v0, t1[0] * u[0] + t1[1] * u[1] + t1[2] * u[2], zeros)
    cyy = torch.where(v0, t1[0] * w[0] + t1[1] * w[1] + t1[2] * w[2], one)
    d0, d1, d2 = cxx + 0.3, cxy, cyy + 0.3
    det = d0 * d2 - d1 * d1
    det_inv = 1.0 / torch.where(det == 0.0, one, det)

    # --- opacity: sigmoid, then the antialiasing scale
    if settings.antialiasing:
        det_cov = cxx * cyy - cxy * cxy
        ratio = det_cov / det
        h = torch.sqrt(torch.clamp(ratio, min=2.5e-5))
        dop = gop * h
    else:
        dop = gop
    dlogit = dop * (1.0 - op) * op

    # --- conic = [d2, -d1, d0] / det
    dd0 = gcc * det_inv
    dd1 = -(gcb * det_inv)
    dd2 = gca * det_inv
    ddinv = (gca * d2 - gcb * d1) + gcc * d0
    ddet = torch.where(det != 0.0, -(ddinv * (det_inv * det_inv)), zeros)
    if settings.antialiasing:
        # h = sqrt(clamp(det_cov / det, min=2.5e-5)); det's two cotangents
        # are summed before they reach the covariance, as autograd sums them
        dratio = torch.where(ratio >= 2.5e-5, (gop * op) / (2.0 * h), zeros)
        ddc = dratio / det
        ddet = ddet - dratio * (ratio / det)
    dcxx = dd0 + ddet * d2
    dcyy = dd2 + ddet * d0
    dcxy = dd1 - 2.0 * (ddet * d1)
    if settings.antialiasing:
        dcxx = dcxx + ddc * cyy
        dcyy = dcyy + ddc * cxx
        dcxy = dcxy - 2.0 * (ddc * cxy)
    dcxx = torch.where(v0, dcxx, zeros)
    dcxy = torch.where(v0, dcxy, zeros)
    dcyy = torch.where(v0, dcyy, zeros)

    # --- cov2d = T Sigma T^T, T = J W
    du = [dcxx * t0[i] + dcxy * t1[i] for i in range(3)]
    dw = [dcyy * t1[i] for i in range(3)]

    def sig_dot(d, i):  # (Sigma d)_i
        row = ((0, 1, 2), (1, 3, 4), (2, 4, 5))[i]
        return d[0] * c[row[0]] + d[1] * c[row[1]] + d[2] * c[row[2]]

    dt0 = [dcxx * u[i] + sig_dot(du, i) for i in range(3)]
    dt1 = [(dcxy * u[i] + dcyy * w[i]) + sig_dot(dw, i) for i in range(3)]
    dc = [du[0] * t0[0] + dw[0] * t1[0],
          ((du[0] * t0[1] + du[1] * t0[0]) + dw[0] * t1[1]) + dw[1] * t1[0],
          ((du[0] * t0[2] + du[2] * t0[0]) + dw[0] * t1[2]) + dw[2] * t1[0],
          du[1] * t0[1] + dw[1] * t1[1],
          ((du[1] * t0[2] + du[2] * t0[1]) + dw[1] * t1[2]) + dw[2] * t1[1],
          du[2] * t0[2] + dw[2] * t1[2]]
    dj00 = (dt0[0] * W[0, 0] + dt0[1] * W[0, 1]) + dt0[2] * W[0, 2]
    dj02 = (dt0[0] * W[2, 0] + dt0[1] * W[2, 1]) + dt0[2] * W[2, 2]
    dj11 = (dt1[0] * W[1, 0] + dt1[1] * W[1, 1]) + dt1[2] * W[1, 2]
    dj12 = (dt1[0] * W[2, 0] + dt1[1] * W[2, 1]) + dt1[2] * W[2, 2]
    dtxp = dj02 * itz2 * nfx
    dtyp = dj12 * itz2 * nfy
    ditz2 = dj02 * (nfx * txp) + dj12 * (nfy * typ)
    ditz = (dj00 * fx + dj11 * fy) + (itz + itz) * ditz2
    drx = torch.where(in_x, dtxp * tz, zeros)
    dry = torch.where(in_y, dtyp * tz, zeros)
    dtz = (-(ditz * (itz * itz)) + dtxp * txtz) + dtyp * tytz
    dtz = (dtz - drx * (rxr / tz)) - dry * (ryr / tz)
    dpvx = torch.where(v0, drx / tz, zeros)
    dpvy = torch.where(v0, dry / tz, zeros)
    dpvz = gdep + torch.where(v0, dtz, zeros)

    # --- mean2d = ndc2pix(p_hom * pw) (+ offset)
    dpx = gmx * 0.5 * camera.width
    dpy = gmy * 0.5 * camera.height
    dph0, dph1 = dpx * pw, dpy * pw
    dwh = torch.where(v0, -((dpx * ph0 + dpy * ph1) * (pw * pw)), zeros)

    # --- SH colour
    k = sh_lib.num_sh_coeffs(settings.sh_degree)
    dxr, dyr, dzr = x - cc[0], y - cc[1], z - cc[2]
    dlen = torch.sqrt((dxr * dxr + dyr * dyr) + dzr * dzr)
    ux, uy, uz = dxr / dlen, dyr / dlen, dzr / dlen
    basis = sh_lib.sh_basis(settings.sh_degree, torch.stack([ux, uy, uz], dim=-1))
    coeff = [params.features_dc[:, 0]] + [params.features_rest[:, j] for j in range(k - 1)]
    dcol = []
    for ch in range(3):
        color = basis[:, 0] * coeff[0][:, ch]
        for j in range(1, k):
            color = color + basis[:, j] * coeff[j][:, ch]
        color = color + 0.5
        dcol.append(torch.where(color >= 0.0, grgb[ch], zeros))
    dsh = [torch.stack([basis[:, j] * dcol[ch] for ch in range(3)], dim=-1) for j in range(k)]
    if settings.sh_degree > 0:
        db = [(coeff[j][:, 0] * dcol[0] + coeff[j][:, 1] * dcol[1]) + coeff[j][:, 2] * dcol[2]
              for j in range(k)]
        gux, guy, guz = _sh_dir_grad(settings.sh_degree, ux, uy, uz, db)
        ddir = _normalize_bwd([ux, uy, uz], dlen, [gux, guy, guz])
    else:
        ddir = [zeros, zeros, zeros]

    # --- xyz: projection, view (cov2d and depth), SH direction
    dxyz = [((P[0, i] * dph0 + P[1, i] * dph1) + P[3, i] * dwh)
            + ((W[0, i] * dpvx + W[1, i] * dpvy) + W[2, i] * dpvz) + ddir[i]
            for i in range(3)]

    # --- Sigma = R diag(v) R^T, v = (mod s)^2, s = exp(scaling)
    dscal, dR = [], [[None] * 3 for _ in range(3)]
    for kk in range(3):
        a0, a1, a2 = R[0][kk], R[1][kk], R[2][kk]
        dv = ((((dc[0] * (a0 * a0) + dc[1] * (a0 * a1)) + dc[2] * (a0 * a2))
               + dc[3] * (a1 * a1)) + dc[4] * (a1 * a2)) + dc[5] * (a2 * a2)
        dR[0][kk] = v[kk] * ((2.0 * dc[0] * a0 + dc[1] * a1) + dc[2] * a2)
        dR[1][kk] = v[kk] * ((dc[1] * a0 + 2.0 * dc[3] * a1) + dc[4] * a2)
        dR[2][kk] = v[kk] * ((dc[2] * a0 + dc[4] * a1) + 2.0 * dc[5] * a2)
        dscal.append(2.0 * S[kk] * dv * settings.scale_modifier * s[kk])
    dqq = [2.0 * (((((qy * dR[0][2] - qz * dR[0][1]) + qz * dR[1][0]) - qx * dR[1][2])
                   - qy * dR[2][0]) + qx * dR[2][1]),
           2.0 * ((((((qy * dR[0][1] + qz * dR[0][2]) + qy * dR[1][0]) - 2.0 * qx * dR[1][1])
                     - qr * dR[1][2]) + qz * dR[2][0]) + qr * dR[2][1] - 2.0 * qx * dR[2][2]),
           2.0 * ((((((qx * dR[0][1] + qr * dR[0][2]) + qx * dR[1][0]) + qz * dR[1][2])
                     - qr * dR[2][0]) + qz * dR[2][1]) - 2.0 * qy * dR[0][0] - 2.0 * qy * dR[2][2]),
           2.0 * ((((((qx * dR[0][2] - qr * dR[0][1]) + qr * dR[1][0]) + qy * dR[1][2])
                     + qx * dR[2][0]) + qy * dR[2][1]) - 2.0 * qz * dR[0][0] - 2.0 * qz * dR[1][1])]
    dqa = _normalize_bwd([qr, qx, qy, qz], n1, dqq)
    drot = _normalize_bwd(qa, n0, dqa)

    def live(cols_, dim=-1):
        t = torch.stack(cols_, dim=dim) if isinstance(cols_, list) else cols_
        return torch.where(alive.reshape((n,) + (1,) * (t.dim() - 1)), t, torch.zeros_like(t))

    rest = torch.zeros_like(params.features_rest)
    if k > 1:
        rest[:, :k - 1] = torch.stack(dsh[1:], dim=1)
    return (live(dxyz), live(dscal), live(drot), live(dlogit[:, None]),
            live(dsh[0][:, None]), live(rest), live([gmx, gmy]))


def _contiguous_f32(name, t):
    if t.dtype != torch.float32:
        raise ValueError(f"preprocess: {name} must be float32, got {t.dtype}")
    return t.contiguous()


def _kernel_params(params, alive, camera: Camera, settings: RenderSettings, grid_x, grid_y,
                   mean2d_offset):
    """The tensors the kernels read (contiguous, checked) and their C
    argument block (`ProjectParams` in `csrc/projection.cu`)."""
    from gsplat_tpu_torch import _kernels

    dev = params.xyz.device
    if not params.xyz.is_cuda:
        raise ValueError("the projection kernels launch on a CUDA device: tensors must be on one")
    if not 0 <= settings.sh_degree <= 4:
        raise ValueError(f"sh_degree {settings.sh_degree}: the kernels take 0-4")
    n = params.xyz.shape[0]
    k_rest = params.features_rest.shape[1]
    if sh_lib.num_sh_coeffs(settings.sh_degree) > k_rest + 1:
        raise ValueError(f"sh_degree {settings.sh_degree} needs "
                         f"{sh_lib.num_sh_coeffs(settings.sh_degree)} coefficients, "
                         f"features hold {k_rest + 1}")
    keep = {f: _contiguous_f32(f, getattr(params, f)) for f in (
        "xyz", "scaling", "rotation", "opacity", "features_dc", "features_rest")}
    shapes = {"xyz": (n, 3), "scaling": (n, 3), "rotation": (n, 4), "opacity": (n, 1),
              "features_dc": (n, 1, 3), "features_rest": (n, k_rest, 3)}
    for f, shape in shapes.items():
        if tuple(keep[f].shape) != shape:
            raise ValueError(f"preprocess: {f} has shape {tuple(keep[f].shape)}, want {shape}")
    keep["alive"] = torch.as_tensor(alive, device=dev).to(torch.bool).contiguous()
    if keep["alive"].shape != (n,):
        raise ValueError(f"preprocess: alive has shape {tuple(keep['alive'].shape)}, want ({n},)")
    if mean2d_offset is not None:
        keep["mean2d_offset"] = _contiguous_f32("mean2d_offset", mean2d_offset)
        if keep["mean2d_offset"].shape != (n, 2):
            raise ValueError("preprocess: mean2d_offset must be (N, 2)")
    for f in ("world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy"):
        t = _contiguous_f32(f, getattr(camera, f))
        if t.device != dev:
            raise ValueError(f"preprocess: camera.{f} is on {t.device}, params on {dev}")
        keep[f] = t
    ptr = lambda f: keep[f].data_ptr() if f in keep else None  # noqa: E731
    args = _kernels.ProjectParams(
        *(ptr(f) for f in ("xyz", "scaling", "rotation", "opacity", "features_dc",
                           "features_rest", "mean2d_offset", "alive", "world_view",
                           "full_proj", "camera_center", "tan_fovx", "tan_fovy")),
        n, k_rest, camera.width, camera.height, grid_x, grid_y, settings.tile,
        settings.scale_modifier)
    return keep, args


def project_fwd(params, alive, camera: Camera, settings: RenderSettings, grid_x: int,
                grid_y: int, mean2d_offset=None) -> ScreenGaussians:
    """The forward kernel (`gs_project_fwd`, `csrc/projection.cu`) on the
    card: `preprocess_torch`'s outputs, bit for bit on the live rows. A dead
    row's parameters are never read: its mask is false, its radius, tile
    counts and rects 0, and its float fields 0. CUDA tensors only."""
    from gsplat_tpu_torch import _kernels

    keep, args = _kernel_params(params, alive, camera, settings, grid_x, grid_y, mean2d_offset)
    n, dev = args.n, params.xyz.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = ScreenGaussians(
        mean2d=torch.empty((n, 2), **f32), conic=torch.empty((n, 3), **f32),
        opacity=torch.empty((n,), **f32), rgb=torch.empty((n, 3), **f32),
        depth=torch.empty((n,), **f32), radius=torch.empty((n,), **i32),
        cull_qmax=torch.empty((n,), **f32), rect_min=torch.empty((n, 2), **i32),
        rect_max=torch.empty((n, 2), **i32), tiles_touched=torch.empty((n,), **i32),
        mask=torch.empty((n,), dtype=torch.bool, device=dev))
    if n == 0:
        return out
    outs = _kernels.ProjectOutputs(*(getattr(out, f.name).data_ptr()
                                     for f in dataclasses.fields(ScreenGaussians)))
    lib = _kernels.load("projection")
    err = lib.gs_project_fwd(ctypes.byref(args), ctypes.byref(outs), settings.sh_degree,
                             int(settings.antialiasing), int(settings.tight_cull),
                             _kernels.stream(dev))
    _kernels.check(err, "project_fwd")
    project_fwd.launches += 1
    return out


project_fwd.launches = 0


def project_bwd(params, alive, camera: Camera, settings: RenderSettings, cotangents,
                with_offset: bool = True):
    """The backward kernel (`gs_project_bwd`, `csrc/projection.cu`) on the
    card: `preprocess_bwd_torch`'s gradients, bit for bit. Reads each
    cotangent where it lies, through its strides (the blend's are strided
    views of K4''s (N, 16) accumulator); a None cotangent is zero. Returns
    the seven gradients (the last None without `with_offset`). CUDA tensors
    only."""
    from gsplat_tpu_torch import _kernels

    keep, args = _kernel_params(params, alive, camera, settings, 1, 1, None)
    n, dev = args.n, params.xyz.device
    if args.k_rest > MAX_K_REST:  # the kernel stages a block's gradients in 48 KB
        raise ValueError(f"project_bwd: features_rest holds {args.k_rest} coefficients, "
                         f"the kernel takes at most {MAX_K_REST} (degree 4)")
    shapes = ((n, 2), (n, 3), (n,), (n, 3), (n,))
    cot = []
    for name, t, shape in zip(("mean2d", "conic", "opacity", "rgb", "depth"), cotangents, shapes):
        if t is None:
            cot += [None, 0, 0]
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"project_bwd: d {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, want float32 {shape} on {dev}")
        st = t.stride()
        cot += [t.data_ptr(), st[0], st[1] if len(st) > 1 else 0]
    grads = tuple(torch.empty_like(keep[f]) for f in (
        "xyz", "scaling", "rotation", "opacity", "features_dc", "features_rest"))
    d_offset = torch.empty((n, 2), dtype=torch.float32, device=dev) if with_offset else None
    if n == 0:
        return (*grads, d_offset)
    g = _kernels.ProjectGrads(*(t.data_ptr() for t in grads),
                              None if d_offset is None else d_offset.data_ptr())
    lib = _kernels.load("projection")
    err = lib.gs_project_bwd(ctypes.byref(args), ctypes.byref(_kernels.ProjectCotangents(*cot)),
                             ctypes.byref(g), settings.sh_degree, int(settings.antialiasing),
                             _kernels.stream(dev))
    _kernels.check(err, "project_bwd")
    project_bwd.launches += 1
    return (*grads, d_offset)


project_bwd.launches = 0


MAX_K_REST = 24  # features_rest coefficients of SH degree 4

_NON_DIFF = ("radius", "cull_qmax", "rect_min", "rect_max", "tiles_touched", "mask")


def _project(params, alive, camera, settings, grid_x, grid_y, mean2d_offset):
    """The forward alone: the kernel on CUDA tensors, the twin on CPU ones."""
    fwd = project_fwd if params.xyz.is_cuda else preprocess_torch
    return fwd(params, alive, camera, settings, grid_x, grid_y, mean2d_offset)


class ProjectFunction(torch.autograd.Function):
    """`preprocess` with a hand-written backward: the kernels on CUDA
    tensors, the twins on CPU tensors.

    Outputs the eleven `ScreenGaussians` fields in their order; radius,
    cull_qmax, the rects, tiles_touched and mask carry no gradient (binning
    reads `cull_qmax` detached). The backward recomputes the forward's
    intermediates from the parameters rather than saving them.
    """

    @staticmethod
    def forward(ctx, xyz, scaling, rotation, opacity, features_dc, features_rest,
                mean2d_offset, alive, camera, settings, grid_x, grid_y):
        params = SimpleNamespace(xyz=xyz, scaling=scaling, rotation=rotation, opacity=opacity,
                                 features_dc=features_dc, features_rest=features_rest)
        with torch.no_grad():
            screen = _project(params, alive, camera, settings, grid_x, grid_y, mean2d_offset)
        ctx.save_for_backward(xyz, scaling, rotation, opacity, features_dc, features_rest, alive)
        ctx.camera, ctx.settings = camera, settings
        ctx.with_offset = mean2d_offset is not None
        ctx.set_materialize_grads(False)
        outs = tuple(getattr(screen, f.name) for f in dataclasses.fields(ScreenGaussians))
        ctx.mark_non_differentiable(*(getattr(screen, f) for f in _NON_DIFF))
        return outs

    @staticmethod
    def backward(ctx, *douts):
        xyz, scaling, rotation, opacity, features_dc, features_rest, alive = ctx.saved_tensors
        params = SimpleNamespace(xyz=xyz, scaling=scaling, rotation=rotation, opacity=opacity,
                                 features_dc=features_dc, features_rest=features_rest)
        cotangents = douts[:5]  # mean2d, conic, opacity, rgb, depth
        with span("backward/project"):
            if xyz.is_cuda:
                grads = project_bwd(params, alive, ctx.camera, ctx.settings, cotangents,
                                    ctx.with_offset)
            else:
                grads = preprocess_bwd_torch(params, alive, ctx.camera, ctx.settings,
                                             cotangents)
        grads = [g if need else None for g, need in zip(grads, ctx.needs_input_grad[:7])]
        if not ctx.with_offset:
            grads[6] = None
        return (*grads, None, None, None, None, None)


def preprocess(
    params: GaussianParams,
    alive,
    camera: Camera,
    settings: RenderSettings,
    grid_x: int,
    grid_y: int,
    mean2d_offset=None,
) -> ScreenGaussians:
    """Project all Gaussians to screen space (`preprocess_torch`'s
    contract, the JAX package's `preprocess`).

    On CUDA tensors the forward kernel runs, and under autograd the backward
    kernel gives the gradients; on CPU tensors the twins do. Without
    gradients (inference, or parameters that need none) only the forward
    runs and nothing is saved.
    """
    alive = torch.as_tensor(alive, device=params.xyz.device)
    inputs = (params.xyz, params.scaling, params.rotation, params.opacity,
              params.features_dc, params.features_rest, mean2d_offset)
    if not (torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in inputs)):
        return _project(params, alive, camera, settings, grid_x, grid_y, mean2d_offset)
    outs = ProjectFunction.apply(*inputs, alive, camera, settings, grid_x, grid_y)
    return ScreenGaussians(*outs)

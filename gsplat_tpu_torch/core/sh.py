"""Spherical-harmonics color evaluation (degrees 0-4).

Counterpart of `gsplat_tpu/core/sh.py`: the basis is an (N, K) tensor
contracted elementwise against the (N, K, 3) coefficients, with the
rasterizer's +0.5 shift and clamp at 0 (`forward.cu:20-71`).
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(degree: int, dirs):
    """Real SH basis values (..., K) for unit directions (..., 3)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    terms = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        terms += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        terms += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        terms += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        terms += [
            SH_C4[0] * xy * (xx - yy),
            SH_C4[1] * yz * (3.0 * xx - yy),
            SH_C4[2] * xy * (7.0 * zz - 1.0),
            SH_C4[3] * yz * (7.0 * zz - 3.0),
            SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            SH_C4[5] * xz * (7.0 * zz - 3.0),
            SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            SH_C4[7] * xz * (xx - 3.0 * yy),
            SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(terms, dim=-1)


def eval_sh_color(degree: int, sh_coeffs, dirs):
    """SH -> RGB with the +0.5 shift and clamp at 0.

    Args:
      degree: active SH degree.
      sh_coeffs: (N, K_max, 3); only the first (degree+1)^2 rows are used.
      dirs: (N, 3) unnormalized view directions, normalized here.

    Returns:
      (color (N, 3) clamped at 0, clamped mask (N, 3) bool).
    """
    # both sums are written out in ascending order, the order the projection
    # kernel uses (`csrc/projection.cu`): `torch.sum` fixes no order, and
    # the kernel is held bit for bit against this function
    dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    dirs = dirs / torch.sqrt((dx * dx + dy * dy) + dz * dz)
    k = num_sh_coeffs(degree)
    basis = sh_basis(degree, dirs)
    color = basis[:, 0:1] * sh_coeffs[:, 0, :]
    for j in range(1, k):
        color = color + basis[:, j:j + 1] * sh_coeffs[:, j, :]
    color = color + 0.5
    clamped = color < 0.0
    return torch.clamp(color, min=0.0), clamped


def sh_to_rgb(sh):
    return sh * SH_C0 + 0.5


def rgb_to_sh(rgb):
    """Inverse of band-0 SH: point-cloud color init (`sh_utils.py:114`)."""
    return (rgb - 0.5) / SH_C0

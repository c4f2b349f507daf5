"""Parameter activations and the quaternion -> covariance helper.

Counterpart of `gsplat_tpu/core/activations.py`: wxyz quaternions normalized
by the activation, exponentiated log-scales, sigmoided logit opacities, and
their inverses for initialisation and densification.
"""

from __future__ import annotations

import torch


def scaling_activation(s):
    return torch.exp(s)


def scaling_inverse_activation(s):
    return torch.log(s)


def opacity_activation(o):
    return torch.sigmoid(o)


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def normalize_rotation(q, eps: float = 0.0):
    """Unit-normalize quaternions (wxyz), last axis.

    The sum of squares is written out left to right, the order the
    projection kernel uses (`csrc/projection.cu`): `torch.sum` fixes no
    order, and the kernel is held bit for bit against this function.
    """
    q0, q1, q2, q3 = (q[..., i:i + 1] for i in range(4))
    norm = torch.sqrt(((q0 * q0 + q1 * q1) + q2 * q2) + q3 * q3 + eps)
    return q / norm


def quat_to_rotmat(q):
    """Quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3), normalized
    here (reference `build_rotation`, `utils/general_utils.py:78-99`)."""
    q = normalize_rotation(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - r * z),
            2 * (x * z + r * y),
            2 * (x * y + r * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - r * x),
            2 * (x * z - r * y),
            2 * (y * z + r * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def covariance_from_scaling_rotation(scales, scale_modifier, quats):
    """World-space 3D covariance as the upper-triangular 6-vector
    [xx, xy, xz, yy, yz, zz] of Sigma = R diag(s^2) R^T (`forward.cu:114-151`).

    Written componentwise in the JAX package's operation order, so the two
    agree to float32 rounding of the same expressions.
    """
    q = normalize_rotation(quats)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s = scale_modifier * scales
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]

    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)

    v0, v1, v2 = s0 * s0, s1 * s1, s2 * s2
    sxx = v0 * r00 * r00 + v1 * r01 * r01 + v2 * r02 * r02
    sxy = v0 * r00 * r10 + v1 * r01 * r11 + v2 * r02 * r12
    sxz = v0 * r00 * r20 + v1 * r01 * r21 + v2 * r02 * r22
    syy = v0 * r10 * r10 + v1 * r11 * r11 + v2 * r12 * r12
    syz = v0 * r10 * r20 + v1 * r11 * r21 + v2 * r12 * r22
    szz = v0 * r20 * r20 + v1 * r21 * r21 + v2 * r22 * r22
    return torch.stack([sxx, sxy, sxz, syy, syz, szz], dim=-1)

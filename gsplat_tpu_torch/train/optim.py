"""Functional Adam for the Gaussian parameters: per-group LRs, sparse mode.

Counterpart of `gsplat_tpu/train/optim.py`. The reference runs one torch
Adam over six param groups with eps 1e-15 and an exponentially decayed xyz
LR (`scene/gaussian_model.py:183-201`), plus the optional SparseGaussianAdam
that touches only the rows visible in the current view (`train.py:178-183`).
As in the JAX package, both are one functional masked-Adam update with a
step count per row: `visibility=None` is dense Adam; a visibility mask
leaves invisible rows' params, moments and step counts unchanged.
`torch.optim.Adam` is not used: its single step count and eps differ.

Parameters, gradients and moments are dicts {field: (N, ...) tensor}; the
update returns new tensors and leaves its inputs as they are.
"""

from __future__ import annotations

import torch

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15  # reference eps (`gaussian_model.py:193`)


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def make_lr_tree(xyz_lr, feature_lr, opacity_lr, scaling_lr, rotation_lr) -> dict:
    """Per-field float32 learning rates matching the reference groups
    (`gaussian_model.py:183-190`); f_rest trains at feature_lr / 20."""
    return {
        "xyz": _f32(xyz_lr),
        "features_dc": _f32(feature_lr),
        "features_rest": _f32(feature_lr) / 20.0,
        "scaling": _f32(scaling_lr),
        "rotation": _f32(rotation_lr),
        "opacity": _f32(opacity_lr),
    }


def _rows(mask, leaf):
    return mask.reshape(mask.shape[:1] + (1,) * (leaf.dim() - 1))


def adam_update(params, grads, m, v, counts, lr_tree, visibility=None, eps=ADAM_EPS):
    """One (optionally row-masked) Adam step over matching dicts.

    Args:
      params, grads, m, v: {field: (N, ...)} float32 tensors.
      counts: (N,) int32 per-row step counts, driving bias correction; every
        row advances for dense Adam, only visible rows for sparse Adam.
      lr_tree: {field: scalar LR}.
      visibility: optional (N,) bool; rows outside it are left untouched.

    Returns:
      (new_params, new_m, new_v, new_counts).
    """
    if visibility is None:
        new_counts = counts + 1
    else:
        new_counts = counts + visibility.to(counts.dtype)

    t = new_counts.to(torch.float32)
    bc1 = 1.0 - torch.pow(ADAM_B1, t)  # (N,)
    bc2 = 1.0 - torch.pow(ADAM_B2, t)

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        lr = torch.as_tensor(lr_tree[k], dtype=torch.float32, device=p.device)
        m_new = ADAM_B1 * m[k] + (1.0 - ADAM_B1) * g
        v_new = ADAM_B2 * v[k] + (1.0 - ADAM_B2) * g * g
        mb = m_new / _rows(bc1, m_new)
        vb = v_new / _rows(bc2, v_new)
        p_new = p - lr * mb / (torch.sqrt(vb) + eps)
        if visibility is not None:
            row = _rows(visibility, p)
            p_new = torch.where(row, p_new, p)
            m_new = torch.where(row, m_new, m[k])
            v_new = torch.where(row, v_new, v[k])
        new_p[k], new_m[k], new_v[k] = p_new, m_new, v_new
    return new_p, new_m, new_v, new_counts


def adam_update_dense(param, grad, m, v, step, lr, eps=1e-8):
    """Plain dense Adam on one tensor with a scalar step (the exposure
    affines, reference `gaussian_model.py:201`, torch defaults)."""
    step = step + 1
    m_new = ADAM_B1 * m + (1.0 - ADAM_B1) * grad
    v_new = ADAM_B2 * v + (1.0 - ADAM_B2) * grad * grad
    t = torch.as_tensor(step, dtype=torch.float32, device=param.device)
    mb = m_new / (1.0 - torch.pow(ADAM_B1, t))
    vb = v_new / (1.0 - torch.pow(ADAM_B2, t))
    lr = torch.as_tensor(lr, dtype=torch.float32, device=param.device)
    return param - lr * mb / (torch.sqrt(vb) + eps), m_new, v_new, step

"""Functional Adam for the Gaussian parameters: per-group LRs, sparse mode.

Counterpart of `gsplat_tpu/train/optim.py`. The reference runs one torch
Adam over six param groups with eps 1e-15 and an exponentially decayed xyz
LR (`scene/gaussian_model.py:183-201`), plus the optional SparseGaussianAdam
that touches only the rows visible in the current view (`train.py:178-183`).
As in the JAX package, both are one functional masked-Adam update with a
step count per row: `visibility=None` is dense Adam; a visibility mask
leaves invisible rows' params, moments and step counts unchanged.
`torch.optim.Adam` is not used: its single step count and eps differ.

On CUDA tensors `adam_update` launches one kernel for every field
(`adam_rows`, `csrc/adam.cu`); on CPU tensors its plain twin
`adam_update_torch` runs, the same arithmetic in eager torch ops.

Parameters, gradients and moments are dicts {field: (N, ...) tensor}; the
update returns new tensors and leaves its inputs as they are.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15  # reference eps (`gaussian_model.py:193`)


def _f32(x) -> float:
    return float(np.float32(x))


def make_lr_tree(xyz_lr, feature_lr, opacity_lr, scaling_lr, rotation_lr) -> dict:
    """Per-field learning rates matching the reference groups
    (`gaussian_model.py:183-190`); f_rest trains at feature_lr / 20. Python
    floats holding the JAX package's float32 values, so no step copies a
    learning rate to the device."""
    return {
        "xyz": _f32(xyz_lr),
        "features_dc": _f32(feature_lr),
        "features_rest": float(np.float32(feature_lr) / np.float32(20.0)),
        "scaling": _f32(scaling_lr),
        "rotation": _f32(rotation_lr),
        "opacity": _f32(opacity_lr),
    }


def _rows(mask, leaf):
    return mask.reshape(mask.shape[:1] + (1,) * (leaf.dim() - 1))


def adam_update(params, grads, m, v, counts, lr_tree, visibility=None, eps=ADAM_EPS,
                alive=None):
    """One (optionally row-masked) Adam step over matching dicts.

    Args:
      params, grads, m, v: {field: (N, ...)} float32 tensors.
      counts: (N,) int32 per-row step counts, driving bias correction; every
        row advances for dense Adam, only visible rows for sparse Adam.
      lr_tree: {field: scalar LR} (floats, or tensors on the host).
      visibility: optional (N,) bool; rows outside it are left untouched.
      alive: optional (N,) bool; a dead row keeps its parameters bit for bit
        (its moments are updated as any row's), the train step's freeze.

    Returns:
      (new_params, new_m, new_v, new_counts).
    """
    lrs = {k: float(lr_tree[k]) for k in params}
    update = adam_rows if counts.is_cuda else adam_update_torch
    return update(params, grads, m, v, counts, lrs, visibility, eps, alive)


def adam_update_torch(params, grads, m, v, counts, lrs, visibility=None, eps=ADAM_EPS,
                      alive=None):
    """The plain twin of `adam_rows`: `adam_update`'s contract in eager torch
    ops, each rounding once as the kernel's operations do. `lrs`: {field:
    float}."""
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
        m_new = ADAM_B1 * m[k] + (1.0 - ADAM_B1) * g
        v_new = ADAM_B2 * v[k] + (1.0 - ADAM_B2) * g * g
        mb = m_new / _rows(bc1, m_new)
        vb = v_new / _rows(bc2, v_new)
        p_new = p - lrs[k] * mb / (torch.sqrt(vb) + eps)
        if visibility is not None:
            row = _rows(visibility, p)
            p_new = torch.where(row, p_new, p)
            m_new = torch.where(row, m_new, m[k])
            v_new = torch.where(row, v_new, v[k])
        if alive is not None:
            p_new = torch.where(_rows(alive, p), p_new, p)
        new_p[k], new_m[k], new_v[k] = p_new, m_new, v_new
    return new_p, new_m, new_v, new_counts


def _row_stride(g, what):
    """Elements between g's rows, where each row's elements are contiguous
    (the layout the kernel reads); raises on any other layout."""
    want = 1
    for size, stride in reversed(list(zip(g.shape[1:], g.stride()[1:]))):
        if size != 1 and stride != want:
            raise ValueError(f"adam_rows: {what} has strides {g.stride()}: each row must be "
                             "contiguous")
        want *= size
    return g.stride(0)


def adam_rows(params, grads, m, v, counts, lrs, visibility=None, eps=ADAM_EPS, alive=None):
    """The Adam kernel (`gs_adam_rows`, `csrc/adam.cu`) on the card:
    `adam_update_torch`'s results, bit for bit, in one launch for every
    field. Parameters and moments must be contiguous; gradients are read
    through their row stride (each row contiguous), as the projection
    backward hands them over. Writes new tensors. CUDA tensors only."""
    from gsplat_tpu_torch import _kernels

    n, dev = counts.shape[0], counts.device
    if counts.dtype != torch.int32 or not counts.is_contiguous():
        raise ValueError(f"adam_rows: counts must be contiguous int32, got {counts.dtype}")
    if len(params) > _kernels.ADAM_MAX_FIELDS:
        raise ValueError(f"adam_rows: {len(params)} fields, the kernel takes at most "
                         f"{_kernels.ADAM_MAX_FIELDS}")
    masks = []
    for name, mask in (("visibility", visibility), ("alive", alive)):
        if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (n,)
                                 or mask.device != dev or not mask.is_contiguous()):
            raise ValueError(f"adam_rows: {name} must be a contiguous ({n},) bool on {dev}")
        masks.append(None if mask is None else mask.data_ptr())
    new_p, new_m, new_v = {}, {}, {}
    fields = []
    for k, p in params.items():
        g = grads[k]
        for what, t in (("param", p), ("grad", g), ("m", m[k]), ("v", v[k])):
            if (t.dtype != torch.float32 or t.shape != p.shape or t.device != dev
                    or t.shape[:1] != (n,)):
                raise ValueError(f"adam_rows: {k} {what} is {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}, want float32 ({n}, ...) on {dev}")
            if what != "grad" and not t.is_contiguous():
                raise ValueError(f"adam_rows: {k} {what} is not contiguous")
        new_p[k], new_m[k], new_v[k] = (torch.empty_like(t, memory_format=torch.contiguous_format)
                                        for t in (p, m[k], v[k]))
        fields.append(_kernels.AdamField(
            p.data_ptr(), g.data_ptr(), m[k].data_ptr(), v[k].data_ptr(), new_p[k].data_ptr(),
            new_m[k].data_ptr(), new_v[k].data_ptr(), _row_stride(g, f"{k} grad"),
            p[0].numel() if n else 0, lrs[k]))
    new_counts = torch.empty_like(counts)
    if n == 0:
        return new_p, new_m, new_v, new_counts
    args = _kernels.AdamArgs((_kernels.AdamField * _kernels.ADAM_MAX_FIELDS)(*fields),
                             counts.data_ptr(), new_counts.data_ptr(), *masks, n, len(fields),
                             eps)
    lib = _kernels.load("adam")
    _kernels.check(lib.gs_adam_rows(ctypes.byref(args), _kernels.stream(dev)), "adam_rows")
    adam_rows.launches += 1
    return new_p, new_m, new_v, new_counts


adam_rows.launches = 0


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

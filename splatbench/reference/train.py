"""Plain PyTorch reference of one 3DGS training step: the render of
`render.py`, the loss (1 - lambda) L1 + lambda (1 - SSIM) with the 11x11
Gaussian window of sigma 1.5 and zero padding (`utils/loss_utils.py` of
Kerbl et al. 2023) on the image times its alpha mask, plus the weighted
L1 of the inverse depth against its target under its mask, its gradient by
autograd, and Adam (beta 0.9 / 0.999, eps 1e-15) with one learning rate per
leaf and bias correction at the step count; with exposure, the per-view
affine and its own Adam.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from splatbench.reference import render as ref_render

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15
SSIM_C1 = 0.01 ** 2
SSIM_C2 = 0.03 ** 2


def _window(device):
    x = torch.arange(11, dtype=torch.float64, device=device) - 5
    g = torch.exp(-x * x / (2 * 1.5 ** 2))
    g = (g / g.sum()).float()
    return (g[:, None] * g[None, :]).expand(3, 1, 11, 11).contiguous()


def ssim(img, gt):
    """Mean SSIM of two (H, W, 3) images."""
    x, y = img.permute(2, 0, 1)[None], gt.permute(2, 0, 1)[None]
    win = _window(img.device)

    def blur(t):
        return F.conv2d(t, win, padding=5, groups=3)

    mu_x, mu_y = blur(x), blur(y)
    sxx = blur(x * x) - mu_x * mu_x
    syy = blur(y * y) - mu_y * mu_y
    sxy = blur(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + SSIM_C1) * (2 * sxy + SSIM_C2)
    den = (mu_x * mu_x + mu_y * mu_y + SSIM_C1) * (sxx + syy + SSIM_C2)
    return (num / den).mean()


def photometric_loss(img, gt, lambda_dssim):
    l1 = torch.abs(img - gt).mean()
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(img, gt))


def loss_and_grads(params, cam, gt, bg, lambda_dssim, targets=None, depth_weight=0.0,
                   exposure=None):
    """(loss, {leaf: gradient}) of one view. `targets` ({alpha_mask,
    inverse_depth, depth_mask}) mask the image and give the depth term its
    target (`train.py:105-140`); an `exposure` (3, 4) gets its gradient as
    the leaf "exposure"."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    wrt = dict(leaves)
    if exposure is not None:
        wrt["exposure"] = exposure.detach().requires_grad_(True)
    out = ref_render.render(leaves, cam, bg, recompute=True, exposure=wrt.get("exposure"))
    image = out["render"] if targets is None else out["render"] * targets["alpha_mask"]
    loss = photometric_loss(image, gt, lambda_dssim)
    if depth_weight:
        depth = (out["invdepth"] - targets["inverse_depth"]) * targets["depth_mask"]
        loss = loss + depth_weight * torch.abs(depth).mean()
    grads = torch.autograd.grad(loss, list(wrt.values()))
    return loss.detach(), dict(zip(wrt, grads))


def adam(params, grads, m, v, step, lrs, eps=ADAM_EPS):
    """One Adam step at step count `step` (1 for the first); new dicts."""
    bc1 = 1.0 - ADAM_B1 ** step
    bc2 = 1.0 - ADAM_B2 ** step
    out_p, out_m, out_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        out_m[k] = ADAM_B1 * m[k] + (1.0 - ADAM_B1) * g
        out_v[k] = ADAM_B2 * v[k] + (1.0 - ADAM_B2) * g * g
        denom = torch.sqrt(out_v[k] / bc2) + eps
        out_p[k] = p - lrs[k] * (out_m[k] / bc1) / denom
    return out_p, out_m, out_v


def learning_rates(xyz_lr, feature_lr=0.0025, opacity_lr=0.025, scaling_lr=0.005,
                   rotation_lr=0.001):
    """The six groups of `gaussian_model.py:183-190`: f_rest at feature_lr / 20."""
    return {"xyz": xyz_lr, "features_dc": feature_lr, "features_rest": feature_lr / 20.0,
            "opacity": opacity_lr, "scaling": scaling_lr, "rotation": rotation_lr}


def norms(tree):
    """{leaf: L2 norm}."""
    return {k: float(torch.linalg.vector_norm(t)) for k, t in tree.items()}


def run_steps(params, views, lambda_dssim, targets=None, depth_weight=0.0, exposure=None):
    """Follow the steps of `views`, each (camera, gt, bg, xyz_lr, exposure_lr,
    view index); returns the losses, the first step's gradient norms per
    leaf and the parameters after the last step. With `exposure` (views,
    3, 4), each step applies its view's affine and the affines follow their
    own dense Adam (one step count, torch's eps 1e-8; `gaussian_model.py:
    201`), reported as the leaf "exposure"."""
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    if exposure is not None:
        em, ev = {"exposure": torch.zeros_like(exposure)}, {"exposure": torch.zeros_like(exposure)}
    losses, first = [], None
    for i, (cam, gt, bg, xyz_lr, exposure_lr, index) in enumerate(views, start=1):
        loss, grads = loss_and_grads(params, cam, gt, bg, lambda_dssim, targets, depth_weight,
                                     None if exposure is None else exposure[index])
        losses.append(float(loss))
        if exposure is not None:
            g = torch.zeros_like(exposure)
            g[index] = grads.pop("exposure")
            full = {**grads, "exposure": g}
            ex, em, ev = adam({"exposure": exposure}, {"exposure": g}, em, ev, i,
                              {"exposure": exposure_lr}, eps=1e-8)
            exposure = ex["exposure"]
        else:
            full = grads
        if first is None:
            first = norms(full)
        params, m, v = adam(params, grads, m, v, i, learning_rates(xyz_lr))
        del grads, full
    if exposure is not None:
        params = {**params, "exposure": exposure}
    return losses, first, params

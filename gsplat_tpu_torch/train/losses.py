"""Image losses: L1, MSE, PSNR, windowed SSIM, depth-L1.

Counterpart of `gsplat_tpu/train/losses.py`. SSIM follows the reference
(`utils/loss_utils.py:46-86`): 11x11 Gaussian window, sigma 1.5, "same"
zero padding, C1 = 0.01^2, C2 = 0.03^2, written as two separable depthwise
`F.conv2d` passes in float32. The JAX package computes SSIM outside any
Pallas kernel, so a library convolution is the port here.

`ssim` is a `torch.autograd.Function` whose backward is the JAX package's
hand-derived one (`_ssim_bwd`, `losses.py:111-148`, the fused-ssim
derivation), built from the same blurs. On the card the convolutions must
run in full float32: `device.resolve_device` turns cuDNN's TF32 off, since
SSIM's variance terms blur(x^2) - mu^2 cancel almost exactly.

Images are HWC float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_C1 = 0.01**2
_C2 = 0.03**2


def l1_loss(pred, target):
    return torch.abs(pred - target).mean()


def mse(pred, target):
    return ((pred - target) ** 2).mean()


def psnr(pred, target):
    """Per-image PSNR (`utils/image_utils.py:17-19`)."""
    m = torch.mean((pred - target) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(m))


def _gaussian_window(window_size: int, sigma: float, device):
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    return torch.tensor(g / g.sum(), dtype=torch.float32, device=device)


def _blur(img, window):
    """Separable depthwise 'same'-padding blur over H and W of an HWC image."""
    k = window.shape[0]
    pad = k // 2
    x = torch.movedim(img, -1, 0)[None]  # (1, C, H, W)
    c = x.shape[1]
    x = F.conv2d(x, window.reshape(1, 1, k, 1).repeat(c, 1, 1, 1), padding=(pad, 0), groups=c)
    x = F.conv2d(x, window.reshape(1, 1, 1, k).repeat(c, 1, 1, 1), padding=(0, pad), groups=c)
    return torch.movedim(x[0], 0, -1)


def _ssim_fields(img1, img2, blur):
    mu1 = blur(img1)
    mu2 = blur(img2)
    sigma1_sq = blur(img1 * img1) - mu1 * mu1
    sigma2_sq = blur(img2 * img2) - mu2 * mu2
    sigma12 = blur(img1 * img2) - mu1 * mu2
    return mu1, mu2, sigma1_sq, sigma2_sq, sigma12


def _ssim_map(mu1, mu2, sigma1_sq, sigma2_sq, sigma12):
    return ((2 * mu1 * mu2 + _C1) * (2 * sigma12 + _C2)) / (
        (mu1 * mu1 + mu2 * mu2 + _C1) * (sigma1_sq + sigma2_sq + _C2)
    )


def _ssim_partials(mu1, mu2, s1, s2, s12):
    """Per-pixel partials of ssim_map wrt (mu1, blur(x^2), blur(x*y)); see
    `gsplat_tpu/train/losses.py:111-130` for the derivation."""
    A = 2 * mu1 * mu2 + _C1
    B = 2 * s12 + _C2
    C = mu1 * mu1 + mu2 * mu2 + _C1
    D = s1 + s2 + _C2
    inv_CD = 1.0 / (C * D)
    AB_CD = A * B * inv_CD
    d_q = 2 * A * inv_CD
    d_p = -AB_CD / D
    d_mu1 = (2 * mu2 * B) * inv_CD - 2 * mu1 * AB_CD / C + 2 * mu1 * AB_CD / D - mu2 * d_q
    return d_mu1, d_p, d_q


class _SSIM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img1, img2, window_size, sigma):
        window = _gaussian_window(window_size, sigma, img1.device)
        fields = _ssim_fields(img1, img2, lambda x: _blur(x, window))
        ctx.save_for_backward(img1, img2, window, *fields)
        return _ssim_map(*fields).mean()

    @staticmethod
    def backward(ctx, g):
        img1, img2, window, mu1, mu2, s1, s2, s12 = ctx.saved_tensors

        def blur(x):  # blur^T == blur (symmetric window, zero 'same' padding)
            return _blur(x, window)

        scale = g / img1.numel()
        d_mu1, d_p, d_q = _ssim_partials(mu1, mu2, s1, s2, s12)
        gx = scale * (blur(d_mu1) + 2 * img1 * blur(d_p) + img2 * blur(d_q))
        # y-side by symmetry of ssim_map in (x, y)
        d_mu2, d_p2, d_q2 = _ssim_partials(mu2, mu1, s2, s1, s12)
        gy = scale * (blur(d_mu2) + 2 * img2 * blur(d_p2) + img1 * blur(d_q2))
        return gx, gy, None, None


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM over an HWC image pair, with the hand-derived backward."""
    return _SSIM.apply(img1, img2, window_size, sigma)


def photometric_loss(image, gt_image, lambda_dssim):
    """(1-λ)·L1 + λ·(1-SSIM) (`train.py:120-126`). Returns (loss, l1)."""
    ll1 = l1_loss(image, gt_image)
    loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(image, gt_image))
    return loss, ll1


def depth_l1_loss(invdepth, mono_invdepth, depth_mask):
    """mean(|render_invdepth - mono_invdepth| * mask) (`train.py:129-140`)."""
    return torch.abs((invdepth - mono_invdepth) * depth_mask).mean()

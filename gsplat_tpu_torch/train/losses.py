"""Image losses: L1, MSE, PSNR, windowed SSIM, depth-L1.

Counterpart of `gsplat_tpu/train/losses.py`. SSIM follows the reference
(`utils/loss_utils.py:46-86`): 11x11 Gaussian window, sigma 1.5, "same"
zero padding, C1 = 0.01^2, C2 = 0.03^2, in float32, with the JAX package's
hand-derived backward (`_ssim_bwd`, `losses.py:111-148`, the fused-ssim
derivation).

`photometric_loss` and `ssim` are one `torch.autograd.Function`
(`PhotometricLoss`). On CUDA tensors it launches the kernels of
`csrc/loss.cu`: `loss_fwd` (the five blurs, the SSIM map, its partials
where a gradient is wanted, both means) and `loss_bwd` (the gradient). On
CPU tensors their plain twins `loss_fwd_torch` and `loss_bwd_torch` run,
the same arithmetic in eager torch ops. The twins' blur (`_blur`) is
separable, the H pass then the W pass, each sum in tap order 0..10
starting from tap 0's product, as the kernels sum, and the twin sums the
two means in the forward kernel's order (`_kernel_order_mean`). SSIM's
variance terms blur(x^2) - mu^2 cancel almost exactly, so every blur is
full float32.

Images are HWC float32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from gsplat_tpu_torch.profiling import span

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


@functools.cache
def _window_taps(window_size: int, sigma: float) -> tuple:
    """The window's float32 taps as Python floats."""
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    return tuple(float(t) for t in (g / g.sum()).astype(np.float32))


def _gaussian_window(window_size: int, sigma: float, device):
    return torch.tensor(_window_taps(window_size, sigma), dtype=torch.float32, device=device)


def _blur(img, window):
    """Separable 'same'-padding blur over H and W of a (..., H, W, C) image:
    along H, then along W, each a sum of the window's taps in order 0..10
    over the zero-padded shifts, starting from tap 0's product. `window`: a
    1-D tensor or a sequence of floats."""
    taps = window.tolist() if torch.is_tensor(window) else list(window)
    k = len(taps)
    pad = k // 2
    for dim, padding in ((-3, (0, 0, 0, 0, pad, pad)), (-2, (0, 0, pad, pad))):
        n = img.shape[dim]
        xp = F.pad(img, padding)
        acc = taps[0] * xp.narrow(dim, 0, n)
        for t in range(1, k):
            acc = acc + taps[t] * xp.narrow(dim, t, n)
        img = acc
    return img


def _blur_conv(img, window):
    """The blur as two depthwise `F.conv2d` passes: the route the kernels
    replaced, kept as a timed reference (`chip_smoke.py`); no train or
    evaluation path calls it."""
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


_TILE = 16  # the tile of the means' float sums, TILE x TILE pixels
_WARP = 32
_FINISH_THREADS = 1024  # the lanes of their double sum


def _kernel_order_mean(v):
    """The mean of an (H, W, 3) float32 map summed as `gs_loss_fwd` sums
    it. In float32: each pixel's three channels in order; per 16 x 16 tile
    (tiles row-major, pixels row-major in a tile, zeros past the image) a
    shuffle-down tree over each 32 pixels (halves added pairwise, 16 then
    8, 4, 2, 1 lanes), then the tile's eight warp sums in order. In
    double: tile i into slot i mod 1024, in order of i, then the 1024
    slots halved pairwise (512, ..., 1). The mean is the double sum over
    H * W * 3, rounded to float32. Every step is an elementwise add, so
    torch sums in this order on either device."""
    h, w, _ = v.shape
    t = ((0.0 + v[..., 0]) + v[..., 1]) + v[..., 2]
    gy, gx = -(-h // _TILE), -(-w // _TILE)
    t = F.pad(t, (0, gx * _TILE - w, 0, gy * _TILE - h))
    t = t.reshape(gy, _TILE, gx, _TILE).transpose(1, 2).reshape(gy * gx, -1, _WARP)
    lanes = _WARP
    while lanes > 1:
        lanes //= 2
        t = t[..., :lanes] + t[..., lanes:2 * lanes]
    t = t[..., 0]  # (tiles, warps)
    tile = torch.zeros_like(t[:, 0])
    for i in range(t.shape[1]):
        tile = tile + t[:, i]
    tiles = tile.shape[0]
    rows = -(-tiles // _FINISH_THREADS)
    d = F.pad(tile.double(), (0, rows * _FINISH_THREADS - tiles)).reshape(rows, -1)
    acc = torch.zeros_like(d[0])
    for r in range(rows):
        acc = acc + d[r]
    while acc.shape[0] > 1:
        half = acc.shape[0] // 2
        acc = acc[:half] + acc[half:]
    # a tensor divisor: torch multiplies by a Python scalar's reciprocal
    return (acc[0] / torch.full_like(acc[0], float(v.numel()))).float()


def loss_fwd_torch(image, gt, lam, want_x, want_y, taps):
    """The plain twin of `loss_fwd`: (loss, l1, ssim, px, py), the three
    means as 0-dim tensors (summed in the kernel's order,
    `_kernel_order_mean`) and the partial maps `_ssim_partials` of the
    rendered image (`px`) and of the ground truth (`py`) stacked as (3, H,
    W, C), each None unless wanted."""
    fields = _ssim_fields(image, gt, lambda z: _blur(z, taps))
    mu1, mu2, s1, s2, s12 = fields
    ss = _kernel_order_mean(_ssim_map(*fields))
    ll1 = _kernel_order_mean(torch.abs(image - gt))
    loss = (1.0 - lam) * ll1 + lam * (1.0 - ss)
    px = torch.stack(_ssim_partials(mu1, mu2, s1, s2, s12)) if want_x else None
    py = torch.stack(_ssim_partials(mu2, mu1, s2, s1, s12)) if want_y else None
    return loss, ll1, ss, px, py


def _f32_inv(n: int) -> float:
    """1/n rounded to float32, as both routes multiply by it."""
    return float(np.float32(1.0 / n))


def loss_bwd_torch(a, b, partials, g_loss, g_l1, g_ssim, lam, taps):
    """The plain twin of `loss_bwd`: the gradient of (loss, l1, ssim) with
    incoming gradients (g_loss, g_l1, g_ssim) (0-dim tensors, None for 0)
    with respect to image `a`, the other image `b` and `a`'s partial maps.
    The L1 term's sign(a - b) is the gradient for either image."""
    zero = a.new_zeros(())
    gl, g1, gs = (zero if g is None else g for g in (g_loss, g_l1, g_ssim))
    inv_n = _f32_inv(a.numel())
    ca = ((1.0 - lam) * gl + g1) * inv_n
    cb = (gs - lam * gl) * inv_n
    d_mu, d_p, d_q = partials
    return ca * torch.sign(a - b) + cb * (
        _blur(d_mu, taps) + 2 * a * _blur(d_p, taps) + b * _blur(d_q, taps))


def _check_images(image, gt, what):
    if (image.dtype != torch.float32 or gt.dtype != torch.float32 or image.shape != gt.shape
            or image.dim() != 3 or image.shape[-1] != 3 or image.device != gt.device
            or image.shape[0] == 0 or image.shape[1] == 0):
        raise ValueError(f"{what}: images are {image.dtype} {tuple(image.shape)} and "
                         f"{gt.dtype} {tuple(gt.shape)}, want float32 (H, W, 3) both")
    if not (image.is_contiguous() and gt.is_contiguous()):
        raise ValueError(f"{what}: images must be contiguous")


@functools.cache
def _ticket(device):
    """The forward kernel's counter of finished blocks on `device`: zero
    before each launch, and the launch's last block zeroes it again, so
    launches on one stream share it (not launches on two streams at
    once)."""
    return torch.zeros((), dtype=torch.int32, device=device)


def loss_fwd(image, gt, lam, want_x, want_y, taps):
    """The forward kernel (`gs_loss_fwd`, `csrc/loss.cu`), one launch, on
    the card: `loss_fwd_torch`'s partial maps and means bit for bit. CUDA
    tensors only."""
    from gsplat_tpu_torch import _kernels

    _check_images(image, gt, "loss_fwd")
    if len(taps) != _kernels.LOSS_TAPS:
        raise ValueError(f"loss_fwd: the kernel blurs with {_kernels.LOSS_TAPS} taps, "
                         f"got {len(taps)}")
    h, w, _ = image.shape
    f32 = dict(dtype=torch.float32, device=image.device)
    blocks = -(-w // 16) * -(-h // 16)
    px, py = (torch.empty((3,) + tuple(image.shape), **f32) if want else None
              for want in (want_x, want_y))
    sums = torch.empty((2, blocks), **f32)
    loss, ll1, ss = (torch.empty((), **f32) for _ in range(3))
    ptr = [None if t is None else t.data_ptr()
           for t in (image, gt, px, py, sums, loss, ll1, ss, _ticket(image.device))]
    args = _kernels.LossFwdArgs(*ptr, h, w, (ctypes.c_float * _kernels.LOSS_TAPS)(*taps),
                                _C1, _C2, lam, 1.0 - lam)
    lib = _kernels.load("loss")
    _kernels.check(lib.gs_loss_fwd(ctypes.byref(args), _kernels.stream(image.device)),
                   "loss_fwd")
    loss_fwd.launches += 1
    return loss, ll1, ss, px, py


loss_fwd.launches = 0


def loss_bwd(a, b, partials, g_loss, g_l1, g_ssim, lam, taps):
    """The backward kernel (`gs_loss_bwd`, `csrc/loss.cu`) on the card:
    `loss_bwd_torch`'s gradient bit for bit. The incoming gradients stay on
    the card (None for 0). CUDA tensors only."""
    from gsplat_tpu_torch import _kernels

    _check_images(a, b, "loss_bwd")
    if partials.shape != (3,) + tuple(a.shape) or not partials.is_contiguous():
        raise ValueError(f"loss_bwd: partials {tuple(partials.shape)}, want contiguous "
                         f"(3,) + {tuple(a.shape)}")
    h, w, _ = a.shape
    grad = torch.empty_like(a)
    ptr = [None if t is None else t.data_ptr()
           for t in (a, b, partials, g_loss, g_l1, g_ssim, grad)]
    args = _kernels.LossBwdArgs(*ptr, h, w, (ctypes.c_float * _kernels.LOSS_TAPS)(*taps),
                                lam, 1.0 - lam, _f32_inv(a.numel()))
    lib = _kernels.load("loss")
    _kernels.check(lib.gs_loss_bwd(ctypes.byref(args), _kernels.stream(a.device)), "loss_bwd")
    loss_bwd.launches += 1
    return grad


loss_bwd.launches = 0


class PhotometricLoss(torch.autograd.Function):
    """(loss, l1, ssim) of an image pair: loss = (1-λ)·l1 + λ·(1-ssim). The
    forward saves only the partial maps of the inputs whose gradient is
    wanted; the backward forms only those gradients."""

    @staticmethod
    def forward(ctx, image, gt, lam, window_size, sigma):
        taps = _window_taps(window_size, sigma)
        want_x, want_y = ctx.needs_input_grad[:2]
        image, gt = image.contiguous(), gt.contiguous()
        fwd = loss_fwd if image.is_cuda else loss_fwd_torch
        loss, ll1, ss, px, py = fwd(image, gt, lam, want_x, want_y, taps)
        ctx.save_for_backward(image, gt, px, py)
        ctx.lam, ctx.taps = lam, taps
        ctx.set_materialize_grads(False)
        return loss, ll1, ss

    @staticmethod
    def backward(ctx, g_loss, g_l1, g_ssim):
        with span("backward/loss"):
            image, gt, px, py = ctx.saved_tensors
            bwd = loss_bwd if image.is_cuda else loss_bwd_torch
            grads = [None, None]
            for i, (a, b, partials) in enumerate(((image, gt, px), (gt, image, py))):
                if ctx.needs_input_grad[i]:
                    grads[i] = bwd(a, b, partials, g_loss, g_l1, g_ssim, ctx.lam, ctx.taps)
        return grads[0], grads[1], None, None, None


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM over an HWC image pair, with the hand-derived backward."""
    return PhotometricLoss.apply(img1, img2, 0.0, window_size, sigma)[2]


def photometric_loss(image, gt_image, lambda_dssim):
    """(1-λ)·L1 + λ·(1-SSIM) (`train.py:120-126`). Returns (loss, l1)."""
    loss, ll1, _ = PhotometricLoss.apply(image, gt_image, float(lambda_dssim), 11, 1.5)
    return loss, ll1


class _SSIMConv(torch.autograd.Function):
    """SSIM through `_blur_conv` with the JAX package's backward, the ground
    truth's gradient always formed: the route the kernels replaced, kept as
    `chip_smoke.py`'s timed reference (`photometric_loss_conv`)."""

    @staticmethod
    def forward(ctx, img1, img2, window):
        fields = _ssim_fields(img1, img2, lambda x: _blur_conv(x, window))
        ctx.save_for_backward(img1, img2, window, *fields)
        return _ssim_map(*fields).mean()

    @staticmethod
    def backward(ctx, g):
        img1, img2, window, mu1, mu2, s1, s2, s12 = ctx.saved_tensors

        def blur(x):
            return _blur_conv(x, window)

        scale = g / img1.numel()
        d_mu1, d_p, d_q = _ssim_partials(mu1, mu2, s1, s2, s12)
        gx = scale * (blur(d_mu1) + 2 * img1 * blur(d_p) + img2 * blur(d_q))
        d_mu2, d_p2, d_q2 = _ssim_partials(mu2, mu1, s2, s1, s12)
        gy = scale * (blur(d_mu2) + 2 * img2 * blur(d_p2) + img1 * blur(d_q2))
        return gx, gy, None


def photometric_loss_conv(image, gt_image, lambda_dssim):
    """`photometric_loss` as the train step computed it before the loss
    kernels: autograd of the L1 mean and `_SSIMConv`."""
    window = _gaussian_window(11, 1.5, image.device)
    ll1 = l1_loss(image, gt_image)
    ss = _SSIMConv.apply(image, gt_image, window)
    return (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ss), ll1


def depth_l1_loss(invdepth, mono_invdepth, depth_mask):
    """mean(|render_invdepth - mono_invdepth| * mask) (`train.py:129-140`)."""
    return torch.abs((invdepth - mono_invdepth) * depth_mask).mean()

"""The loss kernels' plain twins (`loss_fwd_torch`, `loss_bwd_torch`, what
`photometric_loss` and `ssim` run on CPU tensors) against the JAX package.

Same seeded numpy image pairs through `photometric_loss` and its gradient
for both images (`jax.grad`) at rtol 1e-4, atol 1e-7, the JAX package's own
SSIM tolerance (`tests/test_losses.py:94-95`), at 16x16, 37x53 and 11x5
(smaller than the 11-pixel window). The new SSIM against the route it
replaced (two depthwise `F.conv2d` per blur): the two sum each blur in
another order, which SSIM's cancelling variance terms turn into ~1e-6 of
the largest gradient entry; held at 1e-6 relative on the value and 1e-5 of
the largest entry on the gradients; the twin sums its means in the
forward kernel's order, torch's `mean` in its own, held at 1e-6 relative.
That order (`_kernel_order_mean`) equals a loop-by-loop numpy transcription
of the kernel's sums bit for bit. The ground truth's gradient is formed
only when it is asked for. The kernels (`csrc/loss.cu`) are held to the
twins bit for bit on the card by `chip_smoke.py`'s `loss` phase.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.train import losses as jl
from gsplat_tpu_torch.train import losses as tl

LAMBDA = 0.2


def pair(seed, h, w, noise):
    rng = np.random.default_rng(seed)
    a = rng.random((h, w, 3)).astype(np.float32)
    b = np.clip(a + noise * rng.standard_normal((h, w, 3)), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed,h,w,noise", [(0, 16, 16, 0.1), (1, 37, 53, 0.2),
                                            (2, 11, 5, 0.3)])
def test_photometric_loss_and_both_gradients_match_jax(seed, h, w, noise):
    a, b = pair(seed, h, w, noise)

    def jloss(x, y):
        return jl.photometric_loss(x, y, LAMBDA)[0]

    want, (gx_j, gy_j) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(a),
                                                                   jnp.asarray(b))
    x = torch.from_numpy(a).requires_grad_(True)
    y = torch.from_numpy(b).requires_grad_(True)
    loss, ll1 = tl.photometric_loss(x, y, LAMBDA)
    gx, gy = torch.autograd.grad(loss, (x, y))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-4, abs=1e-7)
    assert float(ll1.detach()) == pytest.approx(float(jl.l1_loss(a, b)), rel=1e-6)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(gy.numpy(), np.asarray(gy_j), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("seed,h,w,noise", [(3, 16, 16, 0.1), (4, 37, 53, 0.2),
                                            (5, 11, 5, 0.3)])
def test_ssim_matches_the_conv_route(seed, h, w, noise):
    a, b = pair(seed, h, w, noise)
    x, y, xc, yc = (torch.from_numpy(t).requires_grad_(True) for t in (a, b, a, b))
    got = tl.ssim(x, y)
    want = tl._SSIMConv.apply(xc, yc, tl._gaussian_window(11, 1.5, "cpu"))
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-6)
    for g, gw in zip(torch.autograd.grad(got, (x, y)), torch.autograd.grad(want, (xc, yc))):
        np.testing.assert_allclose(g.numpy(), gw.numpy(), rtol=0,
                                   atol=1e-5 * float(gw.abs().max()))


def test_photometric_loss_matches_the_route_it_replaced():
    a, b = pair(6, 32, 40, 0.2)
    x, xc = (torch.from_numpy(a).requires_grad_(True) for _ in range(2))
    loss, ll1 = tl.photometric_loss(x, torch.from_numpy(b), LAMBDA)
    want, want_l1 = tl.photometric_loss_conv(xc, torch.from_numpy(b), LAMBDA)
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=1e-6)
    assert float(ll1.detach()) == pytest.approx(float(want_l1.detach()), rel=1e-6)
    assert torch.equal(ll1.detach(), tl._kernel_order_mean(torch.from_numpy(np.abs(a - b))))
    g, = torch.autograd.grad(loss, x)
    gw, = torch.autograd.grad(want, xc)
    np.testing.assert_allclose(g.numpy(), gw.numpy(), rtol=0, atol=1e-5 * float(gw.abs().max()))


class Calls:
    """Counts the twins' calls and the partial maps the forward is asked for."""

    def __init__(self, monkeypatch):
        self.fwd, self.bwd = [], []
        fwd, bwd = tl.loss_fwd_torch, tl.loss_bwd_torch

        def count_fwd(image, gt, lam, want_x, want_y, taps):
            self.fwd.append((want_x, want_y))
            return fwd(image, gt, lam, want_x, want_y, taps)

        def count_bwd(a, *rest):
            self.bwd.append(a)
            return bwd(a, *rest)

        monkeypatch.setattr(tl, "loss_fwd_torch", count_fwd)
        monkeypatch.setattr(tl, "loss_bwd_torch", count_bwd)


@pytest.mark.parametrize("image_grad,gt_grad", [(True, False), (True, True), (False, True)])
def test_a_gradient_is_formed_only_when_asked_for(monkeypatch, image_grad, gt_grad):
    a, b = pair(7, 16, 24, 0.2)
    x = torch.from_numpy(a).requires_grad_(image_grad)
    y = torch.from_numpy(b).requires_grad_(gt_grad)
    calls = Calls(monkeypatch)
    loss, _ = tl.photometric_loss(x, y, LAMBDA)
    wrt = [t for t in (x, y) if t.requires_grad]
    grads = torch.autograd.grad(loss, wrt)
    assert calls.fwd == [(image_grad, gt_grad)]
    assert [t is x for t in calls.bwd] == [True] * image_grad + [False] * gt_grad
    # each gradient equals the one formed with both asked for
    xf, yf = (torch.from_numpy(t).requires_grad_(True) for t in (a, b))
    full = dict(zip(("x", "y"), torch.autograd.grad(tl.photometric_loss(xf, yf, LAMBDA)[0],
                                                     (xf, yf))))
    for t, g in zip(wrt, grads):
        assert torch.equal(g, full["x" if t is x else "y"])


def test_ssim_without_gradients_forms_no_partials(monkeypatch):
    a, b = pair(8, 16, 16, 0.1)
    calls = Calls(monkeypatch)
    with torch.no_grad():
        s = tl.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert calls.fwd == [(False, False)] and not calls.bwd
    assert float(s) == pytest.approx(float(jl.ssim(jnp.asarray(a), jnp.asarray(b))), rel=1e-4)


def test_blur_sums_in_tap_order():
    """`_blur` is the twin's explicit sum: the H pass then the W pass, each
    in tap order from tap 0's product, over zero padding."""
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.random((7, 9, 3)).astype(np.float32))
    taps = tl._window_taps(11, 1.5)

    def one_pass(x, axis):
        n = x.shape[axis]
        xp = np.pad(x, [(5, 5) if i == axis else (0, 0) for i in range(3)])
        acc = np.float32(taps[0]) * np.take(xp, range(0, n), axis=axis)
        for t in range(1, 11):
            acc = acc + np.float32(taps[t]) * np.take(xp, range(t, t + n), axis=axis)
        return acc

    want = one_pass(one_pass(img.numpy(), 0), 1)
    assert np.array_equal(tl._blur(img, taps).numpy(), want)


def kernel_sums(v):
    """`gs_loss_fwd`'s mean of an (H, W, 3) map, loop by loop in numpy:
    per thread (one pixel of a 16 x 16 tile) its channels from 0.0; per
    warp `__shfl_down_sync` offsets 16..1 (a lane past the warp reads its
    own value); thread 0 adds the warp sums from 0.0; the finishing
    block's 1024 threads each add tiles t, t + 1024, ... in double from
    0.0, then halve pairwise; the double mean rounded to float32."""
    h, w, _ = v.shape
    gy, gx = -(-h // 16), -(-w // 16)
    tiles = []
    for by in range(gy):
        for bx in range(gx):
            lane_sums = np.zeros(256, np.float32)
            for k in range(256):
                y, x = by * 16 + k // 16, bx * 16 + k % 16
                if y < h and x < w:
                    for c in range(3):
                        lane_sums[k] = lane_sums[k] + v[y, x, c]
            total = np.float32(0.0)
            for warp in lane_sums.reshape(8, 32):
                warp = warp.copy()
                for o in (16, 8, 4, 2, 1):
                    src = np.arange(32) + o
                    warp = warp + warp[np.where(src < 32, src, np.arange(32))]
                total = np.float32(total + warp[0])
            tiles.append(total)
    slots = [0.0] * 1024
    for i, s in enumerate(tiles):
        slots[i % 1024] = slots[i % 1024] + float(s)
    half = 512
    while half:
        for t in range(half):
            slots[t] = slots[t] + slots[t + half]
        half //= 2
    return np.float32(slots[0] / float(h * w * 3))


@pytest.mark.parametrize("h,w", [(5, 11), (37, 53), (33 * 16 - 3, 32 * 16)])
def test_means_sum_in_the_kernel_order(h, w):
    """The last size has 1,056 tiles, so some finishing threads add two."""
    rng = np.random.default_rng(10 + h)
    v = (rng.standard_normal((h, w, 3)) * rng.random((h, w, 3)) ** 8).astype(np.float32)
    got = tl._kernel_order_mean(torch.from_numpy(v))
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.numpy().tobytes() == kernel_sums(v).tobytes()

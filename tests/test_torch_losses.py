"""The port's losses vs the JAX package's, on the same seeded numpy images.

SSIM and its gradient (the hand-derived backward on both sides) at rtol
1e-4, atol 1e-7, the tolerance of the JAX package's own SSIM backward test
(`tests/test_losses.py:94-95`); the scalar losses at rtol 1e-6 (float32
means over the same values, summed in different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.train import losses as jl
from gsplat_tpu_torch.train import losses as tl


def pair(seed, h=37, w=53, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.random((h, w, 3)).astype(np.float32)
    b = np.clip(a + noise * rng.standard_normal((h, w, 3)).astype(np.float32), 0, 1)
    return a, b


@pytest.mark.parametrize("seed,h,w,noise", [(0, 37, 53, 0.1), (1, 23, 31, 0.3), (2, 16, 16, 1.0)])
def test_ssim_and_its_gradient_match_jax(seed, h, w, noise):
    a, b = pair(seed, h, w, noise)
    want = float(jl.ssim(jnp.asarray(a), jnp.asarray(b)))
    gx_j, gy_j = jax.grad(jl.ssim, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    got = tl.ssim(ta, tb)
    got.backward()
    assert float(got.detach()) == pytest.approx(want, rel=1e-4, abs=1e-7)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gy_j), rtol=1e-4, atol=1e-7)


def test_ssim_backward_matches_autograd_of_the_plain_formula():
    """The hand-derived backward equals autograd through the plain blurs."""
    a, b = pair(5, 23, 31, 0.2)
    window = tl._gaussian_window(11, 1.5, "cpu").double()

    def plain(x, y):
        return tl._ssim_map(*tl._ssim_fields(x, y, lambda z: tl._blur(z, window))).mean()

    x = torch.from_numpy(a).double().requires_grad_(True)
    y = torch.from_numpy(b).double().requires_grad_(True)
    plain(x, y).backward()
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    tl.ssim(ta, tb).backward()
    np.testing.assert_allclose(ta.grad.numpy(), x.grad.numpy(), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tb.grad.numpy(), y.grad.numpy(), rtol=1e-4, atol=1e-7)


def test_scalar_losses_match_jax():
    a, b = pair(3, 16, 24, 0.3)
    rng = np.random.default_rng(4)
    inv, mono = rng.random((2, 16, 24)).astype(np.float32)
    mask = (rng.random((16, 24)) > 0.3).astype(np.float32)
    ja, jb_ = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("l1_loss", "mse", "psnr"):
        assert float(getattr(tl, name)(ta, tb)) == pytest.approx(
            float(getattr(jl, name)(ja, jb_)), rel=1e-6), name
    assert float(tl.depth_l1_loss(*map(torch.from_numpy, (inv, mono, mask)))) == pytest.approx(
        float(jl.depth_l1_loss(*map(jnp.asarray, (inv, mono, mask)))), rel=1e-6)


def test_photometric_loss_and_gradient_match_jax():
    a, b = pair(6, 32, 40, 0.2)

    def jloss(x):
        return jl.photometric_loss(x, jnp.asarray(b), 0.2)[0]

    want, gj = jax.value_and_grad(jloss)(jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_(True)
    loss, ll1 = tl.photometric_loss(ta, torch.from_numpy(b), 0.2)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    assert float(ll1.detach()) == pytest.approx(float(jl.l1_loss(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-7)

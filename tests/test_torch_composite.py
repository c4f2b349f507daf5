"""The composite's plain twins (`gsplat_tpu_torch/ops/composite.py`) against
the JAX package's composite and against autograd of the plain composite
`render` ran before the kernels.

- `composite_torch` and `composite_bwd_torch` vs the lines of
  `gsplat_tpu/render.py:113-127` (background term, `tiles_to_image`,
  exposure einsum at HIGHEST precision, clip) and the OIT quotient of
  `gsplat_tpu/ops/rasterize_jnp.py:259`, built here from
  `gsplat_tpu.ops.rasterize_jnp.tiles_to_image` and `jnp`, forward and
  `jax.vjp`, on seeded blend outputs at 100 x 70 (not a multiple of 16) and
  16 x 16, sorted and OIT, bg (0.25, 0.5, 0.75), with and without exposure.
  Tolerances: render atol 1e-6 (the einsum's order against the kernel's);
  invdepth and final_t rel 1e-6; the cotangent per element rel 1e-5 + atol
  1e-6; d exposure rel 1e-5 of its largest entry.
- Ties (a deliberate difference): at a pre-clamp value of exactly 0 or 1
  and at an OIT denominator of exactly 1e-8 the port passes the whole
  gradient, as torch's `clamp` does; JAX's clip and maximum do not. Those
  pixels are held to torch's rule, the others to JAX.
- vs autograd of the plain composite (`render.py`'s and `blend_tiles_cuda`'s
  torch operations before the kernels): the forward bit for bit without
  exposure; the sorted cotangent's colour and inverse-depth columns bit for
  bit (int32 views) without exposure, final T within rel 1e-6 per element;
  the OIT cotangent and everything with exposure within rel 1e-5 + atol
  1e-6; d exposure within rel 1e-5 of its largest entry (autograd sums
  through a matmul, the twin in the kernel's fixed order).
- `render()` on the CPU equals the plain composite of the blend's raw
  output bit for bit, sorted and OIT.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.ops.rasterize_jnp import tiles_to_image as j_tiles_to_image
from gsplat_tpu_torch.ops import composite as cp
from gsplat_tpu_torch.ops.rasterize_torch import tiles_to_image
from tests.test_torch_composite_kernel_host import BG, exposure_of, grads, raw_frame

SIZES = ((100, 70), (16, 16))
GRADS = ("d_render", "d_invdepth", "d_final_t")


def jax_composite(raw, exposure, mode, gx, gy, w, h):
    bg = jnp.asarray(BG, jnp.float32)
    if mode == "oit":
        t_fin = raw[:, :, 5]
        wq = (1.0 - t_fin) / jnp.maximum(raw[:, :, 4], 1e-8)
        color, invdepth, final_t = raw[:, :, 0:3] * wq[:, :, None], raw[:, :, 3] * wq, t_fin
    else:
        color, invdepth, final_t = raw[:, :, 0:3], raw[:, :, 3], raw[:, :, 4]
    color = color + final_t[..., None] * bg[None, None, :]
    image = j_tiles_to_image(color, gx, gy, 16, w, h)
    if exposure is not None:
        image = jnp.einsum("hwc,cd->hwd", image, exposure[:3, :3],
                           precision=jax.lax.Precision.HIGHEST) + exposure[:3, 3]
    return (jnp.clip(image, 0.0, 1.0), j_tiles_to_image(invdepth, gx, gy, 16, w, h),
            j_tiles_to_image(final_t, gx, gy, 16, w, h))


def plain_composite(raw, exposure, mode, gx, gy, w, h):
    """The composite as `render` and `blend_tiles_cuda` ran it in torch
    before the kernels."""
    bg = torch.tensor(BG)
    if mode == "oit":
        final_t = raw[:, :, 5]
        wq = (1.0 - final_t) / torch.clamp(raw[:, :, 4], min=1e-8)
        color, invdepth = raw[:, :, 0:3] * wq[..., None], raw[:, :, 3] * wq
    else:
        color, invdepth, final_t = raw[:, :, 0:3], raw[:, :, 3], raw[:, :, 4]
    color = color + final_t[..., None] * bg[None, None, :]
    image = tiles_to_image(color, gx, gy, 16, w, h)
    if exposure is not None:
        image = torch.einsum("hwc,cd->hwd", image, exposure[:3, :3]) + exposure[:3, 3]
    return (torch.clamp(image, 0.0, 1.0), tiles_to_image(invdepth, gx, gy, 16, w, h),
            tiles_to_image(final_t, gx, gy, 16, w, h))


def ties(raw, exposure, mode, gx, gy, w, h):
    """(per-pixel mask (T, 256) of the pixels whose gradient follows torch's
    tie rule, pre-clamp values (H, W, 3))."""
    color, _, _ = cp._colour(raw, mode == "oit", torch.tensor(BG))
    img = tiles_to_image(color, gx, gy, 16, w, h)
    pre = img if exposure is None else cp._expose(img, exposure)
    tie = ((pre == 0.0) | (pre == 1.0)).any(-1).float()
    tie = cp.image_to_tiles(tie, gx, gy) > 0
    if mode == "oit":
        tie = tie | (raw[:, :, 4] == np.float32(1e-8))
    return tie, pre


def close(got, want, rtol, atol):
    return bool(((got - want).abs() <= rtol * want.abs() + atol).all())


def twin_bwd(raw, exposure, mode, gx, gy, w, h, g):
    return cp.composite_bwd_torch(raw, mode, torch.tensor(BG), exposure, gx, gy, 16, w, h,
                                  **g, want_exposure=exposure is not None)


@pytest.mark.parametrize("with_exposure", (False, True))
@pytest.mark.parametrize("mode", cp.MODES)
@pytest.mark.parametrize("w,h", SIZES)
def test_composite_twins_match_the_jax_composite(mode, with_exposure, w, h):
    raw, gx, gy = raw_frame(mode, w, h, 7 * w + h)
    exposure = exposure_of(w) if with_exposure else None
    jexp = None if exposure is None else jnp.asarray(exposure.numpy())
    got = cp.composite_torch(raw, mode, torch.tensor(BG), exposure, gx, gy, 16, w, h)
    want, vjp = jax.vjp(lambda r, e: jax_composite(r, e, mode, gx, gy, w, h),
                        jnp.asarray(raw.numpy()), jexp)
    for name, a, b, tol in zip(("render", "invdepth", "final_t"), got, want,
                               ((0.0, 1e-6), (1e-6, 0.0), (1e-6, 0.0))):
        assert close(a, torch.from_numpy(np.array(b)), *tol), name

    g = grads(w, h, w, GRADS)
    cot, dexp = twin_bwd(raw, exposure, mode, gx, gy, w, h, g)
    jraw, jdexp = vjp(tuple(jnp.asarray(g[k].numpy()) for k in GRADS))
    jraw = torch.from_numpy(np.array(jraw))
    tie, _ = ties(raw, exposure, mode, gx, gy, w, h)
    # (exposure moves the clamp's ties off the frame's exact 0 and 1)
    assert bool(tie.any()) or (exposure is not None and mode == "sorted"), "no ties"
    keep = ~tie[..., None].expand(-1, -1, 8)
    assert close(cot[keep], jraw[keep], 1e-5, 1e-6)
    assert torch.equal(cot[..., 6:], torch.zeros_like(cot[..., 6:]))
    if exposure is not None:
        # exposure sums run over the tie pixels too: compare where JAX and
        # torch agree on every pixel, the frame without ties
        no_tie = raw.clone()
        if mode == "sorted":
            no_tie[..., 4] = torch.where(tie, no_tie[..., 4] + 0.125, no_tie[..., 4])
        else:
            no_tie[..., 4] = torch.where(tie, torch.full_like(no_tie[..., 4], 0.5), no_tie[..., 4])
        assert not bool(ties(no_tie, exposure, mode, gx, gy, w, h)[0].any())
        _, dexp = twin_bwd(no_tie, exposure, mode, gx, gy, w, h, g)
        _, vjp2 = jax.vjp(lambda r, e: jax_composite(r, e, mode, gx, gy, w, h),
                          jnp.asarray(no_tie.numpy()), jexp)
        jdexp = torch.from_numpy(np.array(vjp2(tuple(jnp.asarray(g[k].numpy())
                                                       for k in GRADS))[1]))
        assert float((dexp - jdexp).abs().max()) <= 1e-5 * float(jdexp.abs().max())


@pytest.mark.parametrize("mode", cp.MODES)
def test_ties_pass_the_whole_gradient_as_torch_clamp_does(mode):
    """At a pre-clamp value of exactly 0 or 1 the colour's gradient is d
    render itself (no exposure: dc = g)."""
    w, h = 100, 70
    raw, gx, gy = raw_frame(mode, w, h, 3)
    g = grads(w, h, 3, ("d_render",))
    cot, _ = twin_bwd(raw, None, mode, gx, gy, w, h, g)
    _, pre = ties(raw, None, mode, gx, gy, w, h)
    at = (pre == 0.0) | (pre == 1.0)
    assert int(at.sum()) > 10
    d = cp.image_to_tiles(g["d_render"] + 0.0, gx, gy)
    at_t = cp.image_to_tiles(at.float(), gx, gy) > 0
    if mode == "sorted":
        assert torch.equal(cot[..., 0:3][at_t], d[at_t])
    else:  # dN_c = dc_c * w
        wq = (1.0 - raw[:, :, 5]) / torch.clamp(raw[:, :, 4], min=1e-8)
        assert torch.equal(cot[..., 0:3][at_t], (d * wq[..., None] + 0.0)[at_t])


@pytest.mark.parametrize("with_exposure", (False, True))
@pytest.mark.parametrize("mode", cp.MODES)
def test_composite_twins_against_autograd_of_the_plain_composite(mode, with_exposure):
    w, h = 100, 70
    raw, gx, gy = raw_frame(mode, w, h, 11)
    exposure = exposure_of(5) if with_exposure else None
    bg = torch.tensor(BG)
    got = cp.composite_torch(raw, mode, bg, exposure, gx, gy, 16, w, h)
    leaf = raw.clone().requires_grad_(True)
    lexp = None if exposure is None else exposure.clone().requires_grad_(True)
    want = plain_composite(leaf, lexp, mode, gx, gy, w, h)
    if exposure is None:
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.detach().contiguous().view(torch.int32))
    for which in (("d_render", "d_invdepth"), GRADS):
        g = grads(w, h, 11, which)
        cot, dexp = twin_bwd(raw, exposure, mode, gx, gy, w, h, g)
        outs = [o for o, k in zip(want, GRADS) if k in which]
        wrt = [leaf] + ([lexp] if lexp is not None else [])
        ag = torch.autograd.grad(outs, wrt, [g[k] for k in which], retain_graph=True)
        if mode == "sorted" and exposure is None:
            assert torch.equal(cot[..., 0:4].contiguous().view(torch.int32),
                               ag[0][..., 0:4].contiguous().view(torch.int32)), which
            assert close(cot[..., 4], ag[0][..., 4], 1e-6, 0.0), which
            assert torch.equal(cot[..., 5:], ag[0][..., 5:]), which
        else:
            assert close(cot, ag[0], 1e-5, 1e-6), which
        if exposure is not None:
            assert float((dexp - ag[1]).abs().max()) <= 1e-5 * float(ag[1].abs().max()), which


@pytest.mark.parametrize("mode", cp.MODES)
def test_render_equals_the_plain_composite_of_its_blend(mode):
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops.binning import pack_bins
    from gsplat_tpu_torch.ops.projection import preprocess
    from gsplat_tpu_torch.ops.rasterize_cuda import blend_tiles_cuda
    from gsplat_tpu_torch.render import grid_dims, render
    from gsplat_tpu_torch.synthetic import tiny_scene

    params, alive, camera = tiny_scene(n=256, width=100, height=70, sh_degree=0, device="cpu")
    settings = make_render_settings(sh_degree=0, blend_mode=mode, packet_dtype="float32")
    with torch.no_grad():
        out = render(camera, params, alive, settings, list(BG), device="cpu")
        gx, gy = grid_dims(camera, 16)
        screen = preprocess(params, alive, camera, settings, gx, gy, None)
        bins = pack_bins(screen, gx, gy, 16, settings.tight_cull, packet_dtype="float32")
        raw = blend_tiles_cuda(screen, bins, gx, gy, 16, blend_mode=mode, raw=True)
        want = plain_composite(raw, None, mode, gx, gy, 100, 70)
    for k, b in zip(("render", "invdepth", "final_t"), want):
        assert torch.equal(out[k].view(torch.int32), b.contiguous().view(torch.int32)), k
    assert float(out["render"].std()) > 0.01

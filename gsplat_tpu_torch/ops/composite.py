"""The composite between the blend and the loss: kernels Cf' and Cb'.

Counterpart of the lines of `gsplat_tpu/render.py:113-127` (the background
term, `tiles_to_image` of `gsplat_tpu/ops/rasterize_jnp.py:269`, the
exposure affine and the clip) and of the OIT
quotient of `gsplat_tpu/ops/rasterize_pallas.py:1317`
(`rasterize_jnp.py:259`), which XLA fuses into one pass. The port ran them
as eager launches (column views, three crops, the background multiply and
add, the einsum, the clamp) and autograd ran their transposes.

The input is the blend's raw (T, 256, 8) output in tile-major order (tile
`(y // 16) * gx + x // 16`, slot `(y % 16) * 16 + x % 16`):

- sorted (K2'): `[r, g, b, invdepth, final_T, n_contrib, 0, 0]`;
- OIT (K5'): the raw sums `[N0, N1, N2, N3, D, T, 0, 0]`, first turned into
  colour and inverse depth by `w = (1 - T) / max(D, 1e-8)`.

The forward returns the cropped `render` (H, W, 3), after `+ final_T * bg`,
the optional exposure `out_d = ((img_0 E[0,d] + img_1 E[1,d]) + img_2
E[2,d]) + E[d,3]` and the clamp to [0, 1], and the cropped `invdepth` and
`final_t` (H, W). Without exposure the sorted form is today's torch
operations in their order, so the image is what `render` gave before the
kernels bit for bit.

The backward writes the (T, 256, 8) cotangent K3' or K6' reads, from d
render, d invdepth and d final_t (each may be None):

- sorted: `[dc_0, dc_1, dc_2, d invdepth, ((dc_0 bg_0 + dc_1 bg_1) + dc_2
  bg_2) + d final_t, 0, 0, 0]`, dc the colour's gradient: d render where
  the pre-clamp value lies in [0, 1] (torch's `clamp` passes the ends and
  stops NaN), through the exposure's transpose `dc_c = ((g_0 E[c,0] + g_1
  E[c,1]) + g_2 E[c,2])`;
- OIT: `[dN0..dN3, dD, dT, 0, 0]` by the chain rule through the quotient,
  with torch's division and `clamp(min=)` derivatives.

Every value is then added to +0.0, as autograd's sum of the column views'
zero-filled gradients does (so a -0 becomes +0), and the padding outside
the crop is exact zeros. The backward recomputes the pre-clamp value from
the raw output, which the blend's autograd node keeps anyway; the forward
saves nothing of its own. Where the exposure needs a gradient, `d E[c,d] =
sum img_c g_d` and `d E[d,3] = sum g_d` are summed in one fixed order
(`_kernel_order_sum`: per tile a warp's shuffle-down tree and the tile's
eight warps in order, in float32; the tiles in double, tile i into lane i
mod 256, then the lanes halved pairwise), which the kernel follows, so the
twin and the kernel agree bit for bit.

`composite_fwd` / `composite_bwd` launch `csrc/composite.cu` on CUDA
tensors; `composite_torch` / `composite_bwd_torch` are their plain twins,
the only route on CPU tensors. `CompositeFunction` joins them under
autograd. The background gets no gradient: `composite` refuses a `bg` that
asks for one.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from gsplat_tpu_torch.ops.rasterize_torch import tiles_to_image
from gsplat_tpu_torch.profiling import span

PPT = 256  # pixels per 16x16 tile
TILE = 16
MIN_DENOM = 1e-8  # the OIT quotient's floor (`rasterize_pallas.py:1317`)
MODES = ("sorted", "oit")
EXPOSURE_SHAPE = (3, 4)
_WARP = 32
_FINISH_LANES = 256  # the lanes of the exposure gradient's double sum


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"blend_mode={mode!r}: expected 'sorted' or 'oit'")


def _colour(out, oit, bg):
    """Per tile pixel: (colour after the background term, invdepth,
    final_T), as `render` composed them before the kernels."""
    if oit:
        final_t = out[:, :, 5]
        w = (1.0 - final_t) / torch.clamp(out[:, :, 4], min=MIN_DENOM)
        color, invdepth = out[:, :, 0:3] * w[..., None], out[:, :, 3] * w
    else:
        color, invdepth, final_t = out[:, :, 0:3], out[:, :, 3], out[:, :, 4]
    return color + final_t[..., None] * bg[None, None, :], invdepth, final_t


def _expose(image, exposure):
    """The exposure affine, each output channel summed in channel order."""
    e = exposure
    return ((image[..., 0:1] * e[0, :3] + image[..., 1:2] * e[1, :3])
            + image[..., 2:3] * e[2, :3]) + e[:3, 3]


def exposure_clamp_torch(image, exposure):
    """The composite's last two steps on an (H, W, 3) image: the exposure
    affine (None: none) and the clamp to [0, 1], in the kernel's order."""
    if exposure is not None:
        image = _expose(image, exposure)
    return torch.clamp(image, 0.0, 1.0)


def image_to_tiles(image, grid_x: int, grid_y: int, tile: int = TILE):
    """(H, W, C?) -> (T, tile*tile, C?): `tiles_to_image`'s transpose, zeros
    in the padding."""
    h, w = image.shape[:2]
    chans = tuple(image.shape[2:])
    pad = (0, 0) * len(chans) + (0, grid_x * tile - w, 0, grid_y * tile - h)
    img = F.pad(image, pad).reshape((grid_y, tile, grid_x, tile) + chans)
    return torch.movedim(img, 1, 2).reshape((grid_y * grid_x, tile * tile) + chans)


def composite_torch(out, mode, bg, exposure, grid_x, grid_y, tile, width, height):
    """Plain twin of `composite_fwd`: (render (H, W, 3), invdepth (H, W),
    final_t (H, W)) from the blend's raw (T, 256, 8) output."""
    _check_mode(mode)
    color, invdepth, final_t = _colour(out, mode == "oit", bg)

    def crop(t):
        return tiles_to_image(t, grid_x, grid_y, tile, width, height).contiguous()

    return exposure_clamp_torch(crop(color), exposure), crop(invdepth), crop(final_t)


def _kernel_order_sum(terms):
    """The sum over tiles and pixels of (T, 256, K) float32 terms as
    `gs_composite_bwd` sums the exposure's gradient: per tile a shuffle-down
    tree over each warp's 32 pixels (halves added pairwise, 16 then 8, 4,
    2, 1 lanes), then the tile's 8 warp sums in order from 0.0, in float32;
    in double, tile i into lane i mod 256, in order of i, then the 256
    lanes halved pairwise; rounded to float32. Elementwise adds only, so
    torch sums in this order on either device."""
    num_tiles, ppt, k = terms.shape
    t = terms.reshape(num_tiles, ppt // _WARP, _WARP, k)
    lanes = _WARP
    while lanes > 1:
        lanes //= 2
        t = t[:, :, :lanes] + t[:, :, lanes:2 * lanes]
    t = t[:, :, 0]  # (T, warps, K)
    tile = torch.zeros_like(t[:, 0])
    for i in range(t.shape[1]):
        tile = tile + t[:, i]
    rows = -(-num_tiles // _FINISH_LANES)
    d = F.pad(tile.double(), (0, 0, 0, rows * _FINISH_LANES - num_tiles))
    d = d.reshape(rows, _FINISH_LANES, k)
    acc = torch.zeros_like(d[0])
    for r in range(rows):
        acc = acc + d[r]
    while acc.shape[0] > 1:
        half = acc.shape[0] // 2
        acc = acc[:half] + acc[half:]
    return acc[0].float()


def composite_bwd_torch(out, mode, bg, exposure, grid_x, grid_y, tile, width, height,
                        d_render, d_invdepth, d_final_t, want_exposure=False):
    """Plain twin of `composite_bwd`: (cotangent (T, 256, 8), d exposure
    (3, 4) or None). A None incoming gradient is zeros; d exposure only
    with `want_exposure` (and an exposure)."""
    _check_mode(mode)
    oit = mode == "oit"
    num_tiles = grid_x * grid_y
    zero = out.new_zeros(())

    def tiles(t, chans=()):
        if t is None:
            return out.new_zeros((num_tiles, tile * tile) + chans)
        return image_to_tiles(t, grid_x, grid_y, tile)

    color, _, _ = _colour(out, oit, bg)
    img = tiles_to_image(color, grid_x, grid_y, tile, width, height)
    pre = img if exposure is None else _expose(img, exposure)
    if d_render is None:
        g = torch.zeros_like(img)
    else:
        g = torch.where((pre >= 0.0) & (pre <= 1.0), d_render, zero)
    if exposure is None:
        dc = g
    else:  # the transpose of `_expose`, each colour's sum in channel order
        e = exposure
        dc = ((g[..., 0:1] * e[:3, 0] + g[..., 1:2] * e[:3, 1]) + g[..., 2:3] * e[:3, 2])
    d_exposure = None
    if want_exposure and exposure is not None:
        terms = torch.stack([f for c in range(3) for f in (
            img[..., c] * g[..., 0], img[..., c] * g[..., 1], img[..., c] * g[..., 2],
            g[..., c])], dim=-1)
        d_exposure = _kernel_order_sum(tiles(terms)).reshape(EXPOSURE_SHAPE)

    dc = tiles(dc, (3,))
    dinv, dft = tiles(d_invdepth), tiles(d_final_t)
    bg_term = (dc[..., 0] * bg[0] + dc[..., 1] * bg[1]) + dc[..., 2] * bg[2]
    if oit:
        n, d_sum, t_fin = out[:, :, 0:4], out[:, :, 4], out[:, :, 5]
        denom = torch.clamp(d_sum, min=MIN_DENOM)
        one_m = 1.0 - t_fin
        w = one_m / denom
        dw = (((dc[..., 0] * n[..., 0] + dc[..., 1] * n[..., 1]) + dc[..., 2] * n[..., 2])
              + dinv * n[..., 3])
        d_denom = -dw * ((one_m / denom) / denom)
        cols = [dc[..., 0] * w, dc[..., 1] * w, dc[..., 2] * w, dinv * w,
                torch.where(d_sum >= MIN_DENOM, d_denom, zero),
                (bg_term - dw / denom) + dft]
    else:
        cols = [dc[..., 0], dc[..., 1], dc[..., 2], dinv, bg_term + dft]
    inside = image_to_tiles(torch.ones((height, width), dtype=torch.float32, device=out.device),
                            grid_x, grid_y, tile) > 0.0
    cot = torch.zeros((num_tiles, tile * tile, 8), dtype=torch.float32, device=out.device)
    cot[..., :len(cols)] = torch.where(inside[..., None], torch.stack(cols, dim=-1) + 0.0, zero)
    return cot, d_exposure


def _check_raw(out, grid_x, grid_y, tile, what):
    if not out.is_cuda:
        raise ValueError(f"{what} launches a CUDA kernel: tensors must be on a CUDA device")
    if tile != TILE:
        raise ValueError(f"{what}: the kernel is built for {TILE}x{TILE} tiles")
    if out.shape != (grid_x * grid_y, PPT, 8) or out.dtype != torch.float32:
        raise ValueError(f"{what}: out must be ({grid_x * grid_y}, {PPT}, 8) float32, got "
                         f"{tuple(out.shape)} {out.dtype}")
    out = out.contiguous()
    return out.clone() if out.data_ptr() % 16 else out  # read as two float4 a pixel


def _on(t, shape, device, what, name):
    """`t` as a contiguous float32 tensor of `shape` on `device`; None stays
    None (a NULL pointer)."""
    if t is None:
        return None
    if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{what}: {name} must be {shape} float32 on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t.contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def composite_fwd(out, mode, bg, exposure, grid_x, grid_y, tile, width, height):
    """Kernel Cf' (`gs_composite_fwd`, `csrc/composite.cu`) on the card:
    `composite_torch`'s outputs bit for bit. CUDA tensors only."""
    from gsplat_tpu_torch import _kernels

    _check_mode(mode)
    out = _check_raw(out, grid_x, grid_y, tile, "composite_fwd")
    dev = out.device
    bg = _on(bg, (3,), dev, "composite_fwd", "bg")
    exposure = _on(exposure, EXPOSURE_SHAPE, dev, "composite_fwd", "exposure")
    f32 = dict(dtype=torch.float32, device=dev)
    image = torch.empty((height, width, 3), **f32)
    invdepth, final_t = (torch.empty((height, width), **f32) for _ in range(2))
    args = _kernels.CompositeFwdArgs(
        *(_ptr(t) for t in (out, bg, exposure, image, invdepth, final_t)),
        grid_x, grid_y, width, height, int(mode == "oit"))
    lib = _kernels.load("composite")
    _kernels.check(lib.gs_composite_fwd(ctypes.byref(args), _kernels.stream(dev)),
                   "composite_fwd")
    composite_fwd.launches += 1
    return image, invdepth, final_t


composite_fwd.launches = 0


@functools.cache
def _ticket(device):
    """The backward's counter of finished blocks on `device` (the exposure
    gradient's sum): zero before each launch, and the launch's last block
    zeroes it again, so launches on one stream share it."""
    return torch.zeros((), dtype=torch.int32, device=device)


def composite_bwd(out, mode, bg, exposure, grid_x, grid_y, tile, width, height,
                  d_render, d_invdepth, d_final_t, want_exposure=False):
    """Kernel Cb' (`gs_composite_bwd`, `csrc/composite.cu`) on the card:
    `composite_bwd_torch`'s cotangent and d exposure bit for bit. CUDA
    tensors only."""
    from gsplat_tpu_torch import _kernels

    _check_mode(mode)
    out = _check_raw(out, grid_x, grid_y, tile, "composite_bwd")
    dev = out.device
    bg = _on(bg, (3,), dev, "composite_bwd", "bg")
    exposure = _on(exposure, EXPOSURE_SHAPE, dev, "composite_bwd", "exposure")
    d_render = _on(d_render, (height, width, 3), dev, "composite_bwd", "d_render")
    d_invdepth, d_final_t = (_on(t, (height, width), dev, "composite_bwd", name)
                             for t, name in ((d_invdepth, "d_invdepth"),
                                             (d_final_t, "d_final_t")))
    num_tiles = grid_x * grid_y
    cot = torch.empty((num_tiles, PPT, 8), dtype=torch.float32, device=dev)
    d_exposure = partials = ticket = None
    if want_exposure and exposure is not None:
        d_exposure = torch.empty(EXPOSURE_SHAPE, dtype=torch.float32, device=dev)
        partials = torch.empty((num_tiles, 12), dtype=torch.float32, device=dev)
        ticket = _ticket(dev)
    args = _kernels.CompositeBwdArgs(
        *(_ptr(t) for t in (out, bg, exposure, d_render, d_invdepth, d_final_t, cot,
                            partials, d_exposure, ticket)),
        grid_x, grid_y, width, height, int(mode == "oit"))
    lib = _kernels.load("composite")
    _kernels.check(lib.gs_composite_bwd(ctypes.byref(args), _kernels.stream(dev)),
                   "composite_bwd")
    composite_bwd.launches += 1
    return cot, d_exposure


composite_bwd.launches = 0


class CompositeFunction(torch.autograd.Function):
    """forward(out, exposure, bg, mode, grid_x, grid_y, width, height) ->
    (render, invdepth, final_t): Cf' on CUDA tensors, its twin on CPU ones.
    The backward runs Cb' (or its twin) into the raw output's cotangent
    and, where asked, the exposure's gradient; it reads the raw output the
    forward saved (the blend's node saves it too)."""

    @staticmethod
    def forward(ctx, out, exposure, bg, mode, grid_x, grid_y, width, height):
        fwd = composite_fwd if out.is_cuda else composite_torch
        res = fwd(out, mode, bg, exposure, grid_x, grid_y, TILE, width, height)
        ctx.save_for_backward(out, exposure, bg)
        ctx.meta = (mode, grid_x, grid_y, TILE, width, height)
        ctx.set_materialize_grads(False)
        return res

    @staticmethod
    def backward(ctx, d_render, d_invdepth, d_final_t):
        out, exposure, bg = ctx.saved_tensors
        none = (None,) * 6
        if d_render is None and d_invdepth is None and d_final_t is None:
            return (None, None) + none
        bwd = composite_bwd if out.is_cuda else composite_bwd_torch
        with span("backward/composite"):
            cot, d_exposure = bwd(out, ctx.meta[0], bg, exposure, *ctx.meta[1:],
                                  d_render, d_invdepth, d_final_t,
                                  want_exposure=ctx.needs_input_grad[1])
        return (cot if ctx.needs_input_grad[0] else None), d_exposure, *none


def composite(out, mode, bg, exposure, grid_x, grid_y, tile, width, height):
    """The composite of one view under autograd: (render, invdepth,
    final_t). `bg` (3,) and `exposure` ((3, 4) or None) on `out`'s device."""
    if tile != TILE:
        raise ValueError(f"the composite is built for {TILE}x{TILE} tiles")
    if bg.requires_grad and torch.is_grad_enabled():
        raise ValueError("composite: the background gets no gradient; pass a bg that "
                         "needs none")
    return CompositeFunction.apply(out, exposure, bg, mode, grid_x, grid_y, width, height)

"""The differentiable tile blend on the card: kernels K2', K3', K5' and K6'.

Counterpart of `gsplat_tpu/ops/rasterize_pallas.py` (`blend_tiles_pallas`,
its sorted custom VJP `_make_blend_vjp`, :1193-1246, and its OIT custom VJP
`_make_oit_vjp`, :1138-1180).

- Forward: K2' `blend_fwd` (`csrc/rasterize_fwd.cu`, replacing the Pallas
  `_fwd_kernel`, `rasterize_pallas.py:368`), plain twin
  `blend_packed_torch`. Both take the packed instance table and return the
  (T, 256, 8) float32 output [r, g, b, invdepth, final_T, n_contrib, 0, 0].
- Backward: K3' `blend_bwd` (`csrc/rasterize_bwd.cu`, replacing the Pallas
  `_bwd_kernel`, `rasterize_pallas.py:605`), plain twin
  `blend_bwd_packed_torch`: (10, K) per-instance gradient rows from the
  forward output and its cotangent. The rows are summed per gaussian by
  `reduce_by_gid` (K4', `ops/reduce.py`).
- `BlendFunction` is the `torch.autograd.Function` with the arguments of
  the JAX custom VJP: the five differentiable per-gaussian arrays (mean2d,
  conic, opacity, rgb, invz = 1/max(depth, 0.2)) and the detached instance
  table, ranges and gauss_id (no slot mask: see `BlendFunction`). Its
  backward returns d mean2d,
  d conic in the true (unfolded) basis, d opacity, d rgb and d invz.
- The OIT mode (`blend_mode="oit"`): K5' `blend_oit_fwd` and K6'
  `blend_oit_bwd` (`csrc/rasterize_oit.cu`, replacing `_oit_fwd_kernel`,
  :897, and `_oit_bwd_kernel`, :974), plain twins `blend_oit_packed_torch`
  and `blend_oit_bwd_packed_torch`, wrapped by `OITBlendFunction`. The
  kernels compute the raw per-pixel sums [N0..N3, D, T, 0, 0]; the
  quotient N / max(D, 1e-8) * (1 - T) is composed in plain torch
  (`blend_tiles_cuda`), so autograd differentiates it, as
  `rasterize_pallas.py:1306-1324` does.

- The warp cull of K2' and K3' (`csrc/common.cuh`): a warp owns an 8x4
  block of its tile's pixels and skips an instance that cannot be kept at
  any of them. `pixel_box_torch` and `warp_reaches_torch` are the twins of
  its two tests; `cull_stats_torch` checks on a frame that no kept pair
  lies outside its box or in a skipped warp, and counts what the cull
  skips. Tests and `chip_smoke.py` use them; the twins' outputs do not
  depend on them.

On CUDA tensors the kernels run; on CPU tensors the twins, which compute
the kernels' arithmetic in the kernels' order. The forward twins walk every
tile's range one instance at a time, batched over tiles and pixels: they
agree with the kernels to the rounding of `exp` and `log1p` (the cull
changes no output bit). The sorted backward's twin sums each row over the
tile's pixels in another order than K3''s reduce-scatter; the OIT
backward's twin walks the 256 pixels in K6''s order, batched over
instances.
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.ops.binning import PackedBins
from gsplat_tpu_torch.ops.projection import ScreenGaussians
from gsplat_tpu_torch.ops.reduce import reduce_by_gid
from gsplat_tpu_torch.ops.rasterize_torch import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    BlendOutput,
    tile_pixel_coords,
)

PPT = 256  # pixels per 16x16 tile
WARPS = PPT // 32
# the pixels a warp of K2'/K3' owns: WARP_W x WARP_H blocks of the tile
# (`gs::WARP_W`, `gs::WARP_H`); the other layout is measured against it
WARP_W, WARP_H = 8, 4
WARP_LAYOUTS = {"blocks_8x4": (8, 4), "strips_16x2": (16, 2)}
DEGENERATE = 1e-3  # `gs::DEGENERATE`
EDGE_PAD = 0.0625  # `gs::EDGE_PAD`


def pair_keep_torch(mx, my, ca, cb, cc, op, px, py):
    """Twin of `gs::pair_power` and `gs::pair_alpha` on broadcastable
    tensors: (dx, dy, power, g, alpha, keep), keep = power <= 0 and alpha
    >= 1/255 (false for NaN)."""
    dx = mx - px
    dy = my - py
    power = (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    g = torch.exp(power)
    alpha = torch.clamp(op * g, max=ALPHA_MAX)
    return dx, dy, power, g, alpha, (power <= 0.0) & (alpha >= ALPHA_MIN)


def _box_and_tau(inst_t):
    """`gs::pixel_box`: the (4, K) box, the margin-padded tau_m (K,) and
    where the box is the finite case (K,) bool, where `gs::pixel_box`
    returns tau_m (elsewhere it returns +-inf)."""
    mx, my, ca, cb, cc, op = inst_t[:6]
    finite = torch.isfinite(inst_t[:6]).all(dim=0)
    ln = torch.log(255.0 * op)
    tau = (ln + 0.03125) + 0.0078125 * torch.abs(ln)
    a, b, c = -ca, -cb, -cc
    four_ac = 4.0 * a * c
    det = four_ac - b * b
    pd = (a > 0.0) & (c > 0.0) & (det > DEGENERATE * four_ac)
    rx2 = 4.0 * c * tau / det
    ry2 = 4.0 * a * tau / det
    rx = 1.0 + torch.sqrt((rx2 + 4.0) + 0.0625 * torch.abs(rx2))
    ry = 1.0 + torch.sqrt((ry2 + 4.0) + 0.0625 * torch.abs(ry2))
    box = torch.stack([mx - rx, mx + rx, my - ry, my + ry])
    inf = float("inf")
    whole = torch.tensor([-inf, inf, -inf, inf], device=inst_t.device)[:, None]
    empty = finite & (~(op > 0.0) | (tau < 0.0))
    box = torch.where(empty, -whole, box)
    return torch.where(~finite | (~empty & ~pd), whole, box), tau, finite & ~empty & pd


def pixel_box_torch(inst_t: torch.Tensor) -> torch.Tensor:
    """Plain twin of `gs::pixel_box` (csrc/common.cuh): (4, K) float32
    [x0, x1, y0, y1] from rows 0-5 [mx, my, ca, cb, cc, op] of the instance
    table, the same arithmetic in the same order.

    Every pixel (px, py) at which the keep test can keep the instance has
    x0 <= px <= x1 and y0 <= py <= y1. The whole plane (+-inf) for a
    non-finite row, and for a conic that is not positive definite or whose
    4a'c' - b'^2 is at most DEGENERATE * 4a'c'; empty (x0 = +inf, x1 = -inf)
    for op <= 0 or ln(255 op) with its margin below 0.
    """
    return _box_and_tau(inst_t)[0]


def _edge_min(u, v0, v1, p, q, r):
    """`gs::edge_min`: min over v in [v0, v1] of p u^2 + q u v + r v^2."""
    v = torch.minimum(torch.maximum(-(q * u) / (r + r), v0), v1)
    return (p * u * u + r * v * v) + q * u * v


def row_span_torch(mx, my, ca, cb, cc, tau, py):
    """Plain twin of `gs::row_span` on broadcastable tensors: (x0, x1), the
    pixels of row `py` at which the keep test can keep an instance whose
    box is finite (`gs::pixel_box`'s tau_m `tau`), the same arithmetic in
    the same order."""
    a, b, c = -ca, -cb, -cc
    dy = my - py
    det = 4.0 * a * c - b * b
    disc = (4.0 * a * tau) * 1.0009765625 - det * (dy * dy)
    h = torch.sqrt(torch.fmax(disc, torch.zeros_like(disc))) / (a + a)  # fmaxf: NaN -> 0
    r = 1.0 + torch.sqrt((h * h + 4.0) + 0.0625 * (h * h))
    xc = mx + (b * dy) / (a + a)
    return xc - r, xc + r


def warp_reaches_torch(inst_t: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """Plain twin of `gs::reaches`: (n, W) bool, whether the warps of
    rectangles `rects` (n, W, 4) walk the instances `inst_t` (>= 6, n):
    the pixel box meets the rectangle and, where the box is finite, the
    conic's minimum over the rectangle widened by 1/16 px is at most tau_m.
    Every pixel where the keep test keeps an instance lies in a warp that
    reaches it (`cull_stats_torch` checks that on a frame)."""
    box, tau, _ = _box_and_tau(inst_t)
    x0, x1, y0, y1 = (v[:, None] for v in box)
    meets = ((x0 <= rects[..., 1]) & (x1 >= rects[..., 0])
             & (y0 <= rects[..., 3]) & (y1 >= rects[..., 2]))
    mx, my, ca, cb, cc = (v[:, None] for v in inst_t[:5])
    u0, u1 = mx - (rects[..., 1] + EDGE_PAD), mx - (rects[..., 0] - EDGE_PAD)
    v0, v1 = my - (rects[..., 3] + EDGE_PAD), my - (rects[..., 2] - EDGE_PAD)
    inside = (u0 <= 0.0) & (u1 >= 0.0) & (v0 <= 0.0) & (v1 >= 0.0)
    a, b, c = -ca, -cb, -cc
    q = torch.minimum(torch.minimum(_edge_min(u0, v0, v1, a, b, c),
                                    _edge_min(u1, v0, v1, a, b, c)),
                      torch.minimum(_edge_min(v0, u0, u1, c, b, a),
                                    _edge_min(v1, u0, u1, c, b, a)))
    return meets & (torch.isinf(x0) | inside | (q <= tau[:, None]))


def pixel_warps(layout=(WARP_W, WARP_H), device=None) -> torch.Tensor:
    """(256,) the warp that owns each pixel of a tile (row-major index) in
    a layout of (width, height) blocks (`gs::warp_pixel` inverted)."""
    w, h = layout
    p = torch.arange(PPT, device=device)
    return torch.div(p // 16, h, rounding_mode="floor") * (16 // w) + (p % 16) // w


def warp_rects_torch(tiles: torch.Tensor, grid_x: int, layout=(WARP_W, WARP_H)) -> torch.Tensor:
    """(n, 8, 4) float32 [wx0, wx1, wy0, wy1] pixel rectangle (both ends
    inclusive) of each warp of the tiles `tiles` (n,)."""
    w, h = layout
    warp = torch.arange(WARPS, device=tiles.device)
    x0 = ((tiles % grid_x) * 16)[:, None] + (warp % (16 // w)) * w
    y0 = (torch.div(tiles, grid_x, rounding_mode="floor") * 16)[:, None] + (warp // (16 // w)) * h
    return torch.stack([x0, x0 + (w - 1), y0, y0 + (h - 1)], dim=-1).to(torch.float32)


def cull_stats_torch(inst_t, tile_start, tile_end, grid_x, grid_y, chunk=1 << 16):
    """The warp cull checked and measured on a frame, in plain torch.

    Over every instance slot of every tile's range and every pixel of its
    tile: the pairs the keep test keeps (`kept_pairs`), those of them
    outside the slot's `pixel_box_torch` box (`kept_outside_box`) and those
    at a pixel whose warp does not reach the slot (`kept_unreached`): both
    must be 0. Per layout of `WARP_LAYOUTS`, the (warp, instance) pairs the
    cull skips (`culled_warp_instances`), of `warp_instances` = 8 per slot.
    `whole_plane`: the slots whose box is the whole plane, which the cull
    never skips: `whole_plane_nonfinite` of them have a non-finite row,
    `whole_plane_degenerate` a finite conic that is not positive definite
    or is past `DEGENERATE`. The shares: `whole_plane_share` of the slots,
    and per layout `culled_share` of the (warp, instance) pairs.
    """
    dev = inst_t.device
    length = (tile_end - tile_start).long()
    tile_of = torch.repeat_interleave(torch.arange(grid_x * grid_y, device=dev), length)
    first = torch.cumsum(length, 0) - length
    slot = tile_start.long()[tile_of] + (torch.arange(tile_of.shape[0], device=dev) - first[tile_of])
    offs = tile_pixel_coords(1, 1, 16, dev)[0]  # (256, 2) pixel offsets in a tile
    warp_of = pixel_warps(device=dev)
    kept = outside = unreached = whole = nonfinite = 0
    culled = dict.fromkeys(WARP_LAYOUTS, 0)
    for c0 in range(0, slot.shape[0], chunk):
        tiles = tile_of[c0:c0 + chunk]
        col = inst_t[:10, slot[c0:c0 + chunk]]
        for name, layout in WARP_LAYOUTS.items():
            reach = warp_reaches_torch(col, warp_rects_torch(tiles, grid_x, layout))
            culled[name] += int((~reach).sum())
            if layout == (WARP_W, WARP_H):
                reach_pix = reach[:, warp_of]
        box = pixel_box_torch(col)
        plane = torch.isinf(box[0]) & (box[0] < 0)
        whole += int(plane.sum())
        nonfinite += int((plane & ~torch.isfinite(col[:6]).all(dim=0)).sum())
        px = ((tiles % grid_x) * 16).to(torch.float32)[:, None] + offs[:, 0]
        py = (torch.div(tiles, grid_x, rounding_mode="floor") * 16).to(torch.float32)[:, None] \
            + offs[:, 1]
        keep = pair_keep_torch(*(v[:, None] for v in col[:6]), px, py)[-1]
        inside = ((px >= box[0][:, None]) & (px <= box[1][:, None])
                  & (py >= box[2][:, None]) & (py <= box[3][:, None]))
        kept += int(keep.sum())
        outside += int((keep & ~inside).sum())
        unreached += int((keep & ~reach_pix).sum())
    n = int(slot.shape[0])
    return {"instances": n, "warp_instances": n * WARPS, "culled_warp_instances": culled,
            "kept_pairs": kept, "kept_outside_box": outside, "kept_unreached": unreached,
            "whole_plane": whole, "whole_plane_nonfinite": nonfinite,
            "whole_plane_degenerate": whole - nonfinite,
            "whole_plane_share": whole / max(n, 1),
            "culled_share": {name: c / max(n * WARPS, 1) for name, c in culled.items()}}


def blend_oit_culled_torch(inst_t, tile_start, tile_end, grid_x, grid_y):
    """K5''s walk in plain torch: `blend_oit_packed_torch`'s sums, each
    pixel adding a pair only where its warp walks the instance
    (`warp_reaches_torch`, 8x4 blocks), in the same order. Bit for bit the
    twin's output when the cull skips no kept pair. Returns (out, walked
    pairs: 32 per (warp, instance) the cull lets through)."""
    dev = inst_t.device
    num_tiles = grid_x * grid_y
    pix = tile_pixel_coords(grid_x, grid_y, 16, dev)
    px, py = pix[..., 0], pix[..., 1]
    start = tile_start.long()
    length = (tile_end - tile_start).long()
    k = inst_t.shape[1]
    warp_of = pixel_warps(device=dev)
    rects = warp_rects_torch(torch.arange(num_tiles, device=dev), grid_x)
    sums = torch.zeros((num_tiles, PPT, 6), dtype=torch.float32, device=dev)
    walked = 0
    for j in range(int(length.max()) if num_tiles else 0):
        col = inst_t[:10, torch.clamp(start + j, max=max(k - 1, 0))]
        reach = warp_reaches_torch(col, rects) & (j < length)[:, None]  # (T, 8)
        walked += 32 * int(reach.sum())
        mx, my, ca, cb, cc, op, r, g, b, iz = (v[:, None] for v in col)
        alpha, kept = pair_keep_torch(mx, my, ca, cb, cc, op, px, py)[4:]
        keep = reach[:, warp_of] & kept
        aw = alpha * (iz * iz)
        terms = torch.stack([aw * r, aw * g, aw * b, aw * iz, aw, torch.log1p(-alpha)], dim=-1)
        sums = torch.where(keep[..., None], sums + terms, sums)
    out = torch.zeros((num_tiles, PPT, 8), dtype=torch.float32, device=dev)
    out[..., 0:5] = sums[..., 0:5]
    out[..., 5] = torch.exp(sums[..., 5])
    return out, walked


def blend_oit_bwd_walked_torch(inst_t, tile_start, tile_end, grid_x, grid_y, fwd, dout):
    """K6''s walk in plain torch: `blend_oit_bwd_packed_torch`'s rows, each
    instance walking only the pixels of its tile inside its
    `pixel_box_torch` box and, where the box is finite, inside each row's
    `row_span_torch`, in the same row-major order. Bit for bit the twin's
    rows when the walk skips no kept pair. Returns (rows, walked pairs)."""
    dev = inst_t.device
    num_tiles = grid_x * grid_y
    length = (tile_end - tile_start).long()
    tile_of = torch.repeat_interleave(torch.arange(num_tiles, device=dev), length)
    first = torch.cumsum(length, 0) - length
    slot = tile_start.long()[tile_of] + (torch.arange(tile_of.shape[0], device=dev) - first[tile_of])
    tx = (tile_of % grid_x) * 16
    ty = torch.div(tile_of, grid_x, rounding_mode="floor") * 16
    col = inst_t[:10, slot]
    (x0, x1, y0, y1), tau, spans = _box_and_tau(col)
    mx, my, ca, cb, cc, op, r, gr, b, z = col
    z2 = z * z
    d = dout.reshape(num_tiles, PPT, 8)
    cot = torch.cat([d[..., 0:5], (d[..., 5] * fwd.reshape(num_tiles, PPT, 8)[..., 5])[..., None]],
                    dim=-1)
    acc = torch.zeros((11, slot.shape[0]), dtype=torch.float32, device=dev)
    walked = 0
    for p in range(PPT):
        px = (tx + p % 16).to(torch.float32)
        py = (ty + p // 16).to(torch.float32)
        sx0, sx1 = row_span_torch(mx, my, ca, cb, cc, tau, py)
        # torch.fmax/fmin pass the box's edge where the span is NaN, as
        # fmaxf/fminf do
        lo = torch.where(spans, torch.fmax(sx0, x0), x0)
        hi = torch.where(spans, torch.fmin(sx1, x1), x1)
        inside = (px >= lo) & (px <= hi) & (py >= y0) & (py <= y1)
        walked += int(inside.sum())
        dx, dy, power, g, alpha, kept = pair_keep_torch(mx, my, ca, cb, cc, op, px, py)
        dn0, dn1, dn2, dn3, dd, rt = cot[tile_of, p].T
        kk = (((dn0 * r + dn1 * gr) + dn2 * b) + dn3 * z) + dd
        dalpha = z2 * kk - rt * (1.0 / (1.0 - alpha))
        dgm = (op * dalpha) * g
        terms = torch.stack([
            dgm * ((ca + ca) * dx + cb * dy), dgm * ((cc + cc) * dy + cb * dx),
            -0.5 * (dgm * dx * dx), -(dgm * dx * dy), -0.5 * (dgm * dy * dy), g * dalpha,
            alpha * dn0, alpha * dn1, alpha * dn2, alpha * dn3, alpha * kk,
        ])
        acc = torch.where(inside & kept, acc + terms, acc)
    dinst = torch.zeros((10, inst_t.shape[1]), dtype=torch.float32, device=dev)
    dinst[0:6, slot] = acc[0:6]
    dinst[6:9, slot] = z2 * acc[6:9]
    dinst[9, slot] = (z + z) * acc[10] + z2 * acc[9]
    return dinst, walked


def blend_packed_torch(
    inst_t: torch.Tensor,
    tile_start: torch.Tensor,
    tile_end: torch.Tensor,
    grid_x: int,
    grid_y: int,
    track_contrib: bool = False,
    count_pairs: bool = False,
):
    """Plain twin of K2': (T, 256, 8) float32 from the packed instances.

    With `count_pairs`, also returns the number of (pixel, instance) pairs
    each pixel walks (its range until it stops, the stopping instance
    included) and how many of them the kernel evaluates: those in a warp
    the cull lets walk the instance (`warp_reaches_torch`).
    """
    dev = inst_t.device
    num_tiles = grid_x * grid_y
    pix = tile_pixel_coords(grid_x, grid_y, 16, dev)
    px, py = pix[..., 0], pix[..., 1]  # (T, 256)
    start = tile_start.long()
    length = (tile_end - tile_start).long()
    max_len = int(length.max()) if num_tiles else 0

    T = torch.ones((num_tiles, PPT), dtype=torch.float32, device=dev)
    color = torch.zeros((num_tiles, PPT, 3), dtype=torch.float32, device=dev)
    inv = torch.zeros((num_tiles, PPT), dtype=torch.float32, device=dev)
    last = torch.zeros((num_tiles, PPT), dtype=torch.int32, device=dev)
    done = torch.zeros((num_tiles, PPT), dtype=torch.bool, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    reached = torch.zeros((), dtype=torch.int64, device=dev)
    k = inst_t.shape[1]
    if count_pairs:
        warp_of = pixel_warps(device=dev)
        rects = warp_rects_torch(torch.arange(num_tiles, device=dev), grid_x)

    for j in range(max_len):
        if j % 64 == 0 and bool((done | (j >= length)[:, None]).all()):
            break
        walk = (j < length)[:, None] & ~done  # (T, 256)
        col = inst_t[:10, torch.clamp(start + j, max=max(k - 1, 0))]  # (10, T)
        mx, my, ca, cb, cc, op, r, g, b, iz = (v[:, None] for v in col)
        alpha, kept = pair_keep_torch(mx, my, ca, cb, cc, op, px, py)[4:]
        keep = walk & kept
        test_t = T * (1.0 - alpha)
        stop = keep & (test_t < T_EPS)
        blend = keep & ~stop
        w = torch.where(blend, alpha * T, torch.zeros_like(T))
        color = color + torch.stack([r * w, g * w, b * w], dim=-1)
        inv = inv + iz * w
        T = torch.where(blend, test_t, T)
        last = torch.where(blend, torch.full_like(last, j + 1), last)
        if count_pairs:
            pairs = pairs + walk.sum()
            reach = warp_reaches_torch(col, rects)[:, warp_of]
            reached = reached + (walk & reach).sum()
        done = done | stop

    out = torch.zeros((num_tiles, PPT, 8), dtype=torch.float32, device=dev)
    out[..., 0:3] = color
    out[..., 3] = inv
    out[..., 4] = T
    if track_contrib:
        out[..., 5] = last.to(torch.float32)
    if count_pairs:
        return out, int(pairs), int(reached)
    return out


def _kernel_inputs(what, inst_t, tile_start, tile_end, grid_x, grid_y, *per_pixel):
    """A blend kernel's inputs, checked and made contiguous: the instance
    table, the int32 ranges and any (T, 256, 8) per-pixel tensors (the
    forward output and its cotangent). CUDA tensors only."""
    if not inst_t.is_cuda:
        raise ValueError(f"{what} launches a CUDA kernel: tensors must be on a CUDA device")
    if inst_t.dtype != torch.float32 or inst_t.dim() != 2 or inst_t.shape[0] < 10:
        raise ValueError(f"inst_t must be (16, K) float32, got {tuple(inst_t.shape)} {inst_t.dtype}")
    num_tiles = grid_x * grid_y
    if tile_start.shape != (num_tiles,) or tile_end.shape != (num_tiles,):
        raise ValueError("tile_start/tile_end must be (grid_x * grid_y,)")
    for name, t in zip(("fwd", "dout"), per_pixel):
        if t.shape != (num_tiles, PPT, 8) or t.dtype != torch.float32 or t.device != inst_t.device:
            raise ValueError(f"{name} must be ({num_tiles}, {PPT}, 8) float32 on {inst_t.device}")
    return (inst_t.contiguous(), tile_start.to(torch.int32).contiguous(),
            tile_end.to(torch.int32).contiguous(), *(t.contiguous() for t in per_pixel))


def blend_fwd(inst_t, tile_start, tile_end, grid_x, grid_y, track_contrib=False):
    """Kernel K2' on the card: same contract as `blend_packed_torch`.
    CUDA tensors only."""
    from gsplat_tpu_torch import _kernels

    inst_t, tile_start, tile_end = _kernel_inputs(
        "blend_fwd", inst_t, tile_start, tile_end, grid_x, grid_y)
    num_tiles = grid_x * grid_y
    out = torch.empty((num_tiles, PPT, 8), dtype=torch.float32, device=inst_t.device)
    lib = _kernels.load("rasterize_fwd")
    err = lib.gs_blend_fwd(
        inst_t.data_ptr(), inst_t.shape[1], tile_start.data_ptr(), tile_end.data_ptr(),
        num_tiles, grid_x, int(track_contrib), out.data_ptr(),
        _kernels.stream(inst_t.device),
    )
    _kernels.check(err, "blend_fwd")
    blend_fwd.launches += 1
    return out


blend_fwd.launches = 0


def blend_bwd_packed_torch(inst_t, tile_start, tile_end, grid_x, grid_y, fwd, dout,
                           count_pairs=False):
    """Plain twin of K3': (10, K) per-instance gradient rows.

    Walks every tile's range front to back with the forward's keep and stop
    decisions (the same arithmetic as `blend_packed_torch`), batched over
    tiles and pixels; each row is the sum over the tile's 256 pixels of the
    kernel's per-pixel terms (see `csrc/rasterize_bwd.cu`).

    With `count_pairs`, also returns the number of (pixel, instance) pairs
    the kernel evaluates (as `blend_packed_torch` counts them) and the
    number it blends, which get the gradient terms.
    """
    dev = inst_t.device
    num_tiles = grid_x * grid_y
    k = inst_t.shape[1]
    pix = tile_pixel_coords(grid_x, grid_y, 16, dev)
    px, py = pix[..., 0], pix[..., 1]  # (T, 256)
    start = tile_start.long()
    length = (tile_end - tile_start).long()
    max_len = int(length.max()) if num_tiles else 0

    f = fwd.reshape(num_tiles, PPT, 8)
    d = dout.reshape(num_tiles, PPT, 8)
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    s_total = ((f[..., 0] * d0 + f[..., 1] * d1) + f[..., 2] * d2) + f[..., 3] * d3
    bgdot = d[..., 4] * f[..., 4]

    T = torch.ones((num_tiles, PPT), dtype=torch.float32, device=dev)
    prefix = torch.zeros((num_tiles, PPT), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, PPT), dtype=torch.bool, device=dev)
    dinst = torch.zeros((10, k), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    evaluated = torch.zeros((), dtype=torch.int64, device=dev)
    blended = torch.zeros((), dtype=torch.int64, device=dev)

    for j in range(max_len):
        if j % 64 == 0 and bool((done | (j >= length)[:, None]).all()):
            break
        has = j < length  # (T,)
        walk = has[:, None] & ~done
        idx = torch.clamp(start + j, max=max(k - 1, 0))
        mx, my, ca, cb, cc, op, r, g_, b, iz = (v[:, None] for v in inst_t[:10, idx])
        dx, dy, _, g, alpha, kept = pair_keep_torch(mx, my, ca, cb, cc, op, px, py)
        keep = walk & kept
        test_t = T * (1.0 - alpha)
        stop = keep & (test_t < T_EPS)
        blend = keep & ~stop

        c = ((r * d0 + g_ * d1) + b * d2) + iz * d3
        w = alpha * T
        prefix = torch.where(blend, prefix + w * c, prefix)
        suffix = s_total - prefix
        inv_one_m = 1.0 / (1.0 - alpha)
        dalpha = T * c - (suffix + bgdot) * inv_one_m
        dgm = (op * dalpha) * g
        terms = (
            dgm * ((ca + ca) * dx + cb * dy),
            dgm * ((cc + cc) * dy + cb * dx),
            -0.5 * (dgm * dx * dx),
            -(dgm * dx * dy),
            -0.5 * (dgm * dy * dy),
            g * dalpha,
            w * d0, w * d1, w * d2, w * d3,
        )
        rows = torch.stack([torch.where(blend, t, zero).sum(dim=1) for t in terms])
        dinst[:, idx[has]] = rows[:, has]
        T = torch.where(blend, test_t, T)
        if count_pairs:
            evaluated = evaluated + walk.sum()
            blended = blended + blend.sum()
        done = done | stop
    if count_pairs:
        return dinst, int(evaluated), int(blended)
    return dinst


def blend_bwd(inst_t, tile_start, tile_end, grid_x, grid_y, fwd, dout):
    """Kernel K3' on the card: same contract as `blend_bwd_packed_torch`.
    CUDA tensors only."""
    from gsplat_tpu_torch import _kernels

    inst_t, tile_start, tile_end, fwd, dout = _kernel_inputs(
        "blend_bwd", inst_t, tile_start, tile_end, grid_x, grid_y, fwd, dout)
    k = inst_t.shape[1]
    dinst = torch.empty((10, k), dtype=torch.float32, device=inst_t.device)
    if k == 0:
        return dinst
    lib = _kernels.load("rasterize_bwd")
    err = lib.gs_blend_bwd(
        inst_t.data_ptr(), k, tile_start.data_ptr(), tile_end.data_ptr(), grid_x * grid_y,
        grid_x, fwd.data_ptr(), dout.data_ptr(), dinst.data_ptr(),
        _kernels.stream(inst_t.device),
    )
    _kernels.check(err, "blend_bwd")
    blend_bwd.launches += 1
    return dinst


blend_bwd.launches = 0


class BlendFunction(torch.autograd.Function):
    """The sorted blend with its hand-written backward (`_make_blend_vjp`).

    forward(mean2d, conic, opacity, rgb, invz, inst_t, tile_start, tile_end,
    gauss_id, grid_x, grid_y, track_contrib, pack_bf16) -> (T, 256, 8). The
    forward reads only the packed (detached) instance table; the five
    per-gaussian arrays exist to receive the gradients.

    The per-frame instance buffer is sized to the frame's instance count,
    so every slot is a real instance: the JAX VJP's slot mask
    (`rasterize_pallas.py:1219-1220`), which zeroes the padding of its
    fixed-capacity buffer, has nothing to zero here.
    """

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, rgb, invz, inst_t, tile_start, tile_end,
                gauss_id, grid_x, grid_y, track_contrib, pack_bf16):
        args = (inst_t, tile_start, tile_end, grid_x, grid_y, track_contrib)
        out = blend_fwd(*args) if inst_t.is_cuda else blend_packed_torch(*args)
        ctx.save_for_backward(out, inst_t, tile_start, tile_end, gauss_id)
        ctx.grid = (grid_x, grid_y)
        ctx.pack_bf16 = pack_bf16
        ctx.n_gauss = mean2d.shape[0]
        return out

    @staticmethod
    def backward(ctx, dout):
        out, inst_t, tile_start, tile_end, gauss_id = ctx.saved_tensors
        bwd = blend_bwd if inst_t.is_cuda else blend_bwd_packed_torch
        dinst = bwd(inst_t, tile_start, tile_end, *ctx.grid, out, dout.contiguous())
        drows = reduce_by_gid(dinst, gauss_id, ctx.n_gauss, pack_bf16=ctx.pack_bf16)
        return (drows[0:2].T, drows[2:5].T, drows[5], drows[6:9].T, drows[9],
                None, None, None, None, None, None, None, None)


def blend_oit_packed_torch(inst_t, tile_start, tile_end, grid_x, grid_y, count_pairs=False):
    """Plain twin of K5': (T, 256, 8) float32 raw OIT sums
    [N0, N1, N2, N3, D, T, 0, 0] from the packed instances.

    Walks every tile's whole range (no early stop), batched over tiles and
    pixels, adding each kept pair's terms in K5''s order. With
    `count_pairs`, also returns the number of (pixel, instance) pairs
    evaluated (every pixel of a tile, every instance of its range) and the
    number kept.
    """
    dev = inst_t.device
    num_tiles = grid_x * grid_y
    pix = tile_pixel_coords(grid_x, grid_y, 16, dev)
    px, py = pix[..., 0], pix[..., 1]  # (T, 256)
    start = tile_start.long()
    length = (tile_end - tile_start).long()
    max_len = int(length.max()) if num_tiles else 0
    k = inst_t.shape[1]

    # per pixel: N0..N3, D and L = sum log1p(-alpha)
    sums = torch.zeros((num_tiles, PPT, 6), dtype=torch.float32, device=dev)
    kept = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(max_len):
        col = inst_t[:10, torch.clamp(start + j, max=max(k - 1, 0))]  # (10, T)
        mx, my, ca, cb, cc, op, r, g, b, iz = (v[:, None] for v in col)
        dx = mx - px
        dy = my - py
        power = (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
        keep = (j < length)[:, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        aw = alpha * (iz * iz)
        terms = torch.stack([aw * r, aw * g, aw * b, aw * iz, aw, torch.log1p(-alpha)], dim=-1)
        sums = torch.where(keep[..., None], sums + terms, sums)
        if count_pairs:
            kept = kept + keep.sum()

    out = torch.zeros((num_tiles, PPT, 8), dtype=torch.float32, device=dev)
    out[..., 0:5] = sums[..., 0:5]
    out[..., 5] = torch.exp(sums[..., 5])
    if count_pairs:
        return out, int(length.sum()) * PPT, int(kept)
    return out


def blend_oit_fwd(inst_t, tile_start, tile_end, grid_x, grid_y):
    """Kernel K5' on the card: same contract as `blend_oit_packed_torch`.
    CUDA tensors only."""
    from gsplat_tpu_torch import _kernels

    inst_t, tile_start, tile_end = _kernel_inputs(
        "blend_oit_fwd", inst_t, tile_start, tile_end, grid_x, grid_y)
    num_tiles = grid_x * grid_y
    out = torch.empty((num_tiles, PPT, 8), dtype=torch.float32, device=inst_t.device)
    lib = _kernels.load("rasterize_oit")
    err = lib.gs_oit_fwd(
        inst_t.data_ptr(), inst_t.shape[1], tile_start.data_ptr(), tile_end.data_ptr(),
        num_tiles, grid_x, out.data_ptr(), _kernels.stream(inst_t.device),
    )
    _kernels.check(err, "blend_oit_fwd")
    blend_oit_fwd.launches += 1
    return out


blend_oit_fwd.launches = 0


def blend_oit_bwd_packed_torch(inst_t, tile_start, tile_end, grid_x, grid_y, fwd, dout):
    """Plain twin of K6': (10, K) per-instance gradient rows of the raw OIT
    sums, from the forward output and its cotangent (both (T, 256, 8);
    channels 0-5 of the cotangent are dN0..3, dD and dT).

    Walks the 256 pixels of a tile in K6''s order, batched over every
    instance slot of every range, with K6''s arithmetic (see
    `csrc/rasterize_oit.cu`); slots outside every range get zero rows.
    """
    dev = inst_t.device
    num_tiles = grid_x * grid_y
    k = inst_t.shape[1]
    length = (tile_end - tile_start).long()
    tiles = torch.arange(num_tiles, device=dev)
    tile_of = torch.repeat_interleave(tiles, length)  # (M,) the tile of each slot
    first = torch.cumsum(length, 0) - length
    slot = tile_start.long()[tile_of] + (torch.arange(tile_of.shape[0], device=dev) - first[tile_of])
    tx = (tile_of % grid_x) * 16
    ty = torch.div(tile_of, grid_x, rounding_mode="floor") * 16

    mx, my, ca, cb, cc, op, r, gr, b, z = inst_t[:10, slot]
    z2 = z * z
    d = dout.reshape(num_tiles, PPT, 8)
    # per pixel: dN0..3, dD and rT = dT * T_final
    cot = torch.cat([d[..., 0:5], (d[..., 5] * fwd.reshape(num_tiles, PPT, 8)[..., 5])[..., None]],
                    dim=-1)
    acc = torch.zeros((11, slot.shape[0]), dtype=torch.float32, device=dev)
    for p in range(PPT):
        px = (tx + p % 16).to(torch.float32)
        py = (ty + p // 16).to(torch.float32)
        dx = mx - px
        dy = my - py
        power = (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        g = torch.exp(power)
        alpha = torch.clamp(op * g, max=ALPHA_MAX)
        keep = (power <= 0.0) & (alpha >= ALPHA_MIN)
        dn0, dn1, dn2, dn3, dd, rt = cot[tile_of, p].T
        kk = (((dn0 * r + dn1 * gr) + dn2 * b) + dn3 * z) + dd
        inv_one_m = 1.0 / (1.0 - alpha)
        dalpha = z2 * kk - rt * inv_one_m
        dgm = (op * dalpha) * g
        terms = torch.stack([
            dgm * ((ca + ca) * dx + cb * dy),
            dgm * ((cc + cc) * dy + cb * dx),
            -0.5 * (dgm * dx * dx),
            -(dgm * dx * dy),
            -0.5 * (dgm * dy * dy),
            g * dalpha,
            alpha * dn0, alpha * dn1, alpha * dn2, alpha * dn3,
            alpha * kk,
        ])
        acc = torch.where(keep, acc + terms, acc)

    dinst = torch.zeros((10, k), dtype=torch.float32, device=dev)
    dinst[0:6, slot] = acc[0:6]
    dinst[6:9, slot] = z2 * acc[6:9]
    dinst[9, slot] = (z + z) * acc[10] + z2 * acc[9]
    return dinst


def blend_oit_bwd(inst_t, tile_start, tile_end, grid_x, grid_y, fwd, dout):
    """Kernel K6' on the card: same contract as `blend_oit_bwd_packed_torch`,
    for ranges that are disjoint and cover every slot. CUDA tensors only."""
    from gsplat_tpu_torch import _kernels

    inst_t, tile_start, tile_end, fwd, dout = _kernel_inputs(
        "blend_oit_bwd", inst_t, tile_start, tile_end, grid_x, grid_y, fwd, dout)
    k = inst_t.shape[1]
    dinst = torch.empty((10, k), dtype=torch.float32, device=inst_t.device)
    if k == 0:
        return dinst
    if dout.data_ptr() % 16:  # K6' stages each pixel's cotangent as two float4
        dout = dout.clone()
    num_tiles = grid_x * grid_y
    # scratch: each pass's first block per tile, each chunk's order and
    # each slot's walk (16 bytes)
    plan = torch.empty(2 * (num_tiles + 1), dtype=torch.int32, device=inst_t.device)
    perm = torch.empty(k, dtype=torch.int32, device=inst_t.device)
    walks = torch.empty((k, 4), dtype=torch.int32, device=inst_t.device)
    lib = _kernels.load("rasterize_oit")
    err = lib.gs_oit_bwd(
        inst_t.data_ptr(), k, tile_start.data_ptr(), tile_end.data_ptr(), num_tiles,
        grid_x, plan.data_ptr(), perm.data_ptr(), walks.data_ptr(), fwd.data_ptr(),
        dout.data_ptr(), dinst.data_ptr(), _kernels.stream(inst_t.device),
    )
    _kernels.check(err, "blend_oit_bwd")
    blend_oit_bwd.launches += 1
    return dinst


blend_oit_bwd.launches = 0


class OITBlendFunction(torch.autograd.Function):
    """The OIT blend's raw sums with their hand-written backward
    (`_make_oit_vjp`, `rasterize_pallas.py:1138-1180`).

    `BlendFunction`'s arguments, so `blend_tiles_cuda` calls either one the
    same way (`track_contrib` is ignored: OIT tracks no contributor).
    Returns the raw sums (T, 256, 8) [N0..N3, D, T, 0, 0]: K5' on CUDA
    tensors, its twin on CPU tensors. The backward runs K6' (or its twin)
    and `reduce_by_gid` (K4' on the card) with `pack_bf16`.
    """

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, rgb, invz, inst_t, tile_start, tile_end,
                gauss_id, grid_x, grid_y, track_contrib, pack_bf16):
        args = (inst_t, tile_start, tile_end, grid_x, grid_y)
        out = blend_oit_fwd(*args) if inst_t.is_cuda else blend_oit_packed_torch(*args)
        ctx.save_for_backward(out, inst_t, tile_start, tile_end, gauss_id)
        ctx.grid = (grid_x, grid_y)
        ctx.pack_bf16 = pack_bf16
        ctx.n_gauss = mean2d.shape[0]
        return out

    @staticmethod
    def backward(ctx, dout):
        out, inst_t, tile_start, tile_end, gauss_id = ctx.saved_tensors
        bwd = blend_oit_bwd if inst_t.is_cuda else blend_oit_bwd_packed_torch
        dinst = bwd(inst_t, tile_start, tile_end, *ctx.grid, out, dout.contiguous())
        drows = reduce_by_gid(dinst, gauss_id, ctx.n_gauss, pack_bf16=ctx.pack_bf16)
        return (drows[0:2].T, drows[2:5].T, drows[5], drows[6:9].T, drows[9],
                None, None, None, None, None, None, None, None)


def blend_tiles_cuda(
    screen: ScreenGaussians,
    bins: PackedBins,
    grid_x: int,
    grid_y: int,
    tile: int = 16,
    track_contrib: bool = False,
    blend_mode: str = "sorted",
    reduce_pack: bool = False,
) -> BlendOutput:
    """Blend the instance stream: `blend_tiles_pallas`, sorted or OIT mode.

    Differentiable w.r.t. the screen arrays through `BlendFunction` (sorted:
    K2' forward, K3' backward) or `OITBlendFunction` (OIT: K5' forward, K6'
    backward), with the K4' per-gaussian reduce, on CUDA tensors; their
    plain twins on CPU tensors. Without gradients (inference, or screen
    arrays that need none) only the forward runs. `reduce_pack` rounds the
    per-instance gradient rows to bf16 before the sum, as the hybrid and
    bf16 packet modes do (`render.py`).

    OIT: the kernels give the raw sums N, D and T; the quotient is composed
    here, in plain torch, so autograd carries its gradient to the sums.
    `n_contrib` is zero (OIT ignores `track_contrib`).
    """
    if tile * tile != PPT:
        raise ValueError("the blend kernel is built for 16x16 tiles")
    if blend_mode not in ("sorted", "oit"):
        raise ValueError(f"blend_mode={blend_mode!r}: expected 'sorted' or 'oit'")
    oit = blend_mode == "oit"
    diff = (screen.mean2d, screen.conic, screen.opacity, screen.rgb, screen.depth)
    if torch.is_grad_enabled() and any(t.requires_grad for t in diff):
        invz = 1.0 / torch.clamp(screen.depth, min=0.2)
        fn = OITBlendFunction if oit else BlendFunction
        out = fn.apply(
            *diff[:4], invz, bins.inst_t, bins.tile_start, bins.tile_end, bins.gauss_id,
            grid_x, grid_y, track_contrib, reduce_pack,
        )
    elif oit:  # serving: the forward alone, no autograd bookkeeping
        args = (bins.inst_t, bins.tile_start, bins.tile_end, grid_x, grid_y)
        out = blend_oit_fwd(*args) if bins.inst_t.is_cuda else blend_oit_packed_torch(*args)
    else:
        args = (bins.inst_t, bins.tile_start, bins.tile_end, grid_x, grid_y, track_contrib)
        out = blend_fwd(*args) if bins.inst_t.is_cuda else blend_packed_torch(*args)
    if oit:
        final_t = out[:, :, 5]
        w = (1.0 - final_t) / torch.clamp(out[:, :, 4], min=1e-8)
        return BlendOutput(
            color=out[:, :, 0:3] * w[..., None],
            invdepth=out[:, :, 3] * w,
            final_t=final_t,
            n_contrib=torch.zeros(final_t.shape, dtype=torch.int32, device=final_t.device),
        )
    return BlendOutput(
        color=out[:, :, 0:3],
        invdepth=out[:, :, 3],
        final_t=out[:, :, 4],
        n_contrib=out[:, :, 5].to(torch.int32),
    )

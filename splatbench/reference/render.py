"""Plain PyTorch reference of the 3D Gaussian Splatting render.

Follows the published rasterizer (Kerbl et al. 2023, `diff-gaussian-
rasterization`): EWA projection with the 0.3-pixel dilation and the 1.3
tan(fov) clamp, colour from SH with the +0.5 shift and the clamp at 0, the
3-sigma tile rectangle, instances sorted by (tile, depth), and the
front-to-back blend per pixel: alpha = min(0.99, opacity exp(power)), an
instance skipped where power > 0 or alpha < 1/255, the pixel stopped at the
first instance that would take its transmittance under 1e-4 (that instance
not blended). Its gradients are the rasterizer's: the 0.99 clamp passes the
gradient straight through, as `backward.cu` ignores it.

Nothing here is written for speed beyond fitting in memory, and nothing is
taken from the program under test. Departures from a per-pixel loop:

- instances whose alpha stays under 1/255 at every pixel of their tile are
  dropped before the blend (`useful`); they change no pixel and get no
  gradient, so the result is the same;
- the transmittance is kept as a sum of log(1 - alpha) in float64, per tile
  a cumulative sum along the depth order, instead of a float32 running
  product; the stop rule reads that sum against log(1e-4);
- the blend runs over chunks of whole tiles (`ROWS_PER_CHUNK` instances
  each), and under autograd each chunk is recomputed in the backward pass
  (`torch.utils.checkpoint`) instead of keeping its pixel-by-instance
  intermediates.

Cameras are dicts of plain tensors (`world_view`, `full_proj`,
`camera_center`, `tan_fovx`, `tan_fovy`) and ints (`width`, `height`), in
the convention x_cam = world_view @ [x, 1]. Parameters are dicts of the six
leaves: xyz (N, 3), features_dc (N, 1, 3), features_rest (N, K - 1, 3),
scaling (N, 3) log-scales, rotation (N, 4) wxyz, opacity (N, 1) logits.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

TILE = 16
PPT = TILE * TILE
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
LOG_T_MIN = math.log(1e-4)
NEAR = 0.2
DILATION = 0.3
ROWS_PER_CHUNK = 1 << 17

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792,
         0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


def full_precision():
    """No TF32 in float32 products on the card: the configuration is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sh_colour(coeffs, dirs):
    """(N, 3) colour of SH coefficients (N, K, 3), K = 1, 4, 9 or 16, seen
    along the unnormalised directions (N, 3)."""
    d = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    basis = [torch.full_like(x, SH_C0)]
    k = coeffs.shape[1]
    if k > 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if k > 4:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
                  SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if k > 9:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3 * yy)]
    colour = sum(b * coeffs[:, j, :] for j, b in enumerate(basis))
    return torch.clamp(colour + 0.5, min=0.0)


def rotation_matrices(q):
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def project(params, cam):
    """Screen-space gaussians of one view: dict of mean2d (N, 2), conic (N, 3)
    as [a, b, c] with power = -(a dx^2 + c dy^2) / 2 - b dx dy, opacity (N,),
    rgb (N, 3), depth (N,), radius (N,) int64 and valid (N,) bool."""
    xyz = params["xyz"]
    ones = torch.ones_like(xyz[:, :1])
    xyz1 = torch.cat([xyz, ones], 1)
    p_view = xyz1 @ cam["world_view"].T
    p_hom = xyz1 @ cam["full_proj"].T
    depth = p_view[:, 2]
    valid = depth > NEAR
    w = torch.where(valid, p_hom[:, 3], torch.ones_like(depth))
    p_ndc = p_hom[:, :2] / (w + 1e-7)[:, None]
    size = torch.tensor([cam["width"], cam["height"]], dtype=xyz.dtype, device=xyz.device)
    mean2d = ((p_ndc + 1.0) * size - 1.0) * 0.5

    rot = rotation_matrices(params["rotation"])
    m = rot * torch.exp(params["scaling"])[:, None, :]
    cov3d = m @ m.transpose(1, 2)

    tz = torch.where(valid, depth, torch.ones_like(depth))
    tan = torch.stack([cam["tan_fovx"], cam["tan_fovy"]])
    focal = size / (2.0 * tan)
    txy = torch.clamp(p_view[:, :2] / tz[:, None], -1.3 * tan, 1.3 * tan) * tz[:, None]
    zero = torch.zeros_like(tz)
    jac = torch.stack([
        torch.stack([focal[0] / tz, zero, -focal[0] * txy[:, 0] / (tz * tz)], -1),
        torch.stack([zero, focal[1] / tz, -focal[1] * txy[:, 1] / (tz * tz)], -1),
    ], 1)
    t = jac @ cam["world_view"][:3, :3]
    cov2d = t @ cov3d @ t.transpose(1, 2)
    a = cov2d[:, 0, 0] + DILATION
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + DILATION
    det = a * c - b * b
    valid = valid & (det != 0.0)
    inv = 1.0 / torch.where(valid, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam.detach())).to(torch.int64)
    valid = valid & (radius > 0)

    coeffs = torch.cat([params["features_dc"], params["features_rest"]], 1)
    rgb = sh_colour(coeffs, xyz - cam["camera_center"])
    opacity = torch.sigmoid(params["opacity"][:, 0])
    return {"mean2d": mean2d, "conic": conic, "opacity": opacity, "rgb": rgb, "depth": depth,
            "radius": torch.where(valid, radius, torch.zeros_like(radius)), "valid": valid}


def grid(cam):
    return -(-cam["width"] // TILE), -(-cam["height"] // TILE)


def tile_origins(tiles, gx):
    """(x, y) pixel coordinates of each tile's top-left pixel."""
    return tiles % gx * TILE, tiles // gx * TILE


def instances(screen, gx, gy):
    """(gaussian id, tile) of every instance, ordered by (tile, depth): every
    tile of each valid gaussian's 3-sigma rectangle (`getRect`)."""
    with torch.no_grad():
        valid = screen["valid"]
        m = screen["mean2d"]
        r = screen["radius"].to(m.dtype)
        x0 = torch.clamp(torch.floor((m[:, 0] - r) / TILE), 0, gx).long()
        y0 = torch.clamp(torch.floor((m[:, 1] - r) / TILE), 0, gy).long()
        x1 = torch.clamp(torch.floor((m[:, 0] + r + TILE - 1) / TILE), 0, gx).long()
        y1 = torch.clamp(torch.floor((m[:, 1] + r + TILE - 1) / TILE), 0, gy).long()
        w = x1 - x0
        count = torch.where(valid, w * (y1 - y0), torch.zeros_like(w))
        gid = torch.repeat_interleave(torch.arange(len(count), device=m.device), count)
        first = torch.cumsum(count, 0) - count
        j = torch.arange(len(gid), device=m.device) - first[gid]
        tile = (y0[gid] + j // w[gid]) * gx + x0[gid] + j % w[gid]
        depth_bits = screen["depth"].detach().contiguous().view(torch.int32).long()
        order = torch.sort((tile << 32) | depth_bits[gid], stable=True).indices
        return gid[order], tile[order]


def _alpha(mean2d, conic, opacity, x0, y0, cam):
    """(256, rows) alpha of each row's gaussian at the pixels of its tile
    (top-left pixel x0, y0; the pixel centre is the integer coordinate, the
    256 pixels row-major), the keep mask (power <= 0, alpha >= 1/255; alpha
    is 0 where not kept) and the mask of pixels inside the image."""
    i = torch.arange(PPT, device=x0.device)[:, None]
    px, py = x0[None, :] + i % TILE, y0[None, :] + i // TILE
    dx = mean2d[:, 0][None, :] - px.to(torch.float32)
    dy = mean2d[:, 1][None, :] - py.to(torch.float32)
    a, b, c = conic[:, 0][None, :], conic[:, 1][None, :], conic[:, 2][None, :]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    raw = opacity[None, :] * torch.exp(power)
    alpha = raw + (torch.clamp(raw, max=ALPHA_MAX) - raw).detach()
    keep = ((power <= 0.0) & (alpha >= ALPHA_MIN)).detach()
    inside = (px < cam["width"]) & (py < cam["height"])
    return torch.where(keep, alpha, torch.zeros_like(alpha)), keep, inside


def useful(screen, gid, tile, cam):
    """Instances whose gaussian is kept at one pixel of its tile or more
    (pixels of the image: the rasterizer blends none outside it)."""
    gx, _ = grid(cam)
    out = torch.empty(len(gid), dtype=torch.bool, device=gid.device)
    with torch.no_grad():
        for s in range(0, len(gid), ROWS_PER_CHUNK):
            g = gid[s:s + ROWS_PER_CHUNK]
            _, keep, inside = _alpha(screen["mean2d"][g], screen["conic"][g],
                                     screen["opacity"][g], *tile_origins(tile[s:s + ROWS_PER_CHUNK], gx),
                                     cam)
            out[s:s + ROWS_PER_CHUNK] = (keep & inside).any(0)
    return out


def _segment_sums(values, seg_first, seg_last):
    """Per segment of consecutive columns, the sum of `values` (..., rows)
    over its columns: differences of one cumulative sum along the last
    axis (float64)."""
    cum = torch.cumsum(values, -1)
    return cum[..., seg_last] - cum[..., seg_first] + values[..., seg_first]


def _blend_chunk(mean2d, conic, opacity, rgb, invz, x0, y0, seg, seg_first, seg_last, cam):
    """The blend of one chunk of whole tiles. Rows are the chunk's instances
    in (tile, depth) order, `seg` each row's tile within the chunk,
    `seg_first` and `seg_last` each tile's first and last row. Pixel-major
    (256, rows) arrays, so every sum runs along the last axis. Returns
    colour (S, 256, 3), invdepth (S, 256), the float64 log transmittance
    (S, 256), and the counts of in-image pairs reached before the pixel
    stopped and of pairs blended."""
    alpha, keep, inside = _alpha(mean2d, conic, opacity, x0, y0, cam)
    log1m = torch.log1p(-alpha.double())
    cum = torch.cumsum(log1m, -1)
    incl = cum - (cum - log1m)[:, seg_first][:, seg]
    excl = incl - log1m
    blended = keep & (incl >= LOG_T_MIN).detach()
    w = torch.where(blended, alpha.double() * torch.exp(excl), torch.zeros_like(excl))
    rgb, invz = rgb.double().T[:, None, :], invz.double()[None, :]
    terms = torch.cat([w[None] * rgb, (w * invz)[None],
                       torch.where(blended, log1m, torch.zeros_like(log1m))[None]])
    sums = _segment_sums(terms, seg_first, seg_last).permute(2, 1, 0)
    reached = ((excl.detach() >= LOG_T_MIN) & inside).sum()
    n_blended = (blended & inside).sum()
    return sums[..., :3].float(), sums[..., 3].float(), sums[..., 4], reached, n_blended


def _chunks(tile):
    """Row ranges [start, end) of whole tiles with at most ROWS_PER_CHUNK
    rows each (a tile with more rows is a chunk of its own)."""
    starts = torch.nonzero(torch.diff(tile, prepend=tile[:1] - 1)).flatten().tolist()
    starts.append(len(tile))
    bounds, s = [], 0
    for i in range(1, len(starts)):
        if starts[i] - s > ROWS_PER_CHUNK and starts[i - 1] > s:
            bounds.append((s, starts[i - 1]))
            s = starts[i - 1]
    if len(tile):
        bounds.append((s, len(tile)))
    return bounds


def blend(screen, gid, tile, cam, recompute=False):
    """Blend the (tile, depth)-ordered instances; returns colour (T, 256, 3),
    invdepth (T, 256), log transmittance (T, 256, float64) and the counts.
    `recompute` recomputes each chunk in the backward pass."""
    gx, gy = grid(cam)
    dev = gid.device
    invz = 1.0 / torch.clamp(screen["depth"], min=NEAR)
    colour = torch.zeros((gx * gy, PPT, 3), device=dev)
    invdepth = torch.zeros((gx * gy, PPT), device=dev)
    log_t = torch.zeros((gx * gy, PPT), dtype=torch.float64, device=dev)
    reached = torch.zeros((), dtype=torch.int64, device=dev)
    n_blended = torch.zeros((), dtype=torch.int64, device=dev)
    for s, e in _chunks(tile):
        t = tile[s:e]
        first = torch.nonzero(torch.diff(t, prepend=t[:1] - 1)).flatten()
        last = torch.cat([first[1:] - 1, first.new_tensor([len(t) - 1])])
        seg = torch.cumsum(torch.diff(t, prepend=t[:1]) != 0, 0)
        tiles = t[first]
        g = gid[s:e]
        args = (screen["mean2d"][g], screen["conic"][g], screen["opacity"][g], screen["rgb"][g],
                invz[g], *tile_origins(t, gx), seg, first, last, cam)
        if recompute:
            out = checkpoint(_blend_chunk, *args, use_reentrant=False)
        else:
            out = _blend_chunk(*args)
        colour = colour.index_copy(0, tiles, out[0])
        invdepth = invdepth.index_copy(0, tiles, out[1])
        log_t = log_t.index_copy(0, tiles, out[2])
        reached = reached + out[3]
        n_blended = n_blended + out[4]
    return colour, invdepth, log_t, {"pairs": reached, "blended": n_blended}


def tiles_to_image(tiled, cam):
    gx, gy = grid(cam)
    chans = tuple(tiled.shape[2:])
    img = tiled.reshape((gy, gx, TILE, TILE) + chans).movedim(2, 1)
    return img.reshape((gy * TILE, gx * TILE) + chans)[:cam["height"], :cam["width"]]


def expose(image, exposure):
    """The exposure affine (3, 4) of `gaussian_renderer/__init__.py`:
    out_d = sum_c image_c E[c, d] + E[d, 3]."""
    return image @ exposure[:, :3] + exposure[:, 3]


def render(params, cam, bg, recompute=False, count=False, exposure=None):
    """One view: {"render": (H, W, 3) in [0, 1], "invdepth": (H, W),
    "final_t": (H, W)} and, with `count`, the work the view needs: visible
    rows, useful instances, rows with a useful instance, pairs reached
    before the pixel stopped, pairs blended, pixels and tiles. An
    `exposure` (3, 4) is applied before the clamp."""
    screen = project(params, cam)
    gx, gy = grid(cam)
    gid, tile = instances(screen, gx, gy)
    keep = useful(screen, gid, tile, cam)
    gid, tile = gid[keep], tile[keep]
    colour, invdepth, log_t, pairs = blend(screen, gid, tile, cam, recompute)
    final_t = torch.exp(log_t).float()
    image = colour + final_t[..., None] * bg
    if exposure is not None:
        image = expose(image, exposure)
    out = {"render": tiles_to_image(torch.clamp(image, 0.0, 1.0), cam),
           "invdepth": tiles_to_image(invdepth, cam), "final_t": tiles_to_image(final_t, cam)}
    if count:
        out["counts"] = {
            "visible": int(screen["valid"].sum()), "instances": int(len(gid)),
            "live": int(torch.unique(gid).numel()), "pairs": int(pairs["pairs"]),
            "blended": int(pairs["blended"]), "pixels": cam["width"] * cam["height"],
            "tiles": gx * gy, "rows": int(params["xyz"].shape[0]),
        }
    return out

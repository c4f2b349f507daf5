"""Reference front-to-back alpha blend in plain PyTorch.

Counterpart of `gsplat_tpu/ops/rasterize_jnp.py`: per tile, a (256 px,
chunk) alpha matrix whose transmittance recurrence is a cumprod along the
gaussian axis. Differentiable by autograd; the CUDA kernel of
`rasterize_cuda.py` is the production path.

Blend semantics (`forward.cu:345-385`):
- skip if power > 0
- alpha = min(0.99, opacity * exp(power)); skip if alpha < 1/255
- stop the pixel once T * (1 - alpha) < 1e-4 (that gaussian is NOT blended);
  T is monotone, so this is the prefix condition cumprod(1 - alpha) >= 1e-4
- expected inverse depth sum(w / z)

`blend_tiles_oit_torch` is the same oracle for the OIT blend mode
(`blend_tiles_oit_jnp`): order-independent sums with the same alpha and keep
rules.
"""

from __future__ import annotations

import dataclasses

import torch

from gsplat_tpu_torch.ops.binning import TileBins
from gsplat_tpu_torch.ops.projection import ScreenGaussians

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


@dataclasses.dataclass(frozen=True)
class BlendOutput:
    color: torch.Tensor  # (T, 256, 3) per-tile accumulated pixel colors
    invdepth: torch.Tensor  # (T, 256)
    final_t: torch.Tensor  # (T, 256) remaining transmittance
    n_contrib: torch.Tensor  # (T, 256) int32, last contributing instance (1-based)
    overflow: int = 0  # per-tile list truncations (blend_tiles_torch only)


def tile_pixel_coords(grid_x: int, grid_y: int, tile: int, device=None):
    """Pixel-center coordinates for each tile, (T, tile*tile, 2) float32."""
    t_idx = torch.arange(grid_x * grid_y, dtype=torch.int32, device=device)
    tx = (t_idx % grid_x) * tile
    ty = torch.div(t_idx, grid_x, rounding_mode="floor") * tile
    i = torch.arange(tile * tile, dtype=torch.int32, device=device)
    px = tx[:, None] + (i % tile)[None, :]
    py = ty[:, None] + torch.div(i, tile, rounding_mode="floor")[None, :]
    return torch.stack([px, py], dim=-1).to(torch.float32)


def blend_tiles_torch(
    screen: ScreenGaussians,
    bins: TileBins,
    grid_x: int,
    grid_y: int,
    tile: int,
    max_per_tile: int,
    chunk: int,
) -> BlendOutput:
    """Blend all tiles, batched over tiles, looped over gaussian chunks.

    Port of `blend_tiles_jnp` (`rasterize_jnp.py:56-172`); walks at most
    `max_per_tile` instances per tile and reports the rest as `overflow`.
    """
    dev = screen.depth.device
    num_tiles = grid_x * grid_y
    ppt = tile * tile
    max_per_tile = max(chunk, (max_per_tile + chunk - 1) // chunk * chunk)

    pix = tile_pixel_coords(grid_x, grid_y, tile, dev)  # (T, ppt, 2)

    lane = torch.arange(max_per_tile, dtype=torch.int32, device=dev)
    idx = bins.tile_start[:, None] + lane[None, :]  # (T, M)
    in_range = idx < bins.tile_end[:, None]
    idx = torch.clamp(idx, max=max(bins.gauss_id.shape[0] - 1, 0)).long()
    overflow = int(torch.clamp(bins.tile_end - bins.tile_start - max_per_tile, min=0).sum())

    inv_depth = 1.0 / torch.clamp(screen.depth, min=0.2)
    # an empty instance list gathers from a one-row dummy, fully masked
    gid_all = bins.gauss_id.long() if bins.gauss_id.numel() else torch.zeros(1, dtype=torch.long, device=dev)

    t_raw = torch.ones((num_tiles, ppt), dtype=torch.float32, device=dev)
    t_eff = torch.ones((num_tiles, ppt), dtype=torch.float32, device=dev)
    color = torch.zeros((num_tiles, ppt, 3), dtype=torch.float32, device=dev)
    invd = torch.zeros((num_tiles, ppt), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((num_tiles, ppt), dtype=torch.int32, device=dev)

    for base in range(0, max_per_tile, chunk):
        ids = idx[:, base : base + chunk]
        m = in_range[:, base : base + chunk]
        g = gid_all[ids]  # (T, C)
        mean2d = screen.mean2d[g]
        conic = screen.conic[g]
        opac = screen.opacity[g]
        rgb = screen.rgb[g]
        invz = inv_depth[g]

        d = mean2d[:, None, :, :] - pix[:, :, None, :]  # (T, ppt, C, 2)
        dx, dy = d[..., 0], d[..., 1]
        a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
        power = (
            -0.5 * (a[:, None, :] * dx * dx + c[:, None, :] * dy * dy)
            - b[:, None, :] * dx * dy
        )
        alpha_raw = opac[:, None, :] * torch.exp(power)
        # forward min(alpha, 0.99); backward straight-through, as the
        # reference backward ignores the clamp (`backward.cu:569-570`)
        alpha = alpha_raw + (torch.clamp(alpha_raw, max=ALPHA_MAX) - alpha_raw).detach()
        keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & m[:, None, :]
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))

        cp = torch.cumprod(1.0 - alpha, dim=-1)
        t_incl_raw = t_raw[..., None] * cp
        blended = (t_incl_raw >= T_EPS).detach()
        alpha_eff = torch.where(blended, alpha, torch.zeros_like(alpha))
        cp_excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
        w = alpha_eff * (t_raw[..., None] * cp_excl)  # (T, ppt, C)

        color = color + torch.einsum("tpc,tcx->tpx", w, rgb)
        invd = invd + torch.sum(w * invz[:, None, :], dim=-1)
        t_raw = t_incl_raw[..., -1]
        t_eff = t_eff * torch.prod(1.0 - alpha_eff, dim=-1)

        contrib = blended & (alpha > 0.0)
        lane_i = torch.arange(1, alpha.shape[-1] + 1, dtype=torch.int32, device=dev)
        last_in_chunk = torch.amax(torch.where(contrib, lane_i, torch.zeros_like(lane_i)), dim=-1)
        n_contrib = torch.where(contrib.any(dim=-1), base + last_in_chunk, n_contrib)

    return BlendOutput(
        color=color, invdepth=invd, final_t=t_eff, n_contrib=n_contrib, overflow=overflow
    )


def blend_tiles_oit_torch(
    screen: ScreenGaussians,
    bins: TileBins,
    grid_x: int,
    grid_y: int,
    tile: int,
    max_per_tile: int,
    chunk: int,
) -> BlendOutput:
    """Order-independent transmittance blend, the oracle of the OIT mode.

    Port of `blend_tiles_oit_jnp` (`rasterize_jnp.py:175-266`). Per pixel,
    commutative sums replace the front-to-back recurrence:

        N = sum alpha * invz^2 * [r, g, b, invz],  D = sum alpha * invz^2,
        T = prod (1 - alpha) = exp(sum log1p(-alpha)),
        out = N / max(D, 1e-8) * (1 - T),  final_t = T.

    The alpha and keep rules are the sorted blend's; the sums read no order.
    Differentiable by autograd; `blend_tiles_cuda(blend_mode="oit")` is the
    production path.
    """
    dev = screen.depth.device
    num_tiles = grid_x * grid_y
    ppt = tile * tile
    max_per_tile = max(chunk, (max_per_tile + chunk - 1) // chunk * chunk)
    pix = tile_pixel_coords(grid_x, grid_y, tile, dev)

    lane = torch.arange(max_per_tile, dtype=torch.int32, device=dev)
    idx = bins.tile_start[:, None] + lane[None, :]
    in_range = idx < bins.tile_end[:, None]
    idx = torch.clamp(idx, max=max(bins.gauss_id.shape[0] - 1, 0)).long()
    overflow = int(torch.clamp(bins.tile_end - bins.tile_start - max_per_tile, min=0).sum())
    inv_depth = 1.0 / torch.clamp(screen.depth, min=0.2)
    gid_all = bins.gauss_id.long() if bins.gauss_id.numel() else torch.zeros(1, dtype=torch.long, device=dev)

    numer = torch.zeros((num_tiles, ppt, 4), dtype=torch.float32, device=dev)
    denom = torch.zeros((num_tiles, ppt), dtype=torch.float32, device=dev)
    logt = torch.zeros((num_tiles, ppt), dtype=torch.float32, device=dev)

    for base in range(0, max_per_tile, chunk):
        g = gid_all[idx[:, base : base + chunk]]
        m = in_range[:, base : base + chunk]
        mean2d = screen.mean2d[g]
        conic = screen.conic[g]
        invz = inv_depth[g]

        d = mean2d[:, None, :, :] - pix[:, :, None, :]
        dx, dy = d[..., 0], d[..., 1]
        a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
        power = (
            -0.5 * (a[:, None, :] * dx * dx + c[:, None, :] * dy * dy)
            - b[:, None, :] * dx * dy
        )
        alpha_raw = screen.opacity[g][:, None, :] * torch.exp(power)
        # the clamp at 0.99 is straight-through, as in the sorted oracle
        alpha = alpha_raw + (torch.clamp(alpha_raw, max=ALPHA_MAX) - alpha_raw).detach()
        keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & m[:, None, :]
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))

        aw = alpha * (invz * invz)[:, None, :]  # (T, ppt, C)
        feat = torch.cat([screen.rgb[g], invz[..., None]], dim=-1)  # (T, C, 4)
        numer = numer + torch.einsum("tpc,tcx->tpx", aw, feat)
        denom = denom + torch.sum(aw, dim=-1)
        logt = logt + torch.sum(torch.log1p(-alpha), dim=-1)

    t_final = torch.exp(logt)
    w = (1.0 - t_final) / torch.clamp(denom, min=1e-8)
    return BlendOutput(
        color=numer[..., 0:3] * w[..., None],
        invdepth=numer[..., 3] * w,
        final_t=t_final,
        n_contrib=torch.zeros((num_tiles, ppt), dtype=torch.int32, device=dev),
        overflow=overflow,
    )


def tiles_to_image(tiled, grid_x: int, grid_y: int, tile: int, width: int, height: int):
    """(T, tile*tile, C?) -> (H, W, C?) crop."""
    chans = tuple(tiled.shape[2:])
    img = tiled.reshape((grid_y, grid_x, tile, tile) + chans)
    img = torch.movedim(img, 2, 1).reshape((grid_y * tile, grid_x * tile) + chans)
    return img[:height, :width]

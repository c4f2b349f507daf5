"""The multi-device render and train step: gaussian shards, tile bands.

Counterpart of `gsplat_tpu/parallel/pipeline.py`, written out over
`torch.distributed` with one process per rank (`parallel/comm.py`):

  each rank's gaussian rows --preprocess--> screen packets
      --gather over the gaussian axes (band-compacted or whole)-->
  the rank's band of tile rows --K1' expand + pack, K2'--> band image
      --gather over "tile"--> the whole image on every rank --> loss

and in reverse K3' and K4' per band, then the transposes of the two
gathers (`comm.gather_rows`, `comm.gather_bands`): each rank keeps the
gradient rows it sent, sums them over its tile group with one all_reduce,
and runs the preprocess backward once on its own rows. Every band runs the
port's single-device kernels unchanged, on a grid of `gx x gy_band` tiles
with the pixel centres shifted up by the band's first pixel row.

Deliberate differences from the JAX pipeline:

- a tile grid whose row count does not divide by the tile axis is padded
  with empty tile rows (rects are clipped to the true grid, so they stay
  background and are cropped); the JAX loop falls back on its GSPMD step;
- the exchange is sized per step, as the instance buffer is: the ranks
  gather their band row counts (one host sync), then rows padded to the
  largest count, then drop the padding. `exchange_capacity` keeps only its
  switch (None or 0: the full gather; anything else: the band exchange);
  `band_overflow` is always 0 and `band_count`/`band_counts` are exact;
- the loss is computed on the whole image, gathered over "tile", on every
  rank;
- the sorted blend only: `blend_mode="oit"` is refused, where the JAX
  pipeline blends sorted whatever the setting (`pipeline.py:175-178`).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from gsplat_tpu_torch.convert import PARAM_FIELDS
from gsplat_tpu_torch.core.types import Camera, RenderSettings
from gsplat_tpu_torch.ops.binning import pack_bins
from gsplat_tpu_torch.ops.composite import exposure_clamp_torch
from gsplat_tpu_torch.ops.projection import ScreenGaussians, preprocess
from gsplat_tpu_torch.ops.rasterize_cuda import blend_tiles_cuda
from gsplat_tpu_torch.ops.rasterize_torch import tiles_to_image
from gsplat_tpu_torch.parallel import comm

# the differentiable ScreenGaussians columns the gather carries (name,
# width); `_columns` packs the structure beside them as int32: radius, rect
# min and max, tiles touched, mask and the bits of cull_qmax
_DIFF = (("mean2d", 2), ("conic", 3), ("opacity", 1), ("rgb", 3), ("depth", 1))


def gauss_axes_of(mesh: comm.Mesh, gauss_axes=None) -> tuple:
    """The axes the gaussian rows are sharded over: every axis but "tile"."""
    return tuple(gauss_axes) if gauss_axes else tuple(a for a in mesh.axes if a != "tile")


def band_rows(grid_y: int, n_tile: int) -> int:
    """Tile rows per band: the grid padded up to a multiple of the tile axis."""
    return -(-grid_y // n_tile)


def restrict_to_tile_rows(screen: ScreenGaussians, row0: int, n_rows: int, grid_x: int):
    """Clip per-gaussian tile rects to a band of tile rows and rebase tile-y
    to the band; gaussians outside the band get 0 tiles
    (`pipeline.py:36-50`)."""
    rmin, rmax = screen.rect_min, screen.rect_max
    rmin_y = torch.clamp(rmin[:, 1], row0, row0 + n_rows) - row0
    rmax_y = torch.clamp(rmax[:, 1], row0, row0 + n_rows) - row0
    tiles = (rmax[:, 0] - rmin[:, 0]) * (rmax_y - rmin_y)
    tiles = torch.where(screen.mask, tiles, torch.zeros_like(tiles))
    return dataclasses.replace(
        screen,
        rect_min=torch.stack([rmin[:, 0], rmin_y], dim=-1),
        rect_max=torch.stack([rmax[:, 0], rmax_y], dim=-1),
        tiles_touched=tiles.to(torch.int32),
        mask=screen.mask & (tiles > 0),
    )


def _columns(screen: ScreenGaussians):
    n = screen.depth.shape[0]
    diff = torch.cat([getattr(screen, k).reshape(n, w) for k, w in _DIFF], dim=1)
    struct = torch.cat([
        screen.radius.reshape(n, 1), screen.rect_min, screen.rect_max,
        screen.tiles_touched.reshape(n, 1), screen.mask.to(torch.int32).reshape(n, 1),
        screen.cull_qmax.detach().contiguous().view(torch.int32).reshape(n, 1),
    ], dim=1).to(torch.int32)
    return diff, struct


def _screen_of(diff, struct) -> ScreenGaussians:
    cols, i = {}, 0
    for k, w in _DIFF:
        cols[k] = diff[:, i:i + w] if w > 1 else diff[:, i]
        i += w
    return ScreenGaussians(
        **cols,
        radius=struct[:, 0],
        rect_min=struct[:, 1:3],
        rect_max=struct[:, 3:5],
        tiles_touched=struct[:, 5],
        mask=struct[:, 6].bool(),
        cull_qmax=struct[:, 7].contiguous().view(torch.float32),
    )


def exchange_screen(screen: ScreenGaussians, mesh: comm.Mesh, gauss_axes, band=None):
    """The screen packets of every gaussian shard of this rank's tile column.

    `band` (row0, n_rows) compacts this rank's packets to the rows whose
    rect meets its band before the gather (the band exchange); None gathers
    every row. Returns (gathered ScreenGaussians, rows per shard, visible
    gaussians in all shards). Gathered rows keep the global row order, so
    the instance order (tile, depth, row) is the single-device one.
    """
    sel = None
    count = screen.depth.shape[0]
    if band is not None:
        row0, n_rows = band
        inter = (screen.mask & (screen.rect_min[:, 1] < row0 + n_rows)
                 & (screen.rect_max[:, 1] > row0))
        sel = torch.nonzero(inter)[:, 0]
        count = sel.shape[0]
    info = comm.gather_counts([count, int(screen.mask.sum())], mesh, gauss_axes, "band_counts")
    sizes = info[:, 0]
    diff, struct = _columns(screen)
    diff_g = comm.gather_rows(diff, sizes, mesh, gauss_axes, sel=sel)
    struct_g = comm.gather_ragged(struct if sel is None else struct[sel], sizes, mesh,
                                  gauss_axes, "gather_struct")
    return _screen_of(diff_g, struct_g), sizes, int(info[:, 1].sum())


def make_sharded_render(mesh: comm.Mesh, settings: RenderSettings, width: int, height: int,
                        gauss_axes=None, exchange_capacity=None):
    """Build the differentiable multi-device render (`pipeline.py:53`).

    Returns fn(camera, params, alive, bg, mean2d_offset=None, exposure=None)
    -> dict with "render" (H, W, 3), "invdepth" and "final_t" (H, W): the
    whole image, the same on every rank; "radii" and "visibility" of this
    rank's rows; "num_instances" over all bands; "band_count" (the most
    rows one shard sent to one band), "band_counts" and "band_instances"
    per band; "n_visible" over all shards; "instance_overflow",
    "tile_overflow" and "band_overflow" 0. `params`, `alive` and
    `mean2d_offset` hold this rank's rows (`sharding.shard_params`).
    """
    if settings.blend_mode != "sorted":
        raise ValueError(f"blend_mode={settings.blend_mode!r}: the multi-device path blends "
                         "sorted, as the JAX pipeline does; OIT is refused under a mesh")
    gaxes = gauss_axes_of(mesh, gauss_axes)
    tile = settings.tile
    gx = (width + tile - 1) // tile
    gy = (height + tile - 1) // tile
    n_tile = mesh.sizes["tile"]
    gy_band = band_rows(gy, n_tile)
    row0 = mesh.coords["tile"] * gy_band
    band = (row0, gy_band) if exchange_capacity else None
    dev = mesh.device
    shift = torch.tensor([0.0, float(row0 * tile)], dtype=torch.float32, device=dev)

    def render_fn(camera: Camera, params, alive, bg, mean2d_offset=None, exposure=None):
        if (camera.width, camera.height) != (width, height):
            raise ValueError(f"camera {camera.width}x{camera.height}, render built for "
                             f"{width}x{height}")
        camera = camera.to(dev)
        if params.xyz.device != dev:
            params = SimpleNamespace(**{k: getattr(params, k).to(dev) for k in PARAM_FIELDS})
        alive = torch.as_tensor(alive, device=dev)
        screen = preprocess(params, alive, camera, settings, gx, gy,
                            None if mean2d_offset is None else mean2d_offset.to(dev))
        gathered, sizes, n_visible = exchange_screen(screen, mesh, gaxes, band)
        local = restrict_to_tile_rows(gathered, row0, gy_band, gx)
        local = dataclasses.replace(local, mean2d=local.mean2d - shift)
        bins = pack_bins(local, gx, gy_band, tile, settings.tight_cull,
                         packet_dtype=settings.packet_dtype)
        out = blend_tiles_cuda(local, bins, gx, gy_band, tile,
                               track_contrib=settings.track_contrib,
                               reduce_pack=settings.packet_dtype in ("hybrid", "bfloat16"))
        bgc = torch.as_tensor(bg, dtype=torch.float32, device=dev)
        color = out.color + out.final_t[..., None] * bgc[None, None, :]
        tiled = torch.cat([color, out.invdepth[..., None], out.final_t[..., None]], dim=-1)
        band_img = tiles_to_image(tiled, gx, gy_band, tile, width, gy_band * tile)
        img = comm.gather_bands(band_img.contiguous(), mesh)[:height]
        per_band = comm.gather_counts([bins.num_instances, int(sizes.max())], mesh, "tile",
                                      "band_instances")
        if exposure is not None:
            exposure = torch.as_tensor(exposure, dtype=torch.float32, device=dev)
        return {
            # the composite kernels' exposure order, so a mesh rounds as one card
            "render": exposure_clamp_torch(img[..., 0:3], exposure),
            "invdepth": img[..., 3],
            "final_t": img[..., 4],
            "radii": screen.radius,
            "visibility": screen.radius > 0,
            "instance_overflow": 0,
            "tile_overflow": 0,
            "num_instances": int(per_band[:, 0].sum()),
            "band_overflow": 0,
            "band_count": int(per_band[:, 1].max()),
            "band_counts": per_band[:, 1].tolist(),
            "band_instances": per_band[:, 0].tolist(),
            "n_visible": n_visible,
        }

    return render_fn


def make_pipeline_train_step(mesh: comm.Mesh, opt, settings: RenderSettings, width: int,
                             height: int, use_exposure: bool = False, gauss_axes=None,
                             exchange_capacity=None):
    """The multi-device train step (`pipeline.py:252`): `make_train_step`
    with the render replaced by `make_sharded_render`. The state holds this
    rank's rows (`sharding.place_train_state`); the step's parameter update
    touches only them, and the exposure, replicated, moves the same on
    every rank."""
    from gsplat_tpu_torch.train.step import make_train_step

    render_fn = make_sharded_render(mesh, settings, width, height, gauss_axes=gauss_axes,
                                    exchange_capacity=exchange_capacity)
    return make_train_step(opt, settings, use_exposure=use_exposure, render_fn=render_fn)

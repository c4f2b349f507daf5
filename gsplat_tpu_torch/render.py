"""High-level renderer: counterpart of `gsplat_tpu/render.py`.

One view goes through `preprocess` (plain PyTorch), `pack_bins` (kernel K1'
plus one `torch.sort`), `blend_tiles_cuda` (sorted blend: kernel K2'
forward, K3' and K4' in its backward; OIT blend: K5' forward, K6' and K4'
in its backward, the quotient in plain PyTorch), then the background
composite, `tiles_to_image`, exposure and clip in plain PyTorch. Images are
HWC, as in the JAX package. On a CPU device the kernels' plain twins run.

Every `blend_mode` ("sorted", "oit") and `packet_dtype` ("float32",
"hybrid", "bfloat16") of the JAX package renders. With hybrid and bf16
packets the backward rounds each per-instance gradient row to bf16 before
the per-gaussian sum, as the JAX VJP does (`rasterize_pallas.py:1166,1232`:
`reduce_pack` or a bf16 table). The port's table is float32 in every mode,
so the bf16 mode has to ask for that rounding by name.

The render is differentiable: gradients reach every parameter, the
optional `mean2d_offset` (the densification signal) and the exposure, as
`jax.grad` of the JAX package's render does. Binning is structure: it sees
detached screen arrays.

`instance_overflow` and `tile_overflow` are always 0: the instance buffer is
sized per frame and the blend walks every instance of a tile.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Optional

import torch

from gsplat_tpu_torch.convert import PARAM_FIELDS
from gsplat_tpu_torch.core.types import Camera, GaussianParams, RenderSettings
from gsplat_tpu_torch.device import resolve_device
from gsplat_tpu_torch.ops.binning import pack_bins
from gsplat_tpu_torch.ops.projection import preprocess
from gsplat_tpu_torch.ops.rasterize_cuda import blend_tiles_cuda
from gsplat_tpu_torch.ops.rasterize_torch import tiles_to_image


def grid_dims(camera: Camera, tile: int):
    return (camera.width + tile - 1) // tile, (camera.height + tile - 1) // tile


def mark_visible(positions, camera: Camera):
    """Frustum-visibility mask of world positions: view-space z > 0.2
    (`markVisible`, `rasterize_points.cu:225-244`)."""
    wv = camera.world_view.to(positions.device)
    p_view = positions @ wv[:3, :3].T + wv[:3, 3]
    return p_view[:, 2] > 0.2


def render(
    camera: Camera,
    params: GaussianParams,
    alive,
    settings: RenderSettings,
    bg,
    mean2d_offset=None,
    exposure: Optional[Any] = None,
    device=None,
) -> dict:
    """Render one view.

    Args:
      camera: the view.
      params: Gaussian parameters (pre-activation).
      alive: (N,) bool live-row mask.
      settings: render settings (every blend mode and packet mode).
      bg: (3,) background color.
      mean2d_offset: optional (N, 2) zeros added to the pixel centers; its
        gradient is the viewspace densification signal (pixel units).
      exposure: optional (3, 4) affine applied to the rendered image.
      device: where to render; `None` means `cuda` (raises without a card).

    Returns:
      dict with "render" (H, W, 3) in [0, 1], "invdepth" (H, W),
      "final_t" (H, W), "radii" (N,), "visibility" (N,) bool,
      "instance_overflow", "tile_overflow" (both 0) and "num_instances".
    """
    dev = resolve_device(device)
    camera = camera.to(dev)
    if params.xyz.device != dev:
        # a view on `dev` whose gradients flow back to the caller's leaves;
        # the module itself is not moved
        params = SimpleNamespace(**{k: getattr(params, k).to(dev) for k in PARAM_FIELDS})
    alive = torch.as_tensor(alive, device=dev)
    gx, gy = grid_dims(camera, settings.tile)

    screen = preprocess(
        params, alive, camera, settings, gx, gy,
        None if mean2d_offset is None else mean2d_offset.to(dev),
    )
    bins = pack_bins(screen, gx, gy, settings.tile, settings.tight_cull,
                     packet_dtype=settings.packet_dtype)
    out = blend_tiles_cuda(
        screen, bins, gx, gy, settings.tile,
        track_contrib=settings.track_contrib, blend_mode=settings.blend_mode,
        reduce_pack=settings.packet_dtype in ("hybrid", "bfloat16"),
    )

    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    color = out.color + out.final_t[..., None] * bg[None, None, :]
    image = tiles_to_image(color, gx, gy, settings.tile, camera.width, camera.height)
    invdepth = tiles_to_image(out.invdepth, gx, gy, settings.tile, camera.width, camera.height)
    final_t = tiles_to_image(out.final_t, gx, gy, settings.tile, camera.width, camera.height)

    if exposure is not None:
        exposure = torch.as_tensor(exposure, dtype=torch.float32, device=dev)
        image = torch.einsum("hwc,cd->hwd", image, exposure[:3, :3]) + exposure[:3, 3]

    image = torch.clamp(image, 0.0, 1.0)

    return {
        "render": image,
        "invdepth": invdepth,
        "final_t": final_t,
        "radii": screen.radius,
        "visibility": screen.radius > 0,
        "instance_overflow": bins.overflow,
        "tile_overflow": out.overflow,
        "num_instances": bins.num_instances,
    }

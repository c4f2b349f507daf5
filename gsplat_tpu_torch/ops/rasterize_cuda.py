"""The sorted forward blend on the card: kernel K2' and its plain twin.

Counterpart of `gsplat_tpu/ops/rasterize_pallas.py` (the forward of
`blend_tiles_pallas`, sorted mode). `blend_tiles_cuda` launches K2'
(`csrc/rasterize_fwd.cu`, replacing the Pallas `_fwd_kernel`,
`rasterize_pallas.py:368`) on a CUDA tensor; on a CPU tensor it runs the
plain twin `blend_packed_torch`. Both take a `PackedBins` and return the
kernel's (T, 256, 8) float32 output [r, g, b, invdepth, final_T, n_contrib,
0, 0].

The twin walks every tile's range one instance at a time, batched over
tiles and pixels, with the kernel's arithmetic in the kernel's order, so
the two agree to the rounding of `exp`.

No autograd yet: the backward slice wraps this in a
`torch.autograd.Function` over kernels K3' and K4'.
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.ops.binning import PackedBins
from gsplat_tpu_torch.ops.rasterize_torch import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    BlendOutput,
    tile_pixel_coords,
)

PPT = 256  # pixels per 16x16 tile


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
    the kernel evaluates: each pixel walks its range until it stops, the
    stopping instance included.
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
    k = inst_t.shape[1]

    for j in range(max_len):
        if j % 64 == 0 and bool((done | (j >= length)[:, None]).all()):
            break
        walk = (j < length)[:, None] & ~done  # (T, 256)
        col = inst_t[:10, torch.clamp(start + j, max=max(k - 1, 0))]  # (10, T)
        mx, my, ca, cb, cc, op, r, g, b, iz = (v[:, None] for v in col)
        dx = mx - px
        dy = my - py
        power = (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
        keep = walk & (power <= 0.0) & (alpha >= ALPHA_MIN)
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
        done = done | stop

    out = torch.zeros((num_tiles, PPT, 8), dtype=torch.float32, device=dev)
    out[..., 0:3] = color
    out[..., 3] = inv
    out[..., 4] = T
    if track_contrib:
        out[..., 5] = last.to(torch.float32)
    if count_pairs:
        return out, int(pairs)
    return out


def blend_fwd(inst_t, tile_start, tile_end, grid_x, grid_y, track_contrib=False):
    """Kernel K2' on the card: same contract as `blend_packed_torch`.
    CUDA tensors only."""
    from gsplat_tpu_torch import _kernels

    if not inst_t.is_cuda:
        raise ValueError("blend_fwd launches a CUDA kernel: tensors must be on a CUDA device")
    if inst_t.dtype != torch.float32 or inst_t.dim() != 2 or inst_t.shape[0] < 10:
        raise ValueError(f"inst_t must be (16, K) float32, got {tuple(inst_t.shape)} {inst_t.dtype}")
    num_tiles = grid_x * grid_y
    if tile_start.shape != (num_tiles,) or tile_end.shape != (num_tiles,):
        raise ValueError("tile_start/tile_end must be (grid_x * grid_y,)")
    inst_t = inst_t.contiguous()
    tile_start = tile_start.to(torch.int32).contiguous()
    tile_end = tile_end.to(torch.int32).contiguous()
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


def blend_tiles_cuda(
    bins: PackedBins,
    grid_x: int,
    grid_y: int,
    tile: int = 16,
    track_contrib: bool = False,
    blend_mode: str = "sorted",
) -> BlendOutput:
    """Blend the sorted instance stream: the forward of `blend_tiles_pallas`.

    On a CUDA tensor through kernel K2' (`blend_fwd`); on a CPU tensor
    through `blend_packed_torch`.
    """
    if tile * tile != PPT:
        raise ValueError("the blend kernel is built for 16x16 tiles")
    if blend_mode != "sorted":
        raise NotImplementedError(
            f"blend_mode={blend_mode!r}: the OIT kernels (K5, K6) are not ported yet"
        )
    args = (bins.inst_t, bins.tile_start, bins.tile_end, grid_x, grid_y, track_contrib)
    out = blend_fwd(*args) if bins.inst_t.is_cuda else blend_packed_torch(*args)
    return BlendOutput(
        color=out[:, :, 0:3],
        invdepth=out[:, :, 3],
        final_t=out[:, :, 4],
        n_contrib=out[:, :, 5].to(torch.int32),
    )

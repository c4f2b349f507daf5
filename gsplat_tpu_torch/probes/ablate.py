"""Skeleton probes P1' and P2': the sorted blend with its math dead.

Counterpart of `scripts/probe_ablate2.py` (`csrc/probe_skeleton.cu`,
replacing the Pallas `_skel_fwd_kernel`, :32, and `_skel_bwd_kernel`, :52).
P2' `skel_bwd` is K3' (`blend_bwd`) with the pair loop compiled out: the
grid, the staging of each tile's range and the writes are left. P1'
`skel_fwd` moves K2''s (`blend_fwd`) bytes, the ten table rows of every
instance of every tile's range into shared memory and the tile's output
out, as Hopper streams them best (bulk copies through a ring of mbarrier
stages, in persistent blocks): the floor that K2''s staging can aim at.
K2''s own staging, K2' with its pair loop compiled out, is a variant in
`scripts/skeleton_ablate.py`. Timed on the frame the full kernels blend,
each skeleton splits its kernel's time into streaming and math.

With h_c = inst_t[0, 128 c], base = s // 128 for a tile's range [s, e), and
acc(g) = sum_{c = base}^{g - 1} h_c * 1e-30 (float32, increasing c, each term
added by one fused multiply-add, as XLA compiles the probes' `acc + h *
1e-30` on the CPU):

- `skel_fwd` -> (T, 256, 8): acc(ceil(e / 128)) broadcast over the tile,
  0 for an empty tile; P1 bit for bit.
- `skel_bwd` -> (10, K): acc(j // 128) in every row of each slot j of a
  range. P2 differs on the columns of a tile's first chunk when s % 128 != 0:
  it carries the earlier tile's accumulator into that chunk from one grid
  step to the next, and P2' writes 0 there (see `csrc/probe_skeleton.cu`).

On CUDA tensors the kernels run; on CPU tensors the twins `skel_fwd_torch`
and `skel_bwd_torch`, which sum in the kernels' order, vectorised over tiles.

    python -m gsplat_tpu_torch.probes.ablate [--device cpu]

builds the seeded 262,144-gaussian SH-3 scene at 1920x1080, projects and
bins it, warms up with one forward-plus-backward render, then prints the
full K2', P1', the full K3' and P2' in ms (`scripts/probe_ablate2.py:140-185`).
"""

from __future__ import annotations

import argparse

import torch

from gsplat_tpu_torch.ops.rasterize_cuda import PPT, _kernel_inputs

CHUNK = 128  # instances per packet of the TPU kernels
HEAD_SCALE = 1e-30
N_GRAD = 10


# the float32 1e-30 that the kernels and the JAX probes multiply by
_SCALE64 = float(torch.tensor(HEAD_SCALE, dtype=torch.float32).double())


def _fma(h, acc):
    """float32 fma(h, 1e-30, acc): the product is exact in float64, and the
    float64 sum rounds to float32 as one rounding would (a double rounding
    needs a float64 tie, which these sums do not reach)."""
    return (h.double() * _SCALE64 + acc.double()).float()


def _chunk_sums(inst_t, tile_start, tile_end):
    """Per tile: base chunk, chunk count and the (T, max count + 1) table of
    acc(base + i), summed one chunk position at a time over all tiles."""
    heads = inst_t[0, ::CHUNK]
    start, end = tile_start.long(), tile_end.long()
    base = torch.div(start, CHUNK, rounding_mode="floor")
    nch = torch.where(end > start, torch.div(end + CHUNK - 1, CHUNK, rounding_mode="floor") - base, 0)
    acc = torch.zeros(start.shape, dtype=torch.float32, device=inst_t.device)
    table = [acc]
    for i in range(int(nch.max()) if nch.numel() else 0):
        h = heads[torch.clamp(base + i, max=heads.numel() - 1)]
        acc = torch.where(i < nch, _fma(h, acc), acc)
        table.append(acc)
    return base, nch, torch.stack(table, dim=1)


def skel_fwd_torch(inst_t, tile_start, tile_end, grid_x, grid_y):
    """Plain twin of P1': (T, 256, 8) float32, each tile's acc broadcast."""
    _, nch, table = _chunk_sums(inst_t, tile_start, tile_end)
    acc = table.gather(1, nch[:, None])  # (T, 1)
    return acc[:, :, None].expand(grid_x * grid_y, PPT, 8).contiguous()


def skel_bwd_torch(inst_t, tile_start, tile_end, grid_x, grid_y, fwd, dout):
    """Plain twin of P2': (10, K) float32, acc(j // 128) in every row of
    each slot j of a tile's range; 0 on slots outside every range. `fwd` and
    `dout` are read by the kernel only (K3''s prologue)."""
    dev = inst_t.device
    k = inst_t.shape[1]
    base, _, table = _chunk_sums(inst_t, tile_start, tile_end)
    length = (tile_end - tile_start).long()
    tile_of = torch.repeat_interleave(torch.arange(length.shape[0], device=dev), length)
    first = torch.cumsum(length, 0) - length
    slot = tile_start.long()[tile_of] + (torch.arange(tile_of.shape[0], device=dev) - first[tile_of])
    val = table[tile_of, torch.div(slot, CHUNK, rounding_mode="floor") - base[tile_of]]
    dinst = torch.zeros((N_GRAD, k), dtype=torch.float32, device=dev)
    dinst[:, slot] = val
    return dinst


def skel_fwd(inst_t, tile_start, tile_end, grid_x, grid_y):
    """P1' on the card: same contract as `skel_fwd_torch`. CUDA tensors
    only; the table must start on a 16-byte boundary (its bulk copies read
    whole 16-byte groups), as every fresh allocation does."""
    from gsplat_tpu_torch import _kernels

    inst_t, tile_start, tile_end = _kernel_inputs(
        "skel_fwd", inst_t, tile_start, tile_end, grid_x, grid_y)
    if inst_t.data_ptr() % 16:
        raise ValueError("skel_fwd: inst_t must start on a 16-byte boundary")
    num_tiles = grid_x * grid_y
    out = torch.empty((num_tiles, PPT, 8), dtype=torch.float32, device=inst_t.device)
    if num_tiles == 0:
        return out
    lib = _kernels.load("probe_skeleton")
    err = lib.gs_skel_fwd(inst_t.data_ptr(), inst_t.shape[1], inst_t.shape[0],
                          tile_start.data_ptr(), tile_end.data_ptr(), num_tiles, out.data_ptr(),
                          _kernels.stream(inst_t.device))
    _kernels.check(err, "skel_fwd")
    skel_fwd.launches += 1
    return out


def skel_fwd_info() -> dict:
    """P1''s build and launch facts on the current card: registers a thread,
    shared bytes a block, resident blocks an SM, the persistent grid's cap
    (SMs x resident blocks)."""
    import ctypes

    from gsplat_tpu_torch import _kernels

    buf = (ctypes.c_int * 4)()
    _kernels.check(_kernels.load("probe_skeleton").gs_skel_fwd_info(buf), "skel_fwd_info")
    return dict(zip(("registers", "shared_bytes", "blocks_per_sm", "grid_cap"), buf))


skel_fwd.launches = 0


def skel_bwd(inst_t, tile_start, tile_end, grid_x, grid_y, fwd, dout):
    """P2' on the card: same contract as `skel_bwd_torch`, for ranges that
    cover every slot. CUDA tensors only."""
    from gsplat_tpu_torch import _kernels

    inst_t, tile_start, tile_end, fwd, dout = _kernel_inputs(
        "skel_bwd", inst_t, tile_start, tile_end, grid_x, grid_y, fwd, dout)
    k = inst_t.shape[1]
    dinst = torch.empty((N_GRAD, k), dtype=torch.float32, device=inst_t.device)
    if k == 0:
        return dinst
    lib = _kernels.load("probe_skeleton")
    err = lib.gs_skel_bwd(inst_t.data_ptr(), k, tile_start.data_ptr(), tile_end.data_ptr(),
                          grid_x * grid_y, fwd.data_ptr(), dout.data_ptr(), dinst.data_ptr(),
                          _kernels.stream(inst_t.device))
    _kernels.check(err, "skel_bwd")
    skel_bwd.launches += 1
    return dinst


skel_bwd.launches = 0


# the probe's scene and timed calls: the JAX script's on the card, a tiny
# scene and one call on the CPU (a rehearsal of the twins)
SIZES = {"cuda": dict(n=262_144, width=1920, height=1080), "cpu": dict(n=512, width=48, height=32)}
ITERS = {"cuda": 10, "cpu": 1}


def main(argv=None) -> dict:
    """Time K2', P1', K3' and P2' on one seeded frame; returns the ms."""
    from gsplat_tpu_torch.convert import PARAM_FIELDS
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops.binning import pack_bins
    from gsplat_tpu_torch.ops.projection import preprocess
    from gsplat_tpu_torch.probes import time_ms
    from gsplat_tpu_torch.render import grid_dims, render
    from gsplat_tpu_torch.synthetic import tiny_scene

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = resolve_device(parser.parse_args(argv).device)
    on_card = dev.type == "cuda"
    size, iters = SIZES[dev.type], ITERS[dev.type]

    params, alive, camera = tiny_scene(**size, sh_degree=3, device=dev)
    settings = make_render_settings(sh_degree=3)
    gx, gy = grid_dims(camera, 16)

    # warm-up: one forward-plus-backward render
    for f in PARAM_FIELDS:
        getattr(params, f).requires_grad_(True)
    with torch.enable_grad():
        out = render(camera, params, alive, settings, [0.0, 0.0, 0.0], device=dev)
        (out["render"].mean() + 0.0 * out["invdepth"].mean()).backward()
    for f in PARAM_FIELDS:
        getattr(params, f).requires_grad_(False)

    with torch.no_grad():
        screen = preprocess(params, alive, camera, settings, gx, gy)
        bins = pack_bins(screen, gx, gy)
        args3 = (bins.inst_t, bins.tile_start, bins.tile_end, gx, gy)
        fwd_full = rc.blend_fwd if on_card else rc.blend_packed_torch
        fwd_skel = skel_fwd if on_card else skel_fwd_torch
        bwd_full = rc.blend_bwd if on_card else rc.blend_bwd_packed_torch
        bwd_skel = skel_bwd if on_card else skel_bwd_torch
        dout = torch.ones((gx * gy, PPT, 8), device=dev) / (size["width"] * size["height"])
        fwd_out = fwd_full(*args3)
        res = {"device": torch.cuda.get_device_name(dev) if on_card else "cpu",
               "gaussians": size["n"], "size": f"{size['width']}x{size['height']}",
               "instances": bins.num_instances}
        for key, label, fn in (
                ("fwd_full_ms", "fwd full      ", lambda: fwd_full(*args3)),
                ("fwd_skeleton_ms", "fwd skeleton  ", lambda: fwd_skel(*args3)),
                ("bwd_full_ms", "bwd full      ", lambda: bwd_full(*args3, fwd_out, dout)),
                ("bwd_skeleton_ms", "bwd skeleton  ", lambda: bwd_skel(*args3, fwd_out, dout))):
            res[key] = time_ms(fn, iters, dev, warmup=2)
            print(f"{label} {res[key]:9.4f} ms", flush=True)
    print(f"({res['device']}, {res['instances']} instances)", flush=True)
    return res


if __name__ == "__main__":
    main()

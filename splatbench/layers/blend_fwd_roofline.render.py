"""The forward blend (`ops/rasterize_cuda.py`, `blend_fwd_kernel`) against
the least time its work needs: bytes, each read once and written once, of
the live gaussians' screen records (mean2d, conic, opacity, rgb, inverse
depth: 40 B), the tile lists (4 B an instance) and ranges (8 B a tile), and
the pixels' colour, inverse depth and transmittance (20 B a pixel); or 11
float32 operations for every pair a pixel reaches before it stops, the
larger. The counts are the reference's on the traced frames."""

from splatbench import work

KERNELS = ("blend_fwd_kernel",)


def read(ctx):
    c = ctx["counts"]
    nbytes = c["live"] * 40 + c["instances"] * 4 + c["tiles"] * 8 + c["pixels"] * 20
    return work.roofline_pct(ctx, KERNELS, nbytes, work.blend_fwd_ops(c))

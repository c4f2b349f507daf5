"""The blend's backward and the per-gaussian reduce (`ops/rasterize_cuda.py`,
`ops/reduce.py`: `blend_bwd_kernel`, `reduce_by_gid_kernel`) against the
least time their work needs: bytes, each read once and written once, of the
live gaussians' screen records (40 B) and their gradients (40 B), the tile
lists (4 B an instance) and ranges (8 B a tile), and per pixel the forward's
transmittance and last index and the colour and inverse-depth cotangents
(24 B); or 11 float32 operations for every pair a pixel reaches before it
stops and 45 more for every pair blended, the larger. The counts are the
reference's on the traced steps' views."""

from splatbench import work

KERNELS = ("blend_bwd_kernel", "reduce_by_gid_kernel")


def read(ctx):
    c = ctx["counts"]
    nbytes = c["live"] * 80 + c["instances"] * 4 + c["tiles"] * 8 + c["pixels"] * 24
    return work.roofline_pct(ctx, KERNELS, nbytes, work.blend_bwd_ops(c))

"""Binning and sort (`ops/binning.py`, `ops/sort.py`: the tables, the
expand, the sort's kernels, the pack) against the least time their bytes
need: each visible gaussian's screen record read once (mean2d 8, conic 12,
opacity 4, depth 4, radius 4 B), the tile-ordered gaussian ids written
once (4 B an instance) and the tile ranges (4 B a tile). Instances are the
reference's: (gaussian, tile) pairs kept at one pixel of the tile or more,
which no cull can go under."""

from splatbench import work

KERNELS = ("emission_tables_kernel", "expand_instances_kernel", "sort_instances_",
           "pack_instances_kernel")


def read(ctx):
    c = ctx["counts"]
    nbytes = c["visible"] * 32 + c["instances"] * 4 + (c["tiles"] + ctx["calls"]) * 4
    return work.roofline_pct(ctx, KERNELS, nbytes)

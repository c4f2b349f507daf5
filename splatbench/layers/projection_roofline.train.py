"""The projection's kernels (forward and backward, `ops/projection.py`)
against the least time their bytes need, each read once and written once
(`proj_bound`, chip_smoke.py:1933-1946): every row reads its alive byte
and 44 B of geometry; a row visible in the view also 12 B per SH
coefficient and 8 B of screen offset, and in the backward its 40 B of
screen cotangents; the forward writes 69 B of screen record per row, the
backward every row's gradient (56 B, 12 B per SH coefficient past DC, 8 B
of offset). Visible rows are the reference's."""

from splatbench import work

KERNELS = ("project_fwd_kernel", "project_bwd_kernel")


def read(ctx):
    c = ctx["counts"]
    k = (ctx["config"]["sh_degree"] + 1) ** 2
    rows, vis = c["rows"], c["visible"]
    fwd = rows + rows * 44 + vis * (12 * k + 8) + rows * 69
    bwd = rows + rows * 44 + vis * (12 * k + 40) + rows * (56 + 12 * (k - 1) + 8)
    return work.roofline_pct(ctx, KERNELS, fwd + bwd)

"""The Adam kernel (`train/optim.py`, `adam_rows_kernel`) against the least
time its work needs (`adam_bound`, chip_smoke.py:3055-3064): per element p,
g, m and v read and p, m and v written (28 B), per row its count read and
written and its alive byte; or 14 float32 operations an element, the
larger."""

from splatbench import work

KERNELS = ("adam_rows_kernel",)


def read(ctx):
    c, cfg = ctx["counts"], ctx["config"]
    nbytes = c["rows"] * (work.adam_width(cfg) * 28 + 8 + 1)
    return work.roofline_pct(ctx, KERNELS, nbytes, work.adam_ops(c, cfg))

"""The loss kernels (`train/losses.py`: `loss_fwd_kernel`, `loss_bwd_kernel`)
against the least time their work needs: the image and the ground truth
read once and the image's gradient written once (12 B a value), or 261 +
137 float32 operations a value (chip_smoke.py:3028-3033), the larger."""

from splatbench import work

KERNELS = ("loss_fwd_kernel", "loss_bwd_kernel")


def read(ctx):
    values = 3 * ctx["counts"]["pixels"]
    return work.roofline_pct(ctx, KERNELS, values * 12, work.loss_ops(ctx["counts"]))

"""The whole train step's share of the card's float32 peak: the float32
operations the reference counts for the traced steps' views (the blend's
forward and backward pairs, the loss's values, Adam's elements; the
projection's and the binning's few operations per row are left out, so
this is a lower bound) per step, over the untraced window's seconds per
step (`train_step_ms`) at 67 TFLOP/s."""

from splatbench import work


def read(ctx):
    c, cfg = ctx["counts"], ctx["config"]
    ops = (work.blend_fwd_ops(c) + work.blend_bwd_ops(c) + work.loss_ops(c)
           + work.adam_ops(c, cfg))
    return work.mfu_pct(ctx, ops)

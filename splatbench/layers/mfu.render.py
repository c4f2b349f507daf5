"""The whole render frame's share of the card's float32 peak: the blend's
float32 operations that the reference counts for the traced frames (11 for
every pair a pixel reaches before it stops; the projection's and the
binning's few operations per row are left out, so this is a lower bound)
per frame, over the untraced window's seconds per frame (1 / `render_fps`)
at 67 TFLOP/s."""

from splatbench import work


def read(ctx):
    return work.mfu_pct(ctx, work.blend_fwd_ops(ctx["counts"]))

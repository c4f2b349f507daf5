"""The yardstick's constants: published peaks and the float32 operations a
unit of work needs, frozen here with their line of origin in
`chip_smoke.py` (the port's smoke script, which later changes
are free to edit), and the least time a piece of work needs.
"""

from __future__ import annotations

# published peaks of one H100 SXM (NVIDIA data sheet), chip_smoke.py:395-396
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# float32 operations every evaluated (pixel, instance) pair needs before the
# keep test: 2 subtractions, 8 for the conic quadratic, 1 compare
# (chip_smoke.py:397-400)
BLEND_OPS_PER_PAIR = 11
# float32 operations every blended pair adds in the backward for its
# gradient terms: the cotangent dot 7, w and the prefix 3, suffix and
# 1 / (1 - alpha) 3, dalpha 4, dgm 2, the ten row terms 26 (chip_smoke.py:2522-2525)
BWD_OPS_PER_BLENDED = 45
# per element of one Adam update: m' 3, v' 4, the two bias divisions 2,
# sqrt and + eps 2, lr * and / 2, p - 1 (chip_smoke.py:3025-3027)
ADAM_OPS_PER_ELEMENT = 14
# per image value: the loss forward (two passes of 5 blurs of 11 taps, the
# SSIM map, its partials, L1) and backward (chip_smoke.py:3028-3033)
LOSS_FWD_OPS_PER_VALUE = 261
LOSS_BWD_OPS_PER_VALUE = 137


def least_seconds(nbytes, ops=0.0):
    """The least time for the work: its bytes, each read once and each
    written once, at the HBM rate, or its float32 operations at the FP32
    rate, the larger (chip_smoke.py:605-611)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)


def adam_width(config):
    """Floats a row of the six leaves holds: xyz 3, scaling 3, rotation 4,
    opacity 1, SH 3 (sh_degree + 1)^2."""
    return 11 + 3 * (config["sh_degree"] + 1) ** 2


def blend_fwd_ops(counts):
    return counts["pairs"] * BLEND_OPS_PER_PAIR


def blend_bwd_ops(counts):
    return counts["pairs"] * BLEND_OPS_PER_PAIR + counts["blended"] * BWD_OPS_PER_BLENDED


def loss_ops(counts):
    return 3 * counts["pixels"] * (LOSS_FWD_OPS_PER_VALUE + LOSS_BWD_OPS_PER_VALUE)


def adam_ops(counts, config):
    return counts["rows"] * adam_width(config) * ADAM_OPS_PER_ELEMENT


def roofline_pct(ctx, kernels, nbytes, ops=0.0):
    """Percent of the least time the work needs that the kernels whose
    names contain one of `kernels` took in the trace; None where the trace
    holds none of them."""
    seconds = ctx["trace"].kernel_seconds(kernels)
    if not seconds:
        return None
    return 100.0 * least_seconds(nbytes, ops) / seconds


def mfu_pct(ctx, ops):
    """Percent of the card's float32 peak that `ops` float32 operations of
    the traced calls reach in the time the window took per call (host gaps
    and all; the window is untraced, so the profiler's host cost is not in
    it)."""
    return 100.0 * (ops / ctx["calls"]) / (ctx["call_s"] * FP32_FLOPS)


def idle_pct(ctx):
    """Percent of the window's time per call in which the card ran nothing:
    the traced calls' busy seconds per call against the untraced window's
    seconds per call."""
    return 100.0 * (1.0 - ctx["trace"].busy_s / ctx["calls"] / ctx["call_s"])

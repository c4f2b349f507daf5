"""The warp cull of K2' and K3' (`csrc/common.cuh:pixel_box`), through its
plain twin `pixel_box_torch`: every pair the blend's keep test keeps lies in
its instance's pixel box, so a warp that skips an instance whose box misses
its pixels changes no output bit.

The keep test is `pair_keep_torch`, the one `blend_packed_torch` and
`blend_bwd_packed_torch` run; tables are float32, hybrid (rows 2-8 on the
bf16 grid) or bf16 (rows 0-9), as the packs store them. The JAX package
has no cull; `test_cull_stats_on_packed_jax_screens` runs it on screens the
JAX `preprocess` made.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from gsplat_tpu.core.types import make_render_settings
from gsplat_tpu.ops.projection import preprocess
from gsplat_tpu.render import grid_dims
from gsplat_tpu_torch.ops import binning as tb
from gsplat_tpu_torch.ops import rasterize_cuda as rc
from tests.oracle.reference_math import make_test_scene
from tests.test_forward_vs_oracle import scene_to_inputs
from tests.test_torch_binning import to_port

INF = float("inf")
WHOLE = [-INF, INF, -INF, INF]
EMPTY = [INF, -INF, INF, -INF]
PACKETS = ("float32", "hybrid", "bfloat16")


def table(mx, my, sx, sy, angle, op, packets="float32"):
    """(10, n) float32 instance rows [mx, my, ca, cb, cc, op, 0, 0, 0, 0]
    of gaussians with axis sigmas (sx, sy) rotated by `angle`, the 2D
    covariance dilated by 0.3 as `preprocess` does, rounded as `packets`
    rounds them."""
    mx, my, sx, sy, angle, op = np.broadcast_arrays(
        *(np.atleast_1d(np.asarray(v, np.float64)) for v in (mx, my, sx, sy, angle, op)))
    c, s = np.cos(angle), np.sin(angle)
    xx = c * c * sx * sx + s * s * sy * sy + 0.3
    yy = s * s * sx * sx + c * c * sy * sy + 0.3
    xy = c * s * (sx * sx - sy * sy)
    det = xx * yy - xy * xy
    a, b, cc = yy / det, -xy / det, xx / det
    t = np.zeros((10, mx.shape[0]), np.float32)
    t[:6] = np.stack([mx, my, -0.5 * a, -b, -0.5 * cc, op])
    t = torch.from_numpy(t)
    if packets == "hybrid":
        t[2:9] = tb.round_bf16(t[2:9])
    elif packets == "bfloat16":
        t = tb.round_bf16(t)
    return t


def kept_outside(t, reach=80):
    """(kept pairs, kept pairs outside the box, kept pairs at a pixel whose
    warp does not reach the instance) over the integer pixels within
    `reach` of each instance's mean; warps are the 8x4 blocks of 16x16
    tiles that start at multiples of 16."""
    box = rc.pixel_box_torch(t)
    off = torch.arange(-reach, reach + 1, dtype=torch.float32)
    fx, fy = torch.floor(t[0]), torch.floor(t[1])
    px = (fx[:, None, None] + off[None, None, :]).expand(-1, off.numel(), -1)
    py = (fy[:, None, None] + off[None, :, None]).expand(-1, -1, off.numel())
    keep = rc.pair_keep_torch(*(v[:, None, None] for v in t[:6]), px, py)[-1]
    inside = ((px >= box[0][:, None, None]) & (px <= box[1][:, None, None])
              & (py >= box[2][:, None, None]) & (py <= box[3][:, None, None]))
    wx0 = torch.floor(px / rc.WARP_W) * rc.WARP_W
    wy0 = torch.floor(py / rc.WARP_H) * rc.WARP_H
    rects = torch.stack([wx0, wx0 + rc.WARP_W - 1, wy0, wy0 + rc.WARP_H - 1], dim=-1)
    n = t.shape[1]
    reached = rc.warp_reaches_torch(t, rects.reshape(n, -1, 4)).reshape(keep.shape)
    return int(keep.sum()), int((keep & ~inside).sum()), int((keep & ~reached).sum())


@pytest.mark.parametrize("packets", PACKETS)
def test_pixel_box_holds_every_kept_pair_seeded(packets):
    """Seeded gaussians of every size and orientation, opacities over
    [1/255, 1] and a hair above 1/255: no kept pair outside the box."""
    rng = np.random.default_rng(11)
    n = 240
    op = rng.uniform(1 / 255, 1.0, n)
    op[: n // 4] = (1 / 255) * (1.0 + rng.uniform(0, 1e-4, n // 4))  # a hair above
    t = table(rng.uniform(0, 32, n), rng.uniform(0, 32, n), np.exp(rng.uniform(-1.5, 3.0, n)),
              np.exp(rng.uniform(-1.5, 3.0, n)), rng.uniform(0, np.pi, n), op, packets)
    kept, outside, unreached = kept_outside(t)
    assert kept > 0
    assert outside == 0 and unreached == 0
    box = rc.pixel_box_torch(t)
    assert torch.isfinite(box).all(), "well-conditioned visible gaussians get a finite box"


@settings(max_examples=60, deadline=None)
@given(sx=st.floats(0.05, 20.0), sy=st.floats(0.05, 20.0), angle=st.floats(0.0, 3.2),
       op_over=st.one_of(st.floats(1.0, 1.001), st.floats(1.0, 255.0)),
       fx=st.floats(0.0, 1.0), fy=st.floats(0.0, 1.0), packets=st.sampled_from(PACKETS))
def test_pixel_box_holds_every_kept_pair_property(sx, sy, angle, op_over, fx, fy, packets):
    t = table(100.0 + fx, 50.0 + fy, sx, sy, angle, min(op_over / 255, 1.0), packets)
    assert kept_outside(t)[1:] == (0, 0)


def test_pixel_box_at_the_opacity_threshold():
    """Opacity below 1/255 by more than the margin: empty; op <= 0: empty;
    op = 1/255 exactly: the mean, which the keep test keeps, is inside."""
    t = table([10.5, 10.5, 10.5, 10.5], [7.25] * 4, 3.0, 2.0, 0.3,
              [0.95 / 255, 0.0, -0.1, 1 / 255])
    box = rc.pixel_box_torch(t)
    for i in range(3):
        assert box[:, i].tolist() == EMPTY
    x0, x1, y0, y1 = box[:, 3].tolist()
    assert x0 <= 10.5 <= x1 and y0 <= 7.25 <= y1
    at_mean = rc.pair_keep_torch(*t[:6, 3], torch.tensor(10.5), torch.tensor(7.25))[-1]
    assert bool(at_mean)


@pytest.mark.parametrize("case", ["near_degenerate", "not_pd_a", "not_pd_det", "nan_mx",
                                  "inf_my", "nan_ca", "inf_cb", "nan_cc", "nan_op", "inf_op"])
def test_pixel_box_whole_tile(case):
    """No cull where the box cannot be trusted: the keep test decides."""
    t = table(10.0, 10.0, 3.0, 2.0, 0.5, 0.5)
    if case == "near_degenerate":  # 4a'c' - b'^2 = 5e-4 * 4a'c'
        a, c = 1.0, 2.0
        t[2], t[4], t[3] = -a, -c, -np.sqrt(4 * a * c * (1 - 5e-4))
    elif case == "not_pd_a":
        t[2] = 0.1
    elif case == "not_pd_det":
        t[3] = -3.0 * np.sqrt(4 * float(t[2]) * float(t[4]))
    else:
        bad, row = case.split("_")
        t[["mx", "my", "ca", "cb", "cc", "op"].index(row)] = float(bad)
    assert rc.pixel_box_torch(t)[:, 0].tolist() == WHOLE
    # the property holds there too: the whole plane holds every kept pair
    assert kept_outside(t, reach=20)[1:] == (0, 0)


def test_near_degenerate_conic_just_inside_the_cull():
    """A conic a step better conditioned than DEGENERATE gets a finite box
    that still holds every kept pair."""
    a, c = 1.0, 2.0
    t = table(10.3, 10.6, 3.0, 2.0, 0.5, 0.9)
    t[2], t[4], t[3] = -a, -c, -np.sqrt(4 * a * c * (1 - 2e-3))
    assert torch.isfinite(rc.pixel_box_torch(t)).all()
    assert kept_outside(t, reach=120)[1:] == (0, 0)


@pytest.mark.parametrize("angle", [0.0, 0.7])
def test_warp_reach_at_the_margin(angle):
    """A gaussian slid toward a warp's rectangle in steps of 1/64 px: the
    warp reaches it no later than its first kept pixel, and within a pixel
    of it (the cull is not vacuous); at the border column between two
    warps a sub-pixel gaussian reaches only its own."""
    rects = rc.warp_rects_torch(torch.tensor([0]), 1)[0]  # tile (0, 0), 8x4 blocks
    r1 = rects[1]  # warp 1: columns 8-15, rows 0-3
    px = torch.arange(8, 16, dtype=torch.float32)[None, :]
    py = torch.arange(0, 4, dtype=torch.float32)[:, None]
    first_reach = first_keep = None
    for i in range(64 * 12):
        mx = 8.0 - 12.0 + i / 64
        t = table(mx, 1.5, 1.2, 0.8, angle, 0.6)
        reach = bool(rc.warp_reaches_torch(t, r1[None, None])[0, 0])
        keep = bool(rc.pair_keep_torch(*t[:6, 0], px, py)[-1].any())
        assert reach or not keep, f"mx={mx}: a kept pixel in a warp that does not reach"
        if reach and first_reach is None:
            first_reach = mx
        if keep and first_keep is None:
            first_keep = mx
    assert first_reach is not None and first_keep is not None
    assert first_keep - 1.0 <= first_reach <= first_keep
    # a sub-pixel gaussian on column 7 (warp 0's last) reaches warp 0 and
    # not warp 1, whose rectangle starts one column over; its mean on
    # column 8 reaches warp 1
    for mx, want in ((7.0, [True, False]), (8.0, [False, True])):
        t = table(mx, 1.5, 0.05, 0.05, angle, 0.9)
        t[2], t[3], t[4] = -40.0, 0.0, -40.0  # conic of sigma ~0.11 px, no dilation
        assert rc.warp_reaches_torch(t, rects[None, :2])[0].tolist() == want
        assert kept_outside(t, reach=4)[2] == 0


@pytest.mark.parametrize("layout", list(rc.WARP_LAYOUTS))
def test_warp_layout_partitions_the_tile(layout):
    """Each warp owns 32 pixels, all inside its rectangle, and the
    rectangles tile the 16x16 tile."""
    wh = rc.WARP_LAYOUTS[layout]
    owner = rc.pixel_warps(wh)
    rects = rc.warp_rects_torch(torch.tensor([5]), 3, wh)[0]  # tile (2, 1)
    assert torch.bincount(owner, minlength=8).tolist() == [32] * 8
    p = torch.arange(256)
    px, py = 32 + p % 16, 16 + p // 16
    r = rects[owner]
    assert ((px >= r[:, 0]) & (px <= r[:, 1]) & (py >= r[:, 2]) & (py <= r[:, 3])).all()
    area = ((rects[:, 1] - rects[:, 0] + 1) * (rects[:, 3] - rects[:, 2] + 1)).sum()
    assert float(area) == 256.0


@pytest.mark.parametrize("packets", PACKETS)
def test_cull_stats_on_packed_jax_screens(packets):
    """On the instances the port packs from the JAX package's screen: no
    kept pair lies outside its box, the cull skips a share of the (warp,
    instance) pairs, 8x4 blocks at least as many as 16x2 strips, and the
    blend walk evaluates only pairs the cull keeps."""
    sc = make_test_scene(np.random.default_rng(5), n=900, width=128, height=96, sh_degree=1)
    params, camera, alive = scene_to_inputs(sc)
    gx, gy = grid_dims(camera, 16)
    js = jax.jit(lambda p, a: preprocess(p, a, camera, make_render_settings(sh_degree=1),
                                         gx, gy))(params, alive)
    pb = tb.pack_bins(to_port(js), gx, gy, packet_dtype=packets)
    stats = rc.cull_stats_torch(pb.inst_t, pb.tile_start, pb.tile_end, gx, gy, chunk=512)
    assert stats["instances"] == pb.num_instances > 0
    assert stats["kept_pairs"] > 0 and stats["kept_outside_box"] == 0
    culled = stats["culled_warp_instances"]
    assert culled["blocks_8x4"] >= culled["strips_16x2"]
    assert 0.1 * stats["warp_instances"] < culled["blocks_8x4"] < stats["warp_instances"]
    _, pairs, reached = rc.blend_packed_torch(pb.inst_t, pb.tile_start, pb.tile_end, gx, gy,
                                              count_pairs=True)
    assert 0 < reached < pairs

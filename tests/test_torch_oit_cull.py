"""The walks of the OIT kernels K5' and K6' against their unchanged twins,
bit for bit, on the CPU.

K5' (`csrc/rasterize_oit.cu`) walks only the instances its warp's ballot of
`gs::reaches` keeps; K6' walks only the pixels of an instance's
`gs::pixel_box` in its tile. Their plain-torch walks,
`rasterize_cuda.blend_oit_culled_torch` and `blend_oit_bwd_walked_torch`,
add a pair only where the kernel walks it, in the twins' order, so each
equals its twin (`blend_oit_packed_torch`, `blend_oit_bwd_packed_torch`)
bit for bit exactly when no kept pair is skipped. Held on:

- the seeded OIT scene of `tests/test_torch_oit.py` (the JAX `preprocess`
  and its bins), float32 and hybrid packets, at two sizes;
- that table salted with conics past `DEGENERATE` (whole-plane boxes),
  non-finite rows, opacities at and under the keep threshold, and wide
  splats that cover many tiles.

The row spans K6' narrows each box row to (`row_span_torch`, twin of
`gs::row_span`) hold every kept pixel of single gaussians of any shape,
opacity and sub-pixel position (a hypothesis property). A box shrunk by
three pixels makes both walks differ from the twins: the comparison sees a
skipped kept pair.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gsplat_tpu_torch.ops import binning as tb
from gsplat_tpu_torch.ops import rasterize_cuda as rc
from tests.test_torch_binning import to_port
from tests.test_torch_oit import build
from tests.test_torch_warp_cull import PACKETS, table

INF = float("inf")


def packed(width, height, packets):
    js, _, _, gx, gy = build(width=width, height=height)
    pb = tb.pack_bins(to_port(js), gx, gy, packet_dtype=packets)
    return pb.inst_t, pb.tile_start, pb.tile_end, gx, gy


def salted(inst_t):
    """Every 5th slot salted in turn: a conic past DEGENERATE, NaN and inf
    rows, opacity at 1/255, just under it, 0 and 1e-30, and a wide splat."""
    t = inst_t.clone()
    k = t.shape[1]
    idx = torch.arange(0, k, 5)
    kinds = len(SALTS)
    for n, i in enumerate(idx.tolist()):
        SALTS[n % kinds](t, i)
    return t


def _degenerate(t, i):  # 4a'c' - b'^2 = 5e-4 * 4a'c': the whole plane, keep decides
    a, c = 0.02, 0.05
    t[2, i], t[4, i], t[3, i] = -a, -c, -float(np.sqrt(4 * a * c * (1 - 5e-4)))


def _nan_conic(t, i):
    t[2, i] = float("nan")


def _inf_mean(t, i):
    t[0, i] = INF


def _nan_op(t, i):
    t[5, i] = float("nan")


def _op_threshold(t, i):
    t[5, i] = 1.0 / 255.0


def _op_under(t, i):
    t[5, i] = float(np.nextafter(np.float32(1.0 / 255.0), np.float32(0.0)))


def _op_zero(t, i):
    t[5, i] = 0.0


def _op_tiny(t, i):
    t[5, i] = 1e-30


def _wide(t, i):  # sigma ~ 40 px: a box over many tiles, clipped to this one
    t[2, i], t[3, i], t[4, i], t[5, i] = -0.5 / 1600.0, 0.0, -0.5 / 1600.0, 0.9


SALTS = (_degenerate, _nan_conic, _inf_mean, _nan_op, _op_threshold, _op_under, _op_zero,
         _op_tiny, _wide)


def dout_for(fwd, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=fwd.shape).astype(np.float32))


CASES = [(96, 80, "float32", False), (96, 80, "hybrid", False), (200, 120, "float32", False),
         (96, 80, "float32", True), (200, 120, "hybrid", True)]


@pytest.mark.parametrize("width,height,packets,salt", CASES)
def test_k5_warp_culled_walk_equals_twin(width, height, packets, salt):
    inst_t, ts, te, gx, gy = packed(width, height, packets)
    if salt:
        inst_t = salted(inst_t)
    want = rc.blend_oit_packed_torch(inst_t, ts, te, gx, gy)
    got, walked = rc.blend_oit_culled_torch(inst_t, ts, te, gx, gy)
    assert torch.equal(got, want)
    assert torch.isfinite(got).all()
    evaluated = int((te - ts).sum()) * rc.PPT
    assert 0 < walked < evaluated  # the cull skips pairs, and keeps some


@pytest.mark.parametrize("width,height,packets,salt", CASES)
def test_k6_span_walk_equals_twin(width, height, packets, salt):
    inst_t, ts, te, gx, gy = packed(width, height, packets)
    if salt:
        inst_t = salted(inst_t)
    fwd = rc.blend_oit_packed_torch(inst_t, ts, te, gx, gy)
    dout = dout_for(fwd)
    want = rc.blend_oit_bwd_packed_torch(inst_t, ts, te, gx, gy, fwd, dout)
    got, walked = rc.blend_oit_bwd_walked_torch(inst_t, ts, te, gx, gy, fwd, dout)
    assert torch.equal(got, want)
    assert torch.isfinite(got).all()
    assert (got.abs().sum(0) > 0).float().mean() > 0.3
    evaluated = int((te - ts).sum()) * rc.PPT
    assert 0 < walked < evaluated
    if salt:  # the salted rows that keep no pair have zero rows in both
        dropped = torch.arange(0, inst_t.shape[1], 5)[1::len(SALTS)]  # NaN conics
        assert not got[:, dropped].any()


def test_a_skipped_kept_pair_shows(monkeypatch):
    """Shrink every box by three pixels on each side (more than its margin)
    and lower its tau_m by 1:
    K5''s and K6''s walks then skip kept pairs, and the comparisons above
    see it."""
    inst_t, ts, te, gx, gy = packed(96, 80, "float32")
    fwd = rc.blend_oit_packed_torch(inst_t, ts, te, gx, gy)
    dout = dout_for(fwd)
    want_rows = rc.blend_oit_bwd_packed_torch(inst_t, ts, te, gx, gy, fwd, dout)
    box_and_tau = rc._box_and_tau

    def shrunk(t):
        box, tau, finite = box_and_tau(t)
        return box + torch.tensor([3.0, -3.0, 3.0, -3.0])[:, None], tau - 1.0, finite

    monkeypatch.setattr(rc, "_box_and_tau", shrunk)
    assert not torch.equal(rc.blend_oit_culled_torch(inst_t, ts, te, gx, gy)[0], fwd)
    assert not torch.equal(
        rc.blend_oit_bwd_walked_torch(inst_t, ts, te, gx, gy, fwd, dout)[0], want_rows)


def kept_outside_spans(t, reach=80):
    """(kept pairs, kept pairs outside their row's span) over the integer
    pixels within `reach` of each instance's mean; only instances with a
    finite box have spans."""
    _, tau, spans = rc._box_and_tau(t)
    off = torch.arange(-reach, reach + 1, dtype=torch.float32)
    fx, fy = torch.floor(t[0]), torch.floor(t[1])
    px = (fx[:, None, None] + off[None, None, :]).expand(-1, off.numel(), -1)
    py = (fy[:, None, None] + off[None, :, None]).expand(-1, -1, off.numel())
    keep = rc.pair_keep_torch(*(v[:, None, None] for v in t[:6]), px, py)[-1]
    x0, x1 = rc.row_span_torch(*(v[:, None, None] for v in t[:5]), tau[:, None, None], py)
    inside = (px >= x0) & (px <= x1)
    return int(keep.sum()), int((keep & ~inside & spans[:, None, None]).sum())


@settings(max_examples=60, deadline=None)
@given(sx=st.floats(0.05, 20.0), sy=st.floats(0.05, 20.0), angle=st.floats(0.0, 3.2),
       op_over=st.floats(1.0, 300.0), fx=st.floats(0.0, 1.0), fy=st.floats(0.0, 1.0),
       packets=st.sampled_from(PACKETS))
def test_row_span_holds_every_kept_pixel_property(sx, sy, angle, op_over, fx, fy, packets):
    t = table(40.0 + fx, 40.0 + fy, sx, sy, angle, min(op_over / 255.0, 0.999), packets)
    kept, outside = kept_outside_spans(t, reach=80)
    assert outside == 0


@pytest.mark.parametrize("packets", PACKETS)
def test_row_span_holds_every_kept_pixel_seeded(packets):
    """Thin, rotated, faint and near-degenerate splats."""
    rng = np.random.default_rng(11)
    n = 300
    sx = np.exp(rng.uniform(np.log(0.05), np.log(30.0), n))
    sy = np.exp(rng.uniform(np.log(0.05), np.log(30.0), n))
    t = table(rng.uniform(20, 60, n), rng.uniform(20, 60, n), sx, sy, rng.uniform(0, np.pi, n),
              rng.uniform(1.0 / 255.0, 1.0, n), packets)
    kept, outside = kept_outside_spans(t, reach=100)
    assert kept > 0 and outside == 0

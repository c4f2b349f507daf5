"""K1' (binning) and K4' (gradient reduce) as redesigned for Hopper: the
plain twins on the CPU against the JAX package and against direct decodes.

- The packet rows that K1''s expand writes per live gaussian, gathered by
  the JAX `pack_bins`' gaussian ids, equal the JAX instance table's ten
  columns bit for bit (float32 packets; the JAX expand runs its Pallas
  kernel in interpret mode).
- `_expand_instances_torch` on adversarial emission tables (zero counts,
  one gaussian on every tile of a 120 x 68 grid, trimmed gaussians with
  empty rows, N around multiples of 256) emits exactly the tiles the table
  was built from, gaussian by gaussian and row by row: the slot order is
  gid-major, as the kernel's load-balanced walk must reproduce.
- `reduce_by_gid` returns the (16, N) view of an (N, 16) buffer; its
  values match the JAX `reduce_by_gid` within atol 1e-4, rtol 1e-5
  (`tests/test_reduce.py:45`).
- `BlendFunction` and `OITBlendFunction` take their gradients through that
  strided view: against `jax.grad` of the JAX blends with `backend="jnp"`,
  max relative error 5e-5 per gradient, as `test_torch_blend_bwd.py` and
  `test_torch_oit.py` hold them.
"""

import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from gsplat_tpu.ops import binning as jb
from gsplat_tpu.ops.binning import bin_gaussians
from gsplat_tpu.ops.rasterize_jnp import blend_tiles_jnp, blend_tiles_oit_jnp
from gsplat_tpu_torch.ops import binning as tb
from gsplat_tpu_torch.ops import rasterize_cuda as rc
from gsplat_tpu_torch.ops import reduce as rd
from gsplat_tpu_torch.ops.sort import sort_instances_torch, sort_key_bits
from tests import test_torch_blend_bwd as bb
from tests import test_torch_oit as oit
from tests.test_torch_binning import CAP, screen_pair
from tests.test_torch_reduce import ATOL, RTOL, j_reduce_np, rows_and_ids

GRID = (120, 68)  # tiles of a 1920 x 1080 frame


@pytest.mark.parametrize("seed,tight_cull", [(3, True), (7, False)])
def test_packets_match_jax_table_columns(seed, tight_cull):
    js, ts, gx, gy = screen_pair(seed, 1500, tight_cull)
    jp = jax.jit(lambda s: jb.pack_bins(s, gx, gy, CAP, 16, tight_cull=tight_cull,
                                        packet_dtype=jnp.float32))(js)
    assert int(jp.overflow) == 0
    k = int(jp.num_instances)
    tables = tb._emission_tables(ts, 16, tight_cull)
    keys, gid, packets = tb._expand_instances_torch(*tables[:5], ts, tables[5], gx, tight_cull)
    assert packets.shape == (1500, tb.PACKET_COLS) and packets.dtype == torch.float32
    assert packets.stride() == (tb.PACKET_COLS, 1)
    jgid = np.asarray(jp.gauss_id)[:k]
    live = np.nonzero(tables[0][:, 3].numpy() > 0)[0]
    np.testing.assert_array_equal(np.unique(jgid), live)  # every live row is read
    rows = packets.numpy()[jgid]
    np.testing.assert_array_equal(rows[:, :10].T.view(np.uint32),
                                  np.asarray(jp.inst_t)[:10, :k].view(np.uint32))
    assert not rows[:, 10:].any()
    # the pack twin copies the rows into the table exactly
    keys_sorted, gauss_sorted = sort_instances_torch(keys, gid, sort_key_bits(gx * gy))
    inst_t = tb._pack_instances_torch(keys_sorted, gauss_sorted, packets, gx * gy)[0]
    np.testing.assert_array_equal(inst_t.numpy(), np.asarray(jp.inst_t)[:, :k])


def emission_table(rng, n, full_grid, tight_cull):
    """An emission table of `n` gaussians on GRID and, per gaussian, the
    tiles it must emit in slot order (row by row, columns ascending).

    Kinds: dead (count 0, some flagged trimmed), rects of up to 12 x 10
    tiles, and trimmed gaussians of up to 8 rows whose rows hold a run each
    or are empty (with every row empty the gaussian is dead); with
    `full_grid`, one gaussian covers all 120 x 68 tiles. Without
    `tight_cull` a trimmed flag is ignored and the whole rect is emitted."""
    gx, gy = GRID
    rect = np.zeros((n, 4), np.int32)
    trimmed = np.zeros(n, np.uint8)
    t_lo = np.zeros((n, 8), np.int32)
    cum_run = np.zeros((n, 8), np.int32)
    tiles = []
    full_at = int(rng.integers(n)) if full_grid else -1
    for w in range(n):
        kind = "full" if w == full_at else ("dead", "rect", "trimmed")[int(rng.integers(0, 3))]
        rw, rh = (gx, gy) if kind == "full" else (int(rng.integers(1, 13)), int(rng.integers(1, 11)))
        if kind == "trimmed":
            rh = min(rh, 8)
        x0, y0 = int(rng.integers(0, gx - rw + 1)), int(rng.integers(0, gy - rh + 1))
        rect[w, :3] = (x0, y0, rw)
        t_lo[w] = x0
        whole = [(x0 + c, y0 + r) for r in range(rh) for c in range(rw)]
        em = []
        if kind == "trimmed":
            trimmed[w] = 1
            runs = np.zeros(8, np.int32)
            for r in range(rh):
                if rng.random() < 0.35:
                    continue  # an empty row: t_lo stays rmin_x
                a, b = np.sort(rng.integers(x0, x0 + rw, 2))
                t_lo[w, r], runs[r] = a, b - a + 1
                em += [(int(c), y0 + r) for c in range(a, b + 1)]
            cum_run[w] = np.cumsum(runs) - runs
            if not tight_cull:
                em = whole if em else []
        elif kind == "dead":
            trimmed[w] = rng.random() < 0.5
        else:
            em = whole
        rect[w, 3] = len(em)
        tiles.append(em)
    return rect, trimmed, t_lo, cum_run, tiles


def random_columns(rng, depth):
    """Screen columns for the packet rows (any finite values will do)."""
    n = depth.shape[0]
    f = lambda *shape: torch.from_numpy(rng.standard_normal((n,) + shape).astype(np.float32))
    return types.SimpleNamespace(mean2d=f(2), conic=f(3), opacity=f(), rgb=f(3),
                                 depth=torch.from_numpy(depth))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       n=st.one_of(st.integers(1, 600), st.sampled_from([255, 256, 257, 511, 513, 767])),
       full_grid=st.booleans(), tight_cull=st.booleans())
def test_expand_twin_emits_the_table_tiles_gid_major(seed, n, full_grid, tight_cull):
    rng = np.random.default_rng(seed)
    rect, trimmed, t_lo, cum_run, tiles = emission_table(rng, n, full_grid, tight_cull)
    depth = rng.uniform(0.21, 50.0, n).astype(np.float32)
    depth[rng.random(n) < 0.2] = 3.0  # ties: order among equal keys is the gid order
    counts = rect[:, 3].astype(np.int64)
    cum_excl = np.cumsum(counts) - counts
    screen = random_columns(rng, depth)
    keys, gid, packets = tb._expand_instances_torch(
        torch.from_numpy(rect), torch.from_numpy(cum_excl), torch.from_numpy(trimmed),
        torch.from_numpy(t_lo), torch.from_numpy(cum_run), screen, int(counts.sum()),
        GRID[0], tight_cull)

    want_gid = np.repeat(np.arange(n), counts)
    dbits = depth.view(np.int32).astype(np.int64)
    want_keys = np.array([((ty * GRID[0] + tx) << 32) | dbits[w]
                          for w in range(n) for tx, ty in tiles[w]], np.int64)
    np.testing.assert_array_equal(gid.numpy(), want_gid)
    np.testing.assert_array_equal(keys.numpy(), want_keys.reshape(-1))
    assert packets.shape == (n, tb.PACKET_COLS)
    assert (packets[:, 9] == 1.0 / screen.depth).all() and not packets[:, 10:].any()


@pytest.mark.parametrize("pack_bf16", [False, True])
def test_reduce_by_gid_layout_matches_jax(pack_bf16):
    k, n = 3000, 517
    dinst, gid = rows_and_ids(k, n, 5, dead_share=0.2)
    got = rd.reduce_by_gid(torch.from_numpy(dinst), torch.from_numpy(gid), n, pack_bf16)
    assert got.shape == (16, n) and got.dtype == torch.float32
    assert got.stride() == (1, 16) and got.T.is_contiguous()
    assert not got[10:].any()
    np.testing.assert_allclose(got.numpy(), j_reduce_np(dinst, gid, n, pack_bf16),
                               atol=ATOL, rtol=RTOL)
    # the slices the blend Functions return are views of the buffer
    for view, stride in ((got[0:2].T, (16, 1)), (got[2:5].T, (16, 1)), (got[5], (16,)),
                         (got[6:9].T, (16, 1)), (got[9], (16,))):
        assert view.stride() == stride
        assert view.untyped_storage().data_ptr() == got.untyped_storage().data_ptr()


@pytest.mark.parametrize("blend_mode", ["sorted", "oit"])
def test_blend_functions_grads_through_strided_reduce(monkeypatch, blend_mode):
    strides = []

    def spy(dinst, gauss_id, n_gauss, pack_bf16=False):
        out = rd.reduce_by_gid(dinst, gauss_id, n_gauss, pack_bf16)
        strides.append(out.stride())
        return out

    monkeypatch.setattr(rc, "reduce_by_gid", spy)
    if blend_mode == "sorted":
        js, gx, gy, tgt, wd = bb.build()
        jbins = bin_gaussians(js, gx, gy, bb.CAP)
        want = bb.jax_grads(js, gx, gy, tgt, wd,
                            lambda s: blend_tiles_jnp(s, jbins, gx, gy, 16, 1024, 128))
        got, pb = bb.port_grads(js, gx, gy, tgt, wd)
    else:
        js, jbins, _, gx, gy = oit.build()
        tgt, wd = oit.loss_inputs(gx, gy)
        want = bb.jax_grads(js, gx, gy, tgt, wd,
                            lambda s: blend_tiles_oit_jnp(s, jbins, gx, gy, 16, 1024, 128))
        got, pb = oit.grads_and_bins(js, gx, gy, tgt, wd)
    assert strides == [(1, 16)]
    assert pb.num_instances > 1000
    assert all(float(np.abs(np.asarray(w)).max()) > 0 for w in want)
    bb.assert_grads_close(want, got)


def test_k1_wrappers_refuse_sliced_packets():
    _, ts, gx, _ = screen_pair(3, 200, True)
    tables = tb._emission_tables(ts, 16, True)
    packets = tb.gaussian_packets(ts)
    keys, gid, _ = tb._expand_instances_torch(*tables[:5], ts, tables[5], gx, True)
    keys_sorted, gauss_sorted = sort_instances_torch(keys, gid, sort_key_bits(4))
    with pytest.raises(ValueError, match="CUDA"):
        tb.pack_instances(keys_sorted, gauss_sorted, packets, 4)
    with pytest.raises(ValueError, match="packets"):
        tb._check_packets(torch.zeros((200, 16))[:, :12], 200)
    with pytest.raises(ValueError, match="packets"):
        tb._check_packets(torch.zeros(200 * 12 + 1)[1:].view(200, 12), 200)
    tb._check_packets(packets.contiguous(), 200)
    assert tb.pack_instances.launches == 0

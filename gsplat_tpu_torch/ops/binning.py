"""Tile binning: (gaussian, tile)-instance expansion, depth sort, tile ranges.

Counterpart of `gsplat_tpu/ops/binning.py`. `pack_bins` produces the blend
kernel's input, the `PackedBins` of the JAX package (`binning.py:801-809`):
instances in (tile, depth bits, gaussian id) order, per-tile [start, end)
ranges and the (16, K) float32 instance table.

On a CUDA tensor it runs kernel Bt' (`emission_tables`, `csrc/binning.cu`)
for the emission tables, then kernel K1' (replacing the Pallas
`_expand_kernel`, `gsplat_tpu/ops/binning.py:485`) in two launches around
the sort (`ops/sort.py`: kernel St'', `csrc/sort.cu`, for up to 2^23 keys
on a grid of up to 2^15 tiles; kernel St', `csrc/sort_onesweep.cu`, for
more keys or a wider grid, up to 2^31 tiles):

- `emission_tables`: per gaussian, the tight-cull row runs of
  `compute_row_runs` (`t_lo`, `cum_run`, the trimmed flag, `tiles_post`),
  its rect row and the exclusive int64 prefix sum of `tiles_post`
  (`cum_excl`) with the total K, in one launch, bit for bit the plain twin
  `_emission_tables_torch`; `pack_bins` reads K, the frame's one host
  sync (the instance buffer is sized from it).

- `expand_instances`: each gaussian's `tiles_post` instance slots start at
  offset `cum_excl` (the reference's `duplicateWithKeys`); a block of 256
  gaussians emits its contiguous slot range 256 slots at a time, with the
  JAX package's rect decode or, under `tight_cull`, its run-trimmed decode
  (`RUN_HMAX` = 8). Each slot gets the int64 key `(tile << 32) | depth_bits`
  and its gaussian id. Slots go out in gid order, so a stable sort on the
  key gives the JAX total order (tile, depth bits, gid): St'' buckets
  the keys by tile, sorts each tile's (depth bits, slot) and gathers the
  gid, St' radix-sorts them with the gid as payload (`ops/sort.py`). The same
  launch writes one (12,) float32 packet row per live gaussian: the ten table
  columns (conic pre-folded to [-a/2, -b, -c/2], invz = 1/max(depth, 0.2)),
  unrounded, and two zeros; rows of dead gaussians are left unwritten.
- `pack_instances`: after the sort, each sorted slot reads its sorted gid
  and copies its gaussian's packet row into its column of the instance
  table, rounded as the packet mode says, and writes the tile boundaries,
  which give `tile_start` and `tile_end` without a searchsorted.

Packet modes (`packet_dtype`): "float32" stores every row exactly;
"hybrid", the training default, rounds the folded conic, opacity and rgb
rows 2-8 to bf16 (nearest even) after the fold and stores them as float32,
as the JAX package's bf16 pair packing leaves them (`binning.py:737-795`);
mean2d and invz stay exact. "bfloat16" rounds all ten rows, mean2d and
invz = 1/max(depth, 0.2) (computed per gaussian in float32) included, as
the JAX package's all-bf16 packets hold them (`binning.py:743-746`).
Deliberate difference: the rounded values are stored in the float32 table,
so the blends compute exactly what the JAX kernels compute after
`blk.astype(float32)`; a table stored in bf16 (half the bytes) is later
performance work.

The JAX package leaves the sort to XLA (`lax.sort`, `binning.py:758`);
the port sorts with St'' or St' on the card. On a CPU tensor, `pack_bins` runs the
plain twin `pack_bins_torch`, which computes the same function with tensor
ops (`compute_row_runs` and `torch.cumsum` for the tables, `torch.sort`
and a gather for the sort). Both routes run the same stages, each a span
while a profiler records (`profiling.span`): `bin/tables`, `bin/read_k`
(the read of K, which the `instances` counter records), `bin/expand`,
`bin/sort`, `bin/pack`.

Deliberate difference: the instance buffer is sized for each frame from the
prefix sum, as the CUDA reference does (`rasterize_points.cu:27-33`). So
`overflow` is always 0, `num_instances` is exact, and there is no
`capacity` argument. The 2^24 ceiling of the JAX package's
`_check_f32_exact_limits` does not apply: ids and offsets are integers.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from gsplat_tpu_torch.ops.projection import ScreenGaussians
from gsplat_tpu_torch.ops.sort import sort_instances, sort_instances_torch, sort_key_bits
from gsplat_tpu_torch.profiling import count, span

# Max rect height (in tile rows) for run-trimmed emission; taller splats fall
# back to full-rect emission
RUN_HMAX = 8

# conservative outward padding of the run interval endpoints
_RUN_PAD_REL = 1.0 + 2.0**-12
_RUN_PAD_ABS = 2.0**-8  # pixels

N_ROWS = 16  # instance-table rows: mx, my, ca, cb, cc, op, r, g, b, invz, 6 x 0
PACKET_COLS = 12  # packet row: the ten table columns and 2 x 0 (48 bytes)


@dataclasses.dataclass(frozen=True)
class TileBins:
    """Sorted (gaussian, tile) instances + per-tile ranges."""

    gauss_id: torch.Tensor  # (K,) int32 gaussian index per sorted instance
    tile_id: torch.Tensor  # (K,) int32 tile per sorted instance
    tile_start: torch.Tensor  # (T,) int32 range start per tile
    tile_end: torch.Tensor  # (T,) int32 range end per tile
    num_instances: int  # K, exact
    overflow: int = 0  # always 0: the buffer is sized per frame


@dataclasses.dataclass(frozen=True)
class PackedBins:
    """TileBins plus the blend kernel's (16, K) float32 instance table."""

    inst_t: torch.Tensor  # (16, K) rows [mx, my, -a/2, -b, -c/2, op, r, g, b, invz, 0...]
    gauss_id: torch.Tensor  # (K,) int32
    tile_id: torch.Tensor  # (K,) int32
    tile_start: torch.Tensor  # (T,) int32
    tile_end: torch.Tensor  # (T,) int32
    num_instances: int
    overflow: int = 0


def _conic_box_qmin(mx, my, a, b, c, x0, y0, tile):
    """Conservative lower bound of the minimum of Q(dx, dy) =
    (a*dx^2 + c*dy^2)/2 + b*dx*dy over the tile pixel box
    [x0, x0+tile-1] x [y0, y0+tile-1] relative to (mx, my).

    The per-tile oracle that `compute_row_runs` must cover: the box minimum
    is 0 when the center lies in the box, else it lies on one of the two
    near edges, each a clamped closed form. An error allowance proportional
    to the terms' magnitudes is subtracted (near-degenerate conics cancel).
    """
    dx0 = x0 - mx
    dx1 = dx0 + (tile - 1.0)
    dy0 = y0 - my
    dy1 = dy0 + (tile - 1.0)
    zero = torch.zeros_like(dx0)
    dxc = torch.clamp(zero, min=dx0, max=dx1)  # jnp.clip(0, dx0, dx1)
    dyc = torch.clamp(zero, min=dy0, max=dy1)
    dyx = torch.clamp(-(b / c) * dxc, min=dy0, max=dy1)
    t1 = 0.5 * a * dxc * dxc
    t2 = b * dxc * dyx
    t3 = 0.5 * c * dyx * dyx
    qx = (t1 + t2) + t3
    mag_x = (torch.abs(t1) + torch.abs(t2)) + torch.abs(t3)
    dxy = torch.clamp(-(b / a) * dyc, min=dx0, max=dx1)
    u1 = 0.5 * a * dxy * dxy
    u2 = b * dxy * dyc
    u3 = 0.5 * c * dyc * dyc
    qy = (u1 + u2) + u3
    mag_y = (torch.abs(u1) + torch.abs(u2)) + torch.abs(u3)
    take_x = qx <= qy
    qmin = torch.where(take_x, qx, qy)
    mag = torch.where(take_x, mag_x, mag_y)
    return qmin - 1e-5 * mag


def compute_row_runs(screen: ScreenGaussians, tile: int, tight_cull: bool):
    """Exact per-tile-row emission runs (`gsplat_tpu/ops/binning.py:171`).

    For each gaussian and each of its first RUN_HMAX rect rows: the interval
    of tile columns whose 16px box meets the opacity ellipse
    {Q <= cull_qmax} restricted to the row's pixel band.

    Returns (t_lo, cum_run, trimmed, tiles_post):
      t_lo:     (N, RUN_HMAX) f32 integer-valued first tile column per row
      cum_run:  (N, RUN_HMAX) f32 exclusive prefix of run lengths
      trimmed:  (N,) bool, run-trimmed emission applies (else full rect)
      tiles_post: (N,) int32 post-cull emission count
    """
    n = screen.depth.shape[0]
    dev = screen.depth.device
    rmin = screen.rect_min
    rmax = screen.rect_max
    rect_h = (rmax[:, 1] - rmin[:, 1]).to(torch.int32)
    live = screen.tiles_touched > 0

    if not tight_cull:
        zeros = torch.zeros((n, RUN_HMAX), dtype=torch.float32, device=dev)
        return (
            zeros,
            zeros,
            torch.zeros((n,), dtype=torch.bool, device=dev),
            screen.tiles_touched.to(torch.int32),
        )

    a = screen.conic[:, 0]
    b = screen.conic[:, 1]
    c = screen.conic[:, 2]
    mx = screen.mean2d[:, 0]
    my = screen.mean2d[:, 1]
    qmax = screen.cull_qmax
    det = a * c - b * b
    finite_conic = (a > 0) & (c > 0) & (det > 0)
    trimmed = live & finite_conic & (rect_h <= RUN_HMAX) & (qmax > 0)

    one = torch.ones_like(a)
    a_s = torch.where(trimmed, a, one)
    c_s = torch.where(trimmed, c, one)
    det_s = torch.where(trimmed, det, one)
    q_s = torch.where(trimmed, qmax, one)

    rx = torch.sqrt(2.0 * q_s * c_s / det_s)
    dy_pk_hi = -(b / c_s) * rx  # dy of the ellipse's rightmost point
    dy_pk_lo = (b / c_s) * rx

    r_idx = torch.arange(RUN_HMAX, dtype=torch.float32, device=dev)[None, :]
    y0 = (rmin[:, 1].to(torch.float32)[:, None] + r_idx) * float(tile)
    dy0 = y0 - my[:, None]
    dy1 = dy0 + (tile - 1.0)
    dyc = torch.clamp(torch.zeros_like(dy0), min=dy0, max=dy1)  # jnp.clip(0, dy0, dy1)
    s_c = 2.0 * (a_s * q_s)[:, None] - det_s[:, None] * dyc * dyc
    row_live = (s_c >= 0.0) & (r_idx < rect_h[:, None].to(torch.float32))

    def endpoint(dy_pk, sign):
        dye = torch.clamp(dy_pk[:, None], min=dy0, max=dy1)
        disc = 2.0 * (a_s * q_s)[:, None] - det_s[:, None] * dye * dye
        root = torch.sqrt(torch.clamp(disc, min=0.0)) * _RUN_PAD_REL
        x = mx[:, None] + (-b[:, None] * dye + sign * root) / a_s[:, None]
        return x + sign * _RUN_PAD_ABS

    x_hi = endpoint(dy_pk_hi, +1.0)
    x_lo = endpoint(dy_pk_lo, -1.0)

    rmin_x = rmin[:, 0].to(torch.float32)[:, None]
    t_lo = torch.maximum(rmin_x, torch.ceil((x_lo - (tile - 1.0)) / float(tile)))
    t_hi = torch.minimum(
        (rmax[:, 0] - 1).to(torch.float32)[:, None],
        torch.floor(x_hi / float(tile)),
    )
    run_len = torch.where(
        row_live, torch.clamp(t_hi - t_lo + 1.0, min=0.0), torch.zeros_like(t_lo)
    )
    t_lo = torch.where(row_live & (run_len > 0), t_lo, rmin_x.expand_as(t_lo))

    # inclusive prefix over the RUN_HMAX rows as explicit column adds (exact:
    # integer-valued floats). torch.cumsum along this short innermost dim
    # ran a scan kernel of ~6 ms at 1M gaussians on an H100 80GB HBM3
    # (700 W), a third of the frame (torch.profiler in chip_smoke.py).
    cols = [run_len[:, 0]]
    for k in range(1, RUN_HMAX):
        cols.append(cols[-1] + run_len[:, k])
    cum_inc = torch.stack(cols, dim=1)
    total_trim = cum_inc[:, -1]
    cum_run = cum_inc - run_len  # exclusive prefix
    tiles_post = torch.where(
        trimmed, total_trim, screen.tiles_touched.to(torch.float32)
    ).to(torch.int32)
    return t_lo, cum_run, trimmed, tiles_post


def bin_gaussians(
    screen: ScreenGaussians,
    grid_x: int,
    grid_y: int,
    tile: int = 16,
    tight_cull: bool = True,
) -> TileBins:
    """Plain reference binning (`gsplat_tpu/ops/binning.py:297`).

    The JAX package's own two-sort algorithm, independent of `pack_bins`:
    gaussians are depth-ordered first, slots are expanded in that order, and
    one stable sort by tile keeps depth order within each tile.
    """
    num_tiles = grid_x * grid_y
    screen = screen.detach()
    dev = screen.depth.device
    n = screen.depth.shape[0]
    t_lo8, cum_run8, trimmed, tiles_post = compute_row_runs(screen, tile, tight_cull)

    live = tiles_post > 0
    depth_key = torch.where(live, screen.depth, torch.full_like(screen.depth, float("inf")))
    order = torch.sort(depth_key, stable=True).indices
    counts = tiles_post[order].to(torch.int64)
    total = int(counts.sum())

    # slot -> owning gaussian (in depth order) and local index
    owner = torch.repeat_interleave(order, counts)
    start = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    local = torch.arange(total, device=dev, dtype=torch.int64) - start

    rmin_x = screen.rect_min[owner, 0].to(torch.int64)
    rmin_y = screen.rect_min[owner, 1].to(torch.int64)
    rect_w = torch.clamp(screen.rect_max[owner, 0] - screen.rect_min[owner, 0], min=1).to(torch.int64)
    tx = rmin_x + local % rect_w
    ty = rmin_y + local // rect_w
    if tight_cull:
        cum_o = cum_run8[owner].to(torch.int64)
        r_trim = (local[:, None] >= cum_o[:, 1:]).sum(dim=1)
        cum_sel = cum_o.gather(1, r_trim[:, None])[:, 0]
        tlo_sel = t_lo8[owner].to(torch.int64).gather(1, r_trim[:, None])[:, 0]
        trim_o = trimmed[owner]
        tx = torch.where(trim_o, tlo_sel + (local - cum_sel), tx)
        ty = torch.where(trim_o, rmin_y + r_trim, ty)
    tile_id = (ty * grid_x + tx).to(torch.int32)

    tile_sorted, perm = torch.sort(tile_id, stable=True)
    gauss_sorted = owner[perm].to(torch.int32)
    bounds = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, device=dev, dtype=torch.int32)
    ).to(torch.int32)
    return TileBins(
        gauss_id=gauss_sorted,
        tile_id=tile_sorted,
        tile_start=bounds[:num_tiles],
        tile_end=bounds[1:],
        num_instances=total,
    )


# -----------------------------------------------------------------------------
# pack_bins: kernel K1' and its plain twin
# -----------------------------------------------------------------------------


def _emission_tables_torch(screen: ScreenGaussians, tile: int, tight_cull: bool,
                           read_total=True):
    """Plain twin of `emission_tables`: the per-gaussian emission inputs of
    the expand, rect (N, 4) int32 [rmin_x, rmin_y, rect_w, tiles_post],
    cum_excl (N,) int64, trimmed (N,) uint8, t_lo and cum_run (N, 8) int32,
    total K (with `read_total=False` a () int64 tensor)."""
    t_lo8, cum_run8, trimmed, tiles_post = compute_row_runs(screen, tile, tight_cull)
    rect_w = torch.clamp(screen.rect_max[:, 0] - screen.rect_min[:, 0], min=1)
    rect = torch.stack(
        [screen.rect_min[:, 0], screen.rect_min[:, 1], rect_w, tiles_post], dim=1
    ).to(torch.int32).contiguous()
    cum = torch.cumsum(tiles_post.to(torch.int64), 0)
    cum_excl = (cum - tiles_post).contiguous()
    total = cum[-1] if cum.numel() else cum.new_zeros(())
    return (
        rect,
        cum_excl,
        trimmed.to(torch.uint8).contiguous(),
        t_lo8.to(torch.int32).contiguous(),
        cum_run8.to(torch.int32).contiguous(),
        int(total) if read_total else total,
    )


_TABLE_HEAD = 2  # Bt''s state before its block sums: the barrier's arrivals and last number
_table_states: dict = {}  # device -> [Bt''s state, its next barrier number]


def table_layout(n):
    """Bt''s launch for `n` rows as built (`gs_emission_layout`, on the
    current device): (blocks, rows a block a round, rounds, the state's
    int64 words)."""
    from gsplat_tpu_torch import _kernels

    out = (ctypes.c_longlong * 4)()
    err = _kernels.load("binning").gs_emission_layout(n, ctypes.addressof(out))
    _kernels.check(err, "emission_tables layout")
    return tuple(out)


def _table_state(device, words, rounds):
    """Bt''s state on `device`, at least `words` int64 words, zeroed when
    allocated (grown by doubling), and the first of `rounds` new barrier
    numbers on it. The barrier returns its count of arrivals to 0 and
    publishes its number; a later launch's numbers are greater, so nothing
    is zeroed between launches. Launches on one stream share it, not
    launches on two streams at once."""
    entry = _table_states.setdefault(device, [None, 1])
    if entry[0] is None or entry[0].numel() < words:
        cap = words if entry[0] is None else max(words, 2 * entry[0].numel())
        entry[0] = torch.zeros((cap,), dtype=torch.int64, device=device)
    first = entry[1]
    entry[1] += rounds
    return entry[0], first


def emission_tables(screen: ScreenGaussians, tile: int, tight_cull: bool, read_total=True):
    """Kernel Bt': the emission tables in one launch on the card.

    Same contract as `_emission_tables_torch`, bit for bit. The total K is
    read back with one `.item()` (the frame's host sync); with
    `read_total=False` it stays on the card as a () int64 tensor. CUDA
    tensors only.
    """
    from gsplat_tpu_torch import _kernels

    if not screen.rect_min.is_cuda:
        raise ValueError("emission_tables launches a CUDA kernel: tensors must be on a CUDA device")
    n, dev = screen.rect_min.shape[0], screen.rect_min.device
    _check_inputs("emission_tables", dev, (screen.rect_min, torch.int32, (n, 2)),
                  (screen.rect_max, torch.int32, (n, 2)), (screen.conic, torch.float32, (n, 3)),
                  (screen.mean2d, torch.float32, (n, 2)), (screen.cull_qmax, torch.float32, (n,)),
                  (screen.tiles_touched, torch.int32, (n,)))
    # the six outputs as views of one allocation (one caching-allocator call
    # where six cost the host more than the kernel takes): rect, t_lo,
    # cum_run, cum_excl, K and trimmed at 16-byte multiples of N
    buf = torch.empty((89 * n + 16,), dtype=torch.uint8, device=dev)
    rect = buf[:16 * n].view(torch.int32).view(n, 4)
    t_lo = buf[16 * n:48 * n].view(torch.int32).view(n, RUN_HMAX)
    cum_run = buf[48 * n:80 * n].view(torch.int32).view(n, RUN_HMAX)
    cum_excl = buf[80 * n:88 * n].view(torch.int64)
    total = buf[88 * n:88 * n + 8].view(torch.int64).view(())
    trimmed = buf[88 * n + 16:]
    tables = (rect, cum_excl, trimmed, t_lo, cum_run)
    if n == 0:
        return *tables, 0 if read_total else total.zero_()
    # the kernel reads the int2 and float2 columns as 8-byte loads: a
    # contiguous view off an 8-byte boundary (a one-row slice of the mesh's
    # gathered columns) is copied
    args = [c.contiguous() for c in (screen.rect_min, screen.rect_max, screen.conic,
                                     screen.mean2d, screen.cull_qmax, screen.tiles_touched)]
    args = [c.clone() if c.data_ptr() % 8 else c for c in args]
    _, _, rounds, words = table_layout(n)
    state, first = _table_state(dev, words, rounds)
    err = _kernels.load("binning").gs_emission_tables(
        *(t.data_ptr() for t in args), n, tile, int(tight_cull),
        rect.data_ptr(), trimmed.data_ptr(), t_lo.data_ptr(), cum_run.data_ptr(),
        cum_excl.data_ptr(), total.data_ptr(), state.data_ptr(), state.numel(), first,
        _kernels.stream(dev),
    )
    _kernels.check(err, "emission_tables")
    emission_tables.launches += 1
    return *tables, int(total.item()) if read_total else total


emission_tables.launches = 0


def _emission_tables(screen: ScreenGaussians, tile: int, tight_cull: bool):
    """The emission tables: kernel Bt' on a CUDA tensor, its twin
    `_emission_tables_torch` on a CPU one."""
    if screen.rect_min.is_cuda:
        return emission_tables(screen, tile, tight_cull)
    return _emission_tables_torch(screen, tile, tight_cull)


def _depth_bits(depth):
    """int64 view of the float32 depth bits (positive depths: monotone)."""
    return depth.contiguous().view(torch.int32).to(torch.int64)


def _expand_instances_torch(rect, cum_excl, trimmed, t_lo, cum_run, screen,
                            total, grid_x, tight_cull):
    """Plain twin of `expand_instances`: (keys (K,) int64, gid (K,) int32)
    in slot order (gid-major), and the (N, 12) float32 packet rows
    (`gaussian_packets`; the kernel writes the live rows only)."""
    dev = rect.device
    counts = rect[:, 3].to(torch.int64)
    owner = torch.repeat_interleave(torch.arange(rect.shape[0], device=dev), counts)
    local = torch.arange(total, device=dev, dtype=torch.int64) - cum_excl[owner]
    r = rect[owner].to(torch.int64)
    ly = local // r[:, 2]
    tx = r[:, 0] + (local - ly * r[:, 2])
    ty = r[:, 1] + ly
    if tight_cull:
        crun = cum_run[owner].to(torch.int64)
        r_trim = (local[:, None] >= crun[:, 1:]).sum(dim=1)
        cum_sel = crun.gather(1, r_trim[:, None])[:, 0]
        tlo_sel = t_lo[owner].to(torch.int64).gather(1, r_trim[:, None])[:, 0]
        trim_o = trimmed[owner].bool()
        tx = torch.where(trim_o, tlo_sel + (local - cum_sel), tx)
        ty = torch.where(trim_o, r[:, 1] + r_trim, ty)
    tile_id = ty * grid_x + tx
    keys = (tile_id << 32) | _depth_bits(screen.depth)[owner]
    return keys, owner.to(torch.int32), gaussian_packets(screen)


def gaussian_packets(screen: ScreenGaussians):
    """(N, 12) float32 per-gaussian packet rows: the instance columns in
    table-row order, unrounded, then two zeros."""
    invz = 1.0 / torch.clamp(screen.depth, min=0.2)
    zero = torch.zeros_like(invz)
    return torch.stack(
        [
            screen.mean2d[:, 0], screen.mean2d[:, 1],
            # conic pre-folded to [-a/2, -b, -c/2]: exact scalings, so the
            # blend's power needs no -0.5 multiply per pair
            -0.5 * screen.conic[:, 0], -screen.conic[:, 1], -0.5 * screen.conic[:, 2],
            screen.opacity,
            screen.rgb[:, 0], screen.rgb[:, 1], screen.rgb[:, 2],
            invz, zero, zero,
        ],
        dim=1,
    )


def round_bf16(x):
    """float32 -> bf16 (round to nearest even) -> float32."""
    return x.to(torch.bfloat16).to(torch.float32)


# packet_dtype -> the pack kernel's mode, and the table rows each mode
# rounds to bf16
PACKET_MODES = {"float32": 0, "hybrid": 1, "bfloat16": 2}
_ROUNDED_ROWS = {"float32": slice(0, 0), "hybrid": slice(2, 9), "bfloat16": slice(0, 10)}


def _check_packet_dtype(packet_dtype: str) -> None:
    if packet_dtype not in PACKET_MODES:
        raise ValueError(f"packet_dtype={packet_dtype!r}: expected one of {sorted(PACKET_MODES)}")


def _pack_instances_torch(keys_sorted, gauss_sorted, packets, num_tiles, packet_dtype="float32"):
    """Plain twin of `pack_instances`: (inst_t (16, K), tile_id, bounds
    (T+1,)) from the sorted keys, their gaussian ids and the packet rows."""
    _check_packet_dtype(packet_dtype)
    k = keys_sorted.shape[0]
    dev = keys_sorted.device
    tile_id = (keys_sorted >> 32).to(torch.int32)
    inst_t = torch.zeros((N_ROWS, k), dtype=torch.float32, device=dev)
    inst_t[:10] = packets[gauss_sorted.long(), :10].T
    rows = _ROUNDED_ROWS[packet_dtype]
    inst_t[rows] = round_bf16(inst_t[rows])
    bounds = torch.searchsorted(
        tile_id, torch.arange(num_tiles + 1, device=dev, dtype=torch.int32)
    ).to(torch.int32)
    return inst_t, tile_id, bounds


def _check_inputs(what, device, *specs):
    """Each (tensor, dtype, shape) on `device` with that dtype and shape."""
    for t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"{what}: expected {dtype} {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_packets(packets, n):
    """The kernels read and write a packet row as three float4: the buffer
    must be (n, 12) float32, rows 12 floats apart, 16-byte aligned. A
    sliced view is refused, never copied."""
    if (packets.dtype != torch.float32 or tuple(packets.shape) != (n, PACKET_COLS)
            or packets.stride() != (PACKET_COLS, 1) or packets.data_ptr() % 16):
        raise ValueError(f"packets must be a 16-byte aligned contiguous ({n}, {PACKET_COLS}) "
                         f"float32 buffer, got {packets.dtype} {tuple(packets.shape)} with "
                         f"strides {packets.stride()} at {packets.data_ptr():#x}")


def expand_instances(rect, cum_excl, trimmed, t_lo, cum_run, screen, total,
                     grid_x, tight_cull):
    """Kernel K1', launch 1: load-balanced instance emission and the packet
    rows of the live gaussians on the card.

    Same contract as `_expand_instances_torch`, on the live packet rows
    (the dead rows of `packets` are left as `torch.empty` gave them). CUDA
    tensors only.
    """
    from gsplat_tpu_torch import _kernels

    if not rect.is_cuda:
        raise ValueError("expand_instances launches a CUDA kernel: tensors must be on a CUDA device")
    n, dev = rect.shape[0], rect.device
    cols = (screen.mean2d, screen.conic, screen.opacity, screen.rgb, screen.depth)
    _check_inputs("expand_instances", dev, (rect, torch.int32, (n, 4)),
                  (cum_excl, torch.int64, (n,)), (trimmed, torch.uint8, (n,)),
                  (t_lo, torch.int32, (n, RUN_HMAX)), (cum_run, torch.int32, (n, RUN_HMAX)),
                  *((c, torch.float32, (n,) + w) for c, w in zip(cols, ((2,), (3,), (), (3,), ()))))
    if total >= 2**31:  # the kernel's slot offsets inside a block are int32
        raise ValueError(f"expand_instances: {total} instances, the kernel takes < 2^31")
    args = [t.contiguous() for t in (rect, cum_excl, trimmed, t_lo, cum_run, *cols)]
    if any(t.data_ptr() % 16 for t in (args[0], args[3], args[4])):  # int4 row loads
        raise ValueError("expand_instances: rect, t_lo and cum_run must be 16-byte aligned")
    keys = torch.empty((total,), dtype=torch.int64, device=dev)
    gids = torch.empty((total,), dtype=torch.int32, device=dev)
    packets = torch.empty((n, PACKET_COLS), dtype=torch.float32, device=dev)
    _check_packets(packets, n)
    if n == 0 or total == 0:
        return keys, gids, packets
    lib = _kernels.load("binning")
    err = lib.gs_expand_instances(
        *(t.data_ptr() for t in args), n, grid_x, int(tight_cull),
        keys.data_ptr(), gids.data_ptr(), packets.data_ptr(), _kernels.stream(dev),
    )
    _kernels.check(err, "expand_instances")
    expand_instances.launches += 1
    return keys, gids, packets


expand_instances.launches = 0


def pack_instances(keys_sorted, gauss_sorted, packets, num_tiles, packet_dtype="float32"):
    """Kernel K1', launch 2: instance table + tile boundaries on the card.

    Same contract as `_pack_instances_torch`, every packet mode included.
    CUDA tensors only.
    """
    from gsplat_tpu_torch import _kernels

    if not keys_sorted.is_cuda:
        raise ValueError("pack_instances launches a CUDA kernel: tensors must be on a CUDA device")
    _check_packet_dtype(packet_dtype)
    k = keys_sorted.shape[0]
    dev = keys_sorted.device
    _check_inputs("pack_instances", dev, (keys_sorted, torch.int64, (k,)),
                  (gauss_sorted, torch.int32, (k,)))
    _check_packets(packets, packets.shape[0])
    if packets.device != dev:
        raise ValueError(f"pack_instances: packets on {packets.device}, keys on {dev}")
    keys_sorted, gauss_sorted = keys_sorted.contiguous(), gauss_sorted.contiguous()
    inst_t = torch.empty((N_ROWS, k), dtype=torch.float32, device=dev)
    tile_id = torch.empty((k,), dtype=torch.int32, device=dev)
    bounds = torch.empty((num_tiles + 1,), dtype=torch.int32, device=dev)
    lib = _kernels.load("binning")
    err = lib.gs_pack_instances(
        keys_sorted.data_ptr(), gauss_sorted.data_ptr(), packets.data_ptr(), k, num_tiles,
        PACKET_MODES[packet_dtype], inst_t.data_ptr(), tile_id.data_ptr(), bounds.data_ptr(),
        _kernels.stream(dev),
    )
    _kernels.check(err, "pack_instances")
    pack_instances.launches += 1
    pack_instances.launches_hybrid += packet_dtype == "hybrid"
    pack_instances.launches_bf16 += packet_dtype == "bfloat16"
    return inst_t, tile_id, bounds


# all launches, and those of them with hybrid and with bf16 packets
pack_instances.launches = 0
pack_instances.launches_hybrid = 0
pack_instances.launches_bf16 = 0


def _pack(screen, grid_x, grid_y, tile, tight_cull, packet_dtype, tables, expand, sort,
          pack) -> PackedBins:
    """The binning's stages, each a span while a profiler records; K is
    read in its own, `bin/read_k`, and counted there (`instances`)."""
    num_tiles = grid_x * grid_y
    with span("bin/tables"):
        screen = screen.detach()
        *emission, total = tables(screen, tile, tight_cull, read_total=False)
    with span("bin/read_k"):
        total = int(total.item())
        count("instances", total)
    with span("bin/expand"):
        keys, gid, packets = expand(*emission, screen, total, grid_x, tight_cull)
    with span("bin/sort"):
        keys_sorted, gauss_sorted = sort(keys, gid, sort_key_bits(num_tiles))
    with span("bin/pack"):
        inst_t, tile_id, bounds = pack(keys_sorted, gauss_sorted, packets, num_tiles,
                                       packet_dtype)
    return PackedBins(
        inst_t=inst_t,
        gauss_id=gauss_sorted,
        tile_id=tile_id,
        tile_start=bounds[:num_tiles],
        tile_end=bounds[1:],
        num_instances=total,
    )


def pack_bins_torch(
    screen: ScreenGaussians,
    grid_x: int,
    grid_y: int,
    tile: int = 16,
    tight_cull: bool = True,
    packet_dtype: str = "float32",
) -> PackedBins:
    """Plain PyTorch twin of `pack_bins`, on any device."""
    return _pack(screen, grid_x, grid_y, tile, tight_cull, packet_dtype,
                 _emission_tables_torch, _expand_instances_torch, sort_instances_torch,
                 _pack_instances_torch)


def pack_bins(
    screen: ScreenGaussians,
    grid_x: int,
    grid_y: int,
    tile: int = 16,
    tight_cull: bool = True,
    packet_dtype: str = "float32",
) -> PackedBins:
    """Fused binning + instance packing (`gsplat_tpu/ops/binning.py:620`).

    Same instance order as `bin_gaussians`: (tile, depth bits, gaussian id).
    On a CUDA tensor through kernels Bt' (`emission_tables`), K1'
    (`expand_instances`, `pack_instances`) and St'' or St'
    (`sort_instances`); on a CPU tensor through `pack_bins_torch`.
    Non-differentiable structure: the screen quantities are detached, as
    `binning.py:657` stops their gradients.
    """
    if screen.depth.is_cuda:
        return _pack(screen, grid_x, grid_y, tile, tight_cull, packet_dtype,
                     emission_tables, expand_instances, sort_instances, pack_instances)
    return pack_bins_torch(screen, grid_x, grid_y, tile, tight_cull, packet_dtype)

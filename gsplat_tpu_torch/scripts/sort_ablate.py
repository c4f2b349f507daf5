"""Where the instance sort's time goes: its two routes, St'' (`csrc/sort.cu`,
a segmented sort) split into its parts and St' (`csrc/sort_onesweep.cu`, a
radix sort), beside the library sort, timed in turns on one card.

    python gsplat_tpu_torch/scripts/sort_ablate.py [--calls 20] [--rounds 3]

On the card only. The routes, each built by `scripts/ablation.py` (a
variant is a source with text edits, each of which must match), each
forced for every case whatever its K (`on_route`):

- `seg`: St'' as committed (CAP 2,048: 256 threads x 8 values; the
  scatter in 8 ranges of tiles; a warp a tile of up to 1,024 keys);
- `cap4096`: St'' with 16 values a thread (CAP 4,096);
- `parts1`, `parts4`, `parts16`: the scatter in 1, 4 or 16 ranges;
- `warp16`: a warp a tile of up to 512 keys, the block the larger ones;
- timing only (the result is wrong): `warp_no_sort` (the warps write
  their tiles unsorted), `scatter_in_place` (each key's value written at
  its own slot), `no_gid_gather` (the slot written in place of its gid);
- `onesweep`: St' as committed (8-bit digits, 6 passes of 44 bits);
  `onesweep_d11`: St' with 11-bit digits (the host tests run it too);
- `torch_sort_gather`: `torch.sort(keys, stable=True)` and the gather of
  the gids (the same function, the library route), `torch_sort`: the sort
  alone;
- yardsticks: `copy24`, a copy of the keys and gids (the 24 bytes a key);
  `read8`, a sum of the keys (the count's 8 bytes).

Cases: the keys and gids of K1''s expand on the flagship render frame
(1,048,576 gaussians, 1920x1080, SH 3) and on the train frame's rows (the
same scene padded to 2,097,152 rows, half dead); the render frame's keys
on coarser grids, the tile ids divided by 2, 4 and 8 (tiles of about 2, 4
and 8 times the keys: the segment sort by tile size and, past CAP, the
big route); and the render frame six times as dense (its keys repeated
with fresh depth bits: 22M keys, as a trained scene's frame, past
ONESWEEP_MIN_KEYS). Every route that sorts is held bit for bit to
`torch.sort` + gather on every case. Prints one JSON line: the card, CAP,
each case's tile-size histogram, largest tile and tiles over CAP (as the
keys hold them and as St'''s count kernel found them), each route's
device ms a sort from the profiler (all its kernels, and St'''s count,
scatter and segment kernels apart) and from CUDA events around the same
calls, per round, and their medians; registers and local memory of each
build (`cuobjdump -res-usage`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


DIGITS = "constexpr int DIGIT_BITS = 8;"
ITEMS = "constexpr int ITEMS = 8;"
PARTS = "constexpr int SCATTER_PART_BITS = 3;"
V_STORE = "            bucket[at] = "
WARP_SORT = "    merge_sort<E, false>(s_w, n, lane);\n"
GID_GATHER = "    gid_out[i] = __ldg(gid + (unsigned)(v & 0x7fffffffu));"
# St'' variants: name: (text edits, extra nvcc flags)
VARIANTS = {
    "seg": ([], []),
    "cap4096": ([(ITEMS, "constexpr int ITEMS = 16;")], []),
    "parts1": ([(PARTS, "constexpr int SCATTER_PART_BITS = 0;")], []),
    "parts4": ([(PARTS, "constexpr int SCATTER_PART_BITS = 2;")], []),
    "parts16": ([(PARTS, "constexpr int SCATTER_PART_BITS = 4;")], []),
    "warp16": ([("constexpr int WARP_ITEMS = 32;", "constexpr int WARP_ITEMS = 16;")], []),
    "warp_no_sort": ([(WARP_SORT, "")], []),
    "scatter_in_place": ([(V_STORE, "            bucket[i] = ")], []),
    "no_gid_gather": ([(GID_GATHER, "    gid_out[i] = (int)v;")], []),
}
TIMING_ONLY = ("scatter_in_place", "no_gid_gather", "warp_no_sort")  # variants that do not sort
# variants of St'
ONESWEEP_VARIANTS = {
    "onesweep": ([], []),
    "onesweep_d11": ([(DIGITS, "constexpr int DIGIT_BITS = 11;")], []),
}
COARSER = (1, 2, 3)  # the coarser grids: tile ids >> 1, 2, 3

PARTS_OF_SORT = ("count", "scatter", "segment")  # St'''s kernels


@contextlib.contextmanager
def on_route(name):
    """`sort_instances` takes route `name` ("segmented" or "onesweep")
    inside the block, whatever the number of keys; keys of more than
    SEGMENTED_MAX_KEY_BITS take St' whatever is forced."""
    from gsplat_tpu_torch.ops import sort as so

    kept = so.ONESWEEP_MIN_KEYS
    so.ONESWEEP_MIN_KEYS = -1 if name == "onesweep" else 1 << 31
    try:
        yield
    finally:
        so.ONESWEEP_MIN_KEYS = kept


def device_ms(fn, calls):
    """Device ms per call of every kernel `fn` launches, over `calls`
    profiled calls (after one unprofiled call): the sum, and each kernel
    name's share (St'''s count, scatter and segment apart)."""
    from torch.autograd import DeviceType

    from gsplat_tpu_torch.profiling import profile_calls

    fn()
    prof = profile_calls(fn, calls)
    rows = [(e.key, e.self_device_time_total / calls / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return {"all": sum(ms for _, ms in rows),
            **{part: sum(ms for k, ms in rows if f"sort_instances_{part}" in k)
               for part in (*PARTS_OF_SORT, "hist", "pass")},
            "by_kernel": {re.sub(r"\(.*", "", k)[-40:]: ms for k, ms in rows}}


def frame_keys(dev, capacity=None):
    """(keys, gid, key_bits) of K1''s expand on the flagship frame."""
    import chip_smoke as cs
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops.sort import sort_key_bits
    from gsplat_tpu_torch.synthetic import tiny_scene

    params, alive, camera = tiny_scene(**cs.FULL, capacity=capacity, device=dev)
    screen, gx, gy = cs.screen_of((params, alive, camera), make_render_settings(sh_degree=3), dev)
    screen = screen.detach()
    tables = tb.emission_tables(screen, 16, True)
    keys, gid, _ = tb.expand_instances(*tables[:5], screen, tables[5], gx, True)
    return keys, gid, sort_key_bits(gx * gy)


def coarser(keys, shift):
    """K1''s keys with each tile id divided by 2^shift (the depth bits
    kept): the same instances on a grid of fewer, larger tiles."""
    return ((keys >> (32 + shift)) << 32) | (keys & 0x7FFFFFFF)


def denser(case, times):
    """A frame `times` as dense: its keys repeated `times` times, each copy
    with fresh depth bits (seeded), its gids repeated; as a trained scene's
    frame holds several times the flagship's instances a tile."""
    import torch

    keys, gid, bits = case
    g = torch.Generator(device=keys.device).manual_seed(20)
    tiles = (keys >> 32).repeat(times)
    depth = torch.randint(0, 1 << 31, tiles.shape, generator=g, device=keys.device)
    return (tiles << 32) | depth, gid.repeat(times), bits


def tile_sizes(keys, cap):
    """Tile-size histogram (keys a tile, in powers of two up to CAP, then
    over CAP), the largest tile, the tiles over CAP."""
    import torch

    counts = torch.bincount((keys >> 32).long())
    counts = counts[counts > 0]
    edges = [0, 64, 128, 256, 512, 1024, 2048, 4096, 8192]
    hist = {f"{lo + 1}-{hi}": int(((counts > lo) & (counts <= hi)).sum())
            for lo, hi in zip(edges, edges[1:])}
    hist[f">{edges[-1]}"] = int((counts > edges[-1]).sum())
    return {"tiles": int(counts.numel()), "histogram": hist, "largest_tile": int(counts.max()),
            "tiles_over_cap": int((counts > cap).sum())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    import chip_smoke as cs
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.device import card_line
    from gsplat_tpu_torch.ops import sort as so
    from gsplat_tpu_torch.scripts import ablation

    if not torch.cuda.is_available():
        print("sort_ablate: no CUDA device", file=sys.stderr)
        return 2
    out_dir = _kernels.BUILD_DIR / "sort_ablate"
    built = ablation.build("sort", VARIANTS, out_dir)
    onesweeps = ablation.build("sort_onesweep", ONESWEEP_VARIANTS, out_dir)
    dev = torch.device("cuda", 0)
    cap = so.sort_layout(1, 44).cap
    with torch.inference_mode():
        render = frame_keys(dev)
        cases = {"render_frame": render, "train_frame_rows": frame_keys(dev, 2 * cs.FULL["n"]),
                 **{f"render_tiles>>{s}": (coarser(render[0], s), render[1], render[2] - s)
                    for s in COARSER},
                 "render_x6": denser(render, 6)}
        sizes = {name: tile_sizes(c[0], cap) for name, c in cases.items()}

        states = {}  # each build's own state: its layout may differ

        def route_fn(route, keys, gid, bits):
            if route in built:
                lib = built[route][0]

                def fn():
                    kept, so._states = so._states, states.setdefault(route, {})
                    try:
                        with ablation.loaded("sort", lib), on_route("segmented"):
                            return so.sort_instances(keys, gid, bits)
                    finally:
                        so._states = kept
                return fn
            if route in onesweeps:
                lib = onesweeps[route][0]

                def fn():
                    with ablation.loaded("sort_onesweep", lib), on_route("onesweep"):
                        return so.sort_instances(keys, gid, bits)
                return fn
            if route == "torch_sort_gather":
                return lambda: so.sort_instances_torch(keys, gid, bits)
            if route == "torch_sort":
                return lambda: torch.sort(keys, stable=True)
            if route == "copy24":
                dk, dg = torch.empty_like(keys), torch.empty_like(gid)
                return lambda: (dk.copy_(keys), dg.copy_(gid))
            return lambda: keys.sum()  # read8

        sorting = [*(v for v in VARIANTS if v not in TIMING_ONLY), *ONESWEEP_VARIANTS,
                   "torch_sort_gather"]
        equal, stats = {}, {}
        for name, (keys, gid, bits) in cases.items():
            want = so.sort_instances_torch(keys, gid, bits)
            for route in sorting:
                print(f"sort_ablate: {route} on {name}", file=sys.stderr, flush=True)
                got = route_fn(route, keys, gid, bits)()
                torch.cuda.synchronize()
                equal[f"{route}/{name}"] = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
                if route == "seg":  # the count kernel's own tiles over CAP and largest tile
                    kept, so._states = so._states, states["seg"]
                    stats[name] = so.sort_stats(dev)
                    so._states = kept
        routes = {name: [*VARIANTS, "copy24", "read8"] for name in cases}
        for name in ("render_frame", "train_frame_rows", "render_x6"):
            routes[name] += [*ONESWEEP_VARIANTS, "torch_sort_gather", "torch_sort"]
        ms = {name: {r: {"profiled": [], "events": [], **{part: [] for part in PARTS_OF_SORT}}
                     for r in rs} for name, rs in routes.items()}
        for r in range(args.rounds):
            for name, (keys, gid, bits) in cases.items():
                for route in (routes[name] if r % 2 == 0 else routes[name][::-1]):
                    fn = route_fn(route, keys, gid, bits)
                    prof = device_ms(fn, args.calls)
                    into = ms[name][route]
                    into.setdefault("by_kernel", prof["by_kernel"])
                    into["profiled"].append(prof["all"])
                    into["events"].append(cs.cuda_time(fn, args.calls))
                    for part in PARTS_OF_SORT:
                        into[part].append(prof[part])
    print(json.dumps({
        "card": card_line(), "cap": cap, "kernel_stats": stats,
        "instances": {name: int(c[0].shape[0]) for name, c in cases.items()},
        "key_bits": {name: c[2] for name, c in cases.items()},
        "bound_ms": {name: 24 * int(c[0].shape[0]) / cs.HBM_BYTES_PER_S * 1e3
                     for name, c in cases.items()},
        "tile_sizes": sizes,
        "res_usage": {v: {f: u for f, u in _kernels.res_usage(path).items() if "sort" in f}
                      for v, (_, path) in {**built, **onesweeps}.items()},
        "equal_to_twin": equal, "ms": ms,
        "ms_median": {name: {r: {how: statistics.median(x) for how, x in per.items()
                                 if how != "by_kernel"}
                             for r, per in by.items()} for name, by in ms.items()}}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

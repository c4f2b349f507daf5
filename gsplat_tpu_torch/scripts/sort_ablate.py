"""Where St''s time goes: variants of `csrc/sort.cu`, built side by side
and timed in turns on the flagship frames' instance keys.

    python gsplat_tpu_torch/scripts/sort_ablate.py [--calls 20] [--rounds 3]

On the card only. Each variant is the committed source with a text edit,
built by `scripts/ablation.py` (each edit must match, so a changed source
fails loudly rather than timing the unchanged kernel):

- `d8`: as committed, 8-bit digits (6 passes over the 44 live bits of a
  1080p key), tiles of 4,096 keys;
- `d11`: 11-bit digits (4 passes);
- `items12`, `items24`: tiles of 3,072 and 6,144 keys;
- `gid_direct`: the gids read by the threads when the tile is laid out in
  shared memory, in place of the asynchronous copies;
- `no_lookback`: no look-back (every tile's prefix 0; the result wrong);
- `scatter_in_place`: each tile written back where it came from, in digit
  order (no scattered writes; the result wrong).

The variants that sort are held bit for bit to the twin
`sort_instances_torch` on every case. Cases: the keys and gids of K1''s
expand on the flagship render frame (1,048,576 gaussians, 1920x1080, SH 3)
and on the train frame's rows (the same scene padded to 2,097,152 rows,
half dead). Prints one JSON line: the card, each variant's registers and
local memory (`cuobjdump -res-usage`) and its SASS opcode counts, its
equality, its device ms a sort from the profiler (`calls` sorts: every
kernel of the sort, the histogram and the passes apart) and from CUDA
events around the same calls, per round and case; and two yardsticks timed
the same ways: `torch.sort(keys, stable=True)` with the gather of the gids
(the library route St' replaced) and a copy of the keys and the gids (the
bytes of one pass).
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DIGITS = "constexpr int DIGIT_BITS = 8;"
ITEMS = "constexpr int ITEMS = 16;"
LOOKBACK = "    if (tile > 0) {\n        int at[BINS];"
SCATTER = "s_base[digit_at<PASS>(kj)] + (unsigned)j;"
GIN_COPY = "        if (idx < (unsigned)k) __pipeline_memcpy_async("
GIN_READ = "        s_gid[pos] = gin[32 * i];"
# name: (text edits, extra nvcc flags)
VARIANTS = {
    "d8": ([], []),
    "d11": ([(DIGITS, "constexpr int DIGIT_BITS = 11;")], []),
    "gid_direct": ([(GIN_COPY, "        if (false) __pipeline_memcpy_async("),
                    (GIN_READ, "        s_gid[pos] = base + 32 * i < (unsigned)k ? "
                               "gid_in[base + 32 * i] : 0;")], []),
    "items12": ([(ITEMS, "constexpr int ITEMS = 12;")], []),
    "items24": ([(ITEMS, "constexpr int ITEMS = 24;")], []),
    "no_lookback": ([(LOOKBACK, LOOKBACK.replace("tile > 0", "false"))], []),
    "scatter_in_place": ([(SCATTER, "(unsigned)tile * TILE + (unsigned)j;")], []),
}
# variants that do not sort (timings only)
TIMING_ONLY = ("no_lookback", "scatter_in_place")


def device_ms(fn, calls):
    """Device ms per call of every kernel `fn` launches, over `calls`
    profiled calls (after one unprofiled call): the sum, and St''s
    histogram and pass kernels apart."""
    from torch.autograd import DeviceType

    from gsplat_tpu_torch.profiling import profile_calls

    fn()
    prof = profile_calls(fn, calls)
    rows = [(e.key, e.self_device_time_total / calls / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return {"all": sum(ms for _, ms in rows),
            **{part: sum(ms for k, ms in rows if part in k)
               for part in ("sort_instances_hist", "sort_instances_pass")},
            "by_kernel": {re.sub(r"\(.*", "", k)[-40:]: ms for k, ms in rows}}


def sass_counts(path):
    """{kernel function: {opcode: count}} of a built library (`cuobjdump
    -sass`)."""
    import subprocess

    from gsplat_tpu_torch import _kernels

    tool = Path(_kernels.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            cur = counts.setdefault(head.group(1), {})
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if ins and cur is not None:
            cur[ins.group(1)] = cur.get(ins.group(1), 0) + 1
    return counts


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


def record(into, profiled, events):
    into.setdefault("by_kernel", profiled["by_kernel"])
    into["profiled"].append(profiled["all"])
    into["events"].append(events)
    into["hist"].append(profiled["sort_instances_hist"])
    into["passes"].append(profiled["sort_instances_pass"])


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
    built = ablation.build("sort", VARIANTS, _kernels.BUILD_DIR / "sort_ablate")
    dev = torch.device("cuda", 0)
    with torch.inference_mode():
        cases = {"render_frame": frame_keys(dev),
                 "train_frame_rows": frame_keys(dev, 2 * cs.FULL["n"])}
        equal = {}
        for v in (v for v in VARIANTS if v not in TIMING_ONLY):
            with ablation.loaded("sort", built[v][0]):
                for name, (keys, gid, bits) in cases.items():
                    got = so.sort_instances(keys, gid, bits)
                    want = so.sort_instances_torch(keys, gid, bits)
                    equal[f"{v}/{name}"] = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        # a yardstick: a copy of the keys and the gids, the bytes of one pass
        copies = {name: (torch.empty_like(c[0]), torch.empty_like(c[1])) for name, c in cases.items()}
        routes = [*VARIANTS, "torch_sort_gather", "copy"]
        ms = {name: {r: {"profiled": [], "events": [], "hist": [], "passes": []} for r in routes}
              for name in cases}
        for r in range(args.rounds):
            for route in (routes if r % 2 == 0 else routes[::-1]):
                for name, (keys, gid, bits) in cases.items():
                    if route == "copy":
                        dk, dg = copies[name]
                        fn = lambda: (dk.copy_(keys), dg.copy_(gid))  # noqa: E731
                        record(ms[name][route], device_ms(fn, args.calls),
                               cs.cuda_time(fn, args.calls))
                        continue
                    if route == "torch_sort_gather":
                        fn = lambda: so.sort_instances_torch(keys, gid, bits)  # noqa: E731
                        record(ms[name][route], device_ms(fn, args.calls),
                               cs.cuda_time(fn, args.calls))
                        continue
                    with ablation.loaded("sort", built[route][0]):
                        fn = lambda: so.sort_instances(keys, gid, bits)  # noqa: E731
                        record(ms[name][route], device_ms(fn, args.calls),
                               cs.cuda_time(fn, args.calls))
    print(json.dumps({
        "card": card_line(),
        "instances": {name: int(c[0].shape[0]) for name, c in cases.items()},
        "key_bits": {name: c[2] for name, c in cases.items()},
        "bound_ms": {name: 24 * int(c[0].shape[0]) / cs.HBM_BYTES_PER_S * 1e3
                     for name, c in cases.items()},
        "res_usage": {v: {f: u for f, u in _kernels.res_usage(path).items() if "sort" in f}
                      for v, (_, path) in built.items()},
        "equal_to_twin": equal, "ms": ms,
        "sass": {v: {f[-40:]: {op: c for op, c in sorted(ops.items(), key=lambda kv: -kv[1])[:24]}
                     for f, ops in sass_counts(path).items() if "sort" in f}
                 for v, (_, path) in built.items()},
        "ms_median": {name: {r: {how: statistics.median(x) for how, x in per.items()
                                 if how != "by_kernel"}
                             for r, per in by.items()} for name, by in ms.items()}}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

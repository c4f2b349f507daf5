"""Where Bt''s time goes: variants of `csrc/binning.cu`'s emission-tables
kernel, built side by side and timed in turns on the flagship frames.

    python gsplat_tpu_torch/scripts/tables_ablate.py [--parent TREE] [--calls 20] [--rounds 3]

On the card only. Each variant is the committed source with a text edit,
built by `scripts/ablation.py` (each edit must match, so a changed source
fails loudly rather than timing the unchanged kernel):

- `kernel`: as committed: persistent blocks, one cooperative launch, the
  prefix after one grid barrier from the tiles_post each block keeps; a
  row a thread (the conic as three scalar loads, t_lo and cum_run as two
  int4 stores a row);
- `threads_128`: blocks of 128 threads (more blocks, more block sums for
  each block to add);
- `chunk_1024`, `chunk_256`: at most 1,024 or 256 rows a block a round
  (more rounds, a barrier each);
- `blocks5`: `__launch_bounds__` asks for 5 blocks an SM (fewer registers);
- `no_barrier`: the barrier's wait taken out (cum_excl and K wrong);
- `no_runs`: the row runs not computed (tiles_post = tiles_touched, t_lo
  and cum_run 0; conic, mean2d and cull_qmax not read): the arithmetic's share;
- `all_ends`: every rect row's run ends computed, the rows outside the
  rect or the ellipse too (their runs then wrong): what skipping them saves.

With `--parent TREE`, `parent` is that tree's `csrc/binning.cu` as it is,
its Bt' (a decoupled look-back over 1,024-row blocks) called through its
own entry point with its own scan state. Cases: the flagship render frame
(1,048,576 gaussians, 1920x1080, SH 3) projected with and without the
tight cull, and the train frame's rows (the same scene padded to 2,097,152
rows, half dead). Prints one JSON line: the card; each variant's
registers, shared and local memory (`cuobjdump -res-usage`) and its launch
layout (blocks, rows a block a round, rounds, state words) on each case;
whether `kernel`, `threads_128`, `chunk_1024`, `chunk_256`, `blocks5` and
`parent` equal the twin `_emission_tables_torch` on every case; each
variant's device ms per call (the profiler, over `calls` calls with K left
on the card), its CUDA-event ms (`calls` back-to-back calls; and `calls`
calls queued behind a hold of the stream, `chip_smoke.queued_ms`, with
whether the host had queued them before the hold ended) and its host
microseconds a call (the host clock over `calls` calls with no wait for the
card) per round and case; and two yardsticks on the card: a copy of as many bytes as Bt' moves
on the render frame (69.7 MB read, 69.7 MB written) and a fill of its 89
MB of outputs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

THREADS128 = ("constexpr int TABLE_THREADS = 256;", "constexpr int TABLE_THREADS = 128;")
CHUNK = ("constexpr int TABLE_CHUNK_MAX = 8192;", "constexpr int TABLE_CHUNK_MAX = 1024;")
CHUNK256 = ("constexpr int TABLE_CHUNK_MAX = 8192;", "constexpr int TABLE_CHUNK_MAX = 256;")
NO_BARRIER = ("            while (load_volatile(state + 1) < target) __nanosleep(64);\n", "")
NO_RUNS = ("        if (io.tight_cull) {\n            const float2 m",
           "        if (false) {\n            const float2 m")
ALL_ENDS = ("        if (row_live) {\n            const float x_hi", "        if (true) {\n            const float x_hi")
BLOCKS5 = ("__launch_bounds__(TABLE_THREADS) emission_tables_kernel(",
           "__launch_bounds__(TABLE_THREADS, 5) emission_tables_kernel(")
# name: (text edits, extra nvcc flags)
VARIANTS = {
    "kernel": ([], []),
    "threads_128": ([THREADS128], []),
    "chunk_1024": ([CHUNK], []),
    "chunk_256": ([CHUNK256], []),
    "no_barrier": ([NO_BARRIER], []),
    "no_runs": ([NO_RUNS], []),
    "all_ends": ([ALL_ENDS], []),
    "blocks5": ([BLOCKS5], []),
}
COMPUTING = ("kernel", "threads_128", "chunk_1024", "chunk_256", "blocks5", "parent")
PARENT_TILE = 1024  # the parent's rows a block, one scan block each


def device_ms(fn, calls, part=""):
    """Device ms per call of the kernels whose name holds `part` over
    `calls` profiled calls (after one unprofiled call)."""
    from torch.autograd import DeviceType

    from gsplat_tpu_torch.profiling import profile_calls

    fn()
    prof = profile_calls(fn, calls)
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and part in e.key) / calls / 1e3


def parent_call(lib, state):
    """A call of the parent tree's Bt' (its `gs_emission_tables`: the
    inputs, n, tile, tight_cull, the six outputs, its scan state of flags,
    aggregates and inclusive prefixes a block and a ticket, the blocks it
    holds, a launch number). Returns fn(screen, tight, read_total)."""
    import torch

    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.ops.binning import RUN_HMAX

    fn = lib.gs_emission_tables
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(screen, tight, read_total=True):
        n, dev = screen.rect_min.shape[0], screen.rect_min.device
        i32, i64 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.int64, device=dev)
        out = (torch.empty((n, 4), **i32), torch.empty((n,), **i64),
               torch.empty((n,), dtype=torch.uint8, device=dev),
               torch.empty((n, RUN_HMAX), **i32), torch.empty((n, RUN_HMAX), **i32))
        total = torch.empty((), **i64)
        blocks = (state["scan"].numel() - 1) // 3
        state["epoch"] += 1
        args = [c.contiguous() for c in (screen.rect_min, screen.rect_max, screen.conic,
                                         screen.mean2d, screen.cull_qmax, screen.tiles_touched)]
        err = fn(*(t.data_ptr() for t in args), n, 16, int(tight), out[0].data_ptr(),
                 out[2].data_ptr(), out[3].data_ptr(), out[4].data_ptr(), out[1].data_ptr(),
                 total.data_ptr(), state["scan"].data_ptr(), blocks, state["epoch"],
                 _kernels.stream(dev))
        _kernels.check(err, "parent emission_tables")
        return *out, int(total.item()) if read_total else total
    return call


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", default=None, help="a tree whose csrc/binning.cu is timed too")
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    import chip_smoke as cs
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.device import card_line
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.scripts import ablation
    from gsplat_tpu_torch.synthetic import tiny_scene

    if not torch.cuda.is_available():
        print("tables_ablate: no CUDA device", file=sys.stderr)
        return 2
    out_dir = _kernels.BUILD_DIR / "tables_ablate"
    built = ablation.build("binning", VARIANTS, out_dir)
    libs = {v: lib for v, (lib, _) in built.items()}
    paths = {v: path for v, (_, path) in built.items()}
    dev = torch.device("cuda", 0)
    with torch.inference_mode():
        params, alive, camera = tiny_scene(**cs.FULL, device=dev)
        cases = {}
        for tight in (True, False):
            settings = make_render_settings(sh_degree=3, tight_cull=tight)
            screen, _, _ = cs.screen_of((params, alive, camera), settings, dev)
            cases[f"render_frame_tight_cull_{tight}"] = (screen.detach(), tight)
        del params, alive
        params, alive, camera = tiny_scene(**cs.FULL, capacity=2 * cs.FULL["n"], device=dev)
        screen, _, _ = cs.screen_of((params, alive, camera), make_render_settings(sh_degree=3), dev)
        cases["train_frame_rows"] = (screen.detach(), True)
        del params, alive, screen

        calls = {v: (lambda screen, tight, read_total=True: tb.emission_tables(
            screen, 16, tight, read_total)) for v in VARIANTS}
        if args.parent:
            parent = ablation.build("binning", {"parent": ([], [])}, out_dir / "parent",
                                    csrc=Path(args.parent).resolve() / "gsplat_tpu_torch" / "csrc",
                                    bind=False)
            libs["parent"], paths["parent"] = parent["parent"]
            most = max(s.rect_min.shape[0] for s, _ in cases.values())
            state = {"scan": torch.zeros((3 * -(-most // PARENT_TILE) + 1,), dtype=torch.int64,
                                         device=dev), "epoch": 0}
            calls["parent"] = parent_call(libs["parent"], state)

        def run(v, screen, tight, read_total=True):
            with ablation.loaded("binning", libs[v]):
                return calls[v](screen, tight, read_total)

        layouts, equal = {}, {}
        for v in calls:
            for name, (screen, tight) in cases.items():
                if v != "parent":
                    with ablation.loaded("binning", libs[v]):
                        layouts[f"{v}/{name}"] = tb.table_layout(screen.rect_min.shape[0])
                if v in COMPUTING:
                    got = run(v, screen, tight)
                    want = tb._emission_tables_torch(screen, 16, tight)
                    equal[f"{v}/{name}"] = got[5] == want[5] and all(
                        bool(torch.equal(a, b)) for a, b in zip(got[:5], want[:5]))
        ms = {name: {v: [] for v in calls} for name in cases}
        event_ms = {name: {v: [] for v in calls} for name in cases}
        queued_ms = {name: {v: [] for v in calls} for name in cases}
        host_us = {name: {v: [] for v in calls} for name in cases}

        def host_time(fn):
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(args.calls):
                fn()
            us = (time.perf_counter() - t) / args.calls * 1e6
            torch.cuda.synchronize()
            return us

        order = list(calls)
        for r in range(args.rounds):
            for v in (order if r % 2 == 0 else order[::-1]):
                for name, (screen, tight) in cases.items():
                    def once(v=v, screen=screen, tight=tight):
                        return run(v, screen, tight, read_total=False)
                    ms[name][v].append(device_ms(once, args.calls, "emission_"))
                    event_ms[name][v].append(cs.cuda_time(once, args.calls))
                    queued_ms[name][v].append(cs.queued_ms(once, args.calls))
                    host_us[name][v].append(host_time(once))
        n = cs.FULL["n"]
        src = torch.empty((n * 133 // 2 // 4,), dtype=torch.int32, device=dev)
        dst = torch.empty_like(src)
        fill = torch.empty((n * 89 // 4,), dtype=torch.int32, device=dev)
        yardsticks = {"copy_render_frame_bytes_ms": device_ms(lambda: dst.copy_(src), args.calls),
                      "fill_render_frame_outputs_ms": device_ms(lambda: fill.fill_(7),
                                                                args.calls)}
    print(json.dumps({
        "card": card_line(),
        "res_usage": {v: {f: u for f, u in _kernels.res_usage(path).items() if "emission" in f}
                      for v, path in paths.items()},
        "layouts": layouts, "equals_twin": equal, "device_ms": ms, "event_ms": event_ms,
        "host_us": host_us, "queued_ms": queued_ms,
        "device_ms_median": {name: {v: statistics.median(x) for v, x in per.items()}
                             for name, per in ms.items()},
        "event_ms_median": {name: {v: statistics.median(x) for v, x in per.items()}
                            for name, per in event_ms.items()},
        "host_us_median": {name: {v: statistics.median(x) for v, x in per.items()}
                           for name, per in host_us.items()},
        "queued_ms_median": {name: {v: statistics.median(ms for ms, _ in x)
                                    for v, x in per.items()}
                             for name, per in queued_ms.items()},
        "yardsticks": yardsticks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

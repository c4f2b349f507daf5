"""Where Bt''s time goes: variants of `csrc/binning.cu`'s emission-tables
kernel, built side by side and timed in turns on the flagship frames.

    python gsplat_tpu_torch/scripts/tables_ablate.py [--calls 20] [--rounds 3]

On the card only. Each variant is the committed source with a text edit,
built by `scripts/ablation.py` (each edit must match, so a changed source
fails loudly rather than timing the unchanged kernel):

- `kernel`: as committed, four rows a thread (a scan block of 1,024);
- `no_lookback`: every block publishes its own sum as its inclusive prefix
  at once (no walk back; cum_excl and K wrong);
- `rows2`, `rows1`: two rows, one row a thread (scan blocks of 512, 256);
- `rows1_no_lookback`: both.

Cases: the flagship render frame (1,048,576 gaussians, 1920x1080, SH 3)
projected with and without the tight cull, and the train frame's rows
(the same scene padded to 2,097,152 rows, half dead). Prints one JSON
line: the card, each variant's registers and local memory (`cuobjdump
-res-usage`), whether `kernel` equals the twin `_emission_tables_torch`
on every case, each variant's kernel device ms per launch (the profiler,
over `calls` launches with K left on the card) per round and case, and
two yardsticks on the card: a copy of as many bytes as Bt' moves on the
render frame (69.7 MB read, 69.7 MB written) and a fill of its 89 MB of
outputs. Only `kernel` computes the tables: the others are timings.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

ROWS = "constexpr int TABLE_ROWS = 4;"
NO_LOOKBACK = ("        if (blk == 0) {\n            if (lane == 0) publish(flag, incl, 0,",
               "        if (true) {\n            if (lane == 0) publish(flag, incl, 0,")
# name: (text edits, extra nvcc flags)
VARIANTS = {
    "kernel": ([], []),
    "no_lookback": ([NO_LOOKBACK], []),
    "rows2": ([(ROWS, "constexpr int TABLE_ROWS = 2;")], []),
    "rows1": ([(ROWS, "constexpr int TABLE_ROWS = 1;")], []),
    "rows1_no_lookback": ([(ROWS, "constexpr int TABLE_ROWS = 1;"), NO_LOOKBACK], []),
}


def device_ms(fn, calls, part=""):
    """Device ms per call of the kernels whose name holds `part` over
    `calls` profiled calls (after one unprofiled call)."""
    from torch.autograd import DeviceType

    from gsplat_tpu_torch.profiling import profile_calls

    fn()
    prof = profile_calls(fn, calls)
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and part in e.key) / calls / 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    built = ablation.build("binning", VARIANTS, _kernels.BUILD_DIR / "tables_ablate")
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
        # the scan state, sized for the variant with the most blocks
        tb._table_scan(dev, -(-2 * cs.FULL["n"] // 256))
        equal = {}
        with ablation.loaded("binning", built["kernel"][0]):
            for name, (screen, tight) in cases.items():
                got = tb.emission_tables(screen, 16, tight)
                want = tb._emission_tables_torch(screen, 16, tight)
                equal[name] = got[5] == want[5] and all(
                    bool(torch.equal(a, b)) for a, b in zip(got[:5], want[:5]))
        ms = {name: {v: [] for v in VARIANTS} for name in cases}
        for r in range(args.rounds):
            for v in (list(VARIANTS) if r % 2 == 0 else list(VARIANTS)[::-1]):
                with ablation.loaded("binning", built[v][0]):
                    for name, (screen, tight) in cases.items():
                        ms[name][v].append(device_ms(
                            lambda: tb.emission_tables(screen, 16, tight, read_total=False),
                            args.calls, "emission_tables_kernel"))
        n = cs.FULL["n"]
        src = torch.empty((n * 133 // 2 // 4,), dtype=torch.int32, device=dev)
        dst = torch.empty_like(src)
        out = torch.empty((n * 89 // 4,), dtype=torch.int32, device=dev)
        yardsticks = {"copy_render_frame_bytes_ms": device_ms(lambda: dst.copy_(src), args.calls),
                      "fill_render_frame_outputs_ms": device_ms(lambda: out.fill_(7), args.calls)}
    print(json.dumps({
        "card": card_line(),
        "res_usage": {v: [u for f, u in _kernels.res_usage(path).items() if "emission" in f]
                      for v, (_, path) in built.items()},
        "kernel_equals_twin": equal, "device_ms": ms,
        "device_ms_median": {name: {v: statistics.median(x) for v, x in per.items()}
                             for name, per in ms.items()},
        "yardsticks": yardsticks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

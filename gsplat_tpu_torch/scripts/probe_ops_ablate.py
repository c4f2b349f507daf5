"""Where a P3'/P4' probe kernel's time goes: variants of `csrc/probe_ops.cu`,
each with one part of one kernel taken out or changed, built side by side
(`scripts/ablation.py`) and timed in turns on the kernel's own inputs.

    python gsplat_tpu_torch/scripts/probe_ops_ablate.py [--reps 5] [--rounds 2]

On the card only. A variant is the committed source with text edits (each
must match it) and the kernel row it times: an `op_rate` variant, or
`blend_mix_bf16` at 256 rows. `kernel` is the source as committed, timed on
every row some variant times; only it computes the probes' functions, the
others are timings.

- `div_ieee`: `k_div` with the IEEE division in place of its reciprocal;
- `bf16_h2exp`: P4' bf16 with `h2exp` (its range fix-up) in place of the
  flush-to-zero exponential;
- `fwd_accum_no_feat_loads`: `k_fwd_accum` with `feat` read once an
  iteration instead of once a k (a warp-uniform 16-byte load);
- `two_matmuls_no_bd_loads`, `merged_no_bd_loads`: the depth's row of
  basis / bd read once an iteration instead of once a depth (three
  warp-uniform 16-byte loads).

Prints one JSON line: the card, the SM clock `nvidia-smi` read before the
runs, each library's registers, stack and local memory (`cuobjdump
-res-usage`), and the mean device ms per call of `reps` calls after one
(CUDA events), per round: `kernel` per row, each variant on its row.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BD_LOADS = ("const float4 b0 = bd_s[3 * k], b1 = bd_s[3 * k + 1];\n"
            "            const float2 b2 = *reinterpret_cast<const float2*>(bd_s + 3 * k + 2);")
BD_ONCE = ("const float4 b0 = bd_s[3 * q], b1 = bd_s[3 * q + 1];\n"
           "            const float2 b2 = *reinterpret_cast<const float2*>(bd_s + 3 * q + 2);")
# variant: (kernel row, text edits)
VARIANTS = {
    "div_ieee": ("div", [("e[m] = rcp_1_2<RCP_STEPS>(d);", "e[m] = 1.0f / d;")]),
    "bf16_h2exp": ("blend_mix_bf16", [("const __nv_bfloat162 g = exp_bf16x2(p);",
                                       "const __nv_bfloat162 g = h2exp(p);")]),
    "fwd_accum_no_feat_loads": ("fwd_accum", [(
        "                const float4 f = feat_s[4 * kk + 2 * h + j];",
        "                const float4 f = feat_s[h];")]),
    "two_matmuls_no_bd_loads": ("two_matmuls", [(BD_LOADS + "\n            const float4 yy",
                                                 BD_ONCE + "\n            const float4 yy")]),
    "merged_no_bd_loads": ("merged", [("const float yk[2] = {yy.x, yy.y};\n            " + BD_LOADS,
                                       "const float yk[2] = {yy.x, yy.y};\n            " + BD_ONCE)]),
}
# the libraries `ablation.build` makes: `kernel` unedited, then each variant
LIBRARIES = {"kernel": ([], []), **{name: (edits, []) for name, (_, edits) in VARIANTS.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)

    import torch

    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.device import card_line
    from gsplat_tpu_torch.probes import bf16_rate, op_rate, time_ms
    from gsplat_tpu_torch.scripts import ablation

    if not torch.cuda.is_available():
        print("probe_ops_ablate: no CUDA device", file=sys.stderr)
        return 2
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip()
    libs = ablation.build("probe_ops", LIBRARIES, _kernels.BUILD_DIR / "probe_ops_ablate")
    dev = torch.device("cuda")
    calls = {}
    for row in dict.fromkeys(row for row, _ in VARIANTS.values()):
        if row in op_rate.VARIANTS:
            ins = op_rate.inputs(row, dev)
            calls[row] = (lambda ins=ins, row=row: op_rate.WRAPPERS[row](*ins))
        else:
            x = bf16_rate.inputs(bf16_rate.SHAPES[0], torch.bfloat16, dev)
            calls[row] = (lambda x=x: bf16_rate.WRAPPERS[torch.bfloat16](x))
    # (library, row) in the order they are timed
    runs = [*(("kernel", row) for row in calls), *((n, row) for n, (row, _) in VARIANTS.items())]

    @contextlib.contextmanager
    def loaded(lib):
        load = _kernels.load
        _kernels.load = lambda name: lib if name == "probe_ops" else load(name)
        try:
            yield
        finally:
            _kernels.load = load

    ms = {f"{name}:{row}": [] for name, row in runs}
    for _ in range(args.rounds):
        for name, row in runs:
            with loaded(libs[name][0]):
                ms[f"{name}:{row}"].append(time_ms(calls[row], args.reps, dev))
    build_facts = {name: {f[-40:]: (u["REG"], u["STACK"], u["LOCAL"])
                          for f, u in _kernels.res_usage(path).items()}
                   for name, (_, path) in libs.items()}
    print(json.dumps({"card": card_line(), "clocks_sm_max_sm": clock, "build": build_facts,
                      "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

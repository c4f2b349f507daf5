"""Time the probe kernels of two trees of this repository in one process,
in alternated pairs, so that a redesign is compared with its parent on one
card.

    python gsplat_tpu_torch/scripts/probe_ab.py --parent TREE [--change TREE] [--pairs 3]

Run it as a file, not with `-m`. Each tree's `gsplat_tpu_torch` is imported
under its own module table and builds its own `csrc/probe_ops.cu` and
`csrc/probe_skeleton.cu` into its own `_build/`; a tree's wrappers run with
its table in place, so the two never share a module or a library. On the
card only. For every kernel row (the twelve `op_<variant>` of
`probes.op_rate` at 1000 iterations, `blend_mix_<dtype>` of
`probes.bf16_rate` at 256 and 512 rows, 2000 iterations, and the skeletons
`skel_fwd` and `skel_bwd` of `probes.ablate` on the flagship frame of
`scripts/skeleton_ablate.py`, 1,048,576 gaussians at 1920x1080) it times
parent, change, change, parent, `--pairs` times in all (the last an odd half when `--pairs` is
odd), each a mean of `--reps` calls after one between CUDA events, on both
trees' own inputs (the same seeded arrays; the skeletons the same frame);
and whether the two trees' outputs are equal bit for bit.
For both trees it also counts each probe kernel's hot loop by pipe, per
warp and pass (`probe_loops` of the change's `probes/floors.py`, with its
`SASS_PROBES` names and warp-uniform loads). Prints one
JSON line: the card and its power limit, `nvidia-smi`'s SM clocks before
and after, per row both trees' times in call order, their medians and the
change's median over the parent's, and the loop counts.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

PKG = "gsplat_tpu_torch"


def _ours(name: str) -> bool:
    return name == PKG or name.startswith(PKG + ".")


def load_tree(root: Path) -> dict:
    """The tree's modules (`op_rate`, `bf16_rate`, `ablate`, `_kernels`,
    `probes`, what the skeletons' frame is built with, and what they import
    of the package), imported from `root` and then taken out of
    `sys.modules` again."""
    saved = {k: v for k, v in sys.modules.items() if _ours(k)}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    try:
        for mod in ("probes.op_rate", "probes.bf16_rate", "probes.ablate", "_kernels",
                    "core.types", "ops.binning", "ops.projection", "render", "synthetic"):
            importlib.import_module(f"{PKG}.{mod}")
        for mod in ("probes.floors", "scripts.skeleton_ablate"):
            if (root / PKG / (mod.replace(".", "/") + ".py")).exists():
                importlib.import_module(f"{PKG}.{mod}")
        mods = {k: v for k, v in sys.modules.items() if _ours(k)}
    finally:
        sys.path.remove(str(root))
        for k in [k for k in sys.modules if _ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
    return mods


@contextlib.contextmanager
def active(mods: dict):
    """The tree's module table in place of any other, for calls whose
    wrappers import the package at call time."""
    saved = {k: v for k, v in sys.modules.items() if _ours(k)}
    for k in saved:
        del sys.modules[k]
    sys.modules.update(mods)
    try:
        yield
    finally:
        for k in mods:
            sys.modules.pop(k, None)
        sys.modules.update(saved)


def rows(mods: dict, device, frame) -> dict:
    """{row: call} of one tree; `frame` is the skeletons' (inst_t,
    tile_start, tile_end, grid_x, grid_y)."""
    op_rate, bf16_rate = mods[f"{PKG}.probes.op_rate"], mods[f"{PKG}.probes.bf16_rate"]
    ablate = mods[f"{PKG}.probes.ablate"]
    out = {}
    for name in op_rate.VARIANTS:
        ins = op_rate.inputs(name, device)
        out[f"op_{name}"] = lambda ins=ins, name=name: op_rate.WRAPPERS[name](*ins)
    for key, dtype_name in (("f32", "float32"), ("bf16", "bfloat16")):
        import torch

        dtype = getattr(torch, dtype_name)
        for shape in bf16_rate.SHAPES:
            x = bf16_rate.inputs(shape, dtype, device)
            row = f"blend_mix_{key}" + ("_512" if shape[0] == 512 else "")
            out[row] = lambda x=x, dtype=dtype: bf16_rate.WRAPPERS[dtype](x)
    import torch

    per_pixel = torch.ones((frame[3] * frame[4], 256, 8), device=device)
    out["skel_fwd"] = lambda: ablate.skel_fwd(*frame)
    out["skel_bwd"] = lambda: ablate.skel_bwd(*frame, per_pixel, per_pixel)
    return out


def loop_counts(trees: dict) -> dict:
    """{tree: {kernel row: per-pipe counts of one warp's pass through the
    hot loop}} from `cuobjdump -sass` of each tree's probe_ops library."""
    floors = trees["change"][f"{PKG}.probes.floors"]
    out = {}
    for label, mods in trees.items():
        kernels = mods[f"{PKG}._kernels"]
        tool = Path(kernels.nvcc_path()).parent / "cuobjdump"
        with active(mods):
            lib = kernels.library_path("probe_ops")
        text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
        out[label] = {row: got["per_body"]
                      for row, got in floors.probe_loops(text, missing_ok=True).items()}
    return out


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", required=True)
    p.add_argument("--change", default=str(Path(__file__).resolve().parents[2]))
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_ab: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    trees = {"parent": load_tree(Path(args.parent).resolve()),
             "change": load_tree(Path(args.change).resolve())}
    jobs = []
    for label, mods in trees.items():
        with active(mods):
            jobs += [(label, mods[f"{PKG}._kernels"]._start_build(source))
                     for source in ("probe_ops", "probe_skeleton")]
    for label, job in jobs:
        if job is not None:
            with active(trees[label]):
                trees[label][f"{PKG}._kernels"]._finish_build(job)
    with active(trees["change"]):
        frame = trees["change"][f"{PKG}.scripts.skeleton_ablate"].flagship_frame(device)
    calls = {}
    for label, mods in trees.items():
        with active(mods):
            calls[label] = rows(mods, device, frame)
    probes = trees["change"][f"{PKG}.probes"]
    clocks_before = smi("clocks.sm,clocks.max.sm")
    out = {}
    order = ["parent", "change", "change", "parent"] * ((args.pairs + 1) // 2)
    order = order[:2 * args.pairs]
    for row in calls["change"]:
        times = {"parent": [], "change": []}
        for label in order:
            with active(trees[label]):
                times[label].append(probes.time_ms(calls[label][row], args.reps, device))
        with active(trees["parent"]):
            a = calls["parent"][row]()
        with active(trees["change"]):
            b = calls["change"][row]()
        pm, cm = statistics.median(times["parent"]), statistics.median(times["change"])
        out[row] = {**times, "parent_median": pm, "change_median": cm, "change_over_parent": cm / pm,
                    "outputs_equal": bool(torch.equal(a, b))}
    print(json.dumps({"card": smi("name,power.limit"), "clocks_sm_max_sm_before": clocks_before,
                      "clocks_sm_max_sm_after": smi("clocks.sm,clocks.max.sm"), "order": order,
                      "reps": args.reps, "rows": out,
                      "loop_counts": loop_counts(trees)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

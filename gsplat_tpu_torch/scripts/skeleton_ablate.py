"""Where the skeleton P1''s time goes, and what K2''s own staging costs:
variants of `csrc/probe_skeleton.cu` and `csrc/rasterize_fwd.cu`, built
side by side (`scripts/ablation.py`) and timed in turns on the flagship
frame (1,048,576 gaussians, SH 3, 1920x1080, seed 0: the frame K2' blends
on the render path).

    python gsplat_tpu_torch/scripts/skeleton_ablate.py [--parent TREE] [--reps 20] [--rounds 3] [--sass DIR]

On the card only. A variant is a source with text edits (each must match
it); only the unedited `kernel` computes P1''s function, the others are
timings. Variants of the committed P1' (bulk copies through a ring of
mbarrier stages, in persistent blocks):

- `one_block_per_tile`: a grid of one block a tile, not the persistent
  grid of SMs x resident blocks;
- `batch_<b>_ring_<r>`: stages of b instances (not 512), r of them in the
  ring (not 2); `batch_256_ring_4` is the first design, ten bulk copies of
  at most 1 KB a batch of 256; with `_7_blocks`, launch bounds that ask
  for 7 resident blocks an SM (not the 5 that 40 registers a thread give);
- `coalesced_output`: the output written as 512 consecutive 16-byte stores
  a tile (thread i the i-th and the (256 + i)-th), not each pixel's 32
  bytes by its own thread;
- `no_output`: the output stores left out (a store under a condition that
  never holds keeps the sum live);
- `row0_only`: row 0 copied alone, the nine others not (the chunk heads
  are all the sum reads, so P1''s function is unchanged, but the probe's
  work is not).

With `--parent TREE`, the variants of the P1' before bulk copies (one block
of 256 threads a tile, scalar loads into volatile shared stores) are built
from that tree's `csrc/probe_skeleton.cu`: `parent` as it is; `no_output`;
`float4_output` (two 16-byte stores a thread); `no_staging` (the batch loop
left out); `nonvolatile` (the staging stores not volatile, one shared read
of a row another thread wrote keeping them live); `no_head_read` (the read
of the head before the range left out).

`k2` is K2' (`csrc/rasterize_fwd.cu`) as committed and `k2_skeleton` K2'
with its pair loop compiled out: the staging (ten rows, the pixel box),
the barriers and the output stay, and one shared read of every staged
field of another thread's slot keeps the stores live. `k2_skeleton / k2`
is K2''s staging share.

Prints one JSON line: the card, the SM clock `nvidia-smi` read before the
runs, the frame's instances and tiles, whether `kernel` (and `parent`)
equal the twin bit for bit, each library's registers, stack, shared and
local memory (`cuobjdump -res-usage`), P1''s launch facts
(`probes.ablate.skel_fwd_info`), and the mean device ms per call of `reps`
calls after one (CUDA events), per round, in the order timed (reversed
every other round). With `--sass DIR` the SASS of P1' (and of the
parent's) goes to files in DIR.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FULL = dict(n=1_048_576, width=1920, height=1080, sh_degree=3)

PARENT_OUTPUT = ("    float* o = out + ((long long)t * PPT + tid) * 8;\n"
                 "#pragma unroll\n"
                 "    for (int c = 0; c < 8; ++c) o[c] = acc;\n")
PARENT_HEADS = ("        for (int h = (b0 + CHUNK - 1) / CHUNK * CHUNK; h < b0 + nb; h += CHUNK)\n"
                "            acc = fmaf(staged[0][h - b0], HEAD_SCALE, acc);\n")
# variant: text edits of the parent tree's csrc/probe_skeleton.cu
PARENT_VARIANTS = {
    "no_output": [(PARENT_OUTPUT, "    if (acc == 1.0f) out[t] = acc;  // never: keeps acc live\n")],
    "float4_output": [(PARENT_OUTPUT,
                       "    float4* o = reinterpret_cast<float4*>(out + ((long long)t * PPT + tid) * 8);\n"
                       "    o[0] = make_float4(acc, acc, acc, acc);\n"
                       "    o[1] = make_float4(acc, acc, acc, acc);\n")],
    "no_staging": [("    for (int b0 = s; b0 < e; b0 += PPT) {", "    for (int b0 = e; b0 < e; b0 += PPT) {")],
    "nonvolatile": [
        ("    volatile float(*staged)[PPT] = batch;",
         "    float(*staged)[PPT] = batch;\n    float live = 0.0f;"),
        (PARENT_HEADS, PARENT_HEADS + "        live += staged[tid % N_ATTR][(tid * 7) % nb];\n"),
        (PARENT_OUTPUT, "    if (live == 12345.0f) acc = live;\n" + PARENT_OUTPUT)],
    "no_head_read": [("    if (e > s && base * CHUNK < s) acc = fmaf(inst_t[(long long)base * CHUNK], "
                      "HEAD_SCALE, acc);\n", "")],
}
# the parent's entry point: (inst_t, k, tile_start, tile_end, num_tiles, out, stream)
PARENT_SIGNATURE = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)

OUTPUT = ("            o[0] = v;\n"
          "            o[1] = v;\n")
# variant: text edits of the committed csrc/probe_skeleton.cu
SKELETON_VARIANTS = {
    "one_block_per_tile": [("skel_fwd_kernel<<<(num_tiles < cap ? num_tiles : cap), FWD_THREADS",
                            "skel_fwd_kernel<<<num_tiles, FWD_THREADS")],
    **{f"batch_{b}_ring_{r}": [("constexpr int FWD_BATCH = 512;", f"constexpr int FWD_BATCH = {b};"),
                               ("constexpr int FWD_STAGES = 2;", f"constexpr int FWD_STAGES = {r};")]
       for b, r in ((256, 4), (512, 4), (1024, 2), (1024, 3), (1024, 1))},
    **{f"batch_{b}_ring_{r}_7_blocks": [
        ("constexpr int FWD_BATCH = 512;", f"constexpr int FWD_BATCH = {b};"),
        ("constexpr int FWD_STAGES = 2;", f"constexpr int FWD_STAGES = {r};"),
        ("__launch_bounds__(FWD_THREADS)", "__launch_bounds__(FWD_THREADS, 7)")]
       for b, r in ((512, 1), (256, 2))},
    "coalesced_output": [(
        "            float4* o = reinterpret_cast<float4*>(out + ((long long)t * PPT + tid) * 8);\n",
        "            float4* o = reinterpret_cast<float4*>(out + (long long)t * PPT * 8) + tid;\n"),
        (OUTPUT, "            o[0] = v;\n            o[PPT] = v;\n")],
    "no_output": [(OUTPUT, "            if (acc == 1.0f) o[0] = v;  // never: keeps acc live\n")],
    "row0_only": [("    for (int r = 0; r < (nb > 0 ? N_ATTR : 0); ++r) {",
                   "    for (int r = 0; r < (nb > 0 ? 1 : 0); ++r) {")],
}
# K2' with its pair loop compiled out
K2_VARIANTS = {
    "k2_skeleton": [
        ("    bool done = false;\n", "    bool done = false;\n    float sink = 0.0f;\n"),
        ("        for (int c = 0; c < nb; c += 32) {",
         "        {\n"
         "            const int q = (tid + 1) % nb;\n"
         "            const float4 a = batch[0][q], b = batch[1][q], d = batch[2][q];\n"
         "            sink += ((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + (b.z + b.w))\n"
         "                    + (d.x + d.y) + ((box[0][q] + box[1][q]) + (box[2][q] + box[3][q]))\n"
         "                    + box[4][q];\n"
         "        }\n"
         "        for (int c = nb; c < nb; c += 32) {"),
        ("    o[7] = 0.0f;", "    o[7] = sink;")],
}
# the libraries `ablation.build` makes: `kernel` unedited, then each variant
LIBRARIES = {"kernel": ([], []), **{n: (e, []) for n, e in SKELETON_VARIANTS.items()}}
PARENT_LIBRARIES = {"parent": ([], []), **{n: (e, []) for n, e in PARENT_VARIANTS.items()}}
K2_LIBRARIES = {"k2": ([], []), **{n: (e, []) for n, e in K2_VARIANTS.items()}}


def flagship_frame(device):
    """The flagship frame's packed bins: (inst_t, tile_start, tile_end,
    grid_x, grid_y)."""
    import torch

    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops.binning import pack_bins
    from gsplat_tpu_torch.ops.projection import preprocess
    from gsplat_tpu_torch.render import grid_dims
    from gsplat_tpu_torch.synthetic import tiny_scene

    params, alive, camera = tiny_scene(**FULL, device=device)
    gx, gy = grid_dims(camera, 16)
    with torch.no_grad():
        screen = preprocess(params, alive, camera, make_render_settings(sh_degree=3), gx, gy)
        pb = pack_bins(screen, gx, gy)
    return pb.inst_t, pb.tile_start, pb.tile_end, gx, gy


# P1''s edge cases: (rows, columns) of a seeded table; K % 4 != 0 but for
# one, and in the (10, K) table the last row's last floats lie past the
# table's last whole 16-byte group
EDGE_TABLES = ((16, 4099), (16, 3200), (10, 4097))


def edge_ranges(k, device="cpu"):
    """Eight tiles' ranges in a table of k >= 3200 columns, as (tile_start,
    tile_end, grid_x, grid_y): an empty tile, a single instance off 16
    bytes, a range from a chunk's middle and off 16 bytes, one from column
    0, one of 1,599 instances and one of 2,895, longer than P1''s ring (4
    and 6 batches of 512 into 2 stages), one from a chunk's start, one to
    the table's end."""
    import torch

    starts = [100, 257, 130, 0, 1001, 5, 2688, k - 611]
    ends = [100, 258, 700, 37, 2600, 2900, 2900, k]
    return (torch.tensor(starts, dtype=torch.int32, device=device),
            torch.tensor(ends, dtype=torch.int32, device=device), 4, 2)


def edge_table(rows, k, device="cpu"):
    """A seeded (rows, k) float32 table."""
    import numpy as np
    import torch

    rng = np.random.default_rng(k)
    return torch.from_numpy(rng.normal(0.0, 100.0, (rows, k)).astype(np.float32)).to(device)


def function_sass(text: str, part: str) -> str:
    """The SASS of the one kernel function whose name holds `part`."""
    blocks = re.split(r"(?=\n\s*Function : )", text)
    hits = [b for b in blocks if re.search(r"Function : \S*" + re.escape(part), b)]
    if len(hits) != 1:
        raise RuntimeError(f"{len(hits)} functions match {part}")
    return hits[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", default=None)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--sass", default=None)
    args = p.parse_args(argv)

    import torch

    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.device import card_line
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.probes import ablate, time_ms
    from gsplat_tpu_torch.scripts import ablation

    if not torch.cuda.is_available():
        print("skeleton_ablate: no CUDA device", file=sys.stderr)
        return 2
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip()
    out_dir = _kernels.BUILD_DIR / "skeleton_ablate"
    libs = {("probe_skeleton", n): v
            for n, v in ablation.build("probe_skeleton", LIBRARIES, out_dir).items()}
    libs.update({("rasterize_fwd", n): v
                 for n, v in ablation.build("rasterize_fwd", K2_LIBRARIES, out_dir).items()})
    if args.parent:
        parent = ablation.build("probe_skeleton", PARENT_LIBRARIES, out_dir / "parent",
                                csrc=Path(args.parent).resolve() / "gsplat_tpu_torch" / "csrc",
                                bind=False)
        for lib, _ in parent.values():
            lib.gs_skel_fwd.argtypes = list(PARENT_SIGNATURE)
            lib.gs_skel_fwd.restype = ctypes.c_int
        libs.update({("parent", n): v for n, v in parent.items()})
    dev = torch.device("cuda")
    inst_t, starts, ends, gx, gy = fargs = flagship_frame(dev)
    want = ablate.skel_fwd_torch(*fargs)

    def parent_call(lib):
        out = torch.empty_like(want)
        _kernels.check(lib.gs_skel_fwd(inst_t.data_ptr(), inst_t.shape[1], starts.data_ptr(),
                                       ends.data_ptr(), gx * gy, out.data_ptr(),
                                       _kernels.stream(dev)), "parent skel_fwd")
        return out

    calls = {}
    for key, (lib, _) in libs.items():
        if key[0] == "parent":
            calls[key] = lambda lib=lib: parent_call(lib)
        elif key[0] == "probe_skeleton":
            calls[key] = lambda: ablate.skel_fwd(*fargs)
        else:
            calls[key] = lambda: rc.blend_fwd(*fargs)

    def run(key):
        with ablation.loaded(key[0], libs[key][0]):
            return calls[key]()

    equal = {name: bool(torch.equal(run(key).view(torch.int32), want.view(torch.int32)))
             for key in (("probe_skeleton", "kernel"), ("parent", "parent")) if key in libs
             for name in (key[1],)}
    with ablation.loaded("probe_skeleton", libs[("probe_skeleton", "kernel")][0]):
        info = ablate.skel_fwd_info()
    order = list(libs)
    ms = {f"{src}:{name}": [] for src, name in order}
    for r in range(args.rounds):
        for key in (order if r % 2 == 0 else order[::-1]):
            with ablation.loaded(key[0], libs[key][0]):
                ms[f"{key[0]}:{key[1]}"].append(time_ms(calls[key], args.reps, dev))
    build_facts = {f"{src}:{name}": {f[-40:]: u for f, u in _kernels.res_usage(path).items()}
                   for (src, name), (_, path) in libs.items()}
    if args.sass:
        tool = Path(_kernels.nvcc_path()).parent / "cuobjdump"
        for key in (("probe_skeleton", "kernel"), ("parent", "parent")):
            if key in libs:
                text = subprocess.run([str(tool), "-sass", str(libs[key][1])], capture_output=True,
                                      text=True, timeout=120, check=True).stdout
                Path(args.sass).mkdir(parents=True, exist_ok=True)
                (Path(args.sass) / f"skel_fwd_{key[1]}.sass").write_text(
                    function_sass(text, "skel_fwd_kernel"))
    print(json.dumps({"card": card_line(), "clocks_sm_max_sm": clock,
                      "instances": int(ends.max()), "tiles": gx * gy,
                      "equals_twin": equal, "skel_fwd_info": info, "build": build_facts,
                      "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

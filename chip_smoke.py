#!/usr/bin/env python
"""On-card smoke run of gsplat_tpu_torch: build, check and time the kernels
on the render path, then drive that path through its entry points.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one) and `nvcc`. Prints one
JSON line per phase:

1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
2. the kernel build (one `nvcc` per source, all at once) and its time;
3. K1' (binning: `expand_instances` + `pack_instances`) against its plain
   twin on the same device, on the seeded 65,536-gaussian scene at 640x480,
   SH 3: ranges and instance order equal, instance table bitwise equal, with
   tight_cull on and off and on an empty scene;
4. K2' (sorted forward blend, `blend_fwd`) against its plain twin on that
   scene, with track_contrib on and off and at 200x120 (not a multiple of
   16): atol 2e-5 on rgb, invdepth and final_T, n_contrib exact;
5. the main path at full width: 1,048,576 gaussians, SH 3, 1920x1080, float32
   packets, through `render(..., device="cuda")` — 5 warm-up and 20 timed
   frames with the launch counts reset just before and read just after; a
   per-stage breakdown; each kernel's time against its plain twin, its bound
   and its error on 64 seeded tiles of the frame;
6. the render CLI on a seeded 3-view Blender-format scene and PLY snapshot;
7. the kernels line: one JSON object with every kernel's launches on the
   main path, times, bound and error.

Then the card's name and power limit on a line of their own, and last the
line `{"ok": true, "device": {...}}`. Every failed check raises, so the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# float32 operations every evaluated (pixel, instance) pair needs before the
# keep test: 2 subtractions, 8 for the conic quadratic, 1 compare (pairs that
# pass do more; this is the least work the run's data needs)
BLEND_OPS_PER_PAIR = 11

DEVICE = "cuda"
SCENE = dict(n=65_536, width=640, height=480, sh_degree=3)
FULL = dict(n=1_048_576, width=1920, height=1080, sh_degree=3)
CLI = dict(size=800, n=200_000)
WARMUP, TIMED = 5, 20
CHECK_TILES = 64
ATOL = 2e-5


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_time(fn, reps):
    """Mean device ms of `fn()` over `reps` calls after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# trace categories of the chrome trace that `torch.profiler` exports
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def interval_union(spans):
    """Total length covered by the (start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def device_profile(frame, frames=3, top=10):
    """Device activity over `frames` profiled frames, from `torch.profiler`.

    `busy_share` is read off the trace: the union of the device's kernel,
    copy and set intervals over the trace's span of those frames (first host
    op to last event end), so it cannot exceed 1. The profiled frames run
    slower than unprofiled ones (`profiled_frame_ms`); the share is theirs.
    Also the summed device time per kernel name, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
    # device-side events only: the CPU-side op rows repeat their kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3 / frames, e.count / frames)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = [e for e in (trace["traceEvents"] if isinstance(trace, dict) else trace)
              if e.get("ph") == "X" and "dur" in e]
    def spans(cats):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e.get("cat") in cats]

    device, host = spans(DEVICE_CATS), spans(HOST_CATS)
    check(device and host, "profiler trace holds no device or no host events")
    t0 = min(s for s, _ in host)
    t1 = max(e for _, e in device + host)
    busy = interval_union([(max(s, t0), min(e, t1)) for s, e in device if min(e, t1) > max(s, t0)])
    return {
        "device_ms_per_frame": sum(r[1] for r in rows),
        "kernels_per_frame": sum(r[2] for r in rows),
        "profiled_frame_ms": (t1 - t0) / 1e3 / frames,
        "busy_ms_per_frame": busy / 1e3 / frames,
        "busy_share": busy / (t1 - t0),
        "top_kernels": [{"kernel": k[:120], "ms_per_frame": ms, "calls_per_frame": c}
                        for k, ms, c in rows[:top]],
    }


def reset_counts(*wrappers):
    for w in wrappers:
        w.launches = 0


def screen_of(scene, settings, device):
    from gsplat_tpu_torch.ops.projection import preprocess
    from gsplat_tpu_torch.render import grid_dims

    params, alive, camera = scene
    gx, gy = grid_dims(camera, 16)
    return preprocess(params, alive, camera, settings, gx, gy), gx, gy


def phase_binning(device):
    """K1' vs pack_bins_torch: exact equality."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.synthetic import tiny_scene

    scene = tiny_scene(**SCENE, device=device)
    cases = []
    for name, tight, alive in (("tight_cull", True, None), ("rect", False, None),
                               ("empty", True, torch.zeros_like(scene[1]))):
        sc = scene if alive is None else (scene[0], alive, scene[2])
        screen, gx, gy = screen_of(sc, make_render_settings(sh_degree=3, tight_cull=tight), device)
        kb = tb.pack_bins(screen, gx, gy, 16, tight)
        pb = tb.pack_bins_torch(screen, gx, gy, 16, tight)
        check(kb.num_instances == pb.num_instances, f"{name}: instance count")
        for f in ("tile_start", "tile_end", "gauss_id", "tile_id"):
            check(torch.equal(getattr(kb, f), getattr(pb, f)), f"{name}: {f} differs")
        check(torch.equal(kb.inst_t, pb.inst_t), f"{name}: inst_t not bitwise equal")
        check(name != "empty" or kb.num_instances == 0, "empty scene emits instances")
        cases.append({"case": name, "instances": kb.num_instances})
    return cases


def blend_errors(out, ref):
    err = float((out[..., :5] - ref[..., :5]).abs().max()) if out.numel() else 0.0
    n_equal = bool(torch.equal(out[..., 5], ref[..., 5]))
    return err, n_equal


def max_abs_diff(kernel, names, outs, refs):
    """Largest |kernel - plain| over the kernel's outputs; checks it is 0
    (integer outputs are compared exactly, as differences of integers)."""
    err = 0.0
    for name, a, b in zip(names, outs, refs):
        check(a.shape == b.shape and a.dtype == b.dtype, f"{kernel} vs plain: {name} shape/dtype")
        if a.numel():
            err = max(err, float((a - b).abs().max()))
    check(err == 0.0, f"{kernel} vs plain: max abs err {err}")
    return err


def phase_blend(device):
    """K2' vs blend_packed_torch: atol 2e-5, n_contrib exact."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.synthetic import tiny_scene

    cases = []
    for w, h in ((SCENE["width"], SCENE["height"]), (200, 120)):
        scene = tiny_scene(**{**SCENE, "width": w, "height": h}, device=device)
        screen, gx, gy = screen_of(scene, make_render_settings(sh_degree=3), device)
        pb = tb.pack_bins(screen, gx, gy)
        for track in (True, False):
            args = (pb.inst_t, pb.tile_start, pb.tile_end, gx, gy, track)
            err, n_equal = blend_errors(rc.blend_fwd(*args), rc.blend_packed_torch(*args))
            check(err <= ATOL, f"blend {w}x{h} track={track}: max abs err {err}")
            check(n_equal, f"blend {w}x{h} track={track}: n_contrib differs")
            cases.append({"size": f"{w}x{h}", "track_contrib": track, "max_abs_err": err})
        # the keep rule on non-finite inputs: a NaN conic or opacity drops the pair
        nan_t = pb.inst_t.clone()
        nan_t[2, ::7] = float("nan")
        nan_t[5, 3::11] = float("nan")
        args = (nan_t, pb.tile_start, pb.tile_end, gx, gy, True)
        err, n_equal = blend_errors(rc.blend_fwd(*args), rc.blend_packed_torch(*args))
        check(err <= ATOL and n_equal, f"blend {w}x{h} NaN rows: max abs err {err}")
        cases.append({"size": f"{w}x{h}", "nan_rows": True, "max_abs_err": err})
    return cases


def phase_main_path(device):
    """The full-width render through `render`, then per-kernel measurements."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops.rasterize_torch import tiles_to_image
    from gsplat_tpu_torch.render import grid_dims, render
    from gsplat_tpu_torch.synthetic import tiny_scene

    t0 = time.perf_counter()
    params, alive, camera = tiny_scene(**FULL, device=device)
    settings = make_render_settings(sh_degree=3, packet_dtype="float32")
    bg = [0.0, 0.0, 0.0]
    setup_s = time.perf_counter() - t0
    kernels = (tb.expand_instances, tb.pack_instances, rc.blend_fwd)

    # --- the main path: counts reset just before, read just after
    reset_counts(*kernels)
    frame_ms = []
    for i in range(WARMUP + TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = render(camera, params, alive, settings, bg, device=DEVICE)
        torch.cuda.synchronize()
        if i >= WARMUP:
            frame_ms.append((time.perf_counter() - t) * 1e3)
    launches = {w.__name__: w.launches for w in kernels}
    frames = WARMUP + TIMED
    for name, n in launches.items():
        check(n == frames, f"{name} launched {n} times over {frames} frames")
    img = out["render"]
    check(img.shape == (FULL["height"], FULL["width"], 3), "image shape")
    check(bool(torch.isfinite(img).all()), "image has non-finite values")
    check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, "image outside [0, 1]")
    check(float(img.std()) > 0.01, "image is flat")
    check(out["instance_overflow"] == 0 and out["tile_overflow"] == 0, "overflow")

    # --- device busy time per frame and the kernels that take it (profiler
    # over a few render() calls; the launch counts were read above)
    profile = device_profile(lambda: render(camera, params, alive, settings, bg, device=DEVICE))

    # --- per-stage breakdown of the same frame, stage by stage
    gx, gy = grid_dims(camera, 16)
    num_tiles = gx * gy
    stages = ("preprocess", "binning_tables", "K1_expand", "sort", "K1_pack", "K2_blend", "composite")
    stage_ms = {s: [] for s in stages}
    for i in range(WARMUP + TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        screen, _, _ = screen_of((params, alive, camera), settings, device)
        ev[1].record()
        tables = tb._emission_tables(screen.detach(), 16, True)
        ev[2].record()
        keys, gid = tb.expand_instances(*tables[:5], screen.depth, tables[5], gx, True)
        ev[3].record()
        keys_sorted, perm = torch.sort(keys, stable=True)
        ev[4].record()
        inst_t, gauss_id, tile_id, bounds = tb.pack_instances(keys_sorted, perm, gid, screen, num_tiles)
        ev[5].record()
        blended = rc.blend_fwd(inst_t, bounds[:num_tiles], bounds[1:], gx, gy)
        ev[6].record()
        color = blended[..., 0:3] + blended[..., 4:5] * torch.zeros(3, device=device)
        image = torch.clamp(tiles_to_image(color, gx, gy, 16, camera.width, camera.height), 0.0, 1.0)
        ev[7].record()
        torch.cuda.synchronize()
        if i >= WARMUP:
            for j, s in enumerate(stages):
                stage_ms[s].append(ev[j].elapsed_time(ev[j + 1]))
    check(torch.equal(image, img), "stage-by-stage frame differs from render()")
    k = tables[5]
    n = params.xyz.shape[0]

    # --- K2' against its plain twin on 64 seeded tiles; the plain twin on the
    # whole frame gives its time and the evaluated pair count
    starts, ends = bounds[:num_tiles], bounds[1:]
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain_blend, pairs = rc.blend_packed_torch(inst_t, starts, ends, gx, gy, count_pairs=True)
    torch.cuda.synchronize()
    blend_plain_ms = (time.perf_counter() - t) * 1e3
    sel = torch.as_tensor(np.random.default_rng(0).choice(num_tiles, CHECK_TILES, replace=False),
                          device=device)
    blend_err, n_equal = blend_errors(blended[sel], plain_blend[sel])
    check(blend_err <= ATOL and n_equal, f"K2' on 64 frame tiles: max abs err {blend_err}")
    full_err, _ = blend_errors(blended, plain_blend)

    # --- K1' against its plain twins at the frame's shapes
    exp_args = (*tables[:5], screen.depth, k, gx, True)
    exp_err = max_abs_diff("expand_instances", ("keys", "gid"), (keys, gid),
                           tb._expand_instances_torch(*exp_args))
    pack_args = (keys_sorted, perm, gid, screen, num_tiles)
    pack_err = max_abs_diff("pack_instances", ("inst_t", "gauss_id", "tile_id", "bounds"),
                            (inst_t, gauss_id, tile_id, bounds),
                            tb._pack_instances_torch(*pack_args))

    def ms_pair(kernel, plain, args, reps, plain_reps):
        return cuda_time(lambda: kernel(*args), reps), cuda_time(lambda: plain(*args), plain_reps)

    exp_ms, exp_plain_ms = ms_pair(tb.expand_instances, tb._expand_instances_torch, exp_args, 20, 3)
    pack_ms, pack_plain_ms = ms_pair(tb.pack_instances, tb._pack_instances_torch, pack_args, 20, 3)
    blend_args = (inst_t, starts, ends, gx, gy)
    blend_ms = cuda_time(lambda: rc.blend_fwd(*blend_args), 20)
    sort_ms = cuda_time(lambda: torch.sort(keys, stable=True), 20)

    # --- bounds: bytes read once + written once at the HBM rate, or the
    # run's float32 operations at the FP32 rate, whichever is larger
    def bound(nbytes, ops=0):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    # what this run's data needs the binning kernels to read: every gaussian's
    # tile count; the rest of the rect, cum_excl, depth and the trimmed flag
    # only for live rows (count > 0); cum_run (all 8 rows) only for trimmed
    # live rows, and t_lo only for their rows that hold a run
    rect, _, trimmed, _, cum_run = tables[:5]
    live_rows = rect[:, 3] > 0
    trim_rows = live_rows & trimmed.bool()
    run_len = torch.diff(cum_run[trim_rows], dim=1, append=rect[trim_rows, 3:4])
    live, trimmed_live, run_rows = (int(x) for x in (live_rows.sum(), trim_rows.sum(),
                                                     (run_len > 0).sum()))
    # expand: key 8 + gid 4 per instance out
    exp_bound = bound(n * 4 + live * (12 + 8 + 4 + 1) + trimmed_live * 32 + run_rows * 4
                      + k * 12)
    # pack: key 8 + perm 8 + gid 4 per instance and 40 B of columns per live
    # gaussian (the only ones an instance points at) in; 16 table rows +
    # gauss_id + tile_id per instance and the T+1 bounds out
    pack_bound = bound(k * 20 + live * 40 + k * (64 + 8) + (num_tiles + 1) * 4)
    # blend: 10 table rows per instance + 2 ranges per tile in; (T, 256, 8) out
    blend_bound = bound(k * 40 + num_tiles * 8 + num_tiles * 256 * 32, pairs * BLEND_OPS_PER_PAIR)

    def row(name, source, replaces, ms, plain_ms, bnd, err):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
        }

    rows = [
        row("expand_instances", "gsplat_tpu_torch/csrc/binning.cu",
            "gsplat_tpu/ops/binning.py:485", exp_ms, exp_plain_ms, exp_bound, exp_err),
        row("pack_instances", "gsplat_tpu_torch/csrc/binning.cu",
            "gsplat_tpu/ops/binning.py:485", pack_ms, pack_plain_ms, pack_bound, pack_err),
        row("blend_fwd", "gsplat_tpu_torch/csrc/rasterize_fwd.cu",
            "gsplat_tpu/ops/rasterize_pallas.py:368", blend_ms, blend_plain_ms, blend_bound, blend_err),
    ]
    summary = {
        "gaussians": n, "size": f"{FULL['width']}x{FULL['height']}", "instances": k,
        "live_gaussians": live, "trimmed_live_gaussians": trimmed_live,
        "trimmed_rows_with_run": run_rows,
        "evaluated_pairs": pairs, "setup_s": setup_s,
        "frame_ms_median": statistics.median(frame_ms), "frame_ms": frame_ms,
        "device_profile": profile,
        "stage_ms_median": {s: statistics.median(v) for s, v in stage_ms.items()},
        "sort_ms": sort_ms, "launches": launches,
        "blend_check_tiles": CHECK_TILES, "blend_full_frame_max_abs_err": full_err,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    return summary, rows


def write_blender_scene(root: Path, size=800, n=200_000, seed=0):
    """A seeded 3-view Blender-format scene and a PLY snapshot of n gaussians."""
    from PIL import Image

    from gsplat_tpu_torch.data.ply import save_gaussian_ply

    rng = np.random.default_rng(seed)
    src = root / "scene"
    src.mkdir()
    frames = []
    for i in range(3):
        angle = i * 2.0 * np.pi / 3
        pos = np.array([4 * np.sin(angle), 0.5, 4 * np.cos(angle)])
        z = pos / np.linalg.norm(pos)  # OpenGL: the camera looks down -z
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, pos
        img = (rng.random((size, size, 4)) * 255).astype(np.uint8)
        img[..., 3] = 255
        Image.fromarray(img).save(src / f"r_{i}.png")
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    for split, fr in (("train", frames), ("test", [])):
        (src / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.69, "frames": fr}))
    model = root / "model"
    pc = model / "point_cloud" / "iteration_30000"
    pc.mkdir(parents=True)
    save_gaussian_ply(
        str(pc / "point_cloud.ply"),
        (rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
        rng.normal(0, 0.6, (n, 1, 3)).astype(np.float32),
        rng.normal(0, 0.05, (n, 15, 3)).astype(np.float32),
        rng.normal(0.0, 1.5, (n, 1)).astype(np.float32),
        np.log(rng.uniform(0.003, 0.03, (n, 3))).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
    )
    return src, model


def phase_cli():
    """The render CLI end to end on the card, counts reset just before."""
    from PIL import Image

    from gsplat_tpu_torch.cli import render as cli
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc

    kernels = (tb.expand_instances, tb.pack_instances, rc.blend_fwd)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        src, model = write_blender_scene(Path(tmp), **CLI)
        reset_counts(*kernels)
        rc_ = cli.main(["-m", str(model), "-s", str(src), "--device", DEVICE, "--quiet"])
        launches = {w.__name__: w.launches for w in kernels}
        check(rc_ == 0, "render CLI returned non-zero")
        out = model / "train" / "ours_30000" / "renders"
        pngs = sorted(out.iterdir())
        check(len(pngs) == 3, f"render CLI wrote {len(pngs)} PNGs, want 3")
        for p in pngs:
            a = np.asarray(Image.open(p))
            check(a.shape == (CLI["size"], CLI["size"], 3) and a.std() > 1.0, f"{p.name}: bad image")
        for name, n in launches.items():
            check(n == 3, f"CLI: {name} launched {n} times for 3 views")
    return {"views": 3, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from gsplat_tpu_torch import _kernels

    device = torch.device(DEVICE)
    smi = nvidia_smi_line()
    emit(phase="card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0))

    t = time.perf_counter()
    _kernels.build_all()
    emit(phase="build", seconds=time.perf_counter() - t,
         libraries=[_kernels.library_path(s).name for s in _kernels.SOURCES])

    with torch.inference_mode():
        t = time.perf_counter()
        emit(phase="k1_vs_plain", cases=phase_binning(device), seconds=time.perf_counter() - t)
        t = time.perf_counter()
        emit(phase="k2_vs_plain", cases=phase_blend(device), seconds=time.perf_counter() - t)
        t = time.perf_counter()
        summary, rows = phase_main_path(device)
        emit(phase="main_path", **summary, seconds=time.perf_counter() - t)
        t = time.perf_counter()
        emit(phase="render_cli", **phase_cli(), seconds=time.perf_counter() - t)

    for r in rows:
        check(r["launches"] > 0, f"{r['name']} never launched on the main path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

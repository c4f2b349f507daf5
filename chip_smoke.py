#!/usr/bin/env python
"""On-card smoke run of gsplat_tpu_torch: build, check and time the kernels,
then drive the render and train paths, sorted and OIT, through their entry
points.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one) and `nvcc`. Prints one
JSON line per phase:

1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
2. the kernel build (one `nvcc` per source, all at once) and its time;
3. K1' (binning: `expand_instances` + `pack_instances`) against its plain
   twin on the same device, on the seeded 65,536-gaussian scene at 640x480,
   SH 3: ranges and instance order equal, instance table bitwise equal, with
   tight_cull on and off, on an empty scene, and with hybrid packets (rows
   2-8 on the bf16 grid, mean2d and invz exact);
4. K2' (sorted forward blend, `blend_fwd`) against its plain twin on that
   scene, with track_contrib on and off and at 200x120 (not a multiple of
   16): atol 2e-5 on rgb, invdepth and final_T, n_contrib exact;
5. K3' (blend backward, `blend_bwd`) against its plain twin on hybrid
   packets of that scene at 640x480 and 200x120, with a seeded cotangent of
   all five outputs and with NaN conic/opacity entries: per-row max relative
   error below 1e-5;
6. K5' (OIT forward, `blend_oit_fwd`) against its plain twin at those
   sizes, float32 and hybrid packets, with and without NaN conic/opacity
   entries: N and D per pixel relative to max(1, |want|) below 2e-5, T
   within atol 2e-5 (`k5_vs_plain`);
7. K6' (OIT backward, `blend_oit_bwd`) against its plain twin in the same
   cases, with a seeded cotangent of all six raw outputs: per-row max
   relative error below 1e-5 (`k6_vs_plain`);
8. the render path at full width: 1,048,576 gaussians, SH 3, 1920x1080,
   float32 packets, through `render(..., device="cuda")` — 5 warm-up and 20
   timed frames with the launch counts reset just before and read just
   after; a per-stage breakdown; each kernel's time against its plain twin,
   its bound and its error;
9. the render CLI on a seeded 3-view Blender-format scene and PLY snapshot;
10. the OIT render path at full width (`oit_render_path`): the same scene
   with `blend_mode="oit"`, 5 + 20 frames, counts read around them (K1' and
   the float32 pack once per frame, K5' once, K2' never), 10 sorted and 10
   OIT frames in turns, stage split, busy share, peak memory, K5' against
   its twin on 64 tiles and its row;
11. bf16 packets (`bf16_packets`): K1''s bf16 pack bitwise against its twin
   at 640x480, tight_cull on and off; 3 full-width sorted frames with bf16
   packets (counts read around them) and the bf16 pack's row;
12. the train path at full width: the same scene (noise on features_dc and
   opacity, padded to 2x capacity with dead rows) trained toward the
   unperturbed render through `make_train_step` with hybrid packets — 5
   warm-up and 20 timed steps with the counts reset just before and read
   just after (K1', K2', K3' and K4' once per step), the loss falling, no
   NaN; a stage split, the busy share, peak memory; K3', K4' and the hybrid
   pack against their twins at the train frame's shapes;
13. K4' (`reduce_by_gid`) against `index_add_` at that frame's K and N, with
   pack_bf16 off and on and against the sum of bf16-rounded rows: per-row
   max relative error below 1e-5 (and K4' without pack_bf16 must miss the
   rounded sum by more than that);
14. one densify step and one opacity reset on the trained state;
15. the OIT train path (`oit_train_path`): as 12 with `blend_mode="oit"`
   (K1', the hybrid pack, K5', K6' and K4' once per step, K2' and K3'
   never), and K6' against its twin on the whole train frame;
16. the train CLI (30 iterations, densification forced early) and the render
   CLI on the model it saved, sorted (`train_cli`) and with `--blend_mode
   oit` (`train_cli_oit`);
17. the kernels line: one JSON object with every kernel's launches on each
   path, times, bound and error.

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
ROW_REL = 1e-5
OIT_REL = 2e-5  # K5''s N and D per pixel, relative to max(1, |want|)
BF16_FRAMES = 3


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


def all_kernels():
    """The wrappers whose launches the script counts, by kernel row name."""
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops import reduce as rd

    return {"expand_instances": tb.expand_instances, "pack_instances": tb.pack_instances,
            "blend_fwd": rc.blend_fwd, "blend_bwd": rc.blend_bwd,
            "reduce_by_gid": rd.reduce_by_gid_cuda,
            "oit_fwd": rc.blend_oit_fwd, "oit_bwd": rc.blend_oit_bwd}


def reset_counts():
    kernels = all_kernels()
    for w in kernels.values():
        w.launches = 0
    kernels["pack_instances"].launches_hybrid = 0
    kernels["pack_instances"].launches_bf16 = 0


def read_counts():
    """Launches since `reset_counts`, one entry per kernel row: the pack
    wrapper's three counters, read together, split its launches into float32
    packets (`pack_instances`), hybrid ones (`pack_instances_hybrid`) and
    bf16 ones (`pack_instances_bf16`)."""
    kernels = all_kernels()
    counts = {name: w.launches for name, w in kernels.items()}
    pack = kernels["pack_instances"]
    counts["pack_instances"] -= pack.launches_hybrid + pack.launches_bf16
    counts["pack_instances_hybrid"] = pack.launches_hybrid
    counts["pack_instances_bf16"] = pack.launches_bf16
    return counts


# the kernels each path launches once per frame or step: serving packs
# float32 packets and has no backward; training packs hybrid ones; the OIT
# paths blend with K5' (and K6') in place of K2' (and K3')
RENDER_KERNELS = ("expand_instances", "pack_instances", "blend_fwd")
TRAIN_KERNELS = ("expand_instances", "pack_instances_hybrid", "blend_fwd", "blend_bwd",
                 "reduce_by_gid")
OIT_RENDER_KERNELS = ("expand_instances", "pack_instances", "oit_fwd")
OIT_TRAIN_KERNELS = ("expand_instances", "pack_instances_hybrid", "oit_fwd", "oit_bwd",
                     "reduce_by_gid")
BF16_RENDER_KERNELS = ("expand_instances", "pack_instances_bf16", "blend_fwd")


def check_counts(counts, path_kernels, n, what):
    """Each kernel of the path launched `n` times, every other kernel none."""
    for name, got in counts.items():
        want = n if name in path_kernels else 0
        check(got == want, f"{what}: {name} launched {got} times, want {want}")


def bound(nbytes, ops=0):
    """Least time for the work: bytes read once + written once at the HBM
    rate, or the run's float32 operations at the FP32 rate, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pack_bound_of(k, live, num_tiles):
    # pack: key 8 + perm 8 + gid 4 per instance and 40 B of columns per live
    # gaussian (the only ones an instance points at) in; 16 table rows +
    # gauss_id + tile_id per instance and the T+1 bounds out
    return bound(k * 20 + live * 40 + k * (64 + 8) + (num_tiles + 1) * 4)


def measured(ms, plain_ms, bnd, err, rel_err, library_ms=None, **extra):
    """A kernel's numbers: `rel_err` is max |kernel - plain| / max |plain|."""
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "max_abs_err": err, "max_rel_err": rel_err, "library_ms": library_ms, **extra}


def screen_of(scene, settings, device):
    from gsplat_tpu_torch.ops.projection import preprocess
    from gsplat_tpu_torch.render import grid_dims

    params, alive, camera = scene
    gx, gy = grid_dims(camera, 16)
    return preprocess(params, alive, camera, settings, gx, gy), gx, gy


def bitwise_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def phase_binning(device):
    """K1' vs pack_bins_torch: exact equality, float32 and hybrid packets."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.synthetic import tiny_scene

    scene = tiny_scene(**SCENE, device=device)
    cases = []
    for name, tight, alive, packets in (
            ("tight_cull", True, None, "float32"), ("rect", False, None, "float32"),
            ("empty", True, torch.zeros_like(scene[1]), "float32"),
            ("tight_cull_hybrid", True, None, "hybrid"), ("rect_hybrid", False, None, "hybrid")):
        sc = scene if alive is None else (scene[0], alive, scene[2])
        screen, gx, gy = screen_of(sc, make_render_settings(sh_degree=3, tight_cull=tight), device)
        kb = tb.pack_bins(screen, gx, gy, 16, tight, packet_dtype=packets)
        pb = tb.pack_bins_torch(screen, gx, gy, 16, tight, packet_dtype=packets)
        check(kb.num_instances == pb.num_instances, f"{name}: instance count")
        for f in ("tile_start", "tile_end", "gauss_id", "tile_id"):
            check(torch.equal(getattr(kb, f), getattr(pb, f)), f"{name}: {f} differs")
        check(bitwise_equal(kb.inst_t, pb.inst_t), f"{name}: inst_t not bitwise equal")
        check(name != "empty" or kb.num_instances == 0, "empty scene emits instances")
        case = {"case": name, "instances": kb.num_instances}
        if packets == "hybrid":
            # positions and invz exact; conic, opacity and rgb on the bf16 grid
            f32 = tb.pack_bins(screen, gx, gy, 16, tight)
            for r in (0, 1, 9):
                check(bitwise_equal(kb.inst_t[r], f32.inst_t[r]), f"{name}: row {r} not exact")
            vals = kb.inst_t[2:9]
            check(bitwise_equal(vals, tb.round_bf16(vals)), f"{name}: rows 2-8 not bf16")
            case["rows_rounded"] = int((vals != f32.inst_t[2:9]).sum())
        cases.append(case)
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


def nan_rows(inst_t):
    """The table with NaN conic and opacity entries, which the keep rule drops."""
    t = inst_t.clone()
    t[2, ::7] = float("nan")
    t[5, 3::11] = float("nan")
    return t


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
        args = (nan_rows(pb.inst_t), pb.tile_start, pb.tile_end, gx, gy, True)
        err, n_equal = blend_errors(rc.blend_fwd(*args), rc.blend_packed_torch(*args))
        check(err <= ATOL and n_equal, f"blend {w}x{h} NaN rows: max abs err {err}")
        cases.append({"size": f"{w}x{h}", "nan_rows": True, "max_abs_err": err})
    return cases


def per_row_rel_err(a, b):
    """max over rows of max|a - b| / max|b| (a row that is 0 in b must be
    0 in a)."""
    worst = 0.0
    for r in range(b.shape[0]):
        den = float(b[r].abs().max()) if b.shape[1] else 0.0
        num = float((a[r] - b[r]).abs().max()) if b.shape[1] else 0.0
        worst = max(worst, num / den if den > 0 else (0.0 if num == 0 else float("inf")))
    return worst


def phase_blend_bwd(device):
    """K3' vs blend_bwd_packed_torch: per-row max relative error < 1e-5, on
    hybrid packets (the training mode) with a seeded cotangent of all five
    outputs, and on a table with NaN conic and opacity entries."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.synthetic import tiny_scene

    cases = []
    for w, h in ((SCENE["width"], SCENE["height"]), (200, 120)):
        scene = tiny_scene(**{**SCENE, "width": w, "height": h}, device=device)
        screen, gx, gy = screen_of(scene, make_render_settings(sh_degree=3), device)
        pb = tb.pack_bins(screen, gx, gy, packet_dtype="hybrid")
        gen = torch.Generator(device=device).manual_seed(7)
        dout = torch.zeros((gx * gy, 256, 8), device=device)
        dout[..., :5] = torch.randn((gx * gy, 256, 5), generator=gen, device=device)
        for label, table in (("hybrid", pb.inst_t), ("nan_rows", nan_rows(pb.inst_t))):
            args = (table, pb.tile_start, pb.tile_end, gx, gy)
            fwd = rc.blend_fwd(*args)
            got = rc.blend_bwd(*args, fwd, dout)
            want = rc.blend_bwd_packed_torch(*args, fwd, dout)
            check(bool(torch.isfinite(got).all()), f"K3' {w}x{h} {label}: non-finite rows")
            err = per_row_rel_err(got, want)
            check(err < ROW_REL, f"K3' {w}x{h} {label}: per-row max rel err {err}")
            cases.append({"size": f"{w}x{h}", "case": label, "instances": pb.num_instances,
                          "max_rel_err": err,
                          "max_abs_err": float((got - want).abs().max())})
    return cases


def oit_errors(got, want):
    """K5' against its twin: N and D (channels 0-4) per pixel relative to
    max(1, |want|) (the sums carry the weight z^2 <= 25, so they reach the
    hundreds), T (channel 5) absolutely; channels 6-7 must be 0."""
    check(not bool(got[..., 6:].any()), "K5' wrote non-zero channels 6-7")
    if not got.numel():
        return 0.0, 0.0
    nd_rel = float(((got[..., :5] - want[..., :5]).abs()
                    / want[..., :5].abs().clamp(min=1.0)).max())
    return nd_rel, float((got[..., 5] - want[..., 5]).abs().max())


def phase_oit_blend(device):
    """K5' vs blend_oit_packed_torch on the seeded scene at 640x480 and
    200x120, float32 and hybrid packets (and NaN conic/opacity rows): N and
    D per pixel relative to max(1, |want|) below 2e-5, T within atol 2e-5.
    `bitwise_equal` says whether `log1pf`/`expf` in K5' and `torch.log1p`/
    `torch.exp` gave the same bits."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.synthetic import tiny_scene

    cases = []
    for w, h in ((SCENE["width"], SCENE["height"]), (200, 120)):
        scene = tiny_scene(**{**SCENE, "width": w, "height": h}, device=device)
        screen, gx, gy = screen_of(scene, make_render_settings(sh_degree=3), device)
        for packets in ("float32", "hybrid"):
            pb = tb.pack_bins(screen, gx, gy, packet_dtype=packets)
            for label, table in ((packets, pb.inst_t), (f"{packets}_nan_rows", nan_rows(pb.inst_t))):
                args = (table, pb.tile_start, pb.tile_end, gx, gy)
                got, want = rc.blend_oit_fwd(*args), rc.blend_oit_packed_torch(*args)
                nd_rel, t_err = oit_errors(got, want)
                check(bool(torch.isfinite(got).all()), f"K5' {w}x{h} {label}: non-finite sums")
                check(nd_rel < OIT_REL and t_err <= ATOL,
                      f"K5' {w}x{h} {label}: N/D rel err {nd_rel}, T abs err {t_err}")
                cases.append({"size": f"{w}x{h}", "case": label, "instances": pb.num_instances,
                              "nd_max_rel_err": nd_rel, "t_max_abs_err": t_err,
                              "max_abs_err": float((got - want).abs().max()),
                              "bitwise_equal": bool(torch.equal(got, want))})
    return cases


def phase_oit_bwd(device):
    """K6' vs blend_oit_bwd_packed_torch at 640x480 and 200x120, float32 and
    hybrid packets, with a seeded cotangent of all six raw outputs (N0..3,
    D, T) and with NaN conic/opacity entries: per-row max relative error
    below 1e-5."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.synthetic import tiny_scene

    cases = []
    for w, h in ((SCENE["width"], SCENE["height"]), (200, 120)):
        scene = tiny_scene(**{**SCENE, "width": w, "height": h}, device=device)
        screen, gx, gy = screen_of(scene, make_render_settings(sh_degree=3), device)
        gen = torch.Generator(device=device).manual_seed(7)
        dout = torch.zeros((gx * gy, 256, 8), device=device)
        dout[..., :6] = torch.randn((gx * gy, 256, 6), generator=gen, device=device)
        for packets in ("float32", "hybrid"):
            pb = tb.pack_bins(screen, gx, gy, packet_dtype=packets)
            for label, table in ((packets, pb.inst_t), (f"{packets}_nan_rows", nan_rows(pb.inst_t))):
                args = (table, pb.tile_start, pb.tile_end, gx, gy)
                fwd = rc.blend_oit_fwd(*args)
                got = rc.blend_oit_bwd(*args, fwd, dout)
                want = rc.blend_oit_bwd_packed_torch(*args, fwd, dout)
                check(bool(torch.isfinite(got).all()), f"K6' {w}x{h} {label}: non-finite rows")
                err = per_row_rel_err(got, want)
                check(err < ROW_REL, f"K6' {w}x{h} {label}: per-row max rel err {err}")
                cases.append({"size": f"{w}x{h}", "case": label, "instances": pb.num_instances,
                              "max_rel_err": err, "max_abs_err": float((got - want).abs().max()),
                              "bitwise_equal": bool(torch.equal(got, want))})
    return cases


def check_bf16_table(name, kb, pb, hybrid, f32):
    """K1''s bf16 table bitwise equal to its twin's, every row on the bf16
    grid, rows 2-8 those of the hybrid table, rows 0, 1 and 9 the float32
    table's rounded."""
    from gsplat_tpu_torch.ops import binning as tb

    check(kb.num_instances == pb.num_instances, f"{name}: instance count")
    for f in ("tile_start", "tile_end", "gauss_id", "tile_id"):
        check(torch.equal(getattr(kb, f), getattr(pb, f)), f"{name}: {f} differs")
    check(bitwise_equal(kb.inst_t, pb.inst_t), f"{name}: bf16 inst_t not bitwise equal to its twin")
    check(bitwise_equal(kb.inst_t[:10], tb.round_bf16(kb.inst_t[:10])), f"{name}: rows not bf16")
    check(bitwise_equal(kb.inst_t[2:9], hybrid.inst_t[2:9]), f"{name}: rows 2-8 differ from hybrid")
    check(bitwise_equal(kb.inst_t[[0, 1, 9]], tb.round_bf16(f32.inst_t[[0, 1, 9]])),
          f"{name}: rows 0, 1, 9 are not the float32 rows rounded")


def phase_bf16(device):
    """All-bf16 packets: K1''s bf16 pack bitwise against its twin on the
    640x480 scene (tight_cull on and off), then the full-width sorted render
    with bf16 packets through `render` (counts reset just before, read just
    after) and the bf16 pack's row at that frame's shapes."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.render import grid_dims, render
    from gsplat_tpu_torch.synthetic import tiny_scene

    cases = []
    scene = tiny_scene(**SCENE, device=device)
    for name, tight in (("tight_cull_bf16", True), ("rect_bf16", False)):
        screen, gx, gy = screen_of(scene, make_render_settings(sh_degree=3, tight_cull=tight),
                                   device)
        kb = tb.pack_bins(screen, gx, gy, 16, tight, packet_dtype="bfloat16")
        pb = tb.pack_bins_torch(screen, gx, gy, 16, tight, packet_dtype="bfloat16")
        check_bf16_table(name, kb, pb, tb.pack_bins(screen, gx, gy, 16, tight, packet_dtype="hybrid"),
                         tb.pack_bins(screen, gx, gy, 16, tight))
        cases.append({"case": name, "instances": kb.num_instances})
    del scene

    params, alive, camera = tiny_scene(**FULL, device=device)
    bg = [0.0, 0.0, 0.0]
    settings = make_render_settings(sh_degree=3, packet_dtype="bfloat16")
    reset_counts()
    frame_ms = []
    for _ in range(BF16_FRAMES):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = render(camera, params, alive, settings, bg, device=DEVICE)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    launches = read_counts()
    check_counts(launches, BF16_RENDER_KERNELS, BF16_FRAMES, "bf16 render path")
    img = out["render"]
    check(img.shape == (FULL["height"], FULL["width"], 3), "bf16 image shape")
    check(bool(torch.isfinite(img).all()), "bf16 image has non-finite values")
    check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, "bf16 image outside [0, 1]")
    check(float(img.std()) > 0.01, "bf16 image is flat")
    f32 = render(camera, params, alive, make_render_settings(sh_degree=3), bg, device=DEVICE)
    diff = (img - f32["render"]).abs()

    # the bf16 pack at the frame's shapes, against its twin bit for bit
    gx, gy = grid_dims(camera, 16)
    screen, _, _ = screen_of((params, alive, camera), settings, device)
    tables = tb._emission_tables(screen.detach(), 16, True)
    keys, gid = tb.expand_instances(*tables[:5], screen.depth, tables[5], gx, True)
    keys_sorted, perm = torch.sort(keys, stable=True)
    pack_args = (keys_sorted, perm, gid, screen, gx * gy, "bfloat16")
    pack_err = max_abs_diff("pack_instances (bf16)", ("inst_t", "gauss_id", "tile_id", "bounds"),
                            tb.pack_instances(*pack_args), tb._pack_instances_torch(*pack_args))
    pack_ms = cuda_time(lambda: tb.pack_instances(*pack_args), 20)
    pack_plain_ms = cuda_time(lambda: tb._pack_instances_torch(*pack_args), 3)
    live = int((tables[0][:, 3] > 0).sum())
    summary = {
        "table_cases": cases, "gaussians": FULL["n"], "size": f"{FULL['width']}x{FULL['height']}",
        "instances": out["num_instances"], "frame_ms": frame_ms,
        "frame_ms_median": statistics.median(frame_ms), "launches": launches,
        "vs_float32_frame": {"max_abs_diff": float(diff.max()), "mean_abs_diff": float(diff.mean())},
    }
    row = measured(pack_ms, pack_plain_ms, pack_bound_of(tables[5], live, gx * gy),
                   pack_err, pack_err)
    return summary, {"pack_instances_bf16": row}


def reduce_errors(dinst, gid, n):
    """K4' held as K3' is, per row: max |K4' - want| / max |want| below
    1e-5 on all 16 rows (rows 10-15 must be exactly 0), against
    - reduce_by_gid_torch (index_add_), pack_bf16 off and on;
    - index_add_ of the rows rounded to bf16 beforehand, which K4' with
      pack_bf16 must meet and K4' without it must miss by more than the
      tolerance: so a K4' that ignored pack_bf16 fails here.
    Returns the largest abs error, the largest per-row relative one, and
    how far the unrounded sum misses the rounded reference."""
    from gsplat_tpu_torch.ops import reduce as rd

    rounded = torch.zeros((rd.N_ROWS, n), dtype=torch.float32, device=dinst.device)
    rounded[:rd.N_GRAD].index_add_(1, gid.long(), dinst[:rd.N_GRAD].to(torch.bfloat16).float())
    got = {pack: rd.reduce_by_gid_cuda(dinst, gid, n, pack) for pack in (False, True)}
    err = rel = 0.0
    for label, a, want in (("pack_bf16=False", got[False], rd.reduce_by_gid_torch(dinst, gid, n)),
                           ("pack_bf16=True", got[True],
                            rd.reduce_by_gid_torch(dinst, gid, n, True)),
                           ("bf16-rounded rows", got[True], rounded)):
        r = per_row_rel_err(a, want)
        check(r < ROW_REL, f"K4' {label}: per-row max rel err {r}")
        err, rel = max(err, float((a - want).abs().max())), max(rel, r)
    miss = per_row_rel_err(got[False], rounded)
    check(miss > ROW_REL, f"K4' without pack_bf16 meets the bf16-rounded sum ({miss}): "
          "the data cannot tell whether K4' rounds")
    return err, rel, miss


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

    # --- the render path: counts (and the peak memory) reset just before,
    # read just after
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    frame_ms = []
    for i in range(WARMUP + TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = render(camera, params, alive, settings, bg, device=DEVICE)
        torch.cuda.synchronize()
        if i >= WARMUP:
            frame_ms.append((time.perf_counter() - t) * 1e3)
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_counts(launches, RENDER_KERNELS, WARMUP + TIMED, "render path")
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
    blend_rel = blend_err / float(plain_blend[sel][..., :5].abs().max())

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
    pack_bound = pack_bound_of(k, live, num_tiles)
    # blend: 10 table rows per instance + 2 ranges per tile in; (T, 256, 8) out
    blend_bound = bound(k * 40 + num_tiles * 8 + num_tiles * 256 * 32, pairs * BLEND_OPS_PER_PAIR)

    rows = {
        # K1' is checked bit for bit (its errors are 0, so relative ones too)
        "expand_instances": measured(exp_ms, exp_plain_ms, exp_bound, exp_err, exp_err),
        "pack_instances": measured(pack_ms, pack_plain_ms, pack_bound, pack_err, pack_err),
        "blend_fwd": measured(blend_ms, blend_plain_ms, blend_bound, blend_err, blend_rel),
    }
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
        "peak_mem_gib": peak_gib,
    }
    return summary, rows


# float32 operations each kept (pixel, instance) pair adds in K5': alpha
# (exp, multiply, clamp, compare) 4, the weight z^2 and alpha z^2 2, N and D
# 9, the log term (negate, log1p, add) 3
OIT_FWD_OPS_PER_KEPT = 18
# and in K6': alpha 4, K 8, 1/(1 - alpha) 2, dalpha 3, dgm 2, the six
# geometry and opacity sums 26, the four alpha dN sums 8, the W sum 2
OIT_BWD_OPS_PER_KEPT = 55


def phase_oit_render(device):
    """The full-width render in OIT mode through `render` (float32 packets),
    then a stage split and K5''s row: K5' against its twin on 64 seeded
    tiles (the twin on the whole frame gives its time and the evaluated and
    kept pair counts)."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops.rasterize_torch import tiles_to_image
    from gsplat_tpu_torch.render import grid_dims, render
    from gsplat_tpu_torch.synthetic import tiny_scene

    t0 = time.perf_counter()
    params, alive, camera = tiny_scene(**FULL, device=device)
    settings = make_render_settings(sh_degree=3, packet_dtype="float32", blend_mode="oit")
    bg = [0.0, 0.0, 0.0]
    setup_s = time.perf_counter() - t0

    # --- the OIT render path: counts reset just before, read just after
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    frame_ms = []
    for i in range(WARMUP + TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = render(camera, params, alive, settings, bg, device=DEVICE)
        torch.cuda.synchronize()
        if i >= WARMUP:
            frame_ms.append((time.perf_counter() - t) * 1e3)
    launches = read_counts()
    check_counts(launches, OIT_RENDER_KERNELS, WARMUP + TIMED, "OIT render path")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    img = out["render"]
    check(img.shape == (FULL["height"], FULL["width"], 3), "OIT image shape")
    check(bool(torch.isfinite(img).all()), "OIT image has non-finite values")
    check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, "OIT image outside [0, 1]")
    check(float(img.std()) > 0.01, "OIT image is flat")

    profile = device_profile(lambda: render(camera, params, alive, settings, bg, device=DEVICE))

    # --- sorted and OIT frames in turns in one loop: the two paths' frame
    # times without the host's drift between phases
    turns = {"sorted": [], "oit": []}
    for _ in range(TIMED // 2):
        for mode in turns:
            st = settings if mode == "oit" else make_render_settings(sh_degree=3)
            torch.cuda.synchronize()
            t = time.perf_counter()
            render(camera, params, alive, st, bg, device=DEVICE)
            torch.cuda.synchronize()
            turns[mode].append((time.perf_counter() - t) * 1e3)

    # --- per-stage breakdown of the same frame
    gx, gy = grid_dims(camera, 16)
    num_tiles = gx * gy
    bg_t = torch.zeros(3, device=device)
    stages = ("preprocess", "binning", "K5_oit_blend", "composite")
    stage_ms = {s: [] for s in stages}
    for i in range(WARMUP + TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        screen, _, _ = screen_of((params, alive, camera), settings, device)
        ev[1].record()
        pb = tb.pack_bins(screen, gx, gy)
        ev[2].record()
        args = (pb.inst_t, pb.tile_start, pb.tile_end, gx, gy)
        raw = rc.blend_oit_fwd(*args)
        ev[3].record()
        final_t = raw[:, :, 5]
        w = (1.0 - final_t) / torch.clamp(raw[:, :, 4], min=1e-8)
        color = raw[:, :, 0:3] * w[..., None] + final_t[..., None] * bg_t[None, None, :]
        image = torch.clamp(tiles_to_image(color, gx, gy, 16, camera.width, camera.height), 0.0, 1.0)
        ev[4].record()
        torch.cuda.synchronize()
        if i >= WARMUP:
            for j, s in enumerate(stages):
                stage_ms[s].append(ev[j].elapsed_time(ev[j + 1]))
    check(torch.equal(image, img), "stage-by-stage OIT frame differs from render()")

    torch.cuda.synchronize()
    t = time.perf_counter()
    plain, evaluated, kept = rc.blend_oit_packed_torch(*args, count_pairs=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    sel = torch.as_tensor(np.random.default_rng(0).choice(num_tiles, CHECK_TILES, replace=False),
                          device=device)
    nd_rel, t_err = oit_errors(raw[sel], plain[sel])
    check(nd_rel < OIT_REL and t_err <= ATOL,
          f"K5' on 64 frame tiles: N/D rel err {nd_rel}, T abs err {t_err}")
    full_nd, full_t = oit_errors(raw, plain)
    k5_ms = cuda_time(lambda: rc.blend_oit_fwd(*args), 20)
    k = pb.num_instances
    # K5': 10 table rows per instance + 2 ranges per tile in; (T, 256, 8) out
    k5_bound = bound(k * 40 + num_tiles * 8 + num_tiles * 256 * 32,
                     evaluated * BLEND_OPS_PER_PAIR + kept * OIT_FWD_OPS_PER_KEPT)
    summary = {
        "gaussians": FULL["n"], "size": f"{FULL['width']}x{FULL['height']}", "instances": k,
        "evaluated_pairs": evaluated, "kept_pairs": kept, "setup_s": setup_s,
        "frame_ms_median": statistics.median(frame_ms), "frame_ms": frame_ms,
        "frames_in_turns_ms_median": {m: statistics.median(v) for m, v in turns.items()},
        "device_profile": profile,
        "stage_ms_median": {s: statistics.median(v) for s, v in stage_ms.items()},
        "launches": launches, "peak_mem_gib": peak_gib, "k5_check_tiles": CHECK_TILES,
        "k5_full_frame": {"nd_max_rel_err": full_nd, "t_max_abs_err": full_t,
                          "bitwise_equal": bool(torch.equal(raw, plain))},
    }
    row = measured(k5_ms, plain_ms, k5_bound, float((raw[sel] - plain[sel]).abs().max()), nd_rel,
                   evaluated_pairs=evaluated, kept_pairs=kept, t_max_abs_err=t_err)
    return summary, {"oit_fwd": row}


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

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        src, model = write_blender_scene(Path(tmp), **CLI)
        reset_counts()
        rc_ = cli.main(["-m", str(model), "-s", str(src), "--device", DEVICE, "--quiet"])
        launches = read_counts()
        check(rc_ == 0, "render CLI returned non-zero")
        out = model / "train" / "ours_30000" / "renders"
        pngs = sorted(out.iterdir())
        check(len(pngs) == 3, f"render CLI wrote {len(pngs)} PNGs, want 3")
        for p in pngs:
            a = np.asarray(Image.open(p))
            check(a.shape == (CLI["size"], CLI["size"], 3) and a.std() > 1.0, f"{p.name}: bad image")
        check_counts(launches, RENDER_KERNELS, 3, "render CLI, 3 views")
    return {"views": 3, "launches": launches}


# float32 operations every blended (pixel, instance) pair of K3' adds for its
# gradient terms: the cotangent dot (7), w and the prefix (3), suffix and
# 1/(1 - alpha) (3), dalpha (4), dgm (2), the ten row terms (26)
BWD_OPS_PER_BLENDED = 45
TRAIN_CAPACITY = 2 * FULL["n"]  # dead-row padding as `init_from_pcd` pads
CLI_ITERS = 30


def pad_rows(params, alive, capacity):
    """The scene's rows padded with dead rows to `capacity`, as
    `model.init_from_pcd` leaves room for densification."""
    from gsplat_tpu_torch.train.densify import sanitize_dead_rows

    pad = capacity - alive.shape[0]
    params = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))]) for k, v in params.items()}
    alive = torch.cat([alive, alive.new_zeros(pad)])
    return sanitize_dead_rows(params, alive), alive


class StageMarks:
    """CUDA events recorded around functions the train step calls, by
    swapping each module attribute for a recording wrapper while active.
    Each wrapper also keeps the arguments of its last call. Used only to
    split and to capture, never on the counted run."""

    def __init__(self, patches):
        self.patches = patches  # (module, attribute, mark before, mark after)
        self.events, self.args, self._saved = {}, {}, []

    def mark(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[name] = e

    def __enter__(self):
        for mod, attr, before, after in self.patches:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))

            def wrapped(*a, _fn=fn, _attr=attr, _b=before, _e=after, **kw):
                if _b:
                    self.mark(_b)
                out = _fn(*a, **kw)
                if _e:
                    self.mark(_e)
                self.args[_attr] = a
                return out

            # a kernel wrapper counts through its module-global name, so
            # while swapped in its counters land on this stand-in
            wrapped.__dict__.update({c: 0 for c in vars(fn) if c.startswith("launches")})
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)

    def ms(self, a, b):
        return self.events[a].elapsed_time(self.events[b])


def phase_train(device, blend_mode="sorted"):
    """The train path at full width: the flagship scene through
    `make_train_step` in hybrid mode, with the sorted or the OIT blend; then
    the stage split, the busy share, and the kernel rows at the train
    frame's shapes: K3', K4' and the hybrid K1' pack (sorted), K6' (OIT)."""
    from gsplat_tpu_torch.config import OptimizationConfig
    from gsplat_tpu_torch.convert import PARAM_FIELDS
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops import reduce as rd
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.synthetic import tiny_scene
    from gsplat_tpu_torch.train import losses
    from gsplat_tpu_torch.train import step as ts

    t0 = time.perf_counter()
    module, alive0, camera = tiny_scene(**FULL, device=device)
    settings = make_render_settings(sh_degree=3, packet_dtype="hybrid", blend_mode=blend_mode)
    oit = blend_mode == "oit"
    bg = torch.zeros(3, device=device)
    with torch.no_grad():  # the target: the unperturbed scene's render
        target = render(camera, module, alive0, settings, bg, device=DEVICE)["render"]
    params = {k: getattr(module, k).detach().clone() for k in PARAM_FIELDS}
    del module
    gen = torch.Generator(device=device).manual_seed(1)
    for k, sigma in (("features_dc", 0.3), ("opacity", 0.5)):
        params[k] += sigma * torch.randn(params[k].shape, generator=gen, device=device)
    params, alive = pad_rows(params, alive0, TRAIN_CAPACITY)
    state = ts.init_train_state(params, alive, num_images=1, seed=0)
    opt = OptimizationConfig()
    step = ts.make_train_step(opt, settings)
    h, w = FULL["height"], FULL["width"]
    zeros = torch.zeros((h, w), device=device)
    args = (camera, target, torch.ones((h, w, 1), device=device), zeros, zeros, bg,
            opt.position_lr_init, opt.exposure_lr_init, 0.0, 0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # --- the train path: counts reset just before, read just after
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms, loss = [], []
    for i in range(WARMUP + TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, *args)
        torch.cuda.synchronize()
        if i >= WARMUP:
            step_ms.append((time.perf_counter() - t) * 1e3)
        loss.append(float(metrics["loss"]))
    launches = read_counts()
    check_counts(launches, OIT_TRAIN_KERNELS if oit else TRAIN_KERNELS, WARMUP + TIMED,
                 f"{blend_mode} train path")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(loss)), f"non-finite loss: {loss}")
    check(loss[-1] < loss[0], f"loss did not fall: {loss[0]} -> {loss[-1]}")
    for k, v in state.params.items():
        check(not bool(torch.isnan(v).any()), f"NaN in {k} after training")
    check(torch.equal(state.alive, alive), "alive changed in train steps")

    # --- device busy share over 3 profiled steps (counts already read)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], *args)

    profile = device_profile(one_step)
    state = holder[0]

    # --- stage split, and the inputs the blend backward (K3' or K6'), K4'
    # and the pack get in a step
    bwd_attr, bwd_stage = ("blend_oit_bwd", "K6_oit_bwd") if oit else ("blend_bwd", "K3_blend_bwd")
    marks = StageMarks([(ts, "render", "fwd0", "fwd1"), (losses, "depth_l1_loss", None, "loss1"),
                        (rc, bwd_attr, "k3_0", "k3_1"), (rd, "reduce_by_gid_cuda", None, "k4_1"),
                        (ts, "adam_update", "adam0", "adam1"), (tb, "pack_instances", None, None)])
    spans = (("forward", "fwd0", "fwd1"), ("loss", "fwd1", "loss1"),
             ("loss_backward", "loss1", "k3_0"), (bwd_stage, "k3_0", "k3_1"),
             ("K4_reduce", "k3_1", "k4_1"),
             ("preprocess_backward_and_stats", "k4_1", "adam0"), ("adam", "adam0", "adam1"),
             ("dead_row_freeze", "adam1", "end"))
    stage_ms = {name: [] for name, _, _ in spans}
    with marks:
        for i in range(WARMUP + TIMED):
            marks.events.clear()
            state, _ = step(state, *args)
            marks.mark("end")
            torch.cuda.synchronize()
            if i >= WARMUP:
                for name, a, b in spans:
                    stage_ms[name].append(marks.ms(a, b))
    k3_args, k4_args, pack_args = (marks.args[a] for a in (
        bwd_attr, "reduce_by_gid_cuda", "pack_instances"))
    summary = {
        "gaussians": FULL["n"], "capacity": TRAIN_CAPACITY,
        "size": f"{FULL['width']}x{FULL['height']}", "packet_dtype": "hybrid",
        "blend_mode": blend_mode,
        "setup_s": setup_s, "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
        "loss_first": loss[0], "loss_last": loss[-1],
        "stage_ms_median": {k: statistics.median(v) for k, v in stage_ms.items()},
        "device_profile": profile, "launches": launches, "peak_mem_gib": peak_gib,
        "instances": int(k3_args[0].shape[1]),
    }
    with torch.no_grad():  # the saved forward output carries requires_grad
        rows = (kernel_rows_oit_train(k3_args) if oit
                else kernel_rows_train(k3_args, k4_args, pack_args))
    return summary, state, rows


def kernel_rows_train(k3_args, k4_args, pack_args):
    """K3', K4' and the hybrid K1' pack on the inputs one train step gave
    them: time, plain twin time, error and bound."""
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops import reduce as rd

    # K3' against its twin on the whole frame; the twin's one call is timed
    # and counts the pairs the bound needs
    inst_t, starts, ends, gx, gy, fwd, dout = k3_args
    k, num_tiles = inst_t.shape[1], gx * gy
    got = rc.blend_bwd(*k3_args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want, evaluated, blended = rc.blend_bwd_packed_torch(*k3_args, count_pairs=True)
    torch.cuda.synchronize()
    k3_plain_ms = (time.perf_counter() - t) * 1e3
    k3_rel = per_row_rel_err(got, want)
    check(k3_rel < ROW_REL, f"K3' on the train frame: per-row max rel err {k3_rel}")
    k3_ms = cuda_time(lambda: rc.blend_bwd(*k3_args), 20)
    # K3': 10 table rows per instance + 2 ranges per tile + the forward
    # output and its cotangent (T, 256, 8) each in; 10 rows per instance out.
    # Operations: the forward's 11 per evaluated pair + 45 per blended pair
    k3_bound = bound(k * 40 + num_tiles * 8 + 2 * num_tiles * 256 * 32 + k * 40,
                     evaluated * BLEND_OPS_PER_PAIR + blended * BWD_OPS_PER_BLENDED)

    # K4' (hybrid: pack_bf16) against index_add_, off and on
    dinst, gid, n, pack = k4_args
    check(pack is True, "the hybrid train step must reduce with pack_bf16")
    k4_err, k4_rel, k4_miss = reduce_errors(dinst, gid, n)
    k4_ms = cuda_time(lambda: rd.reduce_by_gid_cuda(dinst, gid, n, True), 20)
    k4_plain_ms = cuda_time(lambda: rd.reduce_by_gid_torch(dinst, gid, n, True), 20)
    # library: one index_add_ of the same (already rounded) rows into a fresh
    # zeroed output, as K4' zeroes its own
    rows10, gid_l = tb.round_bf16(dinst[:10]), gid.long()
    lib_ms = cuda_time(lambda: torch.zeros((16, n), device=dinst.device)[:10].index_add_(
        1, gid_l, rows10), 20)
    # K4': 10 rows + gid per instance in; 10 x N floats out; 10 adds per instance
    k4_bound = bound(k * (40 + 4) + n * 40, 10 * k)

    # the hybrid pack at the train frame against its twin, bit for bit
    keys_sorted, perm, kgid, screen, pt = pack_args[:5]
    check(pack_args[5] == "hybrid", "the train step packs hybrid instances")
    outs = tb.pack_instances(*pack_args)
    pack_err = max_abs_diff("pack_instances (hybrid)", ("inst_t", "gauss_id", "tile_id", "bounds"),
                            outs, tb._pack_instances_torch(*pack_args))
    pack_ms = cuda_time(lambda: tb.pack_instances(*pack_args), 20)
    pack_plain_ms = cuda_time(lambda: tb._pack_instances_torch(*pack_args), 3)
    live = int(torch.unique(kgid).numel())

    return {
        "pack_instances_hybrid": measured(pack_ms, pack_plain_ms,
                                          pack_bound_of(keys_sorted.shape[0], live, pt),
                                          pack_err, pack_err),
        # K3': the largest per-row relative error (the check's measure)
        "blend_bwd": measured(k3_ms, k3_plain_ms, k3_bound, float((got - want).abs().max()),
                              k3_rel, evaluated_pairs=evaluated, blended_pairs=blended),
        "reduce_by_gid": measured(k4_ms, k4_plain_ms, k4_bound, k4_err, k4_rel,
                                  library_ms=lib_ms, unrounded_rel_miss=k4_miss),
    }


def kernel_rows_oit_train(k6_args):
    """K6' on the inputs one OIT train step gave it: against its twin on the
    whole frame (per-row max relative error below 1e-5; the twin's one call
    is timed), its time and its bound from the frame's evaluated and kept
    pairs."""
    from gsplat_tpu_torch.ops import rasterize_cuda as rc

    inst_t, starts, ends, gx, gy, fwd, dout = k6_args
    k, num_tiles = inst_t.shape[1], gx * gy
    got = rc.blend_oit_bwd(*k6_args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = rc.blend_oit_bwd_packed_torch(*k6_args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    rel = per_row_rel_err(got, want)
    check(rel < ROW_REL, f"K6' on the OIT train frame: per-row max rel err {rel}")
    _, evaluated, kept = rc.blend_oit_packed_torch(inst_t, starts, ends, gx, gy, count_pairs=True)
    ms = cuda_time(lambda: rc.blend_oit_bwd(*k6_args), 20)
    # K6': 10 table rows per instance + 2 ranges per tile + T_final and the
    # cotangents of N0..3, D and T per pixel in; 10 rows per instance out
    bnd = bound(k * 40 + num_tiles * 8 + num_tiles * 256 * 28 + k * 40,
                evaluated * BLEND_OPS_PER_PAIR + kept * OIT_BWD_OPS_PER_KEPT)
    return {"oit_bwd": measured(ms, plain_ms, bnd, float((got - want).abs().max()), rel,
                                evaluated_pairs=evaluated, kept_pairs=kept,
                                bitwise_equal=bool(torch.equal(got, want)))}


def phase_densify(state):
    """One densify step and one opacity reset on the trained state: the
    alive count changes as the masks say, nothing is NaN. The grad threshold
    is the 99th percentile of the state's mean gradients (so about 1% of
    the live rows are hot), the extent 1.0 (so 0.01 splits the scene's
    0.002-0.012 scales into clones and splits)."""
    from gsplat_tpu_torch.config import OptimizationConfig
    from gsplat_tpu_torch.core import activations as act
    from gsplat_tpu_torch.train import step as ts

    st = state.stats
    mean_grad = st["grad_accum"] / torch.clamp(st["denom"], min=1.0)
    thr = float(torch.quantile(mean_grad[state.alive & (st["denom"] > 0)], 0.99))
    before = int(state.alive.sum())
    torch.cuda.synchronize()
    t = time.perf_counter()
    new, info = ts.make_densify_step(OptimizationConfig(densify_grad_threshold=thr))(
        state, 1.0, 0)
    reset = ts.opacity_reset_step(new)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    check(info["n_cloned"] > 0 and info["n_split"] > 0, f"densify made no clones or splits: {info}")
    want = (before - info["n_pruned"] - info["n_split"]
            + info["n_cloned"] + 2 * info["n_split"] - info["n_dropped"])
    check(info["n_alive"] == want == int(new.alive.sum()),
          f"alive {info['n_alive']} after densify, the masks say {want}")
    for k, v in reset.params.items():
        check(not bool(torch.isnan(v).any()), f"NaN in {k} after densify + reset")
    op = act.opacity_activation(reset.params["opacity"])[reset.alive]
    check(float(op.max()) <= 0.01 + 1e-6, "opacity reset left an opacity above 0.01")
    check(not bool(reset.adam_m["opacity"].any()), "opacity reset kept Adam moments")
    return {"grad_threshold": thr, "alive_before": before, **info, "ms": ms}


def phase_train_cli(blend_mode="sorted"):
    """The train CLI on a seeded 3-view Blender scene (densification forced
    into the first iterations), then the render CLI on the saved model,
    both with `--blend_mode`; counts reset just before each and read just
    after."""
    from PIL import Image

    from gsplat_tpu_torch.cli import render as render_cli
    from gsplat_tpu_torch.cli import train as train_cli
    from gsplat_tpu_torch.io.snapshot import load_snapshot

    mode = ["--blend_mode", blend_mode]
    train_kernels, render_kernels = ((OIT_TRAIN_KERNELS, OIT_RENDER_KERNELS) if blend_mode == "oit"
                                     else (TRAIN_KERNELS, RENDER_KERNELS))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        src, _ = write_blender_scene(Path(tmp), size=CLI["size"], n=1000)
        model = Path(tmp) / "trained"
        reset_counts()
        t = time.perf_counter()
        rc_ = train_cli.main([
            "-s", str(src), "-m", str(model), "--iterations", str(CLI_ITERS),
            "--densify_from_iter", "5", "--densification_interval", "10",
            "--densify_until_iter", str(CLI_ITERS), "--opacity_reset_interval", "20",
            "--densify_grad_threshold", "1e-7", "--device", DEVICE, "--quiet",
            "--disable_viewer", *mode])
        train_s = time.perf_counter() - t
        train_launches = read_counts()
        check(rc_ == 0, "train CLI returned non-zero")
        check_counts(train_launches, train_kernels, CLI_ITERS,
                     f"{blend_mode} train CLI, {CLI_ITERS} iterations")
        _, alive, it, _ = load_snapshot(str(model), device=DEVICE)
        n_saved = int(alive.sum())
        check(it == CLI_ITERS and n_saved > 100_000, f"saved snapshot: iteration {it}, {n_saved} rows")

        reset_counts()
        rc_ = render_cli.main(["-m", str(model), "-s", str(src), "--device", DEVICE, "--quiet",
                               *mode])
        render_launches = read_counts()
        check(rc_ == 0, "render CLI returned non-zero on the trained model")
        pngs = sorted((model / "train" / f"ours_{CLI_ITERS}" / "renders").iterdir())
        check(len(pngs) == 3, f"render CLI wrote {len(pngs)} PNGs of the trained model, want 3")
        # the Blender reader's random init is near-uniform gray (colors
        # 0.5 + U(0, 1/255) in SH), so a trained view is a gray cloud over
        # the black background: check the shape and that it is not blank
        stds = []
        for p in pngs:
            a = np.asarray(Image.open(p))
            stds.append(float(a.std()))
            check(a.shape == (CLI["size"], CLI["size"], 3) and a.max() > a.min() and a.max() > 0,
                  f"{p.name}: blank or misshapen image of the trained model")
        check_counts(render_launches, render_kernels, 3,
                     f"{blend_mode} render CLI on the trained model")
    return {"blend_mode": blend_mode, "iterations": CLI_ITERS, "train_s": train_s, "saved_gaussians": n_saved,
            "render_std": stds, "train_launches": train_launches,
            "render_launches": render_launches}


KERNEL_ROWS = (
    # (row, path whose count is `launches`, source, TPU kernel)
    ("expand_instances", "train", "gsplat_tpu_torch/csrc/binning.cu",
     "gsplat_tpu/ops/binning.py:485"),
    ("pack_instances", "render", "gsplat_tpu_torch/csrc/binning.cu",
     "gsplat_tpu/ops/binning.py:485"),
    ("pack_instances_hybrid", "train", "gsplat_tpu_torch/csrc/binning.cu",
     "gsplat_tpu/ops/binning.py:485"),
    ("blend_fwd", "train", "gsplat_tpu_torch/csrc/rasterize_fwd.cu",
     "gsplat_tpu/ops/rasterize_pallas.py:368"),
    ("blend_bwd", "train", "gsplat_tpu_torch/csrc/rasterize_bwd.cu",
     "gsplat_tpu/ops/rasterize_pallas.py:605"),
    ("reduce_by_gid", "train", "gsplat_tpu_torch/csrc/reduce.cu",
     "gsplat_tpu/ops/reduce.py:50"),
    ("pack_instances_bf16", "bf16_render", "gsplat_tpu_torch/csrc/binning.cu",
     "gsplat_tpu/ops/binning.py:485"),
    ("oit_fwd", "oit_train", "gsplat_tpu_torch/csrc/rasterize_oit.cu",
     "gsplat_tpu/ops/rasterize_pallas.py:897"),
    ("oit_bwd", "oit_train", "gsplat_tpu_torch/csrc/rasterize_oit.cu",
     "gsplat_tpu/ops/rasterize_pallas.py:974"),
)


def kernels_line(measures, launches_by_path):
    """One row per kernel: `launches` is the count `read_counts` took on
    the path named in KERNEL_ROWS (each slice's main path: the train path,
    the OIT train path; float32 packets are packed on the render path and
    bf16 ones on the bf16 render path), with every path's count beside
    it."""
    rows = []
    for name, path, source, replaces in KERNEL_ROWS:
        by_path = {p: counts[name] for p, counts in launches_by_path.items()}
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": by_path[path], "launches_by_path": by_path, **measures[name]})
    return rows


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
        emit(phase="k3_vs_plain", cases=phase_blend_bwd(device), seconds=time.perf_counter() - t)
        t = time.perf_counter()
        emit(phase="k5_vs_plain", cases=phase_oit_blend(device), seconds=time.perf_counter() - t)
        t = time.perf_counter()
        emit(phase="k6_vs_plain", cases=phase_oit_bwd(device), seconds=time.perf_counter() - t)
        t = time.perf_counter()
        render_summary, measures = phase_main_path(device)
        emit(phase="render_path", **render_summary, seconds=time.perf_counter() - t)
        t = time.perf_counter()
        emit(phase="render_cli", **phase_cli(), seconds=time.perf_counter() - t)
        t = time.perf_counter()
        oit_render_summary, oit_rows = phase_oit_render(device)
        emit(phase="oit_render_path", **oit_render_summary, seconds=time.perf_counter() - t)
        measures.update(oit_rows)
        t = time.perf_counter()
        bf16_summary, bf16_rows = phase_bf16(device)
        emit(phase="bf16_packets", **bf16_summary, seconds=time.perf_counter() - t)
        measures.update(bf16_rows)

    t = time.perf_counter()
    train_summary, state, train_measures = phase_train(device)
    emit(phase="train_path", **train_summary, seconds=time.perf_counter() - t)
    measures.update(train_measures)
    k4 = measures["reduce_by_gid"]
    emit(phase="k4_vs_plain", pack_bf16=[False, True], max_abs_err=k4["max_abs_err"],
         max_rel_err=k4["max_rel_err"], unrounded_rel_miss=k4["unrounded_rel_miss"],
         instances=train_summary["instances"], gaussians=TRAIN_CAPACITY)
    t = time.perf_counter()
    emit(phase="densify", **phase_densify(state), seconds=time.perf_counter() - t)
    del state
    t = time.perf_counter()
    oit_train_summary, state, oit_train_rows = phase_train(device, "oit")
    emit(phase="oit_train_path", **oit_train_summary, seconds=time.perf_counter() - t)
    measures.update(oit_train_rows)
    del state
    for mode in ("sorted", "oit"):
        t = time.perf_counter()
        emit(phase="train_cli" if mode == "sorted" else "train_cli_oit",
             **phase_train_cli(mode), seconds=time.perf_counter() - t)

    rows = kernels_line(measures, {"train": train_summary["launches"],
                                   "render": render_summary["launches"],
                                   "oit_train": oit_train_summary["launches"],
                                   "oit_render": oit_render_summary["launches"],
                                   "bf16_render": bf16_summary["launches"]})
    for r in rows:
        check(r["launches"] > 0, f"{r['name']} never launched on its path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

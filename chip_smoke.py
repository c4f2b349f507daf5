#!/usr/bin/env python
"""On-card smoke run of gsplat_tpu_torch: build, check and time the kernels,
then drive the render and train paths, sorted and OIT, on one card and on
meshes of ranks that share it, through their entry points.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one) and `nvcc`. Prints one
JSON line per phase:

1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
2. the kernel build (one `nvcc` per source, all at once) and its time,
   then `sass`: each probe kernel's instruction counts from `cuobjdump
   -sass` of the built libraries: the skeletons P1' and P2' keep their ten
   staging stores and their barriers, and no P3'/P4' kernel spills to local
   memory or holds fewer float instructions than one unrolled iteration;
   K2' and K3' touch no local memory (`cuobjdump -res-usage` and no
   LDL/STL), K2' issues no shuffle and K3' at most the 31 of its
   reduce-scatter (its registers and `SHFL` count go on the kernels line);
   K1' and K4' touch no local memory, and K4' holds three global
   reductions per instance in each instantiation, every one a vector form
   (their whole mnemonics, `.FTZ` or not, go on the kernels line);
3. K1' (binning: `expand_instances` + `pack_instances`) against its plain
   twin on the same device, on the seeded 65,536-gaussian scene at 640x480,
   SH 3: ranges and instance order equal, instance table bitwise equal, with
   tight_cull on and off, on an empty scene, and with hybrid packets (rows
   2-8 on the bf16 grid, mean2d and invz exact);
4. `k1_edges`: K1' bit for bit against its twins on adversarial emission
   tables on a 1080p tile grid (one gaussian on all 8,160 tiles, runs
   straddling the expand's 256-slot steps, whole blocks of dead rows, N =
   256 m +- 1, trimmed gaussians with empty rows), expand keys, gids and
   live packet rows, then the pack in all three packet modes;
5. `subnormals`: what the scalar `atomicAdd`, the v4 and v2 `red` forms,
   K4' and its twin do with a subnormal addend, a subnormal sum of normal
   addends and a subnormal addend onto a subnormal sum (kept or flushed);
6. K2' (sorted forward blend, `blend_fwd`) against its plain twin on that
   scene, with track_contrib on and off, at 200x120 (not a multiple of
   16), with NaN conic/opacity entries and on `edge_table` (opacities a
   hair above 1/255, means and box and ellipse edges on warp rectangle
   borders; no kept pair outside the warp cull): max abs err 0 and
   n_contrib exact;
7. K3' (blend backward, `blend_bwd`) against its plain twin on hybrid
   packets of that scene at 640x480 and 200x120, with a seeded cotangent of
   all five outputs, with NaN conic/opacity entries and on `edge_table`:
   per-row max relative error below 1e-5;
8. K5' (OIT forward, `blend_oit_fwd`) against its plain twin at those
   sizes, float32 and hybrid packets, with and without NaN conic/opacity
   entries: `torch.equal` (`k5_vs_plain`; N and D per pixel relative to
   max(1, |want|) and T's abs error reported beside it);
9. K6' (OIT backward, `blend_oit_bwd`) against its plain twin in the same
   cases, with a seeded cotangent of all six raw outputs: `torch.equal`
   (`k6_vs_plain`; per-row max relative error reported);
10. the render path at full width: 1,048,576 gaussians, SH 3, 1920x1080,
   float32 packets, through `render(..., device="cuda")` — 5 warm-up and 20
   timed frames with the launch counts reset just before and read just
   after; a per-stage breakdown; each kernel's time against its plain twin,
   its bound and its error (the packs also `gather_ref_ms`, the card's
   time for `packets.index_select(0, gauss_id)` alone); K2' equal to its
   twin on the whole frame (max abs err 0, n_contrib exact); K1' and K2'
   not under their bounds; the warp cull's
   check on the frame (`cull_stats_torch`: no kept pair outside its box or
   in a skipped warp) and its share of skipped (warp, instance) pairs;
11. the render CLI on a seeded 3-view Blender-format scene and PLY snapshot;
12. the OIT render path at full width (`oit_render_path`): the same scene
   with `blend_mode="oit"`, 5 + 20 frames, counts read around them (K1' and
   the float32 pack once per frame, K5' once, K2' never), 10 sorted and 10
   OIT frames in turns, stage split, busy share, peak memory, K5'
   `torch.equal` to its twin on the whole frame and its row (with its
   walked pairs and culled share);
13. bf16 packets (`bf16_packets`): K1''s bf16 pack bitwise against its twin
   at 640x480, tight_cull on and off; 3 full-width sorted frames with bf16
   packets (counts read around them) and the bf16 pack's row;
14. the train path at full width: the same scene (noise on features_dc and
   opacity, padded to 2x capacity with dead rows) trained toward the
   unperturbed render through `make_train_step` with hybrid packets — 5
   warm-up and 20 timed steps with the counts reset just before and read
   just after (K1', K2', K3' and K4' once per step), the loss falling, no
   NaN; a stage split, the busy share, peak memory; K3', K4', the expand
   (2,097,152 rows, half dead) and the hybrid pack against their twins at
   the train frame's shapes and timed there (K4' also at the live rows'
   N, and the zeroing of its accumulator alone), none under its bound;
   K2' equal to its
   twin on the train frame and timed there, the cull's check on it, and
   neither K2' nor K3' under its bound; then `warp_cull`: both frames'
   cull checks and skipped shares;
15. K4' (`reduce_by_gid`) against `index_add_` at that frame's K and N, with
   pack_bf16 off and on and against the sum of bf16-rounded rows: per-row
   max relative error below 1e-5 (and K4' without pack_bf16 must miss the
   rounded sum by more than that);
16. the skeleton probes (`probe_skeleton`): P1' (`skel_fwd`) on the render
   path's K2' inputs (the flagship frame) and P2' (`skel_bwd`) on the train
   frame's K3' inputs, each bit for bit against its twin; K2', P1', K3' and
   P2' timed in turns on those inputs, and the skeleton share of each
   kernel's time;
17. one densify step and one opacity reset on the trained state, then
   `resize`: that state (2,097,152 rows, 1,048,576 alive) grown to
   3,145,728 rows and shrunk to 1,310,720 by `resize_train_state`, the
   alive rows' params, Adam moments, counts and stats bit for bit the
   originals in alive order, dead rows sanitized, each resized state's
   render within atol 1e-6 of the original's;
18. the OIT train path (`oit_train_path`): as 14 with `blend_mode="oit"`
   (K1', the hybrid pack, K5', K6' and K4' once per step, K2' and K3'
   never), and K6' (and the step's K5' output) `torch.equal` to its twin
   on the whole train frame, its walked pairs and culled share;
19. the train CLI (30 iterations, densification forced early) and the render
   CLI on the model it saved, sorted (`train_cli`) and with `--blend_mode
   oit` (`train_cli_oit`);
   then `colmap_train`: a COLMAP scene written by the port's
   `colmap.write_model` (one PINHOLE camera at 1920x1080, 8 views on a
   ring around the flagship cloud, rendered by K1' and K2' as ground truth;
   262,144 SfM-like points), read back on the native path, trained 200
   iterations through the port's loop with `capacity=0` and hybrid packets
   (densify rounds at 40, 80 and 120) with the counts reset just before and
   read just after (K1' expand and hybrid pack, K2', K3', K4' once per
   iteration); the capacity grows past the init's 524,288 rows, the alive
   count past 262,144, the loss falls; step ms before the first grow and
   after the last, each resize's ms, the capacity and alive trajectory,
   peak memory; then the render CLI on the saved model (8 views);
   `checkpoint_resume`: a 16-view COLMAP scene of the same kind (eval holds
   out views 0 and 8) trained by run A to 120 iterations (rolling
   checkpoints every 40 on the loop's worker thread, `chkpnt120.pkl`,
   evaluations at 60 and 120) and by run B resumed from `chkpnt120.pkl` to
   200, counts reset around each run (K1' expand and hybrid pack and K2' per
   iteration and per evaluation render, K3' and K4' per iteration): the
   loaded state is A's final state bit for bit, generator included; the
   rolling checkpoint holds 120 after A's flush; B starts at 121 with A's
   SH degree, its capacity controller at A's last capacity and no resize;
   `evaluate_test` equals a direct render + `losses.psnr` within 1e-6 of
   max(1, |value|); at 200 B's test PSNR is finite and its sweep's train
   views' PSNR at least A's at 60; run C, uninterrupted to 200, beside them;
   checkpoint bytes, sync save and load ms, the steps that overlap a
   worker-thread write against the others, `evaluate_test` ms per 1080p
   view (ground truth uploaded, then cached); the render CLI on B's test
   views; the checkpoints are deleted;
   `metrics`: `cli.metrics` on those 1080p renders with seeded synthetic
   VGG16 LPIPS weights (14.7 M weights) on the card, LPIPS(x, x) < 1e-6,
   LPIPS and SSIM + PSNR ms per 1080p pair, and on a 270x480 crop the card
   against `--device cpu` within relative 1e-5 per metric and view;
   `train_cli_ckpt`: the train CLI with `--checkpoint_every 10
   --profile_steps 3 --test_iterations 20 30`, resumed from its rolling
   checkpoint to 40 (the profile trace names K2' and K3'; the resumed run
   prints its test PSNR), then `cli.train_supervised` to its end in a
   child process; `viewer`: `NetworkGUI(port=0)` answers three 1920x1080
   loopback requests of the flagship scene (scaling modifier 1.0, 0.5,
   1.0) with exactly the bytes of the port's render, K1' and K2' once per
   request, and the round-trip ms;
   `bench`: `python -m gsplat_tpu_torch.bench`'s points through
   `bench.run` (the top-level `bench.py`'s four points: 1M gaussians
   hybrid and float32 and 262,144 hybrid, forward and backward, 1M forward
   alone; not the trained-cloud scan of `main`), its JSON keys, finite
   positive rates, device time per call at most the host's, the kernels
   each point launches; `entry`: `gsplat_tpu_torch.entry.entry()` once
   (K1' and K2' once each, a finite image);
   `quality_fixture`: the COLMAP quality run of `gsplat_tpu_torch/scripts/
   colmap_proxy.py` at its full size (4,096 GT gaussians, 2,048 SfM points,
   64 PINHOLE views at 400x304, focal 380, seed 3) cut to 1,500
   iterations, its `main` in-process with the counts reset just before and
   read just after (K1' and K2' per GT view, iteration and evaluation or
   render-CLI view, the packs by packet mode, K3' and K4' per iteration,
   exactly); the fixture against itself (3 views re-rendered from the GT
   cloud within 1.5/255 of the saved PNGs, the loaded pixels within
   1/255); the loop's held-out PSNR at the end at least QUALITY_PSNR_BAR
   (from the full runs); the trained-cloud row of the bench on the
   snapshot and the warp cull on a held-out view (whole-plane boxes
   counted; no kept pair outside its box or in a skipped warp); then the
   trained cloud on that view in OIT mode, float32 and hybrid packets,
   with the L1 loss's cotangent through the OIT composite: K5' and K6'
   each `torch.equal` to its twin, their walked pairs and culled shares
   (`oit_trained_frame`);
   `multi_device`: the flagship train state (1,048,576 gaussians in
   2,097,152 rows, 1920x1080, hybrid) on meshes of ranks that share the
   card over gloo (spawned processes; gloo copies each collective's CUDA
   tensors through host memory, and the line says so): 2x2, 4x1 and 1x4
   as 4 ranks, then 1x3 as 3 ranks through `sharded_train_step` on the
   padded grid (68 tile rows, 3 bands of 23). Every rank renders and steps
   on one card alone first; on each mesh the sharded render (full gather)
   is within atol 1e-6 of that render with radii equal, the band
   exchange's render equals it bit for bit, and one train step (the band
   exchange where T > 1, as the loop steps) gives the loss within rtol
   1e-5, params within atol 2e-5 and `grad_accum` within atol 1e-5 of the
   single-device step (`tests/test_parallel.py`'s tolerances), with the
   counts reset just before the step and read just after (K1' expand and
   hybrid pack, K2', K3', K4' once each per rank); then 3 steps timed per
   rank with each collective's calls, bytes and ms (a synchronize around
   each; the ms include waiting for the other ranks); `nccl_1x1`: a
   one-rank NCCL mesh (a spawned process) held to the same checks;
   `dryrun_multichip`: `entry.dryrun_multichip(4)` and
   `entry.dryrun_multihost(8, 2)` over gloo on the card (each loss within
   relative 1e-5 of the single-device loss); `train_cli_mesh`: `torchrun
   --nproc_per_node 2 -m gsplat_tpu_torch.cli.train --mesh 1x2
   --dist_backend gloo` 30 iterations on the train CLI's scene (densify
   forced early, `chkpnt30.pkl`), the render CLI under `--mesh 1x2` (3
   views), then the checkpoint resumed on one card to 40 in-process,
   counts reset around it (K1' expand and hybrid pack, K2', K3', K4' 10
   times);
20. the op-rate probes (`probe_ops`): every P3' variant (1000 iterations)
   and P4' at float32 and bf16, (256, 128) and (512, 128) (2000
   iterations), each against its twin on the card (float32: within 1e-6 of
   max |want|; bf16: within 2 bf16 ulps per element), with its time per
   iteration, its per-SM bound, the per-op costs and the bf16 speedups;
21. the probe path (`probe_path`): the entry points of the three probe
   modules (`ablate.main`, `op_rate.main`, `bf16_rate.main`, as `python -m
   gsplat_tpu_torch.probes.<name>` runs them) with the counts reset just
   before and read just after: every probe kernel launched, no OIT kernel
   and no hybrid or bf16 pack;
22. the kernels line: one JSON object with every kernel's launches on each
   path, times, bound and error (K2' and K3' also their walked and
   evaluated pairs, culled share and build facts, K2' its train-frame
   time; K1' its train-frame expand and expand + pack per path; K4' its
   build facts and the subnormal outcomes; every path kernel its device
   time from its path's profile, `profiled_ms`, which no slow host
   stretches, also not under its bound); K1' to K6' count on the render
   and train paths, and the probe kernels P1' (`skel_fwd`), P2' (`skel_bwd`), the
   twelve P3' variants (`op_<variant>`) and P4' (`blend_mix_<dtype>`, and
   `_512` at 512 rows) on the probe path, with their bounds on one SM for
   P3' and P4'; the COLMAP train path's, the bench's and the entry's counts
   beside them, and those of the checkpoint runs A and B, the direct
   `evaluate_test`, the two train CLI runs of `train_cli_ckpt`, the
   viewer, the quality run, each mesh's checked step summed over its ranks
   (`multi_device_<G>x<T>`), `nccl_1x1` and the mesh checkpoint's resumed
   run (`train_cli_mesh_resumed`). The render and train paths launch no
   probe kernel.

Then the card's name and power limit on a line of their own, and last the
line `{"ok": true, "device": {...}}`. Every failed check raises, so the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
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
# the P3'/P4' probes run one block: their bound is one SM's share of the
# card's rate. bf16 outside the tensor cores: packed bf16x2 instructions at
# twice the float32 rate (NVIDIA H100 white paper, SXM5: 133.8 TFLOP/s)
SMS = 132
BF16_FLOPS = 133.8e12
PROBE_REL = 1e-6  # P3' and float32 P4' against their twins, of max |want|
BF16_ULPS = 2  # bf16 P4' against its twin, per element

DEVICE = "cuda"
SCENE = dict(n=65_536, width=640, height=480, sh_degree=3)
FULL = dict(n=1_048_576, width=1920, height=1080, sh_degree=3)
CLI = dict(size=800, n=200_000)
WARMUP, TIMED = 5, 20
CHECK_TILES = 64
ATOL = 2e-5
ROW_REL = 1e-5
BF16_FRAMES = 3


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def cuda_time(fn, reps):
    """Mean device ms of `fn()` over `reps` calls after one warm-up call
    (CUDA events around the calls)."""
    from gsplat_tpu_torch.probes import time_ms

    return time_ms(fn, reps, torch.device(DEVICE))


# the port's kernel functions on the paths, as the profiler names them
PATH_KERNEL_FUNCS = ("expand_instances_kernel", "pack_instances_kernel", "blend_fwd_kernel",
                     "blend_bwd_kernel", "reduce_by_gid_kernel", "oit_fwd_kernel",
                     "oit_bwd_kernel")


def device_profile(frame, frames=3, top=10):
    """Device activity over `frames` profiled frames, from `torch.profiler`.

    `busy_share` is read off the trace (`gsplat_tpu_torch.profiling`, which
    the bench reports its device times with): the union of the device's
    kernel, copy and set intervals over the trace's span of those frames
    (first host op to last event end), so it cannot exceed 1. The profiled
    frames run slower than unprofiled ones (`profiled_frame_ms`); the share
    is theirs. Also the summed device time per kernel name, the top kernels,
    and the device time per frame of each of the port's kernels the frame
    ran (no host gap between launches counts there)."""
    from torch.autograd import DeviceType

    from gsplat_tpu_torch.profiling import busy_span_us, profile_calls

    prof = profile_calls(frame, frames)
    # device-side events only: the CPU-side op rows repeat their kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3 / frames, e.count / frames)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy, span = busy_span_us(prof)
    return {
        "device_ms_per_frame": sum(r[1] for r in rows),
        "kernels_per_frame": sum(r[2] for r in rows),
        "profiled_frame_ms": span / 1e3 / frames,
        "busy_ms_per_frame": busy / 1e3 / frames,
        "busy_share": busy / span,
        "top_kernels": [{"kernel": k[:120], "ms_per_frame": ms, "calls_per_frame": c}
                        for k, ms, c in rows[:top]],
        "port_kernels_ms_per_frame": {f: sum(ms for k, ms, _ in rows if f in k)
                                      for f in PATH_KERNEL_FUNCS if any(f in k for k, _, _ in rows)},
    }


def all_kernels():
    """The wrappers whose launches the script counts, by kernel row name."""
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops import reduce as rd
    from gsplat_tpu_torch.probes import ablate, bf16_rate, op_rate

    return {"expand_instances": tb.expand_instances, "pack_instances": tb.pack_instances,
            "blend_fwd": rc.blend_fwd, "blend_bwd": rc.blend_bwd,
            "reduce_by_gid": rd.reduce_by_gid_cuda,
            "oit_fwd": rc.blend_oit_fwd, "oit_bwd": rc.blend_oit_bwd,
            "skel_fwd": ablate.skel_fwd, "skel_bwd": ablate.skel_bwd,
            **{f"op_{name}": w for name, w in op_rate.WRAPPERS.items()},
            "blend_mix_f32": bf16_rate.blend_mix_f32, "blend_mix_bf16": bf16_rate.blend_mix_bf16}


MIX_ROWS = ("blend_mix_f32", "blend_mix_bf16")  # counted apart at 512 rows


def reset_counts():
    kernels = all_kernels()
    for w in kernels.values():
        w.launches = 0
    kernels["pack_instances"].launches_hybrid = 0
    kernels["pack_instances"].launches_bf16 = 0
    for name in MIX_ROWS:
        kernels[name].launches_512 = 0


def read_counts():
    """Launches since `reset_counts`, one entry per kernel row: the pack
    wrapper's three counters, read together, split its launches into float32
    packets (`pack_instances`), hybrid ones (`pack_instances_hybrid`) and
    bf16 ones (`pack_instances_bf16`); P4''s `launches_512` splits each of
    its wrappers into rows at (256, 128) and at (512, 128)."""
    kernels = all_kernels()
    counts = {name: w.launches for name, w in kernels.items()}
    pack = kernels["pack_instances"]
    counts["pack_instances"] -= pack.launches_hybrid + pack.launches_bf16
    counts["pack_instances_hybrid"] = pack.launches_hybrid
    counts["pack_instances_bf16"] = pack.launches_bf16
    for name in MIX_ROWS:  # P4' at (256, 128) and at (512, 128)
        counts[name] -= kernels[name].launches_512
        counts[f"{name}_512"] = kernels[name].launches_512
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


def expand_bound_of(tables):
    """The expand's bound and the counts it rests on. What this run's data
    needs the kernel to read: every gaussian's tile count; the rest of the
    rect, cum_excl, depth and the trimmed flag only for live rows (count >
    0); cum_run (all 8 rows) only for trimmed live rows, and t_lo only for
    their rows that hold a run. Out: key 8 + gid 4 per instance. The packet
    rows are the design's cost, not the work's."""
    rect, _, trimmed, _, cum_run, k = tables
    live_rows = rect[:, 3] > 0
    trim_rows = live_rows & trimmed.bool()
    run_len = torch.diff(cum_run[trim_rows], dim=1, append=rect[trim_rows, 3:4])
    live, trimmed_live, run_rows = (int(x) for x in (live_rows.sum(), trim_rows.sum(),
                                                     (run_len > 0).sum()))
    n = rect.shape[0]
    bnd = bound(n * 4 + live * (12 + 8 + 4 + 1) + trimmed_live * 32 + run_rows * 4 + k * 12)
    return bnd, live, trimmed_live, run_rows


def gather_ref_ms(packets, keys_sorted, perm, gid):
    """A yardstick beside the pack's row, not a library time: the card's
    time for `packets.index_select(0, gauss_id)` alone, the gather of one
    packet row per sorted instance that the pack also makes."""
    gauss_id = gid[perm].long()
    return cuda_time(lambda: packets.index_select(0, gauss_id), 20)


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


def expand_errors(what, got, want, rect):
    """K1''s expand against its twin: keys and gids equal, the packet rows
    of live gaussians bit for bit (the kernel leaves dead rows unwritten).
    Returns the largest abs difference (0)."""
    live = rect[:, 3] > 0
    check(bitwise_equal(got[2][live], want[2][live]), f"{what}: live packet rows not bitwise equal")
    return max_abs_diff(what, ("keys", "gid", "packets"), (got[0], got[1], got[2][live]),
                        (want[0], want[1], want[2][live]))


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


EDGE_TILES = (120, 68)  # the tile grid of a 1920 x 1080 frame
EXPAND_BLOCK = 256  # gaussians per expand block = slots per step of its walk


def emission_edges(rng, n, tight, big=False, full_at=(), dead=()):
    """An adversarial emission table on EDGE_TILES and screen columns for
    its packet rows: a third each of dead rows (count 0, half flagged
    trimmed), rects (up to 12 x 8 tiles, or 40 x 20 with `big`) and trimmed
    gaussians of up to 8 rows, a third of whose rows are empty (t_lo at
    rmin_x, cum_run shared with the next row; without `tight` their whole
    rect is emitted and the flag ignored). `full_at` rows cover all 8,160
    tiles; `dead` rows are forced dead. Depths in (0.21, 100) with ties."""
    from types import SimpleNamespace

    gx, gy = EDGE_TILES
    kind = rng.integers(0, 3, n)  # 0 dead, 1 rect, 2 trimmed
    kind[list(dead)] = 0
    rw = rng.integers(1, 41 if big else 13, n)
    rh = rng.integers(1, 21 if big else 9, n)
    rh = np.where(kind == 2, np.minimum(rh, 8), rh)
    full = np.zeros(n, bool)
    full[list(full_at)] = True
    kind[full], rw[full], rh[full] = 1, gx, gy
    x0 = (rng.random(n) * (gx - rw + 1)).astype(np.int64)
    y0 = (rng.random(n) * (gy - rh + 1)).astype(np.int64)
    ends = x0[:, None, None] + (rng.random((n, 2, 8)) * rw[:, None, None]).astype(np.int64)
    a, b = ends.min(axis=1), ends.max(axis=1)
    row_live = (np.arange(8)[None, :] < rh[:, None]) & (rng.random((n, 8)) >= 1 / 3)
    run = np.where(row_live, b - a + 1, 0)
    t_lo = np.where(row_live, a, x0[:, None])
    cum_run = np.cumsum(run, axis=1) - run
    trim = kind == 2
    count = np.where(kind == 0, 0, np.where(trim & tight, run.sum(axis=1), rw * rh))
    flag = trim | ((kind == 0) & (rng.random(n) < 0.5))
    cum = np.cumsum(count)
    rect = np.stack([x0, y0, rw, count], axis=1)
    depth = rng.uniform(0.21, 100.0, n).astype(np.float32)
    depth[rng.random(n) < 0.1] = 7.0
    dev = lambda x, dt: torch.as_tensor(x, dtype=dt, device=DEVICE).contiguous()
    f = lambda *shape: dev(rng.standard_normal((n,) + shape), torch.float32)
    cols = SimpleNamespace(mean2d=f(2), conic=f(3), opacity=f(), rgb=f(3),
                           depth=dev(depth, torch.float32))
    tables = (dev(rect, torch.int32), dev(cum - count, torch.int64), dev(flag, torch.uint8),
              dev(t_lo, torch.int32), dev(cum_run, torch.int32))
    return tables, cols, int(cum[-1])


def straddled_steps(cum_excl, count, gid):
    """(steps, straddled): the 256-slot steps of every expand block's walk
    that fall inside its slot range, and those a run crosses (the slots on
    either side of the step belong to one gaussian)."""
    lo = cum_excl[::EXPAND_BLOCK]
    last = torch.clamp(torch.arange(EXPAND_BLOCK - 1, cum_excl.shape[0] + EXPAND_BLOCK - 1,
                                    EXPAND_BLOCK, device=cum_excl.device), max=cum_excl.shape[0] - 1)
    hi = cum_excl[last] + count[last]
    per_block = torch.clamp((hi - lo - 1) // EXPAND_BLOCK, min=0)
    step = torch.repeat_interleave(lo, per_block) + EXPAND_BLOCK * (
        torch.arange(int(per_block.sum()), device=lo.device)
        - torch.repeat_interleave(torch.cumsum(per_block, 0) - per_block, per_block) + 1)
    return int(step.numel()), int((gid[step - 1] == gid[step]).sum())


def phase_k1_edges(device):
    """K1' on adversarial emission tables, bit for bit against its twins:
    expand (keys, gids, live packet rows), then the pack in all three
    packet modes, on a 1080p tile grid. Cases: one gaussian on all 8,160
    tiles; runs that straddle the 256-slot steps of the expand's walk
    (rects up to 40 x 20); whole blocks of dead rows and a last block of one
    row; N = 256 m +- 1; trimmed gaussians with empty rows (tight_cull)."""
    from gsplat_tpu_torch.ops import binning as tb

    rng = np.random.default_rng(11)
    cases = (("full_grid", 257, True, dict(full_at=(100,))),
             ("full_grid_rect", 511, False, dict(full_at=(0, 510))),
             ("straddle", 4095, True, dict(big=True)),
             ("straddle_rect", 4097, False, dict(big=True, full_at=(2000,))),
             ("dead_blocks", 4097, True, dict(dead=range(0, 1280))),
             ("trimmed_empty_rows", 65_535, True, {}),
             ("n_plus_1", 65_537, True, dict(dead=range(256, 768))))
    out = []
    num_tiles = EDGE_TILES[0] * EDGE_TILES[1]
    for name, n, tight, kw in cases:
        tables, cols, total = emission_edges(rng, n, tight, **kw)
        args = (*tables, cols, total, EDGE_TILES[0], tight)
        got = tb.expand_instances(*args)
        want = tb._expand_instances_torch(*args)
        expand_errors(f"k1_edges {name}", got, want, tables[0])
        keys, gid, packets = got
        keys_sorted, perm = torch.sort(keys, stable=True)
        for packet_dtype in tb.PACKET_MODES:
            pack_args = (keys_sorted, perm, gid, packets, num_tiles, packet_dtype)
            kout = tb.pack_instances(*pack_args)
            pout = tb._pack_instances_torch(*pack_args[:3], want[2], *pack_args[4:])
            check(bitwise_equal(kout[0], pout[0]), f"k1_edges {name} {packet_dtype}: inst_t")
            max_abs_diff(f"k1_edges {name} {packet_dtype}", ("inst_t", "gauss_id", "tile_id",
                                                              "bounds"), kout, pout)
        count = tables[0][:, 3].long()
        steps, straddled = straddled_steps(tables[1], count, gid.long())
        blocks_dead = int((count.reshape(-1)[: n // EXPAND_BLOCK * EXPAND_BLOCK]
                           .reshape(-1, EXPAND_BLOCK).sum(1) == 0).sum())
        out.append({"case": name, "gaussians": n, "tight_cull": tight, "instances": total,
                    "live": int((count > 0).sum()), "max_count": int(count.max()),
                    "trimmed_live": int(((count > 0) & tables[2].bool()).sum()) if tight else 0,
                    "walk_steps": steps, "steps_straddled": straddled,
                    "all_dead_blocks": blocks_dead})
    check(any(c["max_count"] == num_tiles for c in out), "k1_edges: no gaussian on every tile")
    check(sum(c["steps_straddled"] for c in out) > 0, "k1_edges: no run straddles a step")
    return out


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


EDGE_GRID, EDGE_PER_TILE = (5, 4), 320


def edge_table(device, seed=3):
    """An instance table built to sit on the warp cull's edges, with its
    tile ranges: per 16x16 tile of a 5x4 grid, 320 instances of every size
    and orientation, half with opacity a hair above 1/255 (up to 1e-3
    relative), the rest up to 1; a quarter each with the mean on a warp
    rectangle's border, with the pixel box's edge on one, with the edge of
    the ellipse where alpha = 1/255 on one, and anywhere in the tile (and
    around it)."""
    from gsplat_tpu_torch.ops import rasterize_cuda as rc

    rng = np.random.default_rng(seed)
    gx, gy = EDGE_GRID
    n = EDGE_PER_TILE
    t_all = []
    for tile in range(gx * gy):
        tx0, ty0 = (tile % gx) * 16, (tile // gx) * 16
        sx, sy = np.exp(rng.uniform(-1.0, 2.5, (2, n)))
        ang = rng.uniform(0, np.pi, n)
        c, s_ = np.cos(ang), np.sin(ang)
        xx = c * c * sx * sx + s_ * s_ * sy * sy + 0.3
        yy = s_ * s_ * sx * sx + c * c * sy * sy + 0.3
        xy = c * s_ * (sx * sx - sy * sy)
        det = xx * yy - xy * xy
        op = np.where(rng.random(n) < 0.5, (1 / 255) * (1 + rng.uniform(0, 1e-3, n)),
                      rng.uniform(1 / 255, 1.0, n))
        t = np.zeros((16, n), np.float32)
        t[2:6] = np.stack([-0.5 * yy / det, xy / det, -0.5 * xx / det, op])
        t[6:10] = rng.uniform(0, 1, (4, n))
        tab = torch.from_numpy(t)
        tab[0:2] = 0.0
        rad = rc.pixel_box_torch(tab)[[1, 3]].numpy()  # the box's half widths at a mean of 0
        # the kept ellipse's half widths, sqrt(4c' tau / det') and sqrt(4a' tau / det')
        tau = np.log(255 * op)
        ell = np.sqrt(np.maximum(np.stack([2 * xx, 2 * yy]) * tau, 0.0))
        # warp rectangle borders of the 8x4 blocks: columns 0, 7, 8, 15 and
        # rows 0, 3, 4, ..., 15 of the tile
        bx = tx0 + rng.choice([0, 7, 8, 15], n).astype(np.float32)
        by = ty0 + rng.choice([0, 3, 4, 7, 8, 11, 12, 15], n).astype(np.float32)
        side = rng.choice([-1.0, 1.0], (2, n)).astype(np.float32)
        kind = rng.integers(0, 4, n)
        mx = np.select([kind == 0, kind == 1, kind == 2],
                       [bx, bx + side[0] * rad[0], bx + side[0] * ell[0]],
                       tx0 + rng.uniform(-8, 24, n))
        my = np.select([kind == 0, kind == 1, kind == 2],
                       [by, by + side[1] * rad[1], by + side[1] * ell[1]],
                       ty0 + rng.uniform(-8, 24, n))
        tab[0], tab[1] = torch.from_numpy(mx.astype(np.float32)), torch.from_numpy(
            my.astype(np.float32))
        t_all.append(tab)
    inst_t = torch.cat(t_all, dim=1).to(device)
    bounds = torch.arange(0, gx * gy * n + 1, n, dtype=torch.int32, device=device)
    return inst_t, bounds[:-1], bounds[1:], gx, gy


def phase_blend(device):
    """K2' vs blend_packed_torch: max abs err 0 and n_contrib exact (on the
    card `expf` and `torch.exp` round alike, and the warp cull changes no
    bit), on the seeded scenes and on `edge_table`."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.synthetic import tiny_scene

    def exact(label, args):
        err, n_equal = blend_errors(rc.blend_fwd(*args), rc.blend_packed_torch(*args))
        check(err == 0.0 and n_equal, f"blend {label}: max abs err {err}, n_contrib equal "
              f"{n_equal}")
        return err

    cases = []
    for w, h in ((SCENE["width"], SCENE["height"]), (200, 120)):
        scene = tiny_scene(**{**SCENE, "width": w, "height": h}, device=device)
        screen, gx, gy = screen_of(scene, make_render_settings(sh_degree=3), device)
        pb = tb.pack_bins(screen, gx, gy)
        for track in (True, False):
            err = exact(f"{w}x{h} track={track}", (pb.inst_t, pb.tile_start, pb.tile_end,
                                                   gx, gy, track))
            cases.append({"size": f"{w}x{h}", "track_contrib": track, "max_abs_err": err})
        # the keep rule on non-finite inputs: a NaN conic or opacity drops the pair
        err = exact(f"{w}x{h} NaN rows", (nan_rows(pb.inst_t), pb.tile_start, pb.tile_end,
                                          gx, gy, True))
        cases.append({"size": f"{w}x{h}", "nan_rows": True, "max_abs_err": err})
    edge = edge_table(device)
    stats = cull_summary(rc.cull_stats_torch(*edge), "edge table")
    err = exact("edge table", (*edge, True))
    cases.append({"case": "edge_table", "instances": edge[0].shape[1], "max_abs_err": err,
                  "kept_pairs": stats["kept_pairs"],
                  "culled_share": stats["culled_share"]["blocks_8x4"]})
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
    # the table on the warp cull's edges, with a seeded cotangent
    edge = edge_table(device)
    gx, gy = edge[3:]
    gen = torch.Generator(device=device).manual_seed(9)
    dout = torch.zeros((gx * gy, 256, 8), device=device)
    dout[..., :5] = torch.randn((gx * gy, 256, 5), generator=gen, device=device)
    fwd = rc.blend_fwd(*edge)
    got, want = rc.blend_bwd(*edge, fwd, dout), rc.blend_bwd_packed_torch(*edge, fwd, dout)
    check(bool(torch.isfinite(got).all()), "K3' edge table: non-finite rows")
    err = per_row_rel_err(got, want)
    check(err < ROW_REL, f"K3' edge table: per-row max rel err {err}")
    cases.append({"case": "edge_table", "instances": edge[0].shape[1], "max_rel_err": err,
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
    200x120, float32 and hybrid packets (and NaN conic/opacity rows):
    `torch.equal` (its warp cull and predicated walk add every kept pair in
    the twin's order); N and D per pixel relative to max(1, |want|) and T's
    abs error reported."""
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
                check(torch.equal(got, want),
                      f"K5' {w}x{h} {label}: not equal to its twin (N/D rel err {nd_rel}, "
                      f"T abs err {t_err})")
                cases.append({"size": f"{w}x{h}", "case": label, "instances": pb.num_instances,
                              "nd_max_rel_err": nd_rel, "t_max_abs_err": t_err,
                              "max_abs_err": float((got - want).abs().max()),
                              "bitwise_equal": bool(torch.equal(got, want))})
    return cases


def phase_oit_bwd(device):
    """K6' vs blend_oit_bwd_packed_torch at 640x480 and 200x120, float32 and
    hybrid packets, with a seeded cotangent of all six raw outputs (N0..3,
    D, T) and with NaN conic/opacity entries: `torch.equal` (each instance
    walks its box's pixels in the twin's order); the per-row max relative
    error reported."""
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
                check(torch.equal(got, want),
                      f"K6' {w}x{h} {label}: not equal to its twin (per-row max rel err {err})")
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
    screen = screen.detach()
    tables = tb._emission_tables(screen, 16, True)
    keys, gid, packets = tb.expand_instances(*tables[:5], screen, tables[5], gx, True)
    keys_sorted, perm = torch.sort(keys, stable=True)
    pack_args = (keys_sorted, perm, gid, packets, gx * gy, "bfloat16")
    pack_err = max_abs_diff("pack_instances (bf16)", ("inst_t", "gauss_id", "tile_id", "bounds"),
                            tb.pack_instances(*pack_args), tb._pack_instances_torch(*pack_args))
    pack_ms = cuda_time(lambda: tb.pack_instances(*pack_args), 20)
    pack_plain_ms = cuda_time(lambda: tb._pack_instances_torch(*pack_args), 3)
    live = int((tables[0][:, 3] > 0).sum())
    check(pack_ms >= pack_bound_of(tables[5], live, gx * gy)[0], "bf16 pack ran under its bound")
    summary = {
        "table_cases": cases, "gaussians": FULL["n"], "size": f"{FULL['width']}x{FULL['height']}",
        "instances": out["num_instances"], "frame_ms": frame_ms,
        "frame_ms_median": statistics.median(frame_ms), "launches": launches,
        "vs_float32_frame": {"max_abs_diff": float(diff.max()), "mean_abs_diff": float(diff.mean())},
    }
    row = measured(pack_ms, pack_plain_ms, pack_bound_of(tables[5], live, gx * gy),
                   pack_err, pack_err, gather_ref_ms=gather_ref_ms(packets, keys_sorted, perm, gid))
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


# rows of addends, added in turn into one float4 that starts at +0: a
# subnormal addend; normal addends whose sum is subnormal (exact: Sterbenz);
# a subnormal addend onto a subnormal sum
SUBNORMAL_CASES = {
    "subnormal_addend": [[1e-40, -1e-40, 5e-39, 1.1e-38]],
    "subnormal_sum": [[1.5e-38] * 4, [-1.4e-38] * 4],
    "subnormal_onto_subnormal": [[1e-40] * 4, [2e-40] * 4],
}
RED_FORMS = {"scalar_atomicAdd": 0, "red_v4": 1, "red_v2": 2}


def subnormal_outcome(got, want):
    """'kept' when every component is the exact float32 sum, 'flushed' when
    every one is zero (the exact sums are all subnormal); else it fails."""
    kept = bitwise_equal(got, want)
    flushed = not bool(got.any())
    check(kept or flushed, f"subnormal sum {got.tolist()}: neither {want.tolist()} nor 0")
    return "kept" if kept else "flushed"


def phase_subnormals(device):
    """What the card's float32 reductions do with subnormal addends and
    sums: the scalar `atomicAdd` (K4''s earlier form), the two vector `red` forms
    (`gs_red_forms`, a measurement aid outside every path), K4' itself and
    its twin (`index_add_`), each on SUBNORMAL_CASES."""
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.ops import reduce as rd

    lib = _kernels.load("reduce")
    out = {}
    for case, rows in SUBNORMAL_CASES.items():
        addends = torch.tensor(rows, dtype=torch.float32)
        want = torch.zeros(4, dtype=torch.float32)
        for r in addends:
            want = want + r  # sequential float32 sums on the host keep subnormals
        check(bool((want != 0).all() & (want.abs() < 1.1754944e-38).all()),
              f"{case}: the exact sums are not all subnormal")
        res = {}
        for form, code in RED_FORMS.items():
            acc = torch.zeros(4, dtype=torch.float32, device=device)
            a = addends.to(device).contiguous()
            _kernels.check(lib.gs_red_forms(a.data_ptr(), a.shape[0], code, acc.data_ptr(),
                                            _kernels.stream(device)), "red_forms")
            res[form] = subnormal_outcome(acc.cpu(), want)
        # K4' and its twin: each addend row as one instance's ten values
        # (the four components repeated), all into gaussian 0
        dinst = addends.repeat(1, 3)[:, :10].T.contiguous().to(device)
        gid = torch.zeros(addends.shape[0], dtype=torch.int32, device=device)
        want10 = want.repeat(3)[:10]
        for name, fn in (("k4", rd.reduce_by_gid_cuda), ("twin_index_add", rd.reduce_by_gid_torch)):
            res[name] = subnormal_outcome(fn(dinst, gid, 1)[:10, 0].cpu(), want10)
        out[case] = res
    return out


def cull_summary(stats, what):
    """`cull_stats_torch` of a frame, checked: no kept pair outside its
    box or at a pixel whose warp does not reach it."""
    check(stats["kept_outside_box"] == 0 and stats["kept_unreached"] == 0,
          f"{what}: {stats['kept_outside_box']} kept pairs outside their pixel box, "
          f"{stats['kept_unreached']} in warps the cull skips")
    return stats


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
        screen = screen.detach()
        tables = tb._emission_tables(screen, 16, True)
        ev[2].record()
        keys, gid, packets = tb.expand_instances(*tables[:5], screen, tables[5], gx, True)
        ev[3].record()
        keys_sorted, perm = torch.sort(keys, stable=True)
        ev[4].record()
        inst_t, gauss_id, tile_id, bounds = tb.pack_instances(keys_sorted, perm, gid, packets,
                                                              num_tiles)
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

    # --- K2' against its plain twin on the whole frame: max abs err 0 and
    # n_contrib exact; the twin's one call gives its time and the pairs each
    # pixel walks and the warp cull keeps (the kernel's evaluated pairs)
    starts, ends = bounds[:num_tiles], bounds[1:]
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain_blend, walked, pairs = rc.blend_packed_torch(inst_t, starts, ends, gx, gy,
                                                       count_pairs=True)
    torch.cuda.synchronize()
    blend_plain_ms = (time.perf_counter() - t) * 1e3
    blend_err, n_equal = blend_errors(blended, plain_blend)
    check(blend_err == 0.0 and n_equal, f"K2' on the flagship frame: max abs err {blend_err}, "
          f"n_contrib equal {n_equal}")
    blend_rel = blend_err / float(plain_blend[..., :5].abs().max())
    cull = cull_summary(rc.cull_stats_torch(inst_t, starts, ends, gx, gy), "render frame")

    # --- K1' against its plain twins at the frame's shapes
    exp_args = (*tables[:5], screen, k, gx, True)
    exp_err = expand_errors("expand_instances", (keys, gid, packets),
                            tb._expand_instances_torch(*exp_args), tables[0])
    pack_args = (keys_sorted, perm, gid, packets, num_tiles)
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

    exp_bound, live, trimmed_live, run_rows = expand_bound_of(tables)
    pack_bound = pack_bound_of(k, live, num_tiles)
    check(exp_ms >= exp_bound[0] and pack_ms >= pack_bound[0],
          f"K1' under its bound: expand {exp_ms} / {exp_bound[0]}, pack {pack_ms} / {pack_bound[0]}")
    # blend: 10 table rows per instance + 2 ranges per tile in; (T, 256, 8) out
    blend_bound = bound(k * 40 + num_tiles * 8 + num_tiles * 256 * 32, pairs * BLEND_OPS_PER_PAIR)
    check(blend_ms >= blend_bound[0], f"K2' ran in {blend_ms} ms, under its bound {blend_bound[0]}")

    rows = {
        # K1' is checked bit for bit (its errors are 0, so relative ones too)
        "expand_instances": measured(exp_ms, exp_plain_ms, exp_bound, exp_err, exp_err),
        "pack_instances": measured(pack_ms, pack_plain_ms, pack_bound, pack_err, pack_err,
                                   gather_ref_ms=gather_ref_ms(packets, keys_sorted, perm, gid)),
        "blend_fwd": measured(blend_ms, blend_plain_ms, blend_bound, blend_err, blend_rel,
                              walked_pairs=walked, evaluated_pairs=pairs,
                              culled_share=cull["culled_share"]["blocks_8x4"]),
    }
    summary = {
        "gaussians": n, "size": f"{FULL['width']}x{FULL['height']}", "instances": k,
        "live_gaussians": live, "trimmed_live_gaussians": trimmed_live,
        "trimmed_rows_with_run": run_rows,
        "walked_pairs": walked, "evaluated_pairs": pairs, "warp_cull": cull, "setup_s": setup_s,
        "frame_ms_median": statistics.median(frame_ms), "frame_ms": frame_ms,
        "device_profile": profile,
        "stage_ms_median": {s: statistics.median(v) for s, v in stage_ms.items()},
        "sort_ms": sort_ms, "launches": launches,
        "blend_full_frame_max_abs_err": blend_err,
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


def oit_walked_pairs(args, fwd=None, dout=None):
    """The (pixel, instance) pairs K5' walks on a frame (32 per (warp,
    instance) its cull lets through) and its culled share of the twin's
    evaluated pairs, from `blend_oit_culled_torch`, whose sums must equal
    the twin's bit for bit; with the backward's inputs, K6''s walked pairs
    (each instance's box pixels in its tile, narrowed to each row's span) from
    `blend_oit_bwd_walked_torch`, whose rows must equal the twin's."""
    from gsplat_tpu_torch.ops import rasterize_cuda as rc

    inst_t, starts, ends = args[:3]
    evaluated = int((ends - starts).sum()) * 256
    culled, walked = rc.blend_oit_culled_torch(*args)
    check(torch.equal(culled, rc.blend_oit_packed_torch(*args)),
          "blend_oit_culled_torch differs from blend_oit_packed_torch: the cull skips a kept pair")
    out = {"walked_pairs": walked, "culled_share": 1.0 - walked / max(evaluated, 1)}
    if fwd is not None:
        boxed, walked_bwd = rc.blend_oit_bwd_walked_torch(*args, fwd, dout)
        check(torch.equal(boxed, rc.blend_oit_bwd_packed_torch(*args, fwd, dout)),
              "blend_oit_bwd_walked_torch differs from its twin: the walk skips a kept pair")
        out = {"walked_pairs": walked_bwd, "culled_share": 1.0 - walked_bwd / max(evaluated, 1),
               "k5_walked_pairs": walked}
    return out


def phase_oit_render(device):
    """The full-width render in OIT mode through `render` (float32 packets),
    then a stage split and K5''s row: K5' equal to its twin on the whole
    frame (`torch.equal`), the twin's time and its evaluated and kept pair
    counts, K5''s walked pairs and culled share."""
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
    check(torch.equal(raw, plain), "K5' on the OIT render frame: not equal to its twin")
    full_nd, full_t = oit_errors(raw, plain)
    walked = oit_walked_pairs(args)
    k5_ms = cuda_time(lambda: rc.blend_oit_fwd(*args), 20)
    k = pb.num_instances
    # K5': 10 table rows per instance + 2 ranges per tile in; (T, 256, 8) out
    k5_bound = bound(k * 40 + num_tiles * 8 + num_tiles * 256 * 32,
                     evaluated * BLEND_OPS_PER_PAIR + kept * OIT_FWD_OPS_PER_KEPT)
    summary = {
        "gaussians": FULL["n"], "size": f"{FULL['width']}x{FULL['height']}", "instances": k,
        "evaluated_pairs": evaluated, "kept_pairs": kept, **walked, "setup_s": setup_s,
        "frame_ms_median": statistics.median(frame_ms), "frame_ms": frame_ms,
        "frames_in_turns_ms_median": {m: statistics.median(v) for m, v in turns.items()},
        "device_profile": profile,
        "stage_ms_median": {s: statistics.median(v) for s, v in stage_ms.items()},
        "launches": launches, "peak_mem_gib": peak_gib, "k5_check_tiles": CHECK_TILES,
        "k5_full_frame": {"nd_max_rel_err": full_nd, "t_max_abs_err": full_t,
                          "bitwise_equal": bool(torch.equal(raw, plain))},
    }
    row = measured(k5_ms, plain_ms, k5_bound, float((raw - plain).abs().max()), full_nd,
                   evaluated_pairs=evaluated, kept_pairs=kept, **walked, t_max_abs_err=full_t,
                   bitwise_equal=bool(torch.equal(raw, plain)))
    return summary, {"oit_fwd": row}


def write_blender_scene(root: Path, size=800, n=200_000, seed=0, test_views=0):
    """A seeded 3-view Blender-format scene (and `test_views` held-out views
    between them) and a PLY snapshot of n gaussians."""
    from PIL import Image

    from gsplat_tpu_torch.data.ply import save_gaussian_ply

    rng = np.random.default_rng(seed)
    src = root / "scene"
    src.mkdir()
    frames = []
    for i in range(3 + test_views):
        angle = (i if i < 3 else i - 2.5) * 2.0 * np.pi / 3
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
    for split, fr in (("train", frames[:3]), ("test", frames[3:])):
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
CLI_INIT_POINTS = 100_000  # the Blender reader's random init of the CLI scenes


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


def flagship_train_setup(device, settings, full=None, capacity=None):
    """The train path's inputs: the flagship scene (`full`, default FULL)
    with seeded noise on features_dc and opacity, padded with dead rows to
    `capacity` (default TRAIN_CAPACITY), its initial state, the step's
    arguments (target: the unperturbed scene's render) and the config."""
    from gsplat_tpu_torch.config import OptimizationConfig
    from gsplat_tpu_torch.convert import PARAM_FIELDS
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.synthetic import tiny_scene
    from gsplat_tpu_torch.train import step as ts

    full = full or FULL
    module, alive0, camera = tiny_scene(**full, device=device)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():  # the target: the unperturbed scene's render
        target = render(camera, module, alive0, settings, bg, device=device)["render"]
    params = {k: getattr(module, k).detach().clone() for k in PARAM_FIELDS}
    del module
    gen = torch.Generator(device=device).manual_seed(1)
    for k, sigma in (("features_dc", 0.3), ("opacity", 0.5)):
        params[k] += sigma * torch.randn(params[k].shape, generator=gen, device=device)
    params, alive = pad_rows(params, alive0, capacity or TRAIN_CAPACITY)
    state = ts.init_train_state(params, alive, num_images=1, seed=0)
    opt = OptimizationConfig()
    h, w = full["height"], full["width"]
    zeros = torch.zeros((h, w), device=device)
    args = (camera, target, torch.ones((h, w, 1), device=device), zeros, zeros, bg,
            opt.position_lr_init, opt.exposure_lr_init, 0.0, 0)
    return state, args, opt


def phase_train(device, blend_mode="sorted"):
    """The train path at full width: the flagship scene through
    `make_train_step` in hybrid mode, with the sorted or the OIT blend; then
    the stage split, the busy share, and the kernel rows at the train
    frame's shapes: K3', K4' and the hybrid K1' pack (sorted), K6' (OIT)."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops import reduce as rd
    from gsplat_tpu_torch.train import losses
    from gsplat_tpu_torch.train import step as ts

    t0 = time.perf_counter()
    settings = make_render_settings(sh_degree=3, packet_dtype="hybrid", blend_mode=blend_mode)
    oit = blend_mode == "oit"
    state, args, opt = flagship_train_setup(device, settings)
    alive = state.alive
    step = ts.make_train_step(opt, settings)
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
                        (ts, "adam_update", "adam0", "adam1"), (tb, "pack_instances", None, None),
                        (tb, "expand_instances", None, None)])
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
    k3_args, k4_args, pack_args, exp_args = (marks.args[a] for a in (
        bwd_attr, "reduce_by_gid_cuda", "pack_instances", "expand_instances"))
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
                else kernel_rows_train(k3_args, k4_args, pack_args, exp_args))
    return summary, state, rows, k3_args


def kernel_rows_train(k3_args, k4_args, pack_args, exp_args):
    """K3', K4' and the hybrid K1' pack and expand on the inputs one train
    step gave them: time, plain twin time, error and bound."""
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
    want, walked, blended = rc.blend_bwd_packed_torch(*k3_args, count_pairs=True)
    torch.cuda.synchronize()
    k3_plain_ms = (time.perf_counter() - t) * 1e3
    k3_rel = per_row_rel_err(got, want)
    check(k3_rel < ROW_REL, f"K3' on the train frame: per-row max rel err {k3_rel}")
    k3_ms = cuda_time(lambda: rc.blend_bwd(*k3_args), 20)

    # K2' on the train frame: bit for bit its twin, its time; the twin
    # counts the pairs the warp cull lets K2' and K3' evaluate
    fargs = k3_args[:5]
    k2_got = rc.blend_fwd(*fargs)
    k2_want, k2_walked, evaluated = rc.blend_packed_torch(*fargs, count_pairs=True)
    k2_err, k2_n_equal = blend_errors(k2_got, k2_want)
    check(k2_err == 0.0 and k2_n_equal and k2_walked == walked,
          f"K2' on the train frame: max abs err {k2_err}, n_contrib equal {k2_n_equal}, "
          f"walked {k2_walked} vs K3' twin {walked}")
    k2_train_ms = cuda_time(lambda: rc.blend_fwd(*fargs), 20)
    cull = cull_summary(rc.cull_stats_torch(*fargs), "train frame")

    # K3': 10 table rows per instance + 2 ranges per tile + the forward
    # output and its cotangent (T, 256, 8) each in; 10 rows per instance out.
    # Operations: the forward's 11 per evaluated pair + 45 per blended pair
    k3_bound = bound(k * 40 + num_tiles * 8 + 2 * num_tiles * 256 * 32 + k * 40,
                     evaluated * BLEND_OPS_PER_PAIR + blended * BWD_OPS_PER_BLENDED)
    check(k3_ms >= k3_bound[0], f"K3' ran in {k3_ms} ms, under its bound {k3_bound[0]}")

    # K4' (hybrid: pack_bf16) against index_add_, off and on
    dinst, gid, n, pack = k4_args
    check(pack is True, "the hybrid train step must reduce with pack_bf16")
    k4_err, k4_rel, k4_miss = reduce_errors(dinst, gid, n)
    k4_ms = cuda_time(lambda: rd.reduce_by_gid_cuda(dinst, gid, n, True), 20)
    k4_plain_ms = cuda_time(lambda: rd.reduce_by_gid_torch(dinst, gid, n, True), 20)
    # the same rows at the live gaussians' N (the padding rows own no
    # instance): the accumulator's working set without the dead rows
    n_live = int(gid.max()) + 1
    k4_live_n_ms = cuda_time(lambda: rd.reduce_by_gid_cuda(dinst, gid, n_live, True), 20)
    # a yardstick inside K4''s time: zeroing its (N, 16) accumulator alone
    zero_ref_ms = cuda_time(lambda: torch.zeros((n, rd.N_ROWS), device=dinst.device), 20)
    # library: one index_add_ of the same (already rounded) rows into a fresh
    # zeroed output, as K4' zeroes its own
    rows10, gid_l = tb.round_bf16(dinst[:10]), gid.long()
    lib_ms = cuda_time(lambda: torch.zeros((16, n), device=dinst.device)[:10].index_add_(
        1, gid_l, rows10), 20)
    # K4': 10 rows + gid per instance in; 10 x N floats out; 10 adds per instance
    k4_bound = bound(k * (40 + 4) + n * 40, 10 * k)
    check(k4_ms >= k4_bound[0], f"K4' ran in {k4_ms} ms, under its bound {k4_bound[0]}")

    # the expand at the train frame (2,097,152 rows, half of them dead)
    # and the hybrid pack, each against its twin bit for bit
    exp_err = expand_errors("expand_instances (train frame)", tb.expand_instances(*exp_args),
                            tb._expand_instances_torch(*exp_args), exp_args[0])
    exp_ms = cuda_time(lambda: tb.expand_instances(*exp_args), 20)
    exp_plain_ms = cuda_time(lambda: tb._expand_instances_torch(*exp_args), 3)
    exp_bound, _, _, _ = expand_bound_of((*exp_args[:5], exp_args[6]))
    keys_sorted, perm, kgid, packets, pt = pack_args[:5]
    check(pack_args[5] == "hybrid", "the train step packs hybrid instances")
    outs = tb.pack_instances(*pack_args)
    pack_err = max_abs_diff("pack_instances (hybrid)", ("inst_t", "gauss_id", "tile_id", "bounds"),
                            outs, tb._pack_instances_torch(*pack_args))
    pack_ms = cuda_time(lambda: tb.pack_instances(*pack_args), 20)
    pack_plain_ms = cuda_time(lambda: tb._pack_instances_torch(*pack_args), 3)
    live = int(torch.unique(kgid).numel())
    pack_bound = pack_bound_of(keys_sorted.shape[0], live, pt)
    check(exp_ms >= exp_bound[0] and pack_ms >= pack_bound[0],
          f"K1' under its bound on the train frame: expand {exp_ms} / {exp_bound[0]}, "
          f"pack {pack_ms} / {pack_bound[0]}")

    return {
        "pack_instances_hybrid": measured(pack_ms, pack_plain_ms, pack_bound, pack_err, pack_err,
                                          gather_ref_ms=gather_ref_ms(packets, keys_sorted, perm,
                                                                      kgid)),
        # the expand on the train frame (its row is the render frame's)
        "expand_instances_train_frame": measured(exp_ms, exp_plain_ms, exp_bound, exp_err,
                                                 exp_err, rows=int(exp_args[0].shape[0])),
        # K3': the largest per-row relative error (the check's measure)
        "blend_bwd": measured(k3_ms, k3_plain_ms, k3_bound, float((got - want).abs().max()),
                              k3_rel, walked_pairs=walked, evaluated_pairs=evaluated,
                              blended_pairs=blended,
                              culled_share=cull["culled_share"]["blocks_8x4"]),
        # K2' on the train frame (its row is the render frame's)
        "blend_fwd_train_frame": {"ms": k2_train_ms, "max_abs_err": k2_err,
                                  "walked_pairs": k2_walked, "evaluated_pairs": evaluated,
                                  "warp_cull": cull},
        "reduce_by_gid": measured(k4_ms, k4_plain_ms, k4_bound, k4_err, k4_rel,
                                  library_ms=lib_ms, unrounded_rel_miss=k4_miss,
                                  live_n=n_live, ms_at_live_n=k4_live_n_ms,
                                  zero_ref_ms=zero_ref_ms),
    }


def kernel_rows_oit_train(k6_args):
    """K6' on the inputs one OIT train step gave it: equal to its twin on the
    whole frame (`torch.equal`; the twin's one call is timed), and the
    step's K5' output equal to K5''s twin; its time, its bound from the
    frame's evaluated and kept pairs, its walked pairs and culled share."""
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
    check(torch.equal(got, want), f"K6' on the OIT train frame: not equal to its twin "
          f"(per-row max rel err {rel})")
    fwd_plain, evaluated, kept = rc.blend_oit_packed_torch(inst_t, starts, ends, gx, gy,
                                                           count_pairs=True)
    check(torch.equal(k6_args[5], fwd_plain),
          "K5' on the OIT train frame: not equal to its twin")
    walked = oit_walked_pairs(k6_args[:5], *k6_args[5:])
    ms = cuda_time(lambda: rc.blend_oit_bwd(*k6_args), 20)
    # K6': 10 table rows per instance + 2 ranges per tile + T_final and the
    # cotangents of N0..3, D and T per pixel in; 10 rows per instance out
    bnd = bound(k * 40 + num_tiles * 8 + num_tiles * 256 * 28 + k * 40,
                evaluated * BLEND_OPS_PER_PAIR + kept * OIT_BWD_OPS_PER_KEPT)
    return {"oit_bwd": measured(ms, plain_ms, bnd, float((got - want).abs().max()), rel,
                                evaluated_pairs=evaluated, kept_pairs=kept, **walked,
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


# the COLMAP path: 8 views of the flagship cloud at 1920x1080 on a ring, and
# 262,144 SfM-like points; densify rounds at iterations 40, 80 and 120 with
# grad threshold 0, so every alive gaussian is cloned or split and each round
# about doubles the count (at 1e-6 too few were hot on this scene for the
# count to pass 75% of the init's rows, and the capacity never grew)
COLMAP = dict(views=8, points=262_144, iterations=200, densify_from_iter=20,
              densification_interval=40, densify_until_iter=121, grad_threshold=0.0)
COLMAP_INIT_ROWS = 524_288  # `init_from_pcd`'s rows for 262,144 points
RESIZE_TO = {"grow": 3_145_728, "shrink": 1_310_720}


def ring_poses(n, radius=4.0, height=0.5):
    """World-to-camera (R, t) of `n` views on a ring around the origin,
    each looking at it (the pose construction of
    `scripts/make_fixtures.py:make_colmap_gaussian_scene`)."""
    poses = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        p = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        z = -p / np.linalg.norm(p)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        poses.append((R, -R @ p))
    return poses


class NativeCalls:
    """Counts the calls of the port's native COLMAP readers that returned a
    result, by swapping the module attributes while active."""

    NAMES = ("colmap_cameras", "colmap_images", "colmap_points3d")

    def __init__(self):
        from gsplat_tpu_torch.data import native

        self.native, self.calls, self._saved = native, {n: 0 for n in self.NAMES}, {}

    def __enter__(self):
        for name in self.NAMES:
            fn = self._saved[name] = getattr(self.native, name)

            def counted(path, _fn=fn, _name=name):
                out = _fn(path)
                self.calls[_name] += out is not None
                return out

            setattr(self.native, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.native, name, fn)


def write_colmap_scene(root: Path, device, views=COLMAP["views"]):
    """A COLMAP scene of the flagship cloud, written by the port's
    `colmap.write_model`: one PINHOLE camera at 1920x1080 with the flagship
    camera's horizontal field of view, `views` posed views on a ring, and
    `points3D.bin` holding a noisy subset of the cloud's centres with their
    DC colours (as `scripts/make_fixtures.py:145-272` builds its points).
    The model is read back once through the port's reader, which must take
    the native path; each view's image is then the float32 sorted render
    (K1', K2') of the cloud from the camera the reader gave."""
    from PIL import Image

    from gsplat_tpu_torch.core.sh import sh_to_rgb
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.data import colmap
    from gsplat_tpu_torch.data.cameras import make_camera
    from gsplat_tpu_torch.data.readers import read_scene_info
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.synthetic import tiny_scene

    params, alive, _ = tiny_scene(**FULL, device=device)
    w, h = FULL["width"], FULL["height"]
    focal = w / (2.0 * np.tan(0.45))  # tiny_scene's fovx 0.9, square pixels
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", w, h, np.array([focal, focal, w / 2, h / 2]))}
    images = {i + 1: colmap.ColmapImage(i + 1, colmap.rotmat2qvec(R), t, 1, f"v_{i:03d}.png",
                                        np.zeros((0, 2)), np.zeros((0,), np.int64))
              for i, (R, t) in enumerate(ring_poses(views))}
    rng = np.random.default_rng(0)
    sel = np.sort(rng.choice(FULL["n"], COLMAP["points"], replace=False))
    xyz = params.xyz.detach().cpu().numpy()[sel].astype(np.float64)
    xyz += rng.normal(0, 0.01, xyz.shape)
    dc = params.features_dc.detach().cpu().numpy()[sel, 0]
    rgb = (np.clip(sh_to_rgb(dc), 0.0, 1.0) * 255).astype(np.uint8)
    src = root / f"colmap_scene_{views}"
    (src / "images").mkdir(parents=True)
    t = time.perf_counter()
    colmap.write_model(cams, images, (xyz, rgb, np.zeros(len(sel))), str(src / "sparse" / "0"))
    write_s = time.perf_counter() - t

    with NativeCalls() as nat:
        info = read_scene_info(str(src))
    check(all(n == 1 for n in nat.calls.values()),
          f"the COLMAP reader did not take the native path: {nat.calls}")
    check(len(info.train_cameras) == views and info.points.shape == (COLMAP["points"], 3),
          f"read {len(info.train_cameras)} views and {info.points.shape[0]} points")

    settings = make_render_settings(sh_degree=3, packet_dtype="float32")
    reset_counts()
    for ci in info.train_cameras:
        cam = make_camera(ci.R, ci.T, ci.fovx, ci.fovy, ci.width, ci.height, device=device)
        with torch.no_grad():
            img = render(cam, params, alive, settings, [0.0, 0.0, 0.0], device=DEVICE)["render"]
        check(float(img.std()) > 0.01, f"{ci.image_name}: the ground-truth view is flat")
        Image.fromarray((img.cpu().numpy() * 255 + 0.5).astype(np.uint8)).save(
            src / "images" / ci.image_name)
    gt_launches = read_counts()
    check_counts(gt_launches, RENDER_KERNELS, views, "COLMAP ground-truth renders")
    return src, {"native_calls": nat.calls, "write_model_s": write_s,
                 "gt_launches": gt_launches}


def phase_colmap_train(device):
    """A COLMAP scene trains through the port's loop at 1080p while its
    gaussian capacity grows (`capacity=0`, hybrid packets), then the render
    CLI renders the saved model. Counts are reset just before the training
    and read just after: K1''s expand and hybrid pack, K2', K3' and K4' once
    per iteration, nothing else."""
    from PIL import Image

    from gsplat_tpu_torch.cli import render as render_cli
    from gsplat_tpu_torch.config import (ModelConfig, OptimizationConfig, PipelineConfig,
                                         save_cfg_args)
    from gsplat_tpu_torch.train import loop

    iters = COLMAP["iterations"]
    densify_its = {it for it in range(1, iters + 1)
                   if COLMAP["densify_from_iter"] < it < COLMAP["densify_until_iter"]
                   and it % COLMAP["densification_interval"] == 0}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t = time.perf_counter()
        src, scene_facts = write_colmap_scene(Path(tmp), device)
        setup_s = time.perf_counter() - t
        model = Path(tmp) / "model"
        cfg = ModelConfig(source_path=str(src), model_path=str(model), resolution=1,
                          sh_degree=3)
        save_cfg_args(str(model), cfg)
        opt = OptimizationConfig(
            iterations=iters, densify_from_iter=COLMAP["densify_from_iter"],
            densification_interval=COLMAP["densification_interval"],
            densify_until_iter=COLMAP["densify_until_iter"],
            densify_grad_threshold=COLMAP["grad_threshold"])
        pipe = PipelineConfig(capacity=0, packet_dtype="hybrid")

        step_end, loss, trajectory, resizes = {}, [], [], []

        def on_iteration(it, state, metrics):
            torch.cuda.synchronize()
            step_end[it] = time.perf_counter()
            loss.append(float(metrics["loss"]))
            if it in densify_its or it == iters:
                trajectory.append({"iteration": it, "capacity": state.capacity,
                                   "alive": int(state.alive.sum())})

        resize = loop.resize_train_state

        def timed_resize(state, new_capacity):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = resize(state, new_capacity)
            torch.cuda.synchronize()
            resizes.append({"iteration": max(step_end, default=0) + 1, "from": state.capacity,
                            "to": out.capacity, "ms": (time.perf_counter() - t0) * 1e3})
            return out

        loop.resize_train_state = timed_resize
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        try:
            t = time.perf_counter()
            state, scene, _ = loop.train(
                cfg, opt, pipe, testing_iterations=(), saving_iterations=(iters,), quiet=True,
                log_every=10, on_iteration=on_iteration, seed=0, device=DEVICE)
            train_s = time.perf_counter() - t
        finally:
            loop.resize_train_state = resize
        launches = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check_counts(launches, TRAIN_KERNELS, iters, f"COLMAP train path, {iters} iterations")
        check(len(scene.get_train_cameras()) == COLMAP["views"]
              and scene.info.points.shape[0] == COLMAP["points"],
              f"the loop read {len(scene.get_train_cameras())} views and "
              f"{scene.info.points.shape[0]} init points")
        n_alive = int(state.alive.sum())
        check(resizes and resizes[0]["to"] > resizes[0]["from"] == COLMAP_INIT_ROWS,
              f"the gaussian capacity never grew from {COLMAP_INIT_ROWS}: {resizes}, "
              f"capacity and alive at the densify rounds {trajectory}")
        check(state.capacity > COLMAP_INIT_ROWS and n_alive > COLMAP["points"],
              f"capacity {state.capacity}, alive {n_alive} at the end: {trajectory}")
        check(all(np.isfinite(loss)), f"non-finite loss: {loss}")
        # a view's loss per iteration: the means of the first and the last
        # ten iterations cover every view about once
        check(np.mean(loss[-10:]) < np.mean(loss[:10]), f"loss did not fall: {loss}")
        for k, v in state.params.items():
            check(not bool(torch.isnan(v).any()), f"NaN in {k} after the COLMAP training")

        step_ms = {it: (step_end[it] - step_end[it - 1]) * 1e3 for it in range(2, iters + 1)}
        first, last = resizes[0]["iteration"], resizes[-1]["iteration"]
        before = [ms for it, ms in step_ms.items() if it < first]
        after = [ms for it, ms in step_ms.items() if it > last + 1 and it not in densify_its]
        del state

        reset_counts()
        rc_ = render_cli.main(["-m", str(model), "-s", str(src), "--device", DEVICE, "--quiet"])
        render_launches = read_counts()
        check(rc_ == 0, "render CLI returned non-zero on the COLMAP model")
        check_counts(render_launches, RENDER_KERNELS, COLMAP["views"],
                     "render CLI on the COLMAP model")
        out = model / "train" / f"ours_{iters}"
        psnr = []
        for p in sorted((out / "renders").iterdir()):
            a = np.asarray(Image.open(p), np.float32) / 255.0
            g = np.asarray(Image.open(out / "gt" / p.name), np.float32) / 255.0
            check(a.shape == (FULL["height"], FULL["width"], 3) and a.std() > 0.01,
                  f"{p.name}: blank or misshapen render of the COLMAP model")
            psnr.append(float(-10 * np.log10(np.mean((a - g) ** 2))))
        check(len(psnr) == COLMAP["views"], f"render CLI wrote {len(psnr)} views")
    return {
        **COLMAP, "size": f"{FULL['width']}x{FULL['height']}", "packet_dtype": "hybrid",
        **scene_facts, "setup_s": setup_s, "train_s": train_s,
        "step_ms_median_before_first_grow": statistics.median(before),
        "step_ms_median_after_last_grow": statistics.median(after),
        "steps_before_first_grow": len(before), "steps_after_last_grow": len(after),
        "resizes": resizes, "trajectory": trajectory, "alive_end": n_alive,
        "loss": loss, "peak_mem_gib": peak_gib, "launches": launches,
        "render_cli_launches": render_launches, "render_cli_psnr_vs_gt": psnr,
    }


def phase_resize(state, device):
    """Grow the train path's flagship state (2,097,152 rows, 1,048,576
    alive, after its steps) to 3,145,728 rows and shrink it to 1,310,720:
    the alive rows' params, Adam moments, counts and stats equal the
    originals in alive order bit for bit, dead rows are sanitized, and each
    resized state renders the original's image within atol 1e-6
    (`tests/test_capacity.py:193`)."""
    from types import SimpleNamespace

    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.synthetic import tiny_scene
    from gsplat_tpu_torch.train.densify import DEAD_PARAMS
    from gsplat_tpu_torch.train.resize import resize_train_state

    n = int(state.alive.sum())
    check(state.capacity == TRAIN_CAPACITY and n == FULL["n"],
          f"the train state holds {n} alive of {state.capacity} rows")
    _, _, camera = tiny_scene(n=1, width=FULL["width"], height=FULL["height"], device=device)
    settings = make_render_settings(sh_degree=3)

    def image(st):
        with torch.no_grad():
            return render(camera, SimpleNamespace(**st.params), st.alive, settings,
                          [0.0, 0.0, 0.0], device=DEVICE)["render"]

    def alive_rows(st):
        idx = torch.nonzero(st.alive).flatten()
        rows = {f"{name}.{k}": v[idx] for name in ("params", "adam_m", "adam_v")
                for k, v in getattr(st, name).items()}
        rows.update({f"stats.{k}": v[idx] for k, v in st.stats.items()})
        rows["adam_counts"] = st.adam_counts[idx]
        return rows

    base = image(state)
    want = alive_rows(state)
    out = {}
    for name, cap in RESIZE_TO.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        new = resize_train_state(state, cap)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        check(new.capacity == cap and int(new.alive.sum()) == n,
              f"{name}: {int(new.alive.sum())} alive of {new.capacity} rows")
        got = alive_rows(new)
        for k, v in want.items():
            same = bitwise_equal(got[k], v) if v.is_floating_point() else torch.equal(got[k], v)
            check(same, f"{name}: alive rows of {k} differ from the original")
        if name == "shrink":
            check(bool(new.alive[:n].all()), "shrink: the alive rows are not first")
        dead = ~new.alive
        p = new.params
        check(bool((p["scaling"][dead] == DEAD_PARAMS["scaling"]).all()
                   and (p["opacity"][dead] == DEAD_PARAMS["opacity"]).all()
                   and (p["rotation"][dead] == p["rotation"].new_tensor([1.0, 0, 0, 0])).all()),
              f"{name}: dead rows are not sanitized")
        err = float((image(new) - base).abs().max())
        check(err <= 1e-6, f"{name}: the resized state renders {err} away from the original")
        out[name] = {"rows": cap, "ms": ms, "render_max_abs_err": err}
        del new, got
    return {"rows": TRAIN_CAPACITY, "alive": n, **out}


# the checkpoint path: a 16-view COLMAP scene of the flagship cloud (eval
# holds out views 0 and 8, llffhold 8), trained with `COLMAP`'s densify
# settings: run A to 120 iterations with rolling checkpoints, run B resumed
# from A's chkpnt120.pkl to 200
CKPT = dict(views=16, iterations_a=120, iterations_b=200, checkpoint_every=40,
            testing_a=(60, 120), testing_b=(200,))
EVAL_TRAIN_VIEWS = 5  # the sweep's train views 5, 10, ..., 25 mod their count
LPIPS_CROP = (270, 480)  # the metrics' card-vs-CPU comparison crop
METRIC_REL = 1e-5


class Swaps:
    """Module attributes swapped for wrappers while active."""

    def __init__(self, module, **wrappers):
        self.module, self.wrappers, self.saved = module, wrappers, {}

    def __enter__(self):
        for name, make in self.wrappers.items():
            self.saved[name] = getattr(self.module, name)
            setattr(self.module, name, make(self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def eval_counts(iterations, renders):
    """Launches of a training run with `renders` evaluation renders: K1'
    (expand, hybrid pack) and K2' per iteration and per render, K3' and K4'
    per iteration."""
    return {"expand_instances": iterations + renders, "pack_instances_hybrid": iterations + renders,
            "blend_fwd": iterations + renders, "blend_bwd": iterations,
            "reduce_by_gid": iterations}


def check_launches(counts, want, what):
    for name, got in counts.items():
        check(got == want.get(name, 0), f"{what}: {name} launched {got} times, "
              f"want {want.get(name, 0)}")


def states_equal(a, b):
    """Every tensor of two train states bit for bit, the generator states and
    the step equal."""
    from gsplat_tpu_torch.convert import train_state_tree

    ta, tb = train_state_tree(a), train_state_tree(b)
    for k, v in ta.items():
        if isinstance(v, dict):
            for f, t in v.items():
                check(bitwise_equal(t, tb[k][f]), f"loaded state differs in {k}.{f}")
        elif isinstance(v, torch.Tensor):
            check(bitwise_equal(v, tb[k]), f"loaded state differs in {k}")
        elif isinstance(v, np.ndarray):
            check(np.array_equal(v, tb[k]), f"loaded state differs in {k}")
        else:
            check(v == tb[k], f"loaded state differs in {k}: {v} != {tb[k]}")


def phase_checkpoint_resume(device, root: Path):
    """Run A trains the 16-view COLMAP scene 120 iterations (densify at 40,
    80, 120 as `colmap_train`; rolling checkpoints every 40 on the worker
    thread, chkpnt120.pkl at 120, evaluations at 60 and 120); run B resumes
    from chkpnt120.pkl to 200 (rolling checkpoints every 40, evaluation and
    snapshot at 200). Counts are reset just before each run and read just
    after. Checks: the loaded state equals A's final state bit for bit,
    generator included; the rolling checkpoint holds 120 after A's flush; B
    starts at 121 with A's SH degree and its controller at the
    checkpoint's capacity, with no resize; `evaluate_test` equals a direct
    render + `losses.psnr` of the test views within 1e-6 relative to
    max(1, |value|); at 200 B's test PSNR is finite and its sweep's train
    views at least as sharp as at 60. Run C trains the same scene
    uninterrupted to 200, evaluated at 60, 120 and 200, beside A and B. The
    render CLI then renders B's test views (kept for `metrics`); the
    checkpoints are deleted."""
    import threading
    from types import SimpleNamespace

    from gsplat_tpu_torch.cli import render as render_cli
    from gsplat_tpu_torch.config import (ModelConfig, OptimizationConfig, PipelineConfig,
                                         save_cfg_args)
    from gsplat_tpu_torch.convert import read_checkpoint
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.train import loop, losses

    t = time.perf_counter()
    src, _ = write_colmap_scene(root, device, views=CKPT["views"])
    setup_s = time.perf_counter() - t
    model = root / "ckpt_model"
    cfg = ModelConfig(source_path=str(src), model_path=str(model), resolution=1, sh_degree=3,
                      eval=True)
    save_cfg_args(str(model), cfg)
    opt_a = OptimizationConfig(
        iterations=CKPT["iterations_a"], densify_from_iter=COLMAP["densify_from_iter"],
        densification_interval=COLMAP["densification_interval"],
        densify_until_iter=COLMAP["densify_until_iter"],
        densify_grad_threshold=COLMAP["grad_threshold"])
    pipe = PipelineConfig(capacity=0, packet_dtype="hybrid")
    chkpnt = model / f"chkpnt{CKPT['iterations_a']}.pkl"
    rolling = model / "rolling_chkpnt.pkl"

    rec = {"sh": [], "ctl": [], "resizes": [], "save_ms": [], "load_ms": [], "d2h": [],
           "writes": [], "loaded": None}

    # the loop's own stream: a device-wide synchronize would also wait for
    # the checkpoint writer's copy on its side stream, which the loop never does
    def sync():
        torch.cuda.current_stream().synchronize()

    def timed(key, fn):
        def wrapper(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            rec[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    def loading(fn):
        def wrapper(*a, **kw):
            state, it = timed("load_ms", fn)(*a, **kw)
            rec["loaded"] = (state, state.rng.get_state().clone(), it)
            return state, it
        return wrapper

    def span(key):  # wall-clock spans of the writer thread's copy and write
        def make(fn):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if threading.current_thread().name.startswith("ckpt"):
                    rec[key].append((t0, time.perf_counter()))
                return out
            return wrapper
        return make

    def make_step(fn):
        def wrapper(opt, settings, **kw):
            rec["sh"].append(settings.sh_degree)
            return fn(opt, settings, **kw)
        return wrapper

    def controller(cls):
        class Recording(cls):
            def __init__(self, capacity, **kw):
                rec["ctl"].append(capacity)
                super().__init__(capacity, **kw)
        return Recording

    def resize(fn):
        def wrapper(state, cap):
            rec["resizes"].append((state.capacity, cap))
            return fn(state, cap)
        return wrapper

    runs = {}
    with Swaps(loop, save_checkpoint=lambda fn: timed("save_ms", fn), load_checkpoint=loading,
               tree_to_numpy=span("d2h"), write_checkpoint=span("writes"),
               make_train_step=make_step, CapacityController=controller,
               resize_train_state=resize):
        for name, opt, kw in (
                ("a", opt_a, dict(testing_iterations=CKPT["testing_a"], saving_iterations=(),
                                  checkpoint_iterations=(CKPT["iterations_a"],))),
                ("b", dataclasses.replace(opt_a, iterations=CKPT["iterations_b"]),
                 dict(testing_iterations=CKPT["testing_b"],
                      saving_iterations=(CKPT["iterations_b"],), start_checkpoint=str(chkpnt)))):
            ends = {}

            def on_iteration(it, state, metrics, ends=ends):
                sync()
                ends[it] = time.perf_counter()

            marks = {k: len(v) for k, v in rec.items() if isinstance(v, list)}
            reset_counts()
            t0 = time.perf_counter()
            state, scene, results = loop.train(
                cfg, opt, pipe, quiet=True, log_every=10, on_iteration=on_iteration, seed=0,
                checkpoint_every=CKPT["checkpoint_every"], device=DEVICE, **kw)
            runs[name] = dict(state=state, results=results, ends=ends, t0=t0,
                              wall_s=time.perf_counter() - t0, launches=read_counts(),
                              **{k: rec[k][m:] for k, m in marks.items()})
            if name == "a":
                check(read_checkpoint(str(rolling))["iteration"] == CKPT["iterations_a"],
                      "the rolling checkpoint after A's flush does not hold iteration 120")
    a, b = runs["a"], runs["b"]
    test_cams, train_cams = scene.get_test_cameras(), scene.get_train_cameras()
    check(len(test_cams) == 2 and len(train_cams) == CKPT["views"] - 2,
          f"{len(test_cams)} test and {len(train_cams)} train views, want 2 and 14")
    renders = 2 + EVAL_TRAIN_VIEWS
    check_launches(a["launches"], eval_counts(CKPT["iterations_a"], renders * len(CKPT["testing_a"])),
                   "checkpoint run A")
    check_launches(b["launches"], eval_counts(CKPT["iterations_b"] - CKPT["iterations_a"],
                                              renders * len(CKPT["testing_b"])),
                   "checkpoint run B")

    # the round trip: what B loaded is A's final state, bit for bit
    loaded, loaded_rng, it = rec["loaded"]
    check(it == CKPT["iterations_a"], f"B loaded iteration {it}")
    states_equal(loaded, a["state"])
    check(torch.equal(loaded_rng, a["state"].rng.get_state()),
          "the loaded generator state differs from A's")
    check(min(b["ends"]) == CKPT["iterations_a"] + 1, f"B started at {min(b['ends'])}")
    check(b["sh"] == a["sh"][-1:], f"SH degrees: A built {a['sh']}, B built {b['sh']}")
    check(b["ctl"] == [a["state"].capacity] and not b["resizes"]
          and b["state"].capacity == a["state"].capacity,
          f"B's controller started at {b['ctl']} (A ended at {a['state'].capacity}), "
          f"resizes {b['resizes']}")
    check(a["ctl"] == [COLMAP_INIT_ROWS] and a["resizes"], f"A's controller {a['ctl']}, "
          f"resizes {a['resizes']}")

    # evaluate_test against a direct render of the test views (counted apart)
    settings = make_render_settings(sh_degree=a["sh"][-1], packet_dtype="hybrid")
    bg = torch.zeros(3, device=device)
    st = a["state"]
    pixels = loop.PixelCache(device)
    reset_counts()
    eval_ms = []  # the first sweep uploads the ground truth, the second reads it cached
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = loop.evaluate_test(st, test_cams, settings, bg, pixels)
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    eval_launches = read_counts()
    check_launches(eval_launches, {"expand_instances": 4, "pack_instances_hybrid": 4,
                                   "blend_fwd": 4}, "evaluate_test, 2 views twice")
    l1s, psnrs = [], []
    with torch.no_grad():
        for cam in test_cams:
            img = torch.clamp(render(cam.camera, SimpleNamespace(**st.params), st.alive, settings,
                                     bg, device=DEVICE)["render"], 0.0, 1.0)
            gt = torch.as_tensor(cam.image, device=device)
            l1s.append(float(losses.l1_loss(img, gt)))
            psnrs.append(float(losses.psnr(img, gt)))
    direct = {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs))}
    for k, v in direct.items():
        check(abs(ev[k] - v) <= 1e-6 * max(1.0, abs(v)),
              f"evaluate_test {k} {ev[k]} against the direct render's {v}")
    # progress across the resume: the sweep's train views at 200 against 60.
    # The held-out views' PSNR is reported beside an uninterrupted run C's,
    # not ordered: after the split of every gaussian at 120 it moves by less
    # than its run-to-run spread (PERF.md §6)
    first, last = CKPT["testing_a"][0], CKPT["testing_b"][-1]
    fit_a, fit_b = a["results"]["train"][first]["psnr"], b["results"]["train"][last]["psnr"]
    check(np.isfinite(b["results"]["test"][last]["psnr"]) and fit_b >= fit_a,
          f"PSNR fell across the resume: train views {fit_a} at {first}, {fit_b} at {last}; "
          f"test views {a['results']['test']} then {b['results']['test']}")
    t0 = time.perf_counter()
    _, _, uninterrupted = loop.train(
        dataclasses.replace(cfg, model_path=""), dataclasses.replace(opt_a, iterations=last),
        pipe, testing_iterations=CKPT["testing_a"] + CKPT["testing_b"], saving_iterations=(),
        quiet=True, log_every=10, seed=0, device=DEVICE)
    c_s = time.perf_counter() - t0

    # steps that overlap a write on the worker thread (its copy to the host
    # through the end of its pickle), against the others
    def steps(run):
        its = sorted(run["ends"])
        out = []
        for prev, it in zip(its, its[1:]):
            t0, t1 = run["ends"][prev], run["ends"][it]
            busy = any(s < t1 and e > t0 for s, e in run["d2h"] + run["writes"])
            out.append((it, (t1 - t0) * 1e3, busy))
        return out

    overlap = {}
    for name in ("a", "b"):
        sts = steps(runs[name])
        quiet_ms = [ms for it, ms, busy in sts if not busy]
        busy_ms = [ms for it, ms, busy in sts if busy]
        overlap[name] = {
            "step_ms_median": statistics.median(quiet_ms) if quiet_ms else None,
            "overlapping_steps": len(busy_ms),
            "overlapping_step_ms_median": statistics.median(busy_ms) if busy_ms else None,
            "overlapping_step_ms_max": max(busy_ms) if busy_ms else None,
            "first_overlapping": [(it, ms) for it, ms, busy in sts if busy][:3],
            "d2h_ms": [(e - s) * 1e3 for s, e in runs[name]["d2h"]],
            "write_ms": [(e - s) * 1e3 for s, e in runs[name]["writes"]],
        }
    nbytes = chkpnt.stat().st_size

    reset_counts()
    rc_ = render_cli.main(["-m", str(model), "-s", str(src), "--device", DEVICE, "--quiet",
                           "--skip_train"])
    render_launches = read_counts()
    check(rc_ == 0, "render CLI returned non-zero on the resumed model")
    check_counts(render_launches, RENDER_KERNELS, 2, "render CLI, 2 test views")
    chkpnt.unlink()
    rolling.unlink()
    return {
        **CKPT, "size": f"{FULL['width']}x{FULL['height']}", "setup_s": setup_s,
        "checkpoint_bytes": nbytes, "bytes_per_row": nbytes / a["state"].capacity,
        "sync_save_ms": a["save_ms"], "load_ms": b["load_ms"],
        "overlap": overlap, "evaluate_test_ms_per_view": [ms / len(test_cams) for ms in eval_ms],
        "evaluate_test": ev, "direct": direct,
        "capacity": {"a_start": a["ctl"], "a_resizes": a["resizes"], "a_end": a["state"].capacity,
                     "b_start": b["ctl"], "b_end": b["state"].capacity},
        "alive_end": int(b["state"].alive.sum()), "sh_degree": b["sh"],
        "test": {**a["results"]["test"], **b["results"]["test"]},
        "train_views": {**a["results"]["train"], **b["results"]["train"]},
        "uninterrupted": {"test": uninterrupted["test"], "train_views": uninterrupted["train"]},
        "wall_s": {"a": a["wall_s"], "b": b["wall_s"], "c": c_s},
        "launches": {"a": a["launches"], "b": b["launches"], "eval": eval_launches,
                     "render_cli": render_launches},
    }, model


def phase_train_cli_ckpt():
    """The train CLI with `--checkpoint_every 10 --profile_steps 3
    --test_iterations 20 30` on a seeded Blender scene with a held-out view,
    then the same command resumed from its rolling checkpoint to 40, then one
    run of the supervisor (`cli.train_supervised`) to its end; counts are
    reset just before each in-process run and read just after. Checks: the
    trace names the blend kernels, the resumed run prints its test PSNR,
    the supervisor completes with a rolling checkpoint at its last
    iteration."""
    from gsplat_tpu_torch.cli import train as train_cli
    from gsplat_tpu_torch.convert import read_checkpoint

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        src, _ = write_blender_scene(Path(tmp), size=CLI["size"], n=1000, test_views=1)
        model = Path(tmp) / "trained"
        base = ["-s", str(src), "-m", str(model), "--eval", "--densify_from_iter", "5",
                "--densification_interval", "10", "--densify_until_iter", str(CLI_ITERS),
                "--densify_grad_threshold", "1e-7", "--device", DEVICE, "--quiet",
                "--disable_viewer"]
        renders = 1 + EVAL_TRAIN_VIEWS  # per sweep: the test view and five train views
        out, launches = {}, {}
        for name, extra, iters, sweeps in (
                ("first", ["--iterations", str(CLI_ITERS), "--checkpoint_every", "10",
                           "--profile_steps", "3", "--test_iterations", "20", str(CLI_ITERS)],
                 CLI_ITERS, 2),
                ("resumed", ["--iterations", "40", "--test_iterations", "40",
                             "--start_checkpoint", str(model / "rolling_chkpnt.pkl")], 10, 1)):
            buf = io.StringIO()
            reset_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc_ = train_cli.main(base + extra)
            out[name] = {"s": time.perf_counter() - t, "stdout_tail": buf.getvalue()[-400:]}
            launches[name] = read_counts()
            check(rc_ == 0, f"{name} train CLI run returned non-zero")
            check_launches(launches[name], eval_counts(iters, renders * sweeps),
                           f"{name} train CLI run")
        trace = model / "profile" / "trace.json"
        check(trace.exists(), "--profile_steps wrote no trace")
        text = trace.read_text()
        check("blend_fwd_kernel" in text and "blend_bwd_kernel" in text,
              "the profile trace names no blend kernel")
        resumed = out["resumed"]["stdout_tail"]
        check(f"at iteration {CLI_ITERS}" in buf.getvalue() and "iter 40: test PSNR" in resumed,
              f"the resumed run printed no resume or test PSNR: {resumed!r}")

        sup_model = Path(tmp) / "supervised"
        t = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "gsplat_tpu_torch.cli.train_supervised", "--checkpoint_every",
             "10", "--", *base[:2], "-m", str(sup_model), *base[4:], "--iterations", "20",
             "--test_iterations", "20"],
            capture_output=True, text=True, timeout=300, cwd=str(ROOT))
        sup_s = time.perf_counter() - t
        log = (sup_model / "train_supervised.log").read_text()
        check(res.returncode == 0 and "training completed" in res.stdout,
              f"the supervisor failed: rc {res.returncode}, {res.stdout[-400:]} {log[-800:]}")
        check(read_checkpoint(str(sup_model / "rolling_chkpnt.pkl"))["iteration"] == 20
              and "iter 20: test PSNR" in log, f"supervised run: {log[-800:]}")
        return {"runs": out, "trace_mb": trace.stat().st_size / 2**20, "supervised_s": sup_s,
                "supervised_log_tail": log[-300:], "launches": launches}


def vgg16_weights(path: Path, seed=0):
    """Seeded synthetic LPIPS weights at VGG16's full widths (He-scaled
    convolutions, positive heads) in the `.npz` format `eval/lpips.py`
    reads; returns the weight count."""
    from gsplat_tpu_torch.eval.lpips import VGG16_BLOCKS

    rng = np.random.default_rng(seed)
    blob, cin, i = {}, 3, 0
    for cout, n_convs in VGG16_BLOCKS:
        for _ in range(n_convs):
            blob[f"conv_{i}_w"] = rng.normal(0, np.sqrt(2.0 / (cin * 9)),
                                             (cout, cin, 3, 3)).astype(np.float32)
            blob[f"conv_{i}_b"] = rng.normal(0, 0.01, (cout,)).astype(np.float32)
            cin, i = cout, i + 1
    for k, (cout, _) in enumerate(VGG16_BLOCKS):
        blob[f"lin_{k}_w"] = np.abs(rng.normal(0, 1.0 / cout, (cout,))).astype(np.float32)
    np.savez(path, **blob)
    return sum(v.size for v in blob.values())


def phase_metrics(model: Path, device):
    """`cli.metrics` on the render CLI's PNGs of the resumed model (2 test
    views at 1080p) with seeded synthetic VGG16 weights, on the card; then
    on a 270x480 crop of the same pairs on the card and with `--device cpu`:
    SSIM, PSNR and LPIPS, mean and per view, within relative 1e-5. LPIPS(x,
    x) < 1e-6 on the card; LPIPS and SSIM + PSNR timed per 1080p pair."""
    import os

    from PIL import Image

    from gsplat_tpu_torch.cli import metrics as metrics_cli
    from gsplat_tpu_torch.eval import lpips as lp
    from gsplat_tpu_torch.train.losses import psnr, ssim

    method = f"ours_{CKPT['iterations_b']}"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        weights = Path(tmp) / "lpips_vgg16.npz"
        n_weights = vgg16_weights(weights)
        saved = os.environ.get("GSPLAT_LPIPS_WEIGHTS")
        os.environ["GSPLAT_LPIPS_WEIGHTS"] = str(weights)
        lp._load_weights.cache_clear()
        try:
            t = time.perf_counter()
            check(metrics_cli.main(["-m", str(model), "--device", DEVICE]) == 0,
                  "metrics CLI returned non-zero")
            full_s = time.perf_counter() - t
            results = json.loads((model / "results.json").read_text())[method]
            check(all(np.isfinite(results[k]) for k in ("SSIM", "PSNR", "LPIPS"))
                  and results["LPIPS"] > 0, f"metrics on the card: {results}")

            pair = sorted((model / "test" / method / "renders").iterdir())[0]
            r, g = (torch.from_numpy(np.asarray(Image.open(d / pair.name).convert("RGB"),
                                                np.float32) / 255.0).to(device)
                    for d in (pair.parent, model / "test" / method / "gt"))
            same = float(lp.lpips(r, r))
            check(abs(same) < 1e-6, f"LPIPS(x, x) = {same}")
            lpips_ms = cuda_time(lambda: lp.lpips(r, g), 3)
            ssim_psnr_ms = cuda_time(lambda: (ssim(r, g), psnr(r, g)), 10)

            crop = Path(tmp) / "crop"
            h, w = LPIPS_CROP
            y0, x0 = (FULL["height"] - h) // 2, (FULL["width"] - w) // 2
            for sub in ("renders", "gt"):
                (crop / "test" / method / sub).mkdir(parents=True)
                for p in sorted((model / "test" / method / sub).iterdir()):
                    Image.fromarray(np.asarray(Image.open(p))[y0:y0 + h, x0:x0 + w]).save(
                        crop / "test" / method / sub / p.name)
            got = {}
            for dev in (DEVICE, "cpu"):
                t = time.perf_counter()
                check(metrics_cli.main(["-m", str(crop), "--device", dev]) == 0,
                      f"metrics CLI on {dev} returned non-zero")
                got[dev] = {"s": time.perf_counter() - t,
                            "results": json.loads((crop / "results.json").read_text())[method],
                            "per_view": json.loads((crop / "per_view.json").read_text())[method]}
        finally:
            if saved is None:
                os.environ.pop("GSPLAT_LPIPS_WEIGHTS", None)
            else:
                os.environ["GSPLAT_LPIPS_WEIGHTS"] = saved
            lp._load_weights.cache_clear()
    rel = {}
    for k in ("SSIM", "PSNR", "LPIPS"):
        pairs = [(got[DEVICE]["results"][k], got["cpu"]["results"][k])] + [
            (v, got["cpu"]["per_view"][k][n]) for n, v in got[DEVICE]["per_view"][k].items()]
        rel[k] = max(abs(a - b) / abs(b) for a, b in pairs)
    check(all(v <= METRIC_REL for v in rel.values()),
          f"metrics on the card against the CPU, relative: {rel}")
    return {"weights": n_weights, "views": 2, "results_1080p": results, "full_s": full_s,
            "lpips_self": same, "lpips_ms_per_pair": lpips_ms,
            "ssim_psnr_ms_per_pair": ssim_psnr_ms, "crop": list(LPIPS_CROP),
            "crop_results": {d: v["results"] for d, v in got.items()},
            "crop_s": {d: v["s"] for d, v in got.items()}, "card_vs_cpu_rel": rel}


class _Bytes:
    """A connection that hands out the bytes it holds, for decoding a
    request as the bridge does."""

    def __init__(self, data):
        self.data = data

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out


def viewer_message(camera, scaling_modifier):
    """The SIBR client's request for the port's `camera` (glm-convention
    row-major matrices with the Y/Z column flips `NetworkGUI.receive`
    undoes)."""
    wv = camera.world_view.cpu().numpy()
    vm, vp = wv.T.copy(), camera.full_proj.cpu().numpy().T.copy()
    vm[:, 1] *= -1
    vm[:, 2] *= -1
    vp[:, 1] *= -1
    return {"resolution_x": camera.width, "resolution_y": camera.height, "train": True,
            "fov_x": float(2 * np.arctan(float(camera.tan_fovx))),
            "fov_y": float(2 * np.arctan(float(camera.tan_fovy))), "z_near": 0.01,
            "z_far": 100.0, "shs_python": False, "rot_scale_python": False, "keep_alive": True,
            "scaling_modifier": scaling_modifier,
            "view_matrix": [float(x) for x in vm.reshape(-1)],
            "view_projection_matrix": [float(x) for x in vp.reshape(-1)]}


def phase_viewer(device):
    """`NetworkGUI(port=0)` serves a loopback client three 1920x1080
    requests of the flagship scene (scaling modifier 1.0, 0.5, 1.0), counts
    reset just before and read just after: the bytes returned equal
    `(clip(render) * 255).astype(uint8)` of the port's `render()` on the
    card for the decoded camera, exactly; K1' (expand, float32 pack) and K2'
    once per request."""
    import socket
    import threading

    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.synthetic import tiny_scene
    from gsplat_tpu_torch.viewer.network_gui import NetworkGUI, camera_from_request

    params, alive, camera = tiny_scene(**FULL, device=device)
    settings = make_render_settings(sh_degree=3)
    bg = [0.0, 0.0, 0.0]
    gui = NetworkGUI(port=0)
    port = gui.listener.getsockname()[1]
    mods = (1.0, 0.5, 1.0)
    got, rtt_ms = [], []
    reset_counts()
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            for sm in mods:
                payload = json.dumps(viewer_message(camera, sm)).encode("utf-8")
                done = threading.Event()

                def client(payload=payload, done=done):
                    t0 = time.perf_counter()
                    s.sendall(len(payload).to_bytes(4, "little") + payload)
                    want = camera.width * camera.height * 3
                    buf = bytearray()
                    while len(buf) < want:
                        buf += s.recv(want - len(buf))
                    n = int.from_bytes(s.recv(4), "little")
                    verify = s.recv(n).decode("ascii")
                    rtt_ms.append((time.perf_counter() - t0) * 1e3)
                    got.append((bytes(buf), verify))
                    done.set()

                th = threading.Thread(target=client)
                th.start()
                # one pass accepts the connection (first request) and serves
                # one request; a second would wait for a request never sent
                gui.pump(params, alive, settings, bg, "chip-smoke-src", 1, 10)
                th.join(timeout=60)
                check(done.is_set() and not th.is_alive(), f"viewer request {sm} not answered")
    finally:
        gui.close()
    launches = read_counts()
    check_counts(launches, RENDER_KERNELS, len(mods), f"viewer, {len(mods)} requests")
    for sm, (data, verify) in zip(mods, got):
        dec = NetworkGUI.__new__(NetworkGUI)
        payload = json.dumps(viewer_message(camera, sm)).encode("utf-8")
        dec.conn = _Bytes(len(payload).to_bytes(4, "little") + payload)
        cam, _, _, smod = dec.receive()
        with torch.no_grad():
            img = render(camera_from_request(cam, device), params, alive,
                         dataclasses.replace(settings, scale_modifier=smod), bg, device=DEVICE)["render"]
        want = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8).tobytes()
        check(verify == "chip-smoke-src" and data == want,
              f"viewer bytes at scaling modifier {sm} differ from the render")
    check(got[0][0] != got[1][0], "the scaling modifier changed nothing")
    return {"size": f"{camera.width}x{camera.height}", "scaling_modifiers": list(mods),
            "round_trip_ms": rtt_ms, "launches": launches}


def phase_bench():
    """`python -m gsplat_tpu_torch.bench`'s points as its `main` runs them
    (`bench.run` at the defaults; the trained-cloud rows, which depend on
    what earlier runs left on disk, are the quality phase's), counts reset
    just before and read just after: `bench.py`'s JSON keys, every rate
    finite and positive, the device time per call finite, positive and at
    most the host's; each point's kernels launched once per call."""
    from gsplat_tpu_torch import bench

    reset_counts()
    res = json.loads(json.dumps(bench.run()))
    launches = read_counts()
    check({"metric", "value", "unit", "vs_baseline", "points", "device"} <= set(res),
          f"bench keys: {sorted(res)}")
    pts = res["points"]
    check(set(pts) == {"1M_gauss", "1M_gauss_f32_parity", "262k_gauss", "render_only"}
          and set(pts["render_only"]) == {"1M_gauss_1080p"}, f"bench points: {sorted(pts)}")
    rows = {**{k: v for k, v in pts.items() if k != "render_only"}, **pts["render_only"]}
    for name, r in rows.items():
        check(np.isfinite(r["pixels_per_s"]) and r["pixels_per_s"] > 0
              and np.isfinite(r["device_ms"]) and 0 < r["device_ms"] <= r["ms"],
              f"bench {name}: rate {r['pixels_per_s']}, device {r['device_ms']} ms, host {r['ms']} ms")
    grad = 1 + bench.GRAD_ITERS + bench.PROFILED_CALLS  # calls per gradient point
    fwd = 1 + bench.RENDER_ITERS + bench.PROFILED_CALLS
    want = {"expand_instances": 3 * grad + fwd, "pack_instances": grad,
            "pack_instances_hybrid": 2 * grad + fwd, "blend_fwd": 3 * grad + fwd,
            "blend_bwd": 3 * grad, "reduce_by_gid": 3 * grad}
    for name, got in launches.items():
        check(got == want.get(name, 0), f"bench: {name} launched {got} times, "
              f"want {want.get(name, 0)}")
    return {"result": res, "launches": launches}


def phase_entry():
    """`gsplat_tpu_torch.entry.entry()` once, counts reset just before its
    call and read just after: K1' (expand, float32 pack) and K2' once each,
    a finite image of the tiny scene."""
    from gsplat_tpu_torch.entry import entry

    fn, args = entry()
    reset_counts()
    img = fn(*args).detach()
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts(launches, RENDER_KERNELS, 1, "entry()")
    check(img.shape == (192, 256, 3) and bool(torch.isfinite(img).all())
          and float(img.std()) > 0.01, "entry(): bad image")
    return {"launches": launches, "image_mean": float(img.mean()), "image_std": float(img.std())}


# the COLMAP quality run, cut short: the full runs' recipe and train seed 0
QUALITY_SMOKE_ITERS = 1_500  # `colmap_proxy.SMOKE_ITERATIONS`: the full runs test there too
# the loop's held-out PSNR at 1,500 iterations in the full runs
# (artifacts/colmap_proxy_torch/seed{0,1}/summary.json, `test_psnr_log`):
# seed 0 28.85, seed 1 28.41 dB; their lower one less their spread (0.44)
# and 0.5 dB is 27.47, rounded down
QUALITY_PSNR_BAR = 27.4
QUALITY_SELF_VIEWS = (0, 21, 63)  # views re-rendered for the fixture's self-check


def phase_quality_fixture(device):
    """The COLMAP quality run at full size, cut to QUALITY_SMOKE_ITERS
    iterations: `python -m gsplat_tpu_torch.scripts.colmap_proxy`'s `main`
    in this process (`--in_process --skip_report`, train seed 0), counts
    reset just before and read just after. It writes the recipe's fixture
    on the card (4,096 GT gaussians, 2,048 SfM points, 64 PINHOLE views at
    400x304, focal 380, seed 3: K1' expand, float32 pack and K2' once per
    view), trains (K1' expand and hybrid pack, K2', K3', K4' once per
    iteration; K1' and K2' once per evaluation render: 8 held-out and 5
    train views), renders the 8 held-out views (K1' expand, float32 pack,
    K2') and scores them. Checks: the launches exactly; the fixture against
    itself (`tests/test_colmap_e2e.py:137-193`): the GT cloud re-rendered
    from views the reader loads within 1.5/255 of the saved PNG, the
    loaded pixels within 1/255; the held-out PSNR of the loop's evaluation
    at the end at least QUALITY_PSNR_BAR (the full runs' own evaluation at
    this iteration, less their seed spread and 0.5 dB); then
    `bench.measure_render_only_trained` on the run's snapshot (the JAX
    bench's keys; its 2 ms floor reported, not lowered) and
    `colmap_proxy.cull_report` on the first held-out view, float32 and
    hybrid packets: whole-plane boxes counted, no kept pair outside its box
    or in a skipped warp."""
    from PIL import Image

    from gsplat_tpu_torch import bench
    from gsplat_tpu_torch.convert import params_from_numpy
    from gsplat_tpu_torch.data.scene import load_scene
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.scripts import colmap_proxy as cp
    from gsplat_tpu_torch.scripts.make_fixtures import gaussian_gt_cloud, gt_render_settings

    check(cp.SMOKE_ITERATIONS == QUALITY_SMOKE_ITERS, "the full runs test at "
          f"{cp.SMOKE_ITERATIONS}, the smoke runs to {QUALITY_SMOKE_ITERS}")
    n_it, recipe = QUALITY_SMOKE_ITERS, cp.RECIPE
    views = recipe["n_images"]
    test_views = len(range(0, views, 8))  # the llffhold split
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        out = Path(tmp) / "run"
        buf = io.StringIO()
        reset_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc_ = cp.main(["--out", str(out), "--seed", "0", "--iterations", str(n_it),
                           "--device", DEVICE, "--in_process", "--skip_report"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        launches = read_counts()
        check(rc_ == 0, f"colmap_proxy returned {rc_}: {buf.getvalue()[-1500:]}")
        renders = test_views + EVAL_TRAIN_VIEWS
        want = {"expand_instances": views + n_it + renders + test_views,
                "pack_instances": views + test_views, "pack_instances_hybrid": n_it + renders,
                "blend_fwd": views + n_it + renders + test_views, "blend_bwd": n_it,
                "reduce_by_gid": n_it}
        check_launches(launches, want, "quality run")
        with open(out / "summary.json") as f:
            row = json.load(f)["model"]
        psnr_log = row["test_psnr_log"][str(n_it)]
        scored = row["results"][f"ours_{n_it}"]
        check(np.isfinite(scored["PSNR"]) and scored["LPIPS"] is None
              and scored["LPIPS_status"] == "weights_unavailable", f"quality scores {scored}")
        check(psnr_log >= QUALITY_PSNR_BAR, f"quality run: held-out PSNR {psnr_log} at {n_it}, "
              f"under the bar {QUALITY_PSNR_BAR}")

        # the fixture against itself
        scene_dir, model_dir = str(out / "scene"), str(out / "model")
        scene = load_scene(scene_dir, device)
        cams = scene.get_train_cameras()
        check(len(cams) == views, f"the fixture loads {len(cams)} views")
        gt = params_from_numpy(gaussian_gt_cloud(
            recipe["n_gauss"], np.random.default_rng(recipe["seed"]))[0], DEVICE)
        alive = torch.ones(recipe["n_gauss"], dtype=torch.bool, device=device)
        self_err = {}
        for i in QUALITY_SELF_VIEWS:
            with torch.no_grad():
                img = render(cams[i].camera, gt, alive, gt_render_settings(), [0.0, 0.0, 0.0],
                             device=DEVICE)["render"].cpu().numpy()
            with Image.open(out / "scene" / "images" / f"r_{i:03d}.png") as im:
                saved = np.asarray(im, np.float32) / 255.0
            self_err[i] = {"render": float(np.abs(np.clip(img, 0, 1) - saved).max()),
                           "loaded": float(np.abs(cams[i].image - saved).max())}
            check(self_err[i]["render"] <= 1.5 / 255.0 and self_err[i]["loaded"] <= 1.0 / 255.0,
                  f"fixture view {i} disagrees with itself: {self_err[i]}")

        trained = bench.measure_render_only_trained(model_dir, scene_dir, iteration=n_it,
                                                    device=DEVICE)
        check(trained is not None and ("invalid" in trained or (
            set(trained) == {"pixels_per_s", "ms", "n_gauss", "vs_baseline"}
            and trained["n_gauss"] == row["final_alive"] and trained["pixels_per_s"] > 0)),
            f"trained-cloud row {trained}")
        cull = cp.cull_report(model_dir, scene_dir, n_it, DEVICE)
        for dtype in ("float32", "hybrid"):
            cull[dtype] = cull_summary(cull[dtype], f"quality run, {dtype} packets")
        oit = oit_trained_frame(model_dir, scene_dir, n_it)
    return {"iterations": n_it, "run_s": run_s, "summary": row, "self_consistency": self_err,
            "psnr_bar": QUALITY_PSNR_BAR, "trained_cloud": trained, "cull": cull,
            "oit_trained_frame": oit, "launches": launches}


def oit_trained_frame(model_dir, scene_dir, iteration):
    """K5' and K6' on a trained state: the quality run's snapshot at
    `iteration` on the first held-out view, rendered in OIT mode and
    differentiated (the L1 loss to the view's ground truth through the OIT
    composite gives K6''s cotangent), with float32 and hybrid packets. Each
    kernel `torch.equal` to its twin; the evaluated, kept and walked pairs
    and the culled shares. These launches compare and are not counted on
    any path."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.data.scene import load_scene
    from gsplat_tpu_torch.io.snapshot import load_snapshot
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops.binning import pack_bins
    from gsplat_tpu_torch.ops.projection import preprocess
    from gsplat_tpu_torch.ops.rasterize_torch import tiles_to_image
    from gsplat_tpu_torch.render import grid_dims

    params, alive, _, _ = load_snapshot(model_dir, iteration, device=DEVICE)
    holder = load_scene(scene_dir, DEVICE, eval=True).get_test_cameras()[0]
    cam = holder.camera
    settings = make_render_settings(sh_degree=3, blend_mode="oit")
    gx, gy = grid_dims(cam, 16)
    gt = torch.as_tensor(holder.image, device=DEVICE)
    out = {"view": holder.image_name, "n_gauss": int(alive.sum())}
    with torch.no_grad():
        screen = preprocess(params, alive, cam, settings, gx, gy)
    for dtype in ("float32", "hybrid"):
        pb = pack_bins(screen, gx, gy, settings.tile, settings.tight_cull, packet_dtype=dtype)
        args = (pb.inst_t, pb.tile_start, pb.tile_end, gx, gy)
        fwd = rc.blend_oit_fwd(*args)
        plain, evaluated, kept = rc.blend_oit_packed_torch(*args, count_pairs=True)
        check(torch.equal(fwd, plain), f"K5' on the trained OIT frame ({dtype}): not equal to "
              "its twin")
        raw = fwd.clone().requires_grad_(True)
        w = (1.0 - raw[:, :, 5]) / torch.clamp(raw[:, :, 4], min=1e-8)
        image = tiles_to_image(raw[:, :, 0:3] * w[..., None], gx, gy, 16, cam.width, cam.height)
        (dout,) = torch.autograd.grad(torch.abs(image - gt).mean(), raw)
        got = rc.blend_oit_bwd(*args, fwd, dout)
        want = rc.blend_oit_bwd_packed_torch(*args, fwd, dout)
        check(torch.equal(got, want), f"K6' on the trained OIT frame ({dtype}): not equal to "
              f"its twin (per-row max rel err {per_row_rel_err(got, want)})")
        check(bool(got.any()), f"K6' on the trained OIT frame ({dtype}): all rows zero")
        walked = oit_walked_pairs(args, fwd, dout)
        out[dtype] = {"instances": pb.num_instances, "evaluated_pairs": evaluated,
                      "kept_pairs": kept, "k5_walked_pairs": walked["k5_walked_pairs"],
                      "k5_culled_share": 1.0 - walked["k5_walked_pairs"] / max(evaluated, 1),
                      "k6_walked_pairs": walked["walked_pairs"],
                      "k6_culled_share": walked["culled_share"]}
    return out


# the multi-device phases: meshes of ranks that share the one card over gloo
# (NCCL refuses two ranks on one card), each held against the single-device
# render and train step on the same card
MESHES = ((2, 2), (4, 1), (1, 4))
PADDED_MESH = (1, 3)  # 68 tile rows do not divide by 3: the padded grid
MESH_TIMED = 3  # steps timed per mesh after the checked one
MESH_RENDER_ATOL = 1e-6  # the JAX test's tolerances (tests/test_parallel.py)
MESH_LOSS_RTOL = 1e-5
MESH_PARAMS_ATOL = 2e-5
MESH_GRAD_ACCUM_ATOL = 1e-5


def _mesh_rank(cfg, shapes, backend, sharded_step=False):
    """One rank of a job on the card: the single-device render and step of
    the flagship train state, then on each (G, T) mesh of `shapes` the
    sharded render (full gather, and the band exchange, which must equal it
    bit for bit) and one train step held against them, counts reset just
    before the step and read just after (K1' expand and hybrid pack, K2',
    K3', K4' once each), then MESH_TIMED steps timed with the collectives'
    ms and bytes. The step exchanges rows as `train()` does by default (the
    band exchange where the tile axis has bands). `sharded_step` runs
    `sharding.sharded_train_step` and `sharded_render` (the full gather) in
    place of the pipeline's functions."""
    from types import SimpleNamespace

    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.parallel import pipeline, sharding
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.train import step as ts

    device = torch.device(cfg["device"])
    settings = make_render_settings(sh_degree=3, packet_dtype="hybrid")
    state, args, opt = flagship_train_setup(device, settings, cfg["full"], cfg["capacity"])
    camera, bg = args[0], args[5]
    w, h = camera.width, camera.height
    params = SimpleNamespace(**state.params)
    with torch.no_grad():
        ref = render(camera, params, state.alive, settings, bg, device=device)
    ref_state, ref_metrics = ts.make_train_step(opt, settings)(state, *args)
    ref_loss = float(ref_metrics["loss"])
    out = []
    for shape in shapes:
        mesh = sharding.make_mesh(*shape, backend=backend, device=cfg["device"])
        tag = f"{shape[0]}x{shape[1]} rank {mesh.rank} {mesh.coords}"
        rows = sharding.param_spec(mesh, state.capacity)
        lp, la = sharding.shard_params(params, state.alive, mesh)
        if sharded_step:
            render_fns = {"full": sharding.sharded_render(mesh, settings)}
            step, place = sharding.sharded_train_step(mesh, opt, settings)
        else:
            render_fns = {name: pipeline.make_sharded_render(mesh, settings, w, h,
                                                             exchange_capacity=exch)
                          for name, exch in (("full", None), ("band", 1))}
            # the step exchanges as the loop's default does: the band exchange
            # where there are bands
            step = pipeline.make_pipeline_train_step(
                mesh, opt, settings, w, h, exchange_capacity=1 if shape[1] > 1 else None)

            def place(st):
                return sharding.place_train_state(mesh, st)
        with torch.no_grad():
            imgs = {name: fn(camera, lp, la, bg) for name, fn in render_fns.items()}
        full = imgs["full"]
        res = {"mesh": f"{shape[0]}x{shape[1]}", "rank": mesh.rank, "coords": mesh.coords,
               "render_max_abs_err": float((full["render"] - ref["render"]).abs().max()),
               "invdepth_max_abs_err": float((full["invdepth"] - ref["invdepth"]).abs().max()),
               "radii_equal": bool(torch.equal(full["radii"], ref["radii"][rows.start:rows.stop])),
               "num_instances": full["num_instances"], "band_instances": full["band_instances"]}
        check(res["render_max_abs_err"] <= MESH_RENDER_ATOL
              and res["invdepth_max_abs_err"] <= MESH_RENDER_ATOL and res["radii_equal"],
              f"{tag}: sharded render off the single-device one: {res}")
        if "band" in imgs:
            res["band_bitwise"] = all(torch.equal(imgs["band"][k], full[k])
                                      for k in ("render", "invdepth", "radii"))
            res["band_counts"] = imgs["band"]["band_counts"]
            check(res["band_bitwise"], f"{tag}: band exchange render != full gather's")
        del imgs, full

        local = place(state)
        torch.cuda.synchronize(device)
        reset_counts()
        local, metrics = step(local, camera, *args[1:])
        torch.cuda.synchronize(device)
        res["launches"] = read_counts()
        check_counts(res["launches"], TRAIN_KERNELS, 1, f"{tag}: mesh train step")
        res["loss"], res["loss_single_device"] = float(metrics["loss"]), ref_loss
        res["params_max_abs_err"] = max(
            float((v - ref_state.params[k][rows.start:rows.stop]).abs().max())
            for k, v in local.params.items())
        res["grad_accum_max_abs_err"] = float(
            (local.stats["grad_accum"] - ref_state.stats["grad_accum"][rows.start:rows.stop])
            .abs().max())
        check(abs(res["loss"] - ref_loss) <= MESH_LOSS_RTOL * abs(ref_loss)
              and res["params_max_abs_err"] <= MESH_PARAMS_ATOL
              and res["grad_accum_max_abs_err"] <= MESH_GRAD_ACCUM_ATOL,
              f"{tag}: mesh train step off the single-device step: {res}")

        mesh.reset_stats()
        mesh.timing = True  # a synchronize around each collective
        ms = []
        for _ in range(MESH_TIMED):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            local, _ = step(local, camera, *args[1:])
            torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t) * 1e3)
        res["step_ms"] = ms
        res["collectives_per_step"] = {
            name: {"calls": rec["calls"] / MESH_TIMED, "bytes": rec["bytes"] / MESH_TIMED,
                   "ms": rec["ms"] / MESH_TIMED} for name, rec in mesh.stats.items()}
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        out.append(res)
        del local
    return out


def _sum_counts(results, mesh):
    """Launches summed over the ranks of one mesh's checked step."""
    rows = [r["launches"] for rank in results for r in rank if r["mesh"] == mesh]
    return {k: sum(c[k] for c in rows) for k in rows[0]}


def mesh_cfg():
    return {"device": DEVICE, "full": FULL, "capacity": TRAIN_CAPACITY}


def phase_multi_device():
    """MESHES as 4 ranks sharing the card over gloo, then PADDED_MESH as 3
    ranks through `sharded_train_step` on the padded grid."""
    from gsplat_tpu_torch.parallel import comm

    torch.cuda.empty_cache()
    t = time.perf_counter()
    four = comm.run_ranks(_mesh_rank, 4, "gloo", args=(mesh_cfg(), MESHES, "gloo"), timeout=900)
    four_s = time.perf_counter() - t
    t = time.perf_counter()
    three = comm.run_ranks(_mesh_rank, 3, "gloo", args=(mesh_cfg(), (PADDED_MESH,), "gloo", True),
                           timeout=600)
    three_s = time.perf_counter() - t
    sharing = ("ranks sharing one card over gloo (gloo copies the CUDA tensors of each "
               "collective through host memory itself); times are of ranks contending for "
               "one card and its host")
    launches = {f"multi_device_{m}": _sum_counts(four, m) for m in ("2x2", "4x1", "1x4")}
    launches["multi_device_1x3"] = _sum_counts(three, "1x3")
    return {"sharing": sharing, "ranks_4": four, "ranks_3": three, "seconds_4": four_s,
            "seconds_3": three_s, "launches": launches}


def phase_nccl_1x1():
    """A one-rank NCCL mesh on the card (the NCCL collectives' code path),
    held against the single-device render and step as `_mesh_rank` holds
    the gloo meshes."""
    from gsplat_tpu_torch.parallel import comm

    torch.cuda.empty_cache()
    t = time.perf_counter()
    res = comm.run_ranks(_mesh_rank, 1, "nccl", args=(mesh_cfg(), ((1, 1),), "nccl"),
                         timeout=600)
    return {"rank": res[0][0], "seconds": time.perf_counter() - t,
            "launches": _sum_counts(res, "1x1")}


def phase_dryruns():
    """`entry.dryrun_multichip(4)` and `entry.dryrun_multihost(8, 2)` on the
    card, gloo (the ranks share it)."""
    from gsplat_tpu_torch import entry

    torch.cuda.empty_cache()
    t = time.perf_counter()
    chip = entry.dryrun_multichip(4, backend="gloo")
    chip_s = time.perf_counter() - t
    t = time.perf_counter()
    host = entry.dryrun_multihost(8, 2, backend="gloo")
    return {"multichip": chip, "multichip_s": chip_s, "multihost": host,
            "multihost_s": time.perf_counter() - t}


def phase_train_cli_mesh():
    """`torchrun --nproc_per_node 2 -m gsplat_tpu_torch.cli.train --mesh 1x2
    --dist_backend gloo` for CLI_ITERS iterations on the train CLI's scene
    (densify forced early, a checkpoint at the end), the render CLI under
    `--mesh 1x2` on the model, then the checkpoint resumed on one card for
    10 more iterations in-process, counts reset just before and read just
    after (K1' expand and hybrid pack, K2', K3', K4' once per iteration)."""
    from PIL import Image

    from gsplat_tpu_torch.cli import train as train_cli
    from gsplat_tpu_torch.convert import read_checkpoint

    torch.cuda.empty_cache()
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2", "-m"]
    mesh = ["--mesh", "1x2", "--dist_backend", "gloo", "--device", DEVICE, "--quiet"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        src, _ = write_blender_scene(Path(tmp), size=CLI["size"], n=1000)
        model = Path(tmp) / "trained"
        base = ["-s", str(src), "-m", str(model), "--densify_from_iter", "5",
                "--densification_interval", "10", "--densify_until_iter", str(CLI_ITERS),
                "--opacity_reset_interval", "20", "--densify_grad_threshold", "1e-7",
                "--disable_viewer"]
        t = time.perf_counter()
        res = subprocess.run([*torchrun, "gsplat_tpu_torch.cli.train", *base, "--iterations",
                              str(CLI_ITERS), "--checkpoint_iterations", str(CLI_ITERS), *mesh],
                             capture_output=True, text=True, timeout=600, cwd=str(ROOT))
        train_s = time.perf_counter() - t
        check(res.returncode == 0, f"torchrun train CLI --mesh 1x2 failed: rc {res.returncode}, "
              f"{res.stdout[-600:]} {res.stderr[-1500:]}")
        ckpt_path = model / f"chkpnt{CLI_ITERS}.pkl"
        ckpt = read_checkpoint(str(ckpt_path))
        n_alive = int(ckpt["state"]["alive"].sum())
        check(ckpt["iteration"] == CLI_ITERS and n_alive > CLI_INIT_POINTS,
              f"mesh checkpoint: iteration {ckpt['iteration']}, {n_alive} alive")

        t = time.perf_counter()
        res = subprocess.run([*torchrun, "gsplat_tpu_torch.cli.render", "-m", str(model), "-s",
                              str(src), *mesh], capture_output=True, text=True, timeout=300,
                             cwd=str(ROOT))
        render_s = time.perf_counter() - t
        check(res.returncode == 0, f"torchrun render CLI --mesh 1x2 failed: rc {res.returncode}, "
              f"{res.stdout[-600:]} {res.stderr[-1500:]}")
        pngs = sorted((model / "train" / f"ours_{CLI_ITERS}" / "renders").iterdir())
        check(len(pngs) == 3, f"mesh render CLI wrote {len(pngs)} PNGs, want 3")
        for p in pngs:
            a = np.asarray(Image.open(p))
            check(a.shape == (CLI["size"], CLI["size"], 3) and a.max() > a.min(),
                  f"{p.name}: blank or misshapen mesh render")

        buf = io.StringIO()
        reset_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc_ = train_cli.main([*base, "--iterations", str(CLI_ITERS + 10), "--start_checkpoint",
                                  str(ckpt_path), "--device", DEVICE, "--quiet"])
        resume_s = time.perf_counter() - t
        launches = read_counts()
        check(rc_ == 0 and f"at iteration {CLI_ITERS}" in buf.getvalue(),
              f"resuming the mesh checkpoint on one card failed: {buf.getvalue()[-400:]}")
        check_counts(launches, TRAIN_KERNELS, 10, "the mesh checkpoint resumed on one card")
    return {"iterations": CLI_ITERS, "train_s": train_s, "render_s": render_s,
            "resume_s": resume_s, "checkpoint_alive": n_alive,
            "checkpoint_rows": int(ckpt["state"]["alive"].shape[0]), "launches": launches}


def sass_counts(source, full=False):
    """{kernel function: {opcode: count}} of a built library, from
    `cuobjdump -sass`; with `full` the key is the whole mnemonic, its
    modifiers included (`RED.E.ADD...`)."""
    from gsplat_tpu_torch import _kernels

    tool = Path(_kernels.nvcc_path()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", str(_kernels.library_path(source))],
                         capture_output=True, text=True, timeout=120, check=True)
    counts, cur = {}, None
    for line in res.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            cur = counts.setdefault(head.group(1), {})
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)"
                       r"((?:\.[A-Za-z0-9_]+)*)", line)
        if ins and cur is not None:
            op = ins.group(1) + (ins.group(2) if full else "")
            cur[op] = cur.get(op, 0) + 1
    return counts


SASS_FP = ("FADD", "FMUL", "FFMA", "MUFU", "HADD2", "HMUL2", "HFMA2")
# (part of the mangled name in libprobe_ops, least float instructions of one
# unrolled iteration of a thread). The static count cannot show that every
# row is computed in every iteration (a compiler may move a row's work under
# a branch that rarely runs); the kernels rule that out by storing every row
# unconditionally, and `phase_probe_ops` checks that none runs under its bound
SASS_PROBES = {
    "op_cumprod": ("elementwise_kernelILi0E", 16 * 32),
    "op_vpu9": ("elementwise_kernelILi1E", 16 * 4 * 8),
    "op_exp": ("elementwise_kernelILi2E", 16 * 4 * 3),
    "op_div": ("elementwise_kernelILi3E", 16 * 4 * 3),
    "op_cvpu": ("contract4_kernelILb0E", 16 * 4 * 7),
    "op_cmatmul": ("contract4_kernelILb1E", 16 * 4 * 4),
    "op_two_matmuls": ("two_matmuls_kernel", 64 * 11),
    "op_merged": ("merged_kernel", 64 * 21),
    "op_fwd_accum": ("fwd_accum_kernel", 32 * 5),
    **{f"op_kappa{k}": (f"kappa_kernelILi{k}E", k * 16 * 4 * 8) for k in (1, 2, 4)},
    "blend_mix_f32": ("blend_mix_f32_kernel", 8 * 8),
    "blend_mix_bf16": ("blend_mix_bf16_kernel", 8 * 7),
}


def res_usage(source):
    """{kernel function: {REG, STACK, SHARED, LOCAL}} of a built library,
    from `cuobjdump -res-usage`."""
    from gsplat_tpu_torch import _kernels

    tool = Path(_kernels.nvcc_path()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-res-usage", str(_kernels.library_path(source))],
                         capture_output=True, text=True, timeout=120, check=True)
    return {m.group(1): {k: int(m.group(i + 2)) for i, k in enumerate(("REG", "STACK", "SHARED",
                                                                       "LOCAL"))}
            for m in re.finditer(r"Function\s+(\S+?):\s+REG:(\d+)\s+STACK:(\d+)\s+"
                                 r"SHARED:(\d+)\s+LOCAL:(\d+)", res.stdout)}


# K3''s reduce-scatter: 31 shuffles per group of 3 instances (a five-level
# butterfly per row would issue 50 per instance)
K3_SHFL, K3_GROUP = 31, 3


def sass_blend():
    """K2' and K3' as built: registers, stack, shared and local memory
    (`cuobjdump -res-usage`) and their SASS; neither touches local memory
    (no spills at 256 threads a block); K2' issues no shuffle, and K3''s
    only shuffles are one reduce-scatter of 31 per 3 instances."""
    out = {}
    for name, source, part in (("blend_fwd", "rasterize_fwd", "blend_fwd_kernel"),
                               ("blend_bwd", "rasterize_bwd", "blend_bwd_kernel")):
        ops = [v for f, v in sass_counts(source).items() if part in f]
        use = [v for f, v in res_usage(source).items() if part in f]
        check(len(ops) == 1 and len(use) == 1, f"{name}: {len(ops)} SASS / {len(use)} "
              f"resource entries for {part}")
        ops, use = ops[0], use[0]
        check(not ops.get("LDL") and not ops.get("STL") and use["LOCAL"] == 0,
              f"{name}: local memory ({use}, LDL {ops.get('LDL', 0)}, STL {ops.get('STL', 0)})")
        shfl = ops.get("SHFL", 0)
        if name == "blend_fwd":
            check(shfl == 0, f"K2' issues {shfl} shuffles")
        else:
            check(0 < shfl <= K3_SHFL, f"K3' holds {shfl} SHFL, want at most {K3_SHFL}")
        out[name] = {**use, "SHFL": shfl, "shfl_per_instance": shfl / K3_GROUP if shfl else 0.0,
                     "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:20])}
    return out


# opcodes of reductions and atomics on global memory (ATOMS, REDUX: shared
# memory and warp reductions, not counted)
GLOBAL_REDUCTIONS = ("RED", "REDG", "ATOM", "ATOMG")


def one_function(table, part, what):
    hits = [v for f, v in table.items() if part in f]
    check(len(hits) == 1, f"{what}: {len(hits)} functions match {part}")
    return hits[0]


def sass_k1_k4():
    """K1' and K4' as built: registers and no local memory; K4''s global
    reductions, with their whole mnemonics: three per instance (for ten
    values) in each of its two instantiations (pack_bf16 off and on), each
    a mnemonic of the vector probe kernels (v4, v2); the scalar probe's
    mnemonic is recorded beside them."""
    out = {}
    for name, source, part in (("expand_instances", "binning", "expand_instances_kernel"),
                               ("pack_instances", "binning", "pack_instances_kernel"),
                               ("reduce_by_gid", "reduce", "reduce_by_gid_kernelILb0E"),
                               ("reduce_by_gid_pack_bf16", "reduce", "reduce_by_gid_kernelILb1E")):
        ops = one_function(sass_counts(source), part, name)
        use = one_function(res_usage(source), part, name)
        check(not ops.get("LDL") and not ops.get("STL") and use["LOCAL"] == 0,
              f"{name}: local memory ({use}, LDL {ops.get('LDL', 0)}, STL {ops.get('STL', 0)})")
        out[name] = {**use, "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:16])}
    full = sass_counts("reduce", full=True)

    def reductions(part):
        ops = one_function(full, part, part)
        return {m: c for m, c in ops.items() if m.split(".")[0] in GLOBAL_REDUCTIONS}

    forms = {form: reductions(f"red_forms_kernelILi{code}E") for form, code in RED_FORMS.items()}
    check(sum(forms["scalar_atomicAdd"].values()) == 4 and sum(forms["red_v4"].values()) == 1
          and sum(forms["red_v2"].values()) == 2, f"probe kernels' reductions: {forms}")
    vector = set(forms["red_v4"]) | set(forms["red_v2"])
    for name in ("reduce_by_gid", "reduce_by_gid_pack_bf16"):
        red = reductions("reduce_by_gid_kernelILb" + ("1E" if "bf16" in name else "0E"))
        check(sum(red.values()) == 3 and set(red) <= vector,
              f"{name}: global reductions {red}, want 3 of the vector forms {sorted(vector)}")
        out[name].update(global_reductions=red, reductions_per_instance=sum(red.values()),
                         scalar_form=sorted(forms["scalar_atomicAdd"]),
                         ftz=any(".FTZ" in m for m in red))
    out["red_forms"] = forms
    return out


def phase_sass():
    """Instruction counts of the probe kernels: the skeletons keep their ten
    staging stores (volatile, so nothing may drop them) and their barriers;
    no P3'/P4' kernel spills, and each holds at least one unrolled
    iteration's float instructions. Then the blend kernels' build facts
    (`sass_blend`)."""
    libs = {src: sass_counts(src) for src in ("probe_skeleton", "probe_ops")}

    def find(src, part):
        hits = [f for f in libs[src] if part in f]
        check(len(hits) == 1, f"{part}: {len(hits)} functions in lib{src}")
        return libs[src][hits[0]]

    out = {}
    for name, part in (("skel_fwd", "skel_fwd_kernel"), ("skel_bwd", "skel_bwd_kernel")):
        ops = find("probe_skeleton", part)
        check(ops.get("STS", 0) >= 10, f"{name}: {ops.get('STS', 0)} shared stores, want the ten rows")
        check(ops.get("BAR", 0) >= 2, f"{name}: lost its barriers")
        out[name] = {k: ops.get(k, 0) for k in ("STS", "LDS", "LDG", "STG", "BAR", "BRA")}
    for name, (part, body) in SASS_PROBES.items():
        ops = find("probe_ops", part)
        fp = sum(ops.get(k, 0) for k in SASS_FP)
        check(fp >= body, f"{name}: {fp} float instructions, want >= {body}")
        check(not ops.get("LDL") and not ops.get("STL"), f"{name}: spills to local memory")
        out[name] = {"float": fp, "least": body,
                     "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:16])}
    out.update(sass_blend())
    out.update(sass_k1_k4())
    return out


def phase_probe_skeleton(device, render_instances, k3_args):
    """P1' on the render frame's K2' inputs and P2' on the train frame's K3'
    inputs, bit for bit against their twins; then K2', P1', K3' and P2' in
    turns (full, skeleton, skeleton, full) on those inputs."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.probes import ablate as ab
    from gsplat_tpu_torch.synthetic import tiny_scene

    params, alive, camera = tiny_scene(**FULL, device=device)
    screen, gx, gy = screen_of((params, alive, camera), make_render_settings(sh_degree=3), device)
    pb = tb.pack_bins(screen, gx, gy)
    del params, alive, screen
    check(pb.num_instances == render_instances,
          f"flagship frame: {pb.num_instances} instances, the render path had {render_instances}")
    fargs = (pb.inst_t, pb.tile_start, pb.tile_end, gx, gy)
    got, want = ab.skel_fwd(*fargs), ab.skel_fwd_torch(*fargs)
    check(bitwise_equal(got, want), "P1' on the flagship frame: not bit for bit its twin")
    gotb, wantb = ab.skel_bwd(*k3_args), ab.skel_bwd_torch(*k3_args)
    check(bitwise_equal(gotb, wantb), "P2' on the train frame: not bit for bit its twin")

    turns = {"blend_fwd": [], "skel_fwd": [], "blend_bwd": [], "skel_bwd": []}
    calls = {"blend_fwd": lambda: rc.blend_fwd(*fargs), "skel_fwd": lambda: ab.skel_fwd(*fargs),
             "blend_bwd": lambda: rc.blend_bwd(*k3_args), "skel_bwd": lambda: ab.skel_bwd(*k3_args)}
    for order in (("blend_fwd", "skel_fwd", "blend_bwd", "skel_bwd"),
                  ("skel_fwd", "blend_fwd", "skel_bwd", "blend_bwd")):
        for name in order:
            turns[name].append(cuda_time(calls[name], 20))
    ms = {k: statistics.mean(v) for k, v in turns.items()}
    p1_plain = cuda_time(lambda: ab.skel_fwd_torch(*fargs), 3)
    p2_plain = cuda_time(lambda: ab.skel_bwd_torch(*k3_args), 3)
    k, num_tiles = pb.num_instances, gx * gy
    train_k, train_tiles = k3_args[0].shape[1], k3_args[3] * k3_args[4]
    # P1': K2''s bytes (10 rows per instance, 2 range ends per tile in, the
    # (T, 256, 8) output out); P2': K3''s (the same in, plus the forward
    # output and its cotangent; 10 rows per instance out). One fused
    # multiply-add per chunk.
    p1_bound = bound(k * 40 + num_tiles * 8 + num_tiles * 256 * 32, 2 * -(-k // 128))
    p2_bound = bound(train_k * 80 + train_tiles * (8 + 2 * 256 * 32), 2 * -(-train_k // 128))
    check(ms["skel_fwd"] >= p1_bound[0] and ms["skel_bwd"] >= p2_bound[0],
          "a skeleton ran under its bound: work was skipped")
    summary = {
        "render_frame": {"instances": k, "tiles": num_tiles},
        "train_frame": {"instances": train_k, "tiles": train_tiles},
        "ms_in_turns": turns, "ms": ms,
        "skeleton_share": {"k2": ms["skel_fwd"] / ms["blend_fwd"],
                           "k3": ms["skel_bwd"] / ms["blend_bwd"]},
        "math_ms": {"k2": ms["blend_fwd"] - ms["skel_fwd"], "k3": ms["blend_bwd"] - ms["skel_bwd"]},
    }
    rows = {"skel_fwd": measured(ms["skel_fwd"], p1_plain, p1_bound, 0.0, 0.0, bitwise_equal=True),
            "skel_bwd": measured(ms["skel_bwd"], p2_plain, p2_bound, 0.0, 0.0, bitwise_equal=True)}
    return summary, rows


def phase_probe_ops(device):
    """Every P3' variant and P4' at each dtype and shape against its twin on
    the card, timed; bounds on one SM."""
    from gsplat_tpu_torch.probes import bf16_rate, op_rate

    rows, us = {}, {}
    for name, v in op_rate.VARIANTS.items():
        ins = op_rate.inputs(name, device)
        got, want = op_rate.WRAPPERS[name](*ins), op_rate.TWINS[name](*ins)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= PROBE_REL * scale,
              f"P3' {name}: max abs err {err} against max |want| {scale}")
        ms = cuda_time(lambda: op_rate.WRAPPERS[name](*ins), 5)
        plain_ms = cuda_time(lambda: op_rate.TWINS[name](*ins), 1)
        us[name] = ms * 1e3 / op_rate.N_IT
        bnd = (v.flops * op_rate.N_IT / (FP32_FLOPS / SMS) * 1e3, "operations")
        check(ms >= bnd[0], f"P3' {name} ran in {ms} ms, under its bound {bnd[0]}: work was skipped")
        rows[f"op_{name}"] = measured(ms, plain_ms, bnd, err, err / scale, label=v.label,
                                      us_per_iteration=us[name], bound_basis="one SM",
                                      bitwise_equal=bool(torch.equal(got, want)))
    mix_ms = {}
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for shape in bf16_rate.SHAPES:
            row = f"blend_mix_{key}" + ("_512" if shape[0] == 512 else "")
            x = bf16_rate.inputs(shape, dtype, device)
            fn = bf16_rate.WRAPPERS[dtype]
            got, want = fn(x), bf16_rate.blend_mix_torch(x)
            check(bool(torch.isfinite(got.float()).all()), f"P4' {row}: non-finite")
            err = float((got.float() - want.float()).abs().max())
            rel = float(((got.float() - want.float()).abs() / want.float().abs()).max())
            if dtype == torch.bfloat16:
                ulps = int((got.view(torch.int16).int() - want.view(torch.int16).int()).abs().max())
                check(ulps <= BF16_ULPS, f"P4' {row}: {ulps} bf16 ulps from its twin")
            else:
                ulps = None
                check(rel <= PROBE_REL, f"P4' {row}: max rel err {rel}")
            ms = cuda_time(lambda: fn(x), 10)
            mix_ms[row] = ms
            plain_ms = cuda_time(lambda: bf16_rate.blend_mix_torch(x), 1)
            rate = (FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS) / SMS
            bnd = (bf16_rate.OPS[dtype] * x.numel() * bf16_rate.K / rate * 1e3, "operations")
            check(ms >= bnd[0], f"P4' {row} ran in {ms} ms, under its bound {bnd[0]}")
            rows[row] = measured(ms, plain_ms, bnd, err, rel, bound_basis="one SM",
                                 max_ulps=ulps, bitwise_equal=bool(torch.equal(got, want)),
                                 ns_per_element_iteration=ms * 1e6 / (x.numel() * bf16_rate.K))
    summary = {
        "us_per_iteration": us,
        "per_op_cost_ns": us["vpu9"] / 9 * 1e3,
        "per_chunk_us": {k: us[f"kappa{k}"] / k for k in (1, 2, 4)},
        "p4_ms": mix_ms,
        "bf16_speedup_same_shape": mix_ms["blend_mix_f32"] / mix_ms["blend_mix_bf16"],
        "bf16_speedup_512": mix_ms["blend_mix_f32_512"] / mix_ms["blend_mix_bf16_512"],
    }
    return summary, rows


def phase_probe_path():
    """The probe modules' entry points, `main()` of `ablate`, `op_rate` and
    `bf16_rate` with their defaults (the card, the JAX scripts' sizes), with
    the counts reset just before and read just after. Their printed lines
    are kept; every probe kernel must have launched."""
    from gsplat_tpu_torch.probes import ablate, bf16_rate, op_rate

    reset_counts()
    out = {}
    for name, mod in (("ablate", ablate), ("op_rate", op_rate), ("bf16_rate", bf16_rate)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = mod.main([])
        out[name] = {"result": res, "printed": buf.getvalue().splitlines()}
        check(all(np.isfinite(v) and v > 0 for v in res.values() if isinstance(v, float)),
              f"{name}.main: a time that is not finite and positive: {res}")
    launches = read_counts()
    for name in (row[0] for row in KERNEL_ROWS if row[1] == "probe"):
        check(launches[name] > 0, f"probe path: {name} never launched")
    for name in ("oit_fwd", "oit_bwd", "pack_instances_hybrid", "pack_instances_bf16"):
        check(launches[name] == 0, f"probe path: {name} launched {launches[name]} times")
    return out, launches


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
    ("skel_fwd", "probe", "gsplat_tpu_torch/csrc/probe_skeleton.cu", "scripts/probe_ablate2.py:32"),
    ("skel_bwd", "probe", "gsplat_tpu_torch/csrc/probe_skeleton.cu", "scripts/probe_ablate2.py:52"),
    *((f"op_{name}", "probe", "gsplat_tpu_torch/csrc/probe_ops.cu", f"scripts/probe_mm.py:{line}")
      for name, line in (("cumprod", 54), ("vpu9", 69), ("exp", 79), ("div", 86), ("cvpu", 93),
                         ("cmatmul", 104), ("two_matmuls", 114), ("merged", 129),
                         ("fwd_accum", 141), ("kappa1", 152), ("kappa2", 152), ("kappa4", 152))),
    *((name, "probe", "gsplat_tpu_torch/csrc/probe_ops.cu", "scripts/probe_r5_bf16vpu.py:35")
      for name in ("blend_mix_f32", "blend_mix_f32_512", "blend_mix_bf16", "blend_mix_bf16_512")),
)


# (row, path whose profile times it, kernel function): `profiled_ms`, the
# kernel's device time per frame or step in that path's profiled run
PROFILED_ROWS = (("expand_instances", "render", "expand_instances_kernel"),
                 ("pack_instances", "render", "pack_instances_kernel"),
                 ("blend_fwd", "render", "blend_fwd_kernel"),
                 ("pack_instances_hybrid", "train", "pack_instances_kernel"),
                 ("blend_bwd", "train", "blend_bwd_kernel"),
                 ("reduce_by_gid", "train", "reduce_by_gid_kernel"),
                 ("oit_fwd", "oit_render", "oit_fwd_kernel"),
                 ("oit_bwd", "oit_train", "oit_bwd_kernel"))


def attach_profiled(measures, profiles):
    """Each path kernel's device time from its path's profile beside its
    timed loop (`ms`, CUDA events around back-to-back wrapper calls, which
    a slow host can stretch); neither may be under the bound. K1''s expand
    also gets its train-frame time and expand + pack per path."""
    for row, path, func in PROFILED_ROWS:
        ms = profiles[path][func]
        check(ms >= measures[row]["bound_ms"], f"{row}: {ms} ms in the {path} profile, under "
              f"its bound {measures[row]['bound_ms']}")
        measures[row]["profiled_ms"] = ms
    exp = measures["expand_instances"]
    exp["train_frame"]["profiled_ms"] = profiles["train"]["expand_instances_kernel"]
    exp["k1_total_profiled_ms"] = {
        "render": exp["profiled_ms"] + measures["pack_instances"]["profiled_ms"],
        "train": exp["train_frame"]["profiled_ms"] + measures["pack_instances_hybrid"]["profiled_ms"]}


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
    from gsplat_tpu_torch.device import card_line

    device = torch.device(DEVICE)
    smi = card_line()
    emit(phase="card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0))

    t = time.perf_counter()
    _kernels.build_all()
    emit(phase="build", seconds=time.perf_counter() - t,
         libraries=[_kernels.library_path(s).name for s in _kernels.SOURCES])
    sass = phase_sass()
    emit(phase="sass", kernels=sass)

    with torch.inference_mode():
        t = time.perf_counter()
        emit(phase="k1_vs_plain", cases=phase_binning(device), seconds=time.perf_counter() - t)
        t = time.perf_counter()
        emit(phase="k1_edges", cases=phase_k1_edges(device), seconds=time.perf_counter() - t)
        t = time.perf_counter()
        subnormals = phase_subnormals(device)
        emit(phase="subnormals", cases=subnormals, seconds=time.perf_counter() - t)
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
    train_summary, state, train_measures, k3_args = phase_train(device)
    emit(phase="train_path", **train_summary, seconds=time.perf_counter() - t)
    measures.update(train_measures)
    # the warp cull of K2' and K3' on the flagship frames, and the blend
    # kernels' build facts, beside their rows
    k2_train = measures.pop("blend_fwd_train_frame")
    emit(phase="warp_cull", render_frame=render_summary["warp_cull"],
         train_frame=k2_train["warp_cull"])
    measures["blend_fwd"].update(train_frame={k: v for k, v in k2_train.items()
                                              if k != "warp_cull"}, sass=sass["blend_fwd"])
    measures["blend_bwd"]["sass"] = sass["blend_bwd"]
    # K1': the expand on the train frame too, and expand + pack per path;
    # K4': its build facts and what its reductions do with subnormals
    exp_train = measures.pop("expand_instances_train_frame")
    measures["expand_instances"].update(
        train_frame=exp_train, sass=sass["expand_instances"],
        k1_total_ms={"render": measures["expand_instances"]["ms"]
                     + measures["pack_instances"]["ms"],
                     "train": exp_train["ms"] + measures["pack_instances_hybrid"]["ms"]})
    measures["pack_instances"]["sass"] = sass["pack_instances"]
    measures["reduce_by_gid"].update(sass={k: sass[k] for k in (
        "reduce_by_gid", "reduce_by_gid_pack_bf16", "red_forms")}, subnormals=subnormals)
    k4 = measures["reduce_by_gid"]
    emit(phase="k4_vs_plain", pack_bf16=[False, True], max_abs_err=k4["max_abs_err"],
         max_rel_err=k4["max_rel_err"], unrounded_rel_miss=k4["unrounded_rel_miss"],
         instances=train_summary["instances"], gaussians=TRAIN_CAPACITY)
    t = time.perf_counter()
    with torch.no_grad():
        skel_summary, skel_rows = phase_probe_skeleton(device, render_summary["instances"],
                                                       k3_args)
    emit(phase="probe_skeleton", **skel_summary, seconds=time.perf_counter() - t)
    measures.update(skel_rows)
    del k3_args
    t = time.perf_counter()
    emit(phase="densify", **phase_densify(state), seconds=time.perf_counter() - t)
    t = time.perf_counter()
    emit(phase="resize", **phase_resize(state, device), seconds=time.perf_counter() - t)
    del state
    t = time.perf_counter()
    oit_train_summary, state, oit_train_rows, _ = phase_train(device, "oit")
    emit(phase="oit_train_path", **oit_train_summary, seconds=time.perf_counter() - t)
    measures.update(oit_train_rows)
    del state
    for mode in ("sorted", "oit"):
        t = time.perf_counter()
        emit(phase="train_cli" if mode == "sorted" else "train_cli_oit",
             **phase_train_cli(mode), seconds=time.perf_counter() - t)
    t = time.perf_counter()
    colmap_summary = phase_colmap_train(device)
    emit(phase="colmap_train", **colmap_summary, seconds=time.perf_counter() - t)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t = time.perf_counter()
        ckpt_summary, ckpt_model = phase_checkpoint_resume(device, Path(tmp))
        emit(phase="checkpoint_resume", **ckpt_summary, seconds=time.perf_counter() - t)
        t = time.perf_counter()
        emit(phase="metrics", **phase_metrics(ckpt_model, device),
             seconds=time.perf_counter() - t)
    t = time.perf_counter()
    cli_ckpt_summary = phase_train_cli_ckpt()
    emit(phase="train_cli_ckpt", **cli_ckpt_summary, seconds=time.perf_counter() - t)
    t = time.perf_counter()
    viewer_summary = phase_viewer(device)
    emit(phase="viewer", **viewer_summary, seconds=time.perf_counter() - t)
    t = time.perf_counter()
    bench_summary = phase_bench()
    emit(phase="bench", **bench_summary, seconds=time.perf_counter() - t)
    t = time.perf_counter()
    entry_summary = phase_entry()
    emit(phase="entry", **entry_summary, seconds=time.perf_counter() - t)
    t = time.perf_counter()
    quality_summary = phase_quality_fixture(device)
    emit(phase="quality_fixture", **quality_summary, seconds=time.perf_counter() - t)
    t = time.perf_counter()
    multi_summary = phase_multi_device()
    emit(phase="multi_device", **multi_summary, seconds=time.perf_counter() - t)
    nccl_summary = phase_nccl_1x1()
    emit(phase="nccl_1x1", **nccl_summary)
    emit(phase="dryrun_multichip", **phase_dryruns())
    t = time.perf_counter()
    cli_mesh_summary = phase_train_cli_mesh()
    emit(phase="train_cli_mesh", **cli_mesh_summary, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    ops_summary, ops_rows = phase_probe_ops(device)
    emit(phase="probe_ops", **ops_summary, seconds=time.perf_counter() - t)
    measures.update(ops_rows)
    t = time.perf_counter()
    probe_out, probe_launches = phase_probe_path()
    emit(phase="probe_path", entry_points=probe_out, launches=probe_launches,
         seconds=time.perf_counter() - t)

    attach_profiled(measures, {path: summary["device_profile"]["port_kernels_ms_per_frame"]
                               for path, summary in (("render", render_summary),
                                                     ("train", train_summary),
                                                     ("oit_render", oit_render_summary),
                                                     ("oit_train", oit_train_summary))})
    rows = kernels_line(measures, {"train": train_summary["launches"],
                                   "render": render_summary["launches"],
                                   "oit_train": oit_train_summary["launches"],
                                   "oit_render": oit_render_summary["launches"],
                                   "bf16_render": bf16_summary["launches"],
                                   "probe": probe_launches,
                                   "colmap_train": colmap_summary["launches"],
                                   "checkpoint_run_a": ckpt_summary["launches"]["a"],
                                   "checkpoint_run_b": ckpt_summary["launches"]["b"],
                                   "evaluate_test": ckpt_summary["launches"]["eval"],
                                   "train_cli_ckpt": cli_ckpt_summary["launches"]["first"],
                                   "train_cli_resumed": cli_ckpt_summary["launches"]["resumed"],
                                   "viewer": viewer_summary["launches"],
                                   "bench": bench_summary["launches"],
                                   "entry": entry_summary["launches"],
                                   "quality_fixture": quality_summary["launches"],
                                   **multi_summary["launches"],
                                   "nccl_1x1": nccl_summary["launches"],
                                   "train_cli_mesh_resumed": cli_mesh_summary["launches"]})
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

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
   -sass` of the built libraries: P1' stages with bulk copies and mbarrier
   waits and touches no local memory, P2' keeps its ten staging stores and
   its barriers, and no P3'/P4' kernel spills to local
   memory or holds fewer float instructions in its hot loop than one
   iteration needs; that loop's counts by pipe (`probes/floors.py`: issue,
   FMA, compare and logic, MUFU, shuffle, shared-memory wavefronts);
   K2' and K3' touch no local memory (`cuobjdump -res-usage` and no
   LDL/STL), K2' issues no shuffle and K3' at most the 31 of its
   reduce-scatter (its registers and `SHFL` count go on the kernels line);
   K1' and K4' touch no local memory, and K4' holds three global
   reductions per instance in each instantiation, every one a vector form
   (their whole mnemonics, `.FTZ` or not, go on the kernels line); the
   projection kernels' registers, stack and local memory per
   instantiation, and those of the Adam and loss kernels (a spill is
   recorded, not refused);
   then `projection`: the projection forward (`project_fwd`) and backward
   (`project_bwd`) against their twins `preprocess_torch` and
   `preprocess_bwd_torch`: the forward bit for bit on every field of the
   live rows (zeros on dead ones, whose parameters the kernel never
   reads), the backward bit for bit (int32 views) and within per-row
   relative 1e-5 of autograd of the forward twin (a row: one gradient
   component over the gaussians where float32 autograd is itself within
   1e-5 of float64 autograd; non-finite entries must coincide), the
   backward twin's arithmetic run in float64 within per-row 1e-5 of
   float64 autograd on every live row (the rows left out before included), with
   seeded cotangents laid out as the blend hands them over (strided views
   of an (N, 16) accumulator); on the seeded 65,536-gaussian scene at
   640x480 (every 7th row dead) at SH degree 0-4, antialiasing and tight
   cull on and off, on `projection_edge_table` (view z at and just above 0.2,
   centres past the 1.3 tan_fov clamp, 2D determinants of exactly 0, op
   x 255 at 1 and at the tight cull's 0.999999, SH colours of exactly 0
   and just below, rect edges on tile borders; each edge's live rows
   counted and required), and on the flagship render frame, timed there
   beside the twins and the byte bound (the train frame is checked and
   timed on the train step's own inputs in 14);
3. K1' (binning: `expand_instances` + `pack_instances`, St'' between) against its plain
   twin on the same device, on the seeded 65,536-gaussian scene at 640x480,
   SH 3: ranges and instance order equal, instance table bitwise equal, with
   tight_cull on and off, on an empty scene, and with hybrid packets (rows
   2-8 on the bf16 grid, mean2d and invz exact);
4. `k1_edges`: K1' bit for bit against its twins on adversarial emission
   tables on a 1080p tile grid (one gaussian on all 8,160 tiles, runs
   straddling the expand's 256-slot steps, whole blocks of dead rows, N =
   256 m +- 1, trimmed gaussians with empty rows), expand keys, gids and
   live packet rows, St'' on its keys, then the pack in all three packet
   modes;
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
   after (Bt', K1' expand, St'', K1' pack, K2', Cf' once per frame) and the
   kernels a frame launches (`kernels_per_frame`, the profile's, beside its
   `launch_census`: host launches and device events per frame matched by
   correlation id, and any of either without the other, by name); the
   frame's render, invdepth and final_t bit for bit the plain composite of
   its K2' output that `render` ran before the composite kernels; Cf' and
   Cb' (`composite_fwd`, `composite_bwd`) bit for bit (int32 views) their
   twins `composite_torch` and `composite_bwd_torch` on that output at bg
   (0.25, 0.5, 0.75) with seeded cotangents, without and with a seeded
   exposure (Cb' also with the exposure's gradient, its counter of
   finished blocks zero again after each launch), Cf' timed beside its
   twin and byte bound (CUDA events back to back and queued behind a hold
   of the stream), without and with exposure; the frame's stages from
   the program's own spans over the profiled frames (`profiling.stage_report`:
   host, device and idle ms and launches of each of `project`, `bin/tables`
   (Bt'), `bin/read_k` (the read of K, the frame's one host sync),
   `bin/expand` (its idle ms: the turnaround from that read to the expand's
   launch), `bin/sort` (St''), `bin/pack`, `blend`, `composite`), each
   once a frame, none inside another, no launch outside them, and the
   `instances` counter the frame's K (device operations that start before
   their launch counted, not held); the sort (`sort_instances`,
   St'' up to 2^23 keys of up to 46 bits, St' for more or wider ones) each
   route forced (St'' only on keys of up to 46 bits) `torch.equal` to its
   twin `sort_instances_torch` on the frame's keys (their largest live key
   under 2^key_bits and bit 31 clear, checked outside the timed window)
   and on adversarial keys (all equal and one tile, 2^20 keys each: St'''s
   big route; one tile of CAP - 1, CAP and CAP + 1 keys; a frame with four
   tiles over CAP; 46-bit keys on 3840x2160's 32,400 tiles; 47-bit keys on
   4096x2160's 34,560 tiles, 3 x 2^20 of them, and 62-bit keys, 2^20, both
   the path's St' whatever K; K = 1, 2^22 + 7 and 2^23 + 2^20 random keys,
   the latter the path's St'), St'''s count
   kernel's tiles over CAP and largest tile those of the keys on every
   case, timed beside its bound, its twin, both routes in turns,
   `torch.sort` with the gather (`library_ms`, also `sort_ms`) and
   `torch.sort` alone, with St'''s parts (count, scatter, segment) and
   kernels a sort from the profile; Bt' (`emission_tables`)
   `torch.equal` to its twin `_emission_tables_torch` on all six outputs on
   the frame, on the frame projected with tight_cull off and on the edge
   rows of `synthetic.emission_edge_screen` (rect heights 0, 8 and 9, det,
   a, c and cull_qmax at 0 or below, b = 0, centres on tile edges, NaN and
   inf in mean2d and conic) with tight_cull on and off; each kernel's time
   against its plain twin, its bound and its error (the packs also
   `gather_ref_ms`, the card's time for `packets.index_select(0,
   gauss_id)` alone; Bt' also queued behind a hold of the stream
   (`ms_queued`: a slow host does not stretch it), with K read back,
   torch's cumsum of the tile counts alone, its launch as built and its
   device ms a launch from a profile); K2' equal to its
   twin on the whole frame (max abs err 0, n_contrib exact); K1', St'' and
   K2' not under their bounds; the warp cull's
   check on the frame (`cull_stats_torch`: no kept pair outside its box or
   in a skipped warp) and its share of skipped (warp, instance) pairs;
   then (`wide_render_path`) the same scene at 4096x2160 (34,560 tiles,
   more than St'''s 2^15 tile counters: the sort takes St'), 1 + 5 frames
   through `render` with the counts reset just before and read just after
   (each render kernel once a frame), its image and instance count equal
   exactly to the same frame through the plain route on the card
   (`pack_bins_torch`, `blend_packed_torch`), with its frame ms, instances
   and the sort's route;
11. the render CLI on a seeded 3-view Blender-format scene and PLY snapshot;
12. the OIT render path at full width (`oit_render_path`): the same scene
   with `blend_mode="oit"`, 5 + 20 frames, counts read around them (K1' and
   the float32 pack once per frame, K5' once, K2' never), 10 sorted and 10
   OIT frames in turns, its stages checked as the sorted frame's, busy
   share, peak memory, K5' `torch.equal` to its twin on the whole frame and
   its row (with its walked pairs and culled share); the frame's outputs
   bit for bit the plain composite of K5''s sums (the OIT quotient, the
   background, the crops, the clamp), Cf' and Cb' bit for bit their twins
   there as on the sorted frame, Cf' timed;
13. bf16 packets (`bf16_packets`): K1''s bf16 pack bitwise against its twin
   at 640x480, tight_cull on and off; 3 full-width sorted frames with bf16
   packets (counts read around them), St'' bit for bit its twin on that
   frame's keys and the bf16 pack's row;
14. the train path at full width: the same scene (noise on features_dc and
   opacity, padded to 2x capacity with dead rows) trained toward the
   unperturbed render through `make_train_step` with hybrid packets — 5
   warm-up and 20 timed steps with the counts reset just before and read
   just after (the projection forward and backward, Bt', K1', St'', K2', K3', K4',
   the loss forward and backward, Cf', Cb' and Adam once per step; every path below also projects once per frame, step,
   evaluation view, viewer request and mesh rank-step, and launches Bt'
   and St'' once for each K1' expand), the loss falling,
   no NaN; its stages checked as the frame's (every stage of
   `profiling.STAGES`, the backward's on autograd's device thread inside
   `backward`; `composite` and `backward/composite`: Cf' and Cb'), the busy
   share and kernels per step, peak memory; Cb' on the step's own
   cotangents (d render from the loss, d invdepth from the depth term at
   weight 0, no d final_t): its output the cotangent K3' received in that
   step, bit for bit its twin there and at bg (0.25, 0.5, 0.75) with and
   without exposure, and against autograd of the plain composite at the
   step's bg and at (0.25, 0.5, 0.75): columns 0-3 (colour and inverse
   depth) bit for bit, columns 5-7 zero, final T (summed in another order)
   within 1e-6 of the sum of its terms' magnitudes per element
   (`cotangent_scale`); timed beside its twin and byte bound; the
   projection kernels on the step's own inputs (2,097,152 rows, half
   dead, the offset, the blend's cotangents) against their twins and
   autograd, and timed; K3', K4', Bt' (the train frame's screen, bit for
   bit, and its `bin/tables` stage), St'' (the step's keys, bit
   for bit its twin and the pack's input, and its `bin/sort` stage), the expand
   (2,097,152 rows, half dead) and the hybrid pack against their twins at
   the train frame's shapes and timed there (K4' also at the live rows'
   N, and the zeroing of its accumulator alone), none under its bound;
   K2' equal to its
   twin on the train frame and timed there, the cull's check on it, and
   neither K2' nor K3' under its bound; then `warp_cull`: both frames'
   cull checks and skipped shares; `adam`: the Adam kernel (`adam_rows`)
   bit for bit against its twin `adam_update_torch` on every row (int32
   views), on the step's own inputs (2,097,152 rows, half dead, the
   projection backward's gradients) dense with the freeze, sparse with
   visibility all, none and a seeded half, counts 0, 1 and 30,000 and a
   seeded mix, without the freeze, and on N - 77 rows; timed beside its
   bound and its twin (the unfused update and freeze it replaced);
   `loss`: the loss kernels (`loss_fwd`, `loss_bwd`) against their twins
   on the train frame's render and target and on seeded pairs at
   1920x1080, 400x304, 200x120, 16x16, 11x5, the forward's 64x16 and the
   backward's 64x24 tile +-1 on each axis and 4x40 (narrower than the
   halo): the partial maps of both images and both gradients bit for bit
   (int32 views), the loss, L1 and SSIM means bit for bit (the twin sums
   in the kernel's order), the forward run twice back to back and equal
   both times (its counter of finished blocks is zero again after each
   launch); timed beside their bounds, their float32 issue floors, their
   twins and the `F.conv2d` route they replaced (`photometric_loss_conv`),
   with each kernel's registers, shared memory per block and blocks per
   SM;
15. K4' (`reduce_by_gid`) against `index_add_` at that frame's K and N, with
   pack_bf16 off and on and against the sum of bf16-rounded rows: per-row
   max relative error below 1e-5 (and K4' without pack_bf16 must miss the
   rounded sum by more than that);
16. the skeleton probes (`probe_skeleton`): P1' (`skel_fwd`) on the render
   path's K2' inputs (the flagship frame) and on edge tables, and P2'
   (`skel_bwd`) on the train frame's K3' inputs, each bit for bit against
   its twin; K2', P1', K2' with its pair loop compiled out, K3' and P2'
   timed in turns on those inputs: the skeleton share of each kernel's time
   (`skeleton_share`; P1' moves K2''s bytes through bulk copies into an
   mbarrier ring) and K2''s own staging share (`k2_staging_share`);
17. one densify step and one opacity reset on the trained state, then
   `resize`: that state (2,097,152 rows, 1,048,576 alive) grown to
   3,145,728 rows and shrunk to 1,310,720 by `resize_train_state`, the
   alive rows' params, Adam moments, counts and stats bit for bit the
   originals in alive order, dead rows sanitized, each resized state's
   render within atol 1e-6 of the original's;
18. the OIT train path (`oit_train_path`): as 14 with `blend_mode="oit"`
   (K1', the hybrid pack, K5', K6' and K4' once per step, K2' and K3'
   never), and K6' (and the step's K5' output) `torch.equal` to its twin
   on the whole train frame, its walked pairs and culled share; Cb' as in
   14, its cotangent against autograd of the plain composite (the OIT
   quotient's) within 1e-6 of `cotangent_scale` per element;
   then `exposure_depth_step`: the sorted flagship step with
   `use_exposure=True` and the depth term at weight 0.1 against a non-zero
   inverse-depth target, 2 + 10 steps with the counts reset around them
   (every train kernel once a step), the exposure moved, its median ms and
   kernels per step; Cb' with the exposure's gradient on that step's
   cotangents bit for bit its twin, its cotangent and d exposure against
   autograd of the twin (1e-6 of `cotangent_scale` per element; d exposure
   within 1e-5 of its largest entry), timed; then `composite`: the rows
   of Cf' and Cb' on every frame, the frames' and steps' composite stages
   and kernels a frame and a step;
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
   (`oit_trained_frame`); and the projection backward on the snapshot,
   every train view differentiated as the train step does (`plain_projection.
   snapshot_check`): the kernel bit for bit its twin, and its gradients no
   further from float64 autograd than PROJ_TRAINED_FACTOR times float32
   autograd's distance (`projection_trained_state`);
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
   max |want|; bf16: within 2 bf16 ulps per element; whether bit for bit),
   with its time per iteration, its per-SM bound, the per-op costs and the
   bf16 speedups; on this phase's line (not the kernels line, which holds
   only what was measured or counted) each row's pipe floors from the
   `sass` phase's loop counts at the SM clock a spinning block measures
   (`gs_sm_clock`, beside `nvidia-smi`'s clocks), its limiter and its time
   over the limiter's floor; `k_div`'s reciprocal bit for bit `1.0 / x` on
   every float32 in [1, 2), and `k_div` bit for bit its twin on its own
   inputs and where denominators leave [1, 2) (then it reruns with the
   IEEE division in the same launch, and reports so);
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
   stretches, also not under its bound; Bt' and St'' their train-frame
   time; Cf' its OIT frame and its time with exposure, Cb' its OIT train
   frame and the exposure step's time with the exposure's gradient);
   Bt', St'', K1' to K6', Cf' and Cb' count on the render
   and train paths, and the probe kernels P1' (`skel_fwd`), P2' (`skel_bwd`), the
   twelve P3' variants (`op_<variant>`) and P4' (`blend_mix_<dtype>`, and
   `_512` at 512 rows) on the probe path, with their bounds on one SM for
   P3' and P4', their hot loops' counts by pipe and the SM clock; the COLMAP
   train path's, the bench's and the entry's counts
   beside them, and those of the checkpoint runs A and B, the direct
   `evaluate_test`, the two train CLI runs of `train_cli_ckpt`, the
   viewer, the quality run, each mesh's checked step summed over its ranks
   (`multi_device_<G>x<T>`; a rank composes its band in plain torch, so
   no Cf' or Cb' there), `nccl_1x1`, the mesh checkpoint's resumed
   run (`train_cli_mesh_resumed`) and the exposure step. The render and
   train paths launch no probe kernel.

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
# the flagship scene at 4096x2160: 256 x 135 = 34,560 tiles, more than
# St'''s 2^15 tile counters (key_bits 47), so the sort takes St'
WIDE = dict(FULL, width=4096, height=2160)
WIDE_TILES = 256 * 135
WIDE_TIMED = 5
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


HOLD_CYCLES = 50_000_000  # ~25 ms of the card's clock: the hold before queued calls


def queued_ms(fn, reps):
    """Mean device ms of `fn()` over `reps` calls queued behind a hold of
    the stream (`torch.cuda._sleep`), CUDA events around the calls: the
    card runs them back to back, so a host slower than the kernel does not
    stretch the time as it does `cuda_time`'s. Also whether the host had
    queued them all before the hold ended (else the time is the host's
    too)."""
    fn()
    torch.cuda.synchronize()
    held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    held.record()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms < held.elapsed_time(start)


# the port's kernel functions on the paths, as the profiler names them
# (the sort's kernels, St'''s `sort_instances_count`, `_scatter` and
# `_segment` and St''s `sort_instances_hist` and `_pass`, share the name
# `sort_instances_`, which sums them)
PATH_KERNEL_FUNCS = ("emission_tables_kernel", "expand_instances_kernel", "sort_instances_",
                     "pack_instances_kernel",
                     "blend_fwd_kernel", "blend_bwd_kernel", "reduce_by_gid_kernel",
                     "oit_fwd_kernel", "oit_bwd_kernel", "project_fwd_kernel", "project_bwd_kernel",
                     "adam_rows_kernel", "loss_fwd_kernel", "loss_bwd_kernel",
                     "composite_fwd_kernel", "composite_bwd_kernel")


def device_profile(frame, frames=3, top=10):
    """Device activity over `frames` profiled frames, from `torch.profiler`.

    `busy_share` is read off the trace (`gsplat_tpu_torch.profiling`, which
    the bench reports its device times with): the union of the device's
    kernel, copy and set intervals over the trace's span of those frames
    (first host op to last event end), so it cannot exceed 1. The profiled
    frames run slower than unprofiled ones (`profiled_frame_ms`); the share
    is theirs. Also the summed device time per kernel name, the top kernels,
    and the device time per frame of each of the port's kernels the frame
    ran (no host gap between launches counts there), and the host-to-device
    copies per frame; and the frame's stages, from the program's own spans
    (`profiling.stage_report`: host, device and idle ms and launches per
    stage and frame, the counters, the clock check), with how often each
    stage opened a frame and the spans opened inside another on their
    thread (`nested_stages`: none where the stages are flat)."""
    from torch.autograd import DeviceType

    from gsplat_tpu_torch.profiling import (busy_span_us, launch_census, nested, profile_calls,
                                            stage_report, stage_spans, trace_events)

    prof = profile_calls(frame, frames)
    # device-side events only: the CPU-side op rows repeat their kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3 / frames, e.count / frames)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    events = trace_events(prof)
    busy, span = busy_span_us(prof, events)
    spans = stage_spans(events)
    opened = {}
    for sp in spans:
        opened[sp[2]] = opened.get(sp[2], 0) + 1
    return {
        "stage_report": stage_report(events, frames),
        "stages_per_frame": {k: v / frames for k, v in opened.items()},
        "nested_stages": nested(spans),
        "device_ms_per_frame": sum(r[1] for r in rows),
        "kernels_per_frame": sum(r[2] for r in rows),
        "launch_census": launch_census(events, frames),
        "profiled_frame_ms": span / 1e3 / frames,
        "busy_ms_per_frame": busy / 1e3 / frames,
        "busy_share": busy / span,
        "htod_copies_per_frame": sum(c for k, _, c in rows if "HtoD" in k),
        "top_kernels": [{"kernel": k[:120], "ms_per_frame": ms, "calls_per_frame": c}
                        for k, ms, c in rows[:top]],
        "port_kernels_ms_per_frame": {f: sum(ms for k, ms, _ in rows if f in k)
                                      for f in PATH_KERNEL_FUNCS if any(f in k for k, _, _ in rows)},
    }


def check_stages(profile, stages, instances, what):
    """The profiled frames' stages: each of `stages` (and no other) once a
    frame, none inside another on its thread, every launch inside one, and
    the `instances` counter the frames' instance counts. The clock check
    (`clock_violations`, `clock_lead_us`) is reported, not held: a
    profiler session now and then maps the device's times tens of us off
    the host's (on an H100: one session in nine of the train step, by 50 us)."""
    rep = profile["stage_report"]
    check(profile["stages_per_frame"] == {s: 1.0 for s in stages},
          f"{what}: stages a frame {profile['stages_per_frame']}")
    check(not profile["nested_stages"], f"{what}: nested stages {profile['nested_stages']}")
    check(rep["stages"]["outside"]["launches"] == 0,
          f"{what}: {rep['stages']['outside']['launches']} launches a frame outside every stage")
    check(rep["counters"].get("instances") == instances,
          f"{what}: instances counted {rep['counters'].get('instances')}, the frames' {instances}")


def all_kernels():
    """The wrappers whose launches the script counts, by kernel row name."""
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import composite as cp
    from gsplat_tpu_torch.ops import projection as pj
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops import reduce as rd
    from gsplat_tpu_torch.ops import sort as so
    from gsplat_tpu_torch.probes import ablate, bf16_rate, op_rate
    from gsplat_tpu_torch.train import losses, optim

    return {"project_fwd": pj.project_fwd, "project_bwd": pj.project_bwd,
            "composite_fwd": cp.composite_fwd, "composite_bwd": cp.composite_bwd,
            "adam_rows": optim.adam_rows, "loss_fwd": losses.loss_fwd, "loss_bwd": losses.loss_bwd,
            "emission_tables": tb.emission_tables,
            "expand_instances": tb.expand_instances, "sort_instances": so.sort_instances,
            "pack_instances": tb.pack_instances,
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


# the kernels each path launches once per frame or step: every path
# projects (the projection forward, and its backward in training), bins
# (Bt', K1''s expand and St'', then a pack) and composes (Cf', and Cb' in
# training); serving packs float32 packets and has no backward; training
# packs hybrid ones and runs the loss forward and backward and Adam; the
# OIT paths blend with K5' (and K6') in place of K2' (and K3'); a mesh
# rank composes its band in plain torch (`parallel/pipeline.py`)
STEP_KERNELS = ("loss_fwd", "loss_bwd", "adam_rows")
BIN_KERNELS = ("emission_tables", "expand_instances", "sort_instances")
RENDER_KERNELS = ("project_fwd", *BIN_KERNELS, "pack_instances", "blend_fwd", "composite_fwd")
MESH_TRAIN_KERNELS = ("project_fwd", *BIN_KERNELS, "pack_instances_hybrid", "blend_fwd",
                      "blend_bwd", "reduce_by_gid", "project_bwd", *STEP_KERNELS)
TRAIN_KERNELS = (*MESH_TRAIN_KERNELS, "composite_fwd", "composite_bwd")
OIT_RENDER_KERNELS = ("project_fwd", *BIN_KERNELS, "pack_instances", "oit_fwd", "composite_fwd")
OIT_TRAIN_KERNELS = ("project_fwd", *BIN_KERNELS, "pack_instances_hybrid", "oit_fwd",
                     "oit_bwd", "reduce_by_gid", "project_bwd", *STEP_KERNELS,
                     "composite_fwd", "composite_bwd")
BF16_RENDER_KERNELS = ("project_fwd", *BIN_KERNELS, "pack_instances_bf16", "blend_fwd",
                       "composite_fwd")


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
    # pack: key 8 + sorted gid 4 per instance and 40 B of columns per live
    # gaussian (the only ones an instance points at) in; 16 table rows +
    # tile_id per instance and the T+1 bounds out
    return bound(k * 12 + live * 40 + k * (64 + 4) + (num_tiles + 1) * 4)


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


def gather_ref_ms(packets, gauss_sorted):
    """A yardstick beside the pack's row, not a library time: the card's
    time for `packets.index_select(0, gauss_id)` alone, the gather of one
    packet row per sorted instance that the pack also makes."""
    gauss_id = gauss_sorted.long()
    return cuda_time(lambda: packets.index_select(0, gauss_id), 20)


# St'''s work a key: the key (8 B) and its gid (4 B) read once and written once
SORT_BYTES = 24
SORT_REPLACES = "gsplat_tpu/ops/binning.py:758 lax.sort (XLA; no Pallas kernel)"
SORT_PARTS = ("count", "scatter", "segment")


def sort_check(what, keys, gid, key_bits):
    """Both routes of `sort_instances` (St'' and St', each forced) against
    their twin `sort_instances_torch` on the same keys: both outputs
    `torch.equal` (dtype and shape included); the tiles over CAP and the
    largest tile St'''s count kernel found (its big route, chosen on the
    card) those of the keys (`torch.bincount`). St'' is forced only on keys
    of up to SEGMENTED_MAX_KEY_BITS; wider ones take St' whatever K.
    Returns the outputs of the route the path takes (`sort.route`) and the
    case's counts."""
    from gsplat_tpu_torch.ops import sort as so
    from gsplat_tpu_torch.scripts.sort_ablate import on_route

    k = int(keys.shape[0])
    want = so.sort_instances_torch(keys, gid, key_bits)
    taken = so.route(k, key_bits)
    case = {"case": what, "instances": k, "key_bits": key_bits, "sort_route": taken}
    segmented = key_bits <= so.SEGMENTED_MAX_KEY_BITS
    for name in ("onesweep", "segmented") if segmented else ("onesweep",):
        with on_route(name):
            got = so.sort_instances(keys, gid, key_bits)
        check(so.sort_instances.last_route == name,
              f"sort {what}: forced onto {name}, took {so.sort_instances.last_route}")
        for out, a, b in zip(("keys_sorted", "gid_sorted"), got, want):
            check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b),
                  f"sort {what}, route {name}: {out} differs from its twin")
        if name == taken:
            path_got = got
    if k and segmented:
        _, bins, cap, blocks, seg_blocks, warp_cap = so.sort_layout(k, key_bits)
        counts = torch.bincount((keys >> 32).long())
        stats = (int((counts > cap).sum()), int(counts.max()))
        found = so.sort_stats(keys.device)
        check(found == stats, f"St'' {what}: the count kernel found {found} (tiles over CAP, "
                              f"largest tile), the keys hold {stats}")
        case.update(tile_bins=bins, cap=cap, warp_cap=warp_cap, blocks=blocks,
                    segment_blocks=seg_blocks, tiles_over_cap=stats[0], largest_tile=stats[1])
    return path_got, case


def sort_precondition(what, keys, key_bits):
    """The sort's precondition on K1''s keys, a max over them outside any
    timed window: bit 31 clear and the live bits under 2^key_bits. Returns
    the largest live key."""
    from gsplat_tpu_torch.ops import sort as so

    if keys.numel() == 0:
        return 0
    top = int(so.live_bits(keys).max())
    check(not bool((keys & (1 << 31)).any()) and top < 2**key_bits,
          f"sort {what}: keys outside 2^{key_bits} (largest live key {top}) or bit 31 set")
    return top


def sort_parts_ms(fn, calls=20):
    """Device ms a call of each of St'''s kernels and of all the kernels
    `fn` launches, and the kernels a call, over `calls` profiled calls."""
    from torch.autograd import DeviceType

    from gsplat_tpu_torch.profiling import profile_calls

    fn()
    prof = profile_calls(fn, calls)
    rows = [(e.key, e.self_device_time_total / 1e3 / calls, e.count / calls)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"all": sum(ms for _, ms, _ in rows), "kernels_per_call": sum(c for _, _, c in rows),
            **{part: sum(ms for k, ms, _ in rows if f"sort_instances_{part}" in k)
               for part in SORT_PARTS}}


def sort_row(keys, gid, key_bits):
    """The sort's numbers on a frame's keys: `ms` of the route the path
    takes over 20 back-to-back calls (CUDA events) and from the profile;
    each route forced on the same keys in turns (St', St'', St'', St'),
    St'''s parts from the profile (count, scatter, segment; the big route
    runs inside the segment kernel) and the kernels a sort the profile
    saw; the twin's time; the library route (`torch.sort(keys,
    stable=True)` and the gather of the gids, the same function) and
    `torch.sort` alone; beside the bound (24 B a key)."""
    from gsplat_tpu_torch.ops import sort as so
    from gsplat_tpu_torch.scripts.sort_ablate import on_route

    def library():
        keys_sorted, perm = torch.sort(keys, stable=True)
        return keys_sorted, gid[perm]

    def on(name):
        def fn():
            with on_route(name):
                return so.sort_instances(keys, gid, key_bits)
        return fn

    k = int(keys.shape[0])
    turns = {"onesweep": [], "segmented": []}
    for name in ("onesweep", "segmented", "segmented", "onesweep"):
        turns[name].append(cuda_time(on(name), 20))
    parts = {name: sort_parts_ms(on(name)) for name in turns}
    ms = cuda_time(lambda: so.sort_instances(keys, gid, key_bits), 20)
    bnd = bound(SORT_BYTES * k)
    check(min(ms, *turns["onesweep"], *turns["segmented"]) >= bnd[0],
          f"the sort ran under its bound {bnd[0]}: {ms} ms, {turns}")
    _, bins, cap, blocks, seg_blocks, warp_cap = so.sort_layout(k, key_bits)
    return measured(ms, cuda_time(lambda: so.sort_instances_torch(keys, gid, key_bits), 20), bnd,
                    0.0, 0.0, library_ms=cuda_time(library, 20),
                    torch_sort_alone_ms=cuda_time(lambda: torch.sort(keys, stable=True), 20),
                    sort_route=so.route(k, key_bits),
                    profiled_ms=parts[so.route(k, key_bits)]["all"],
                    segmented_ms=statistics.mean(turns["segmented"]),
                    onesweep_ms=statistics.mean(turns["onesweep"]), ms_turns=turns,
                    parts_ms={p: parts["segmented"][p] for p in SORT_PARTS},
                    profiled_ms_by_route={n: parts[n]["all"] for n in parts},
                    profiled_kernels_per_sort={n: parts[n]["kernels_per_call"] for n in parts},
                    instances=k, key_bits=key_bits, tile_bins=bins, cap=cap,
                    warp_cap=warp_cap, blocks=blocks, segment_blocks=seg_blocks)


def sort_edges(device):
    """Both routes bit for bit their twin on adversarial keys (K1''s layout,
    depths above 0.2 with ties and +inf, random-permutation gids): all 2^20
    keys equal, and 2^20 keys in one tile (St'''s big route: 512 runs of
    CAP merged); one tile of CAP - 1, CAP and CAP + 1 keys among 2^16 keys
    on 1080p's 8,160 tiles; a frame of 2^20 keys on those tiles with four
    tiles over CAP (CAP + 1 to 2^17 keys) among them; 46-bit keys on
    3840x2160's 32,400 tiles; K = 1; K = 2^22 + 7 random keys on 1080p's
    tiles; and 2^23 + 2^20 of them, past ONESWEEP_MIN_KEYS (the path takes
    St'). Keys too wide for St'''s tile counters take St' at any K: 47-bit
    keys on 4096x2160's 34,560 tiles (3 x 2^20 of them, under
    ONESWEEP_MIN_KEYS) and 62-bit keys on tile ids up to 2^31 - 1 (2^20);
    St'' is not forced on them. St'''s segment kernel's device ms (with the
    big route) on the frame with tiles over CAP, beside the same frame
    without them."""
    from gsplat_tpu_torch.ops import sort as so
    from gsplat_tpu_torch.scripts.sort_ablate import on_route

    rng = np.random.default_rng(19)

    def keys_of(tiles, depth):
        bits = depth.astype(np.float32).view(np.int32).astype(np.int64)
        return torch.as_tensor((tiles.astype(np.int64) << 32) | bits, device=device)

    def depths(n):
        d = rng.uniform(0.21, 1e4, n)
        d[rng.random(n) < 0.05] = 7.0
        d[rng.random(n) < 0.01] = np.inf
        return d

    def frame_with(sizes, n):
        """n keys on random tiles of 8,160 (none on tiles 100, 4000, 8159
        and 6000), then those tiles with `sizes` keys each, the slots
        shuffled."""
        ids = np.array([100, 4000, 8159, 6000])
        tiles = rng.integers(0, 8160, n)
        tiles[np.isin(tiles, ids)] -= 1
        tiles = np.concatenate([tiles, np.repeat(ids[:len(sizes)], sizes)])
        tiles = tiles[rng.permutation(tiles.size)]
        return keys_of(tiles, depths(tiles.size))

    cap = so.sort_layout(1, 44).cap
    n, big, past = 1 << 20, (1 << 22) + 7, (1 << 23) + (1 << 20)
    over = [9_000, 20_000, 1 << 17, cap + 1]
    cases = (("all_equal", keys_of(np.full(n, 4000), np.full(n, 3.5)), 44),
             ("one_tile", keys_of(np.full(n, 4321), depths(n)), 44),
             *((f"tile_at_cap{d:+d}", frame_with([cap + d], 1 << 16), 44) for d in (-1, 0, 1)),
             ("frame_tiles_over_cap", frame_with(over, n), 44),
             ("46_bit_3840x2160", keys_of(rng.integers(0, 32_400, 3 * n), depths(3 * n)),
              so.sort_key_bits(32_400)),
             ("47_bit_4096x2160", keys_of(rng.integers(0, WIDE_TILES, 3 * n), depths(3 * n)),
              so.sort_key_bits(WIDE_TILES)),
             ("62_bit", keys_of(np.append(rng.integers(0, 2**31, n - 1), 2**31 - 1), depths(n)),
              62),
             ("k_1", keys_of(np.array([8159]), np.array([0.3])), 44),
             ("random_2^22+7", keys_of(rng.integers(0, 8160, big), depths(big)),
              so.sort_key_bits(8160)),
             ("random_2^23+2^20", keys_of(rng.integers(0, 8160, past), depths(past)),
              so.sort_key_bits(8160)))
    out = []
    for name, keys, bits in cases:
        gid = torch.as_tensor(rng.permutation(keys.shape[0]).astype(np.int32), device=device)
        top = sort_precondition(name, keys, bits)
        (_, gid_sorted), case = sort_check(name, keys, gid, bits)
        if name == "all_equal":
            check(torch.equal(gid_sorted, gid), "sort all_equal: slot order not kept")
        if name == "frame_tiles_over_cap":
            plain = frame_with([], n)
            pgid = torch.as_tensor(rng.permutation(n).astype(np.int32), device=device)
            with on_route("segmented"):
                case["segment_ms"] = sort_parts_ms(
                    lambda: so.sort_instances(keys, gid, bits))["segment"]
                case["segment_ms_without_tiles_over_cap"] = sort_parts_ms(
                    lambda: so.sort_instances(plain, pgid, bits))["segment"]
        out.append({**case, "largest_live_key": top})
    by = {c["case"]: c for c in out}
    for name, bits in (("46_bit_3840x2160", 46), ("47_bit_4096x2160", 47), ("62_bit", 62)):
        check(by[name]["key_bits"] == bits and by[name]["largest_live_key"] >= 2**(bits - 1),
              f"sort {name}: holds no {bits}-bit key")
    check(by["47_bit_4096x2160"]["instances"] <= so.ONESWEEP_MIN_KEYS
          and by["47_bit_4096x2160"]["sort_route"] == "onesweep"
          and by["62_bit"]["sort_route"] == "onesweep",
          "sort: keys wider than St'''s tile counters do not take St'")
    check([by[f"tile_at_cap{d:+d}"]["tiles_over_cap"] for d in (-1, 0, 1)] == [0, 0, 1]
          and by["frame_tiles_over_cap"]["tiles_over_cap"] == len(over)
          and by["all_equal"]["tiles_over_cap"] == 1 and by["one_tile"]["tiles_over_cap"] == 1,
          "St'': the cases over and under CAP do not hold the tiles they should")
    check(by["random_2^22+7"]["sort_route"] == "segmented"
          and by["random_2^23+2^20"]["sort_route"] == "onesweep",
          f"sort routes: {by['random_2^22+7']['sort_route']}, "
          f"{by['random_2^23+2^20']['sort_route']}")
    return out


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


# the composite kernels Cf' and Cb' replace no Pallas kernel: the JAX
# package's composite is one XLA fusion
COMPOSITE_REPLACES = ("gsplat_tpu/render.py:113-127 background, tiles_to_image, exposure, "
                      "clip + gsplat_tpu/ops/rasterize_pallas.py:1317 OIT quotient "
                      "(XLA fusion; no Pallas kernel)")
COMPOSITE_BG = (0.25, 0.5, 0.75)  # the composite checks' background
# Cb''s cotangent against autograd, where the two sum in other orders: per
# element within COT_REL of the sum of the magnitudes of the terms summed
# (`cotangent_scale`; 1e-6 is ~8 float32 ulps of it)
COT_REL = 1e-6
DEXP_REL = 1e-5  # d exposure against autograd, of its largest entry
GRAD_NAMES = ("d_render", "d_invdepth", "d_final_t")


def composite_exposure(device):
    """A seeded exposure near the identity."""
    gen = torch.Generator(device=device).manual_seed(5)
    return (1.1 * torch.eye(3, 4, device=device)
            + 0.1 * torch.rand((3, 4), generator=gen, device=device) - 0.05)


def seeded_grads(h, w, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device)
                 for shape in ((h, w, 3), (h, w), (h, w)))


def composite_bound(h, w, grads=(), num_tiles=0, exposure_grad=False):
    """Cf' (no `grads`): each crop pixel's 32-byte row read, 20 bytes
    written. Cb': the rows and the present incoming gradients read, the
    padded (T, 256, 8) cotangent written (and the per-tile exposure
    partials written and read)."""
    if not num_tiles:
        return bound(h * w * (32 + 20))
    present = sum(12 if g.dim() == 3 else 4 for g in grads if g is not None)
    return bound(h * w * (32 + present) + num_tiles * 256 * 32
                 + (num_tiles * 12 * 8 if exposure_grad else 0))


def composite_check(what, raw, mode, gx, gy, w, h, grads):
    """Cf' and Cb' against their twins bit for bit (int32 views) on one
    frame's blend output at COMPOSITE_BG, without and with exposure (Cb'
    also with the exposure's gradient, its counter of finished blocks zero
    again after each launch)."""
    from gsplat_tpu_torch.ops import composite as cp

    bg = torch.tensor(COMPOSITE_BG, device=raw.device)
    cases = []
    for exposure in (None, composite_exposure(raw.device)):
        args = (raw, mode, bg, exposure, gx, gy, 16, w, h)
        fwd_equal = all(bitwise_equal(a, b) for a, b in zip(cp.composite_fwd(*args),
                                                            cp.composite_torch(*args)))
        check(fwd_equal, f"Cf' on the {what} ({mode}, exposure {exposure is not None}): "
              "not bit for bit its twin")
        for want in (False, True) if exposure is not None else (False,):
            cot, dexp = cp.composite_bwd(*args, *grads, want_exposure=want)
            cot_t, dexp_t = cp.composite_bwd_torch(*args, *grads, want_exposure=want)
            equal = bitwise_equal(cot, cot_t) and (dexp is None) == (dexp_t is None) and (
                dexp is None or bitwise_equal(dexp, dexp_t))
            check(equal and int(cp._ticket(raw.device)) == 0,
                  f"Cb' on the {what} ({mode}, exposure {exposure is not None}, its gradient "
                  f"{want}): not bit for bit its twin, or its ticket not back at 0")
            cases.append({"mode": mode, "exposure": exposure is not None,
                          "exposure_grad": want, "bitwise_equal": True})
    return {"frame": what, "size": f"{w}x{h}", "bg": COMPOSITE_BG,
            "grads": [n for n, g in zip(GRAD_NAMES, grads) if g is not None], "cases": cases}


def cotangent_scale(raw, mode, bg, exposure, gx, gy, w, h, grads):
    """Per element of Cb''s (T, 256, 8) cotangent, in float64, the sum of
    the magnitudes of the terms each value sums (a product's factors'
    magnitudes multiplied): what a sum in another order may move it by,
    in ulps. dc_c sums |g_d E[c,d]| (|g_c| without exposure); dw sums
    |dc_c N_c| and |d inv N3|; dD scales dw's by |(1 - T) / D' / D'|; dT and
    the sorted final T sum the background's |dc_c bg_c|, |dw / D'| (OIT)
    and |d final_t|."""
    from gsplat_tpu_torch.ops import composite as cp
    from gsplat_tpu_torch.ops.rasterize_torch import tiles_to_image

    f = raw.double()
    b = bg.double().abs()
    color, _, _ = cp._colour(raw, mode == "oit", bg)
    img = tiles_to_image(color, gx, gy, 16, w, h)
    pre = img if exposure is None else cp._expose(img, exposure)
    g = (torch.zeros_like(img) if grads[0] is None
         else torch.where((pre >= 0.0) & (pre <= 1.0), grads[0], 0.0)).double().abs()
    dc = g if exposure is None else g @ exposure[:3, :3].double().abs().T
    zeros = torch.zeros((h, w), dtype=torch.float64, device=raw.device)
    dinv, dft = (zeros if t is None else t.double().abs() for t in grads[1:])
    dc, dinv, dft = (cp.image_to_tiles(t, gx, gy) for t in (dc, dinv, dft))
    bg_term = (dc * b).sum(-1)
    scale = torch.zeros(f.shape, dtype=torch.float64, device=raw.device)
    if mode == "oit":
        denom = torch.clamp(f[..., 4], min=float(np.float32(1e-8)))
        one_m = 1.0 - f[..., 5]
        wq = (one_m / denom).abs()
        dw = (dc * f[..., 0:3].abs()).sum(-1) + dinv * f[..., 3].abs()
        scale[..., 0:3] = dc * wq[..., None]
        scale[..., 3] = dinv * wq
        scale[..., 4] = dw * (one_m / denom / denom).abs()
        scale[..., 5] = bg_term + dw / denom + dft
    else:
        scale[..., 0:3] = dc
        scale[..., 3] = dinv
        scale[..., 4] = bg_term + dft
    return scale


def composite_vs_autograd(raw, mode, bg, exposure, gx, gy, w, h, grads):
    """Cb''s cotangent (and d exposure) against autograd of the twin's
    torch operations, which without exposure are `render`'s plain composite
    before the kernels: sorted without exposure columns 0-3 bit for bit and
    5-7 zero; every value within COT_REL of `cotangent_scale`; d exposure
    within DEXP_REL of its largest entry."""
    from gsplat_tpu_torch.ops import composite as cp

    cot, dexp = cp.composite_bwd(raw, mode, bg, exposure, gx, gy, 16, w, h, *grads,
                                 want_exposure=exposure is not None)
    leaf = raw.detach().clone().requires_grad_(True)
    lexp = None if exposure is None else exposure.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        outs = cp.composite_torch(leaf, mode, bg, lexp, gx, gy, 16, w, h)
        sel = [(o, g) for o, g in zip(outs, grads) if g is not None]
        ag = torch.autograd.grad([o for o, _ in sel], [leaf] + ([lexp] if lexp is not None else []),
                                 [g for _, g in sel])
    diff = (cot - ag[0]).abs().double()
    scale = cotangent_scale(raw, mode, bg, exposure, gx, gy, w, h, grads)
    res = {"mode": mode, "exposure": exposure is not None,
           "cot_max_abs_err": float(diff.max()),
           "cot_max_err_over_scale": float((diff / scale.clamp(min=1e-300)).max()),
           "cot_bitwise_columns": [c for c in range(8)
                                   if bitwise_equal(cot[..., c].contiguous(),
                                                    ag[0][..., c].contiguous())]}
    ok = bool((diff <= COT_REL * scale).all())
    if mode == "sorted" and exposure is None:
        ok = ok and set(res["cot_bitwise_columns"]) >= {0, 1, 2, 3, 5, 6, 7}
        ok = ok and bool((cot[..., 5:] == 0).all())
    if exposure is not None:
        res["d_exposure_max_abs_err"] = float((dexp - ag[1]).abs().max())
        res["d_exposure_rel_err"] = res["d_exposure_max_abs_err"] / float(ag[1].abs().max())
        ok = ok and res["d_exposure_rel_err"] <= DEXP_REL
    check(ok, f"Cb' against autograd of the composite: {res}")
    return res


def composite_row(raw, mode, gx, gy, w, h, grads=None, exposure=None):
    """One composite kernel timed on a frame (CUDA events over 20
    back-to-back calls, and queued behind a hold of the stream), beside
    its twin (3 calls) and its bound: Cf' without `grads`, Cb' with."""
    from gsplat_tpu_torch.ops import composite as cp

    bg = torch.tensor(COMPOSITE_BG, device=raw.device)
    args = (raw, mode, bg, exposure, gx, gy, 16, w, h)
    if grads is None:
        kernel, plain = (lambda: cp.composite_fwd(*args)), (lambda: cp.composite_torch(*args))
        bnd = composite_bound(h, w)
    else:
        want = exposure is not None
        kernel = lambda: cp.composite_bwd(*args, *grads, want_exposure=want)  # noqa: E731
        plain = lambda: cp.composite_bwd_torch(*args, *grads, want_exposure=want)  # noqa: E731
        bnd = composite_bound(h, w, grads, gx * gy, want)
    ms = cuda_time(kernel, 20)
    ms_queued, host_ahead = queued_ms(kernel, 20)
    plain_ms = cuda_time(plain, 3)
    check(ms >= bnd[0] and ms_queued >= bnd[0],
          f"composite ({mode}): {ms} / {ms_queued} ms, under its bound {bnd[0]}")
    return measured(ms, plain_ms, bnd, 0.0, 0.0, ms_queued=ms_queued,
                    queued_host_ahead=host_ahead, mode=mode, size=f"{w}x{h}",
                    exposure=exposure is not None)


def expand_errors(what, got, want, rect):
    """K1''s expand against its twin: keys and gids equal, the packet rows
    of live gaussians bit for bit (the kernel leaves dead rows unwritten).
    Returns the largest abs difference (0)."""
    live = rect[:, 3] > 0
    check(bitwise_equal(got[2][live], want[2][live]), f"{what}: live packet rows not bitwise equal")
    return max_abs_diff(what, ("keys", "gid", "packets"), (got[0], got[1], got[2][live]),
                        (want[0], want[1], want[2][live]))


# Bt''s bytes a row, each input read once and each output written once:
# rect_min 8, rect_max 8, conic 12, mean2d 8, cull_qmax 4 and
# tiles_touched 4 in (without the tight cull rect_min, rect_max and
# tiles_touched alone); rect 16, trimmed 1, t_lo 32, cum_run 32 and
# cum_excl 8 out. The design's own traffic is not the function's and is
# left out: its block sums (8 bytes a block, written and read back). Its
# float32 operations a row under the tight cull, an IEEE division or
# square root one each: 18 for the conic
# and 54 for each of the eight rect rows (both run ends 28, the band and
# its clamp 11, the run's columns 10, its prefix 2, the casts 3). A rect
# row outside the rect or the ellipse needs no run ends, so this is the
# most a row needs; the bytes bound it all the same (0.042 ms against
# 0.007 of operations on the flagship render frame).
TABLE_BYTES_IN = {True: 44, False: 20}
TABLE_BYTES_OUT = 89
TABLE_OPS = {True: 18 + 8 * 54, False: 0}
TABLE_FIELDS = ("rect", "cum_excl", "trimmed", "t_lo", "cum_run")


def tables_bound(n, tight):
    return bound(n * (TABLE_BYTES_IN[tight] + TABLE_BYTES_OUT), n * TABLE_OPS[tight])


def tables_check(what, screen, tight):
    """Bt' against its twin `_emission_tables_torch` on `screen`: all five
    tables `torch.equal` (dtype and shape included) and K equal. Returns
    the kernel's tables and the case's counts."""
    from gsplat_tpu_torch.ops import binning as tb

    got = tb.emission_tables(screen, 16, tight)
    want = tb._emission_tables_torch(screen, 16, tight)
    for name, a, b in zip(TABLE_FIELDS, got, want):
        check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b),
              f"Bt' {what}: {name} differs from its twin")
    check(got[5] == want[5], f"Bt' {what}: K {got[5]}, the twin's {want[5]}")
    live = got[0][:, 3] > 0
    return got, {"case": what, "rows": int(got[0].shape[0]), "tight_cull": tight,
                 "instances": got[5], "live": int(live.sum()),
                 "trimmed_live": int((live & got[2].bool()).sum())}


def tables_row(what, screen, tight, tables):
    """Bt''s numbers on `screen`: `ms` over 20 back-to-back launches with K
    left on the card (CUDA events; a slow host stretches them), `ms_queued`
    over 20 launches queued behind a hold (`queued_ms`: the card's time
    alone), beside the same with K read back each time, the twin's, the
    bound and a yardstick
    (`cumsum_ref_ms`: torch's cumsum of the tile counts alone); its launch
    as built (blocks, rows a block a round, rounds) and its device ms a
    launch from a profile of 20 calls."""
    from torch.autograd import DeviceType

    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.profiling import profile_calls

    n = tables[0].shape[0]

    def once():
        return tb.emission_tables(screen, 16, tight, read_total=False)

    ms = cuda_time(once, 20)
    bnd = tables_bound(n, tight)
    queued, behind_hold = queued_ms(once, 20)
    check(min(ms, queued) >= bnd[0],
          f"Bt' on the {what} ran in {ms} ms ({queued} queued), under its bound {bnd[0]}")
    # (the profiler may drop a call's events: its count is reported)
    prof = [e for e in profile_calls(once, 20).key_averages()
            if e.device_type == DeviceType.CUDA and "emission_" in e.key]
    blocks, chunk, rounds, _ = tb.table_layout(n)
    counts = tables[0][:, 3].to(torch.int64)
    return measured(ms, cuda_time(lambda: tb._emission_tables_torch(screen, 16, tight), 3), bnd,
                    0.0, 0.0, rows=n, tight_cull=tight, ms_with_k_read=cuda_time(
                        lambda: tb.emission_tables(screen, 16, tight), 20),
                    ms_queued=queued, ms_queued_behind_hold=behind_hold,
                    own_profiled_ms=sum(e.self_device_time_total for e in prof)
                    / max(1, sum(e.count for e in prof)) / 1e3,
                    profiled_kernels_in_20_calls=sum(e.count for e in prof),
                    blocks=blocks, rows_per_block=chunk, rounds=rounds,
                    cumsum_ref_ms=cuda_time(lambda: torch.cumsum(counts, 0), 20))


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
    expand (keys, gids, live packet rows), St'' on its keys, then the pack
    in all three packet modes, on a 1080p tile grid. Cases: one gaussian on all 8,160
    tiles; runs that straddle the 256-slot steps of the expand's walk
    (rects up to 40 x 20); whole blocks of dead rows and a last block of one
    row; N = 256 m +- 1; trimmed gaussians with empty rows (tight_cull)."""
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import sort as so

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
        (keys_sorted, gauss_sorted), _ = sort_check(f"k1_edges {name}", keys, gid,
                                                    so.sort_key_bits(num_tiles))
        for packet_dtype in tb.PACKET_MODES:
            pack_args = (keys_sorted, gauss_sorted, packets, num_tiles, packet_dtype)
            kout = tb.pack_instances(*pack_args)
            pout = tb._pack_instances_torch(*pack_args[:2], want[2], *pack_args[3:])
            check(bitwise_equal(kout[0], pout[0]), f"k1_edges {name} {packet_dtype}: inst_t")
            max_abs_diff(f"k1_edges {name} {packet_dtype}", ("inst_t", "tile_id", "bounds"),
                         kout, pout)
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
    after), St'' bit for bit its twin on that frame's keys and the bf16
    pack's row at that frame's shapes."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import sort as so
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
    key_bits = so.sort_key_bits(gx * gy)
    sort_precondition("bf16 frame", keys, key_bits)
    (keys_sorted, gauss_sorted), sort_case = sort_check("bf16 frame", keys, gid, key_bits)
    pack_args = (keys_sorted, gauss_sorted, packets, gx * gy, "bfloat16")
    pack_err = max_abs_diff("pack_instances (bf16)", ("inst_t", "tile_id", "bounds"),
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
        "sort_instances_case": sort_case,
    }
    row = measured(pack_ms, pack_plain_ms, pack_bound_of(tables[5], live, gx * gy),
                   pack_err, pack_err, gather_ref_ms=gather_ref_ms(packets, gauss_sorted))
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


# --- the projection kernels (`csrc/projection.cu`), forward and backward

# the backward kernel's distance from float64 autograd on a trained state,
# at most this many times float32 autograd's: both are float32 orders of
# one sum, within 1.45x of each other on 112 trained views (a gradient
# fault is off by orders of magnitude)
PROJ_TRAINED_FACTOR = 4.0
PROJ_SCENE_DEGREE = 4  # the seeded scene's features hold degree 4; each case uses 0-4
PROJ_DEAD_EVERY = 7
PROJ_EDGE_EACH = 256  # rows per kind of edge
PROJ_INPUTS = ("xyz", "scaling", "rotation", "opacity", "features_dc", "features_rest")
PROJ_GRADS = PROJ_INPUTS + ("mean2d_offset",)


def proj_params(params):
    """The six parameter tensors of a model or state, as the kernels take
    them."""
    from types import SimpleNamespace

    get = params.get if isinstance(params, dict) else lambda k: getattr(params, k)
    return SimpleNamespace(**{k: get(k).detach() for k in PROJ_INPUTS})


def proj_cotangents(n, device, seed):
    """Seeded cotangents of the five differentiable outputs, laid out as the
    blend hands them over: mean2d, conic, opacity and rgb as strided views
    of one (N, 16) accumulator (K4''s), depth contiguous."""
    gen = torch.Generator(device=device).manual_seed(seed)
    acc = torch.randn((n, 16), generator=gen, device=device)
    depth = torch.randn((n,), generator=gen, device=device)
    return acc[:, 0:2], acc[:, 2:5], acc[:, 5], acc[:, 6:9], depth


def proj_row_diff(a, b):
    """Rows where `a` and `b` differ in any bit (float32 through int32 views,
    so NaN compares)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    d = a != b
    return d if d.dim() == 1 else d.reshape(d.shape[0], -1).any(dim=1)


def proj_fwd_mismatch(got, want, alive):
    """Rows where the forward kernel's screen is not the twin's, by field:
    every field bit for bit on the live rows; on a dead row the kernel
    writes zeros (it never reads the row's parameters), which for mask,
    radius and tiles_touched are also the twin's values."""
    bad = {}
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        check(a.shape == b.shape and a.dtype == b.dtype, f"project_fwd: {f.name} shape/dtype")
        rows = proj_row_diff(a, b) & alive
        dead_nonzero = proj_row_diff(a, torch.zeros_like(a)) & ~alive
        if f.name in ("mask", "radius", "tiles_touched"):
            dead_nonzero |= proj_row_diff(b, torch.zeros_like(b)) & ~alive
        bad[f.name] = int((rows | dead_nonzero).sum())
    return bad


def proj_cols(t, rows):
    return t[rows].reshape(int(rows.sum()), -1)


def proj_reference_rows(ag32, ag64, live):
    """The live rows where float32 autograd is itself a reference: each of
    its finite gradient entries within ROW_REL of float64 autograd, relative
    to that component's largest magnitude over the live rows. Elsewhere the
    gradient is rounding noise in float32, whatever computes it (splats whose
    dilated 2D determinant cancels to a few ulps under antialiasing)."""
    ok = live.clone()
    for a, b in zip(ag32, ag64):
        a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1).float()
        scale = proj_cols(b, live).abs().amax(dim=0) if int(live.sum()) else b.new_zeros(b.shape[1])
        off = (a - b).abs() > ROW_REL * scale
        ok &= ~(off & torch.isfinite(a)).any(dim=1)
    return ok


def proj_grad_rel(got, want, live, ref_rows):
    """The backward against autograd of the forward twin: the entries that
    are not finite must be so in both on every live row (their count is
    returned); on the reference rows, the largest per-row relative error, a
    row being one gradient component over those gaussians (K3''s
    convention), over the finite entries."""
    worst, nonfinite = 0.0, 0
    for g, w in zip(got, want):
        gl, wl = proj_cols(g, live), proj_cols(w, live)
        check(torch.equal(torch.isnan(gl), torch.isnan(wl))
              and torch.equal(torch.isposinf(gl), torch.isposinf(wl))
              and torch.equal(torch.isneginf(gl), torch.isneginf(wl)),
              "project_bwd: non-finite entries differ from autograd's")
        nonfinite += int((~torch.isfinite(gl)).sum())
        g, w = proj_cols(g, ref_rows), proj_cols(w, ref_rows)
        fin = torch.isfinite(g) & torch.isfinite(w)
        g, w = torch.where(fin, g, 0.0), torch.where(fin, w, 0.0)
        if g.numel():
            worst = max(worst, per_row_rel_err(g.T, w.T))
    return worst, nonfinite


def proj_camera_as(camera, dtype):
    return dataclasses.replace(camera, **{f: getattr(camera, f).to(dtype) for f in (
        "world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy")})


def proj_float64(params, camera, cot):
    """`params`, `camera` and the cotangents in float64."""
    from types import SimpleNamespace

    return (SimpleNamespace(**{k: getattr(params, k).double() for k in PROJ_INPUTS}),
            proj_camera_as(camera, torch.float64), [c.double() for c in cot])


def proj_autograd(params, alive, camera, settings, gx, gy, cot, offset=None,
                  dtype=torch.float32):
    """Autograd of the forward twin on the same inputs, in `dtype`."""
    from types import SimpleNamespace

    from gsplat_tpu_torch.ops.projection import preprocess_torch

    leaves = SimpleNamespace(**{k: getattr(params, k).detach().to(dtype).requires_grad_(True)
                                for k in PROJ_INPUTS})
    off = (torch.zeros((alive.shape[0], 2), device=alive.device) if offset is None
           else offset.detach()).to(dtype).requires_grad_(True)
    cam = proj_camera_as(camera, dtype)
    with torch.enable_grad():
        s = preprocess_torch(leaves, alive, cam, settings, gx, gy, off)
        return torch.autograd.grad((s.mean2d, s.conic, s.opacity, s.rgb, s.depth),
                                   [getattr(leaves, k) for k in PROJ_INPUTS] + [off],
                                   [c.to(dtype) for c in cot])


def proj_check(what, params, alive, camera, settings, gx, gy, cot, backward=True, offset=None):
    """One case: the forward kernel against its twin, and (with `backward`)
    the backward kernel against its twin bit for bit and against autograd
    of the forward twin. Returns the case's numbers."""
    from gsplat_tpu_torch.ops import projection as pj

    with torch.no_grad():
        got = pj.project_fwd(params, alive, camera, settings, gx, gy, offset)
        want = pj.preprocess_torch(params, alive, camera, settings, gx, gy, offset)
    bad = proj_fwd_mismatch(got, want, alive)
    check(not any(bad.values()), f"project_fwd {what}: rows differing from the twin {bad}")
    out = {"rows": int(alive.shape[0]), "live": int(alive.sum()), "visible": int(got.mask.sum())}
    if not backward:
        return out
    with torch.no_grad():
        kg = pj.project_bwd(params, alive, camera, settings, cot)
        tg = pj.preprocess_bwd_torch(params, alive, camera, settings, cot)
    differ = {n: int(proj_row_diff(a, b).sum()) for n, a, b in zip(PROJ_GRADS, kg, tg)}
    check(not any(differ.values()), f"project_bwd {what}: rows differing from the twin {differ}")
    ag = proj_autograd(params, alive, camera, settings, gx, gy, cot, offset)
    ag64 = proj_autograd(params, alive, camera, settings, gx, gy, cot, offset, torch.float64)
    ref_rows = proj_reference_rows(ag, ag64, alive)
    rel, nonfinite = proj_grad_rel(kg, ag, alive, ref_rows)
    check(rel <= ROW_REL, f"project_bwd {what}: per-row max rel err {rel} against autograd")
    # every live row, those left out above included: the backward's
    # arithmetic (the twin's code, which the kernel equals bit for bit) in
    # float64 against float64 autograd
    with torch.no_grad():
        p64, cam64, cot64 = proj_float64(params, camera, cot)
        tg64 = pj.preprocess_bwd_torch(p64, alive, cam64, settings, cot64)
    rel64, _ = proj_grad_rel(tg64, ag64, alive, alive)
    check(rel64 <= ROW_REL, f"preprocess_bwd_torch {what}: in float64, per-row max rel err "
          f"{rel64} against float64 autograd")
    return {**out, "bwd_rel_err_vs_autograd": rel, "nonfinite_grad_entries": nonfinite,
            "rows_where_float32_autograd_misses_float64": int((alive & ~ref_rows).sum()),
            "bwd_twin_float64_rel_err_vs_float64_autograd": rel64}


def proj_edge_coverage(params, alive, camera, gx, gy, kind):
    """How many live rows of each kind sit on their edge, read off the
    forward twin (degree 3, no antialiasing, tight cull); every count must
    be positive, so the table exercises what it claims."""
    from gsplat_tpu_torch.core import sh as sh_lib
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops.projection import preprocess_torch
    from gsplat_tpu_torch.synthetic import PROJECTION_EDGE_KINDS

    settings = make_render_settings(sh_degree=3)
    with torch.no_grad():
        s = preprocess_torch(params, alive, camera, settings, gx, gy)
    kind_t = torch.as_tensor(kind, device=alive.device)
    live = {i: alive & (kind_t == i) for i in range(len(PROJECTION_EDGE_KINDS))}
    ndc_x = (2 * s.mean2d[:, 0].double() + 1) / camera.width - 1
    ndc_y = (2 * s.mean2d[:, 1].double() + 1) / camera.height - 1
    c = s.conic
    det_zero = (c[:, 0] * c[:, 2] - c[:, 1] * c[:, 1] == 0) & (s.depth > 0.2) & ~s.mask
    op255 = s.opacity * 255.0
    colour = params.features_dc[:, 0].cpu().numpy() * np.float32(sh_lib.SH_C0) + np.float32(0.5)
    colour = torch.as_tensor(colour, device=alive.device)
    border = torch.zeros_like(alive)
    r = s.radius.double()
    for edge in (s.mean2d[:, 0].double() - r, s.mean2d[:, 0].double() + r + 15):
        border |= (torch.remainder(edge + 1e-3, 16.0) < 2e-3) & s.mask
    cov = {
        "near_at_or_below": int((live[0] & (s.depth <= 0.2)).sum()),
        "near_above": int((live[0] & (s.depth > 0.2)).sum()),
        "past_clamp": int((live[1] & ((ndc_x.abs() > 1.3) | (ndc_y.abs() > 1.3))).sum()),
        "det_zero": int((live[2] & det_zero).sum()),
        "op255_under_0.999999": int((live[3] & (op255 < 0.999999)).sum()),
        "op255_at_or_over_0.999999": int((live[3] & (op255 >= 0.999999)).sum()),
        "sh_colour_zero": int((live[4][:, None] & (colour == 0)).sum()),
        "sh_colour_negative": int((live[4][:, None] & (colour < 0)).sum()),
        "rect_edge_on_tile_border": int((live[5] & border).sum()),
    }
    check(all(v > 0 for v in cov.values()), f"projection edge table misses an edge: {cov}")
    return cov


def proj_bound(alive, k_active, k_rest, offset, backward=False):
    """The least time on the card for one call (bytes: each input read once,
    each output written once; the few hundred float operations per row are
    far below the FP32 rate). A live row reads its 44 B of geometry and its
    12 B per active SH coefficient (and 8 B of offset); every row its alive
    byte. Forward: 69 B of outputs per row. Backward (`offset`: the kernel
    writes the offset's gradient): also the 40 B of cotangents per live
    row, and the gradients of every row (56 B + 12 B per stored coefficient
    beyond DC, + 8 B of offset)."""
    n, live = int(alive.shape[0]), int(alive.sum())
    read = n + live * (44 + 12 * k_active + (0 if backward else 8 * offset))
    if backward:
        return bound(read + live * 40 + n * (56 + 12 * k_rest + 8 * offset))
    return bound(read + n * 69)


def proj_timed(params, alive, camera, settings, gx, gy, offset=None, cot=None):
    """The kernels' and the twins' times on one frame (`cuda_time`; the
    twins once, they are launch-bound)."""
    from gsplat_tpu_torch.core import sh as sh_lib
    from gsplat_tpu_torch.ops import projection as pj

    k_active, k_rest = sh_lib.num_sh_coeffs(settings.sh_degree), params.features_rest.shape[1]
    args = (params, alive, camera, settings, gx, gy, offset)
    with torch.no_grad():
        fwd = {"ms": cuda_time(lambda: pj.project_fwd(*args), 20),
               "plain_ms": cuda_time(lambda: pj.preprocess_torch(*args), 3),
               "bound": proj_bound(alive, k_active, k_rest, offset is not None)}
        if cot is None:
            return fwd, None
        bargs = (params, alive, camera, settings, cot)
        bwd = {"ms": cuda_time(lambda: pj.project_bwd(*bargs), 20),
               "plain_ms": cuda_time(lambda: pj.preprocess_bwd_torch(*bargs), 3),
               "bound": proj_bound(alive, k_active, k_rest, True, backward=True)}
    for name, t in (("project_fwd", fwd), ("project_bwd", bwd)):
        check(t["ms"] >= t["bound"][0], f"{name} ran in {t['ms']} ms, under its bound "
              f"{t['bound'][0]}")
    return fwd, bwd


def phase_projection(device):
    """The projection kernels against their twins: the forward bit for bit
    (every field on the live rows, zeros on the dead ones), the backward bit
    for bit (int32 views, so NaN compares) and within per-row relative 1e-5
    of autograd of the forward twin, the backward twin's arithmetic in
    float64 within per-row 1e-5 of float64 autograd on every live row, with
    seeded strided cotangents. Cases:
    the seeded 65,536-gaussian scene at 640x480 (features of degree 4, every
    7th row dead) at SH degree 0-4, antialiasing on and off, tight cull on
    and off; `projection_edge_table` on the same cases; the flagship render frame
    (1,048,576 gaussians, 1920x1080, degree 3), timed there. The train frame
    (2,097,152 rows, half dead) is checked and timed on the train path's own
    inputs (`kernel_rows_train`)."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.render import grid_dims
    from gsplat_tpu_torch.synthetic import projection_edge_table, tiny_scene

    module, _, camera = tiny_scene(**{**SCENE, "sh_degree": PROJ_SCENE_DEGREE}, device=device)
    params = proj_params(module)
    alive = torch.ones(SCENE["n"], dtype=torch.bool, device=device)
    alive[::PROJ_DEAD_EVERY] = False
    gx, gy = grid_dims(camera, 16)
    edge_params, edge_alive, kind = projection_edge_table(camera, device, PROJ_EDGE_EACH,
                                                          PROJ_DEAD_EVERY)
    coverage = proj_edge_coverage(edge_params, edge_alive, camera, gx, gy, kind)
    cases = []
    for table, p, a in (("scene", params, alive), ("edge_table", edge_params, edge_alive)):
        cot = proj_cotangents(a.shape[0], device, seed=5)
        for deg in range(PROJ_SCENE_DEGREE + 1):
            for aa in (False, True):
                for tight in (True, False):
                    settings = make_render_settings(sh_degree=deg, antialiasing=aa,
                                                    tight_cull=tight)
                    what = f"{table} degree {deg} aa {aa} tight {tight}"
                    # the backward does not read tight_cull: once per (degree, aa)
                    res = proj_check(what, p, a, camera, settings, gx, gy, cot, backward=tight)
                    cases.append({"table": table, "sh_degree": deg, "antialiasing": aa,
                                  "tight_cull": tight, **res})
    del module, params

    # the flagship render frame: checked, then timed
    module, alive_f, camera_f = tiny_scene(**FULL, device=device)
    params_f = proj_params(module)
    del module
    settings = make_render_settings(sh_degree=3, packet_dtype="float32")
    gxf, gyf = grid_dims(camera_f, 16)
    cot = proj_cotangents(FULL["n"], device, seed=6)
    flagship = proj_check("flagship render frame", params_f, alive_f, camera_f, settings, gxf,
                          gyf, cot)
    fwd, bwd = proj_timed(params_f, alive_f, camera_f, settings, gxf, gyf, cot=cot)
    return {"cases": cases, "edge_coverage": coverage, "render_frame": flagship,
            "render_frame_fwd": fwd, "render_frame_bwd": bwd}


def phase_main_path(device):
    """The full-width render through `render`, then per-kernel measurements."""
    from gsplat_tpu_torch import profiling
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops import sort as so
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

    # --- device busy time per frame, the kernels that take it and the
    # frame's stages (profiler over a few render() calls; the launch counts
    # were read above)
    profile = device_profile(lambda: render(camera, params, alive, settings, bg, device=DEVICE))
    check_stages(profile, profiling.RENDER_STAGES, [out["num_instances"]] * 3, "render path")

    # --- the frame's intermediates, kernel by kernel, for the checks below
    gx, gy = grid_dims(camera, 16)
    num_tiles = gx * gy
    key_bits = so.sort_key_bits(num_tiles)
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=device)
    screen, _, _ = screen_of((params, alive, camera), settings, device)
    screen = screen.detach()
    tables = tb._emission_tables(screen, 16, True)
    keys, gid, packets = tb.expand_instances(*tables[:5], screen, tables[5], gx, True)
    keys_sorted, gauss_sorted = so.sort_instances(keys, gid, key_bits)
    inst_t, tile_id, bounds = tb.pack_instances(keys_sorted, gauss_sorted, packets, num_tiles)
    blended = rc.blend_fwd(inst_t, bounds[:num_tiles], bounds[1:], gx, gy)
    # render()'s three outputs bit for bit the plain composite it ran before
    # the kernels; then Cf' and Cb' against their twins on the frame
    color = blended[..., 0:3] + blended[..., 4:5] * bg_t[None, None, :]
    plain = (torch.clamp(tiles_to_image(color, gx, gy, 16, camera.width, camera.height), 0.0, 1.0),
             tiles_to_image(blended[..., 3], gx, gy, 16, camera.width, camera.height),
             tiles_to_image(blended[..., 4], gx, gy, 16, camera.width, camera.height))
    check(all(bitwise_equal(out[key], p.contiguous())
              for key, p in zip(("render", "invdepth", "final_t"), plain)),
          "render() differs from the plain composite of its blend")
    w_, h_ = camera.width, camera.height
    composite_cases = [composite_check("render frame", blended, "sorted", gx, gy, w_, h_,
                                       seeded_grads(h_, w_, device))]
    cf_row = composite_row(blended, "sorted", gx, gy, w_, h_)
    cf_row["exposure_frame"] = composite_row(blended, "sorted", gx, gy, w_, h_,
                                             exposure=composite_exposure(device))
    cf_row["cases"] = composite_cases
    k = tables[5]
    n = params.xyz.shape[0]

    # --- St'' against its twin bit for bit on the frame's keys (the keys'
    # largest live bit checked first, outside the timed window) and on
    # adversarial keys; its row on the frame
    largest_key = sort_precondition("render frame", keys, key_bits)
    _, sort_frame = sort_check("render frame", keys, gid, key_bits)
    sort_cases = [{**sort_frame, "largest_live_key": largest_key}, *sort_edges(device)]
    sort_measure = sort_row(keys, gid, key_bits)

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
    pack_args = (keys_sorted, gauss_sorted, packets, num_tiles)
    pack_err = max_abs_diff("pack_instances", ("inst_t", "tile_id", "bounds"),
                            (inst_t, tile_id, bounds), tb._pack_instances_torch(*pack_args))

    def ms_pair(kernel, plain, args, reps, plain_reps):
        return cuda_time(lambda: kernel(*args), reps), cuda_time(lambda: plain(*args), plain_reps)

    exp_ms, exp_plain_ms = ms_pair(tb.expand_instances, tb._expand_instances_torch, exp_args, 20, 3)
    pack_ms, pack_plain_ms = ms_pair(tb.pack_instances, tb._pack_instances_torch, pack_args, 20, 3)
    blend_args = (inst_t, starts, ends, gx, gy)
    blend_ms = cuda_time(lambda: rc.blend_fwd(*blend_args), 20)

    # Bt' against its twin bit for bit on the frame, on it projected without
    # the tight cull, and on the edge rows of `emission_edge_screen` (both
    # modes); timed on the frame
    from gsplat_tpu_torch.synthetic import emission_edge_screen

    _, bt_frame = tables_check("render frame", screen, True)
    bt_cases = [bt_frame]
    rect_screen, _, _ = screen_of((params, alive, camera),
                                  make_render_settings(sh_degree=3, tight_cull=False), device)
    bt_cases.append(tables_check("render frame, tight_cull=False", rect_screen.detach(), False)[1])
    del rect_screen
    edge, _ = emission_edge_screen(device=device)
    bt_cases += [tables_check(f"edge rows, tight_cull={t}", edge, t)[1] for t in (True, False)]
    check(bt_frame["instances"] == k, f"Bt' K {bt_frame['instances']}, the frame's {k}")
    bt_row = tables_row("render frame", screen, True, tables)

    exp_bound, live, trimmed_live, run_rows = expand_bound_of(tables)
    pack_bound = pack_bound_of(k, live, num_tiles)
    check(exp_ms >= exp_bound[0] and pack_ms >= pack_bound[0],
          f"K1' under its bound: expand {exp_ms} / {exp_bound[0]}, pack {pack_ms} / {pack_bound[0]}")
    # blend: 10 table rows per instance + 2 ranges per tile in; (T, 256, 8) out
    blend_bound = bound(k * 40 + num_tiles * 8 + num_tiles * 256 * 32, pairs * BLEND_OPS_PER_PAIR)
    check(blend_ms >= blend_bound[0], f"K2' ran in {blend_ms} ms, under its bound {blend_bound[0]}")

    rows = {
        # Bt' and K1' are checked bit for bit (their errors are 0, so
        # relative ones too)
        "emission_tables": bt_row,
        "expand_instances": measured(exp_ms, exp_plain_ms, exp_bound, exp_err, exp_err),
        "sort_instances": sort_measure,
        "pack_instances": measured(pack_ms, pack_plain_ms, pack_bound, pack_err, pack_err,
                                   gather_ref_ms=gather_ref_ms(packets, gauss_sorted)),
        "blend_fwd": measured(blend_ms, blend_plain_ms, blend_bound, blend_err, blend_rel,
                              walked_pairs=walked, evaluated_pairs=pairs,
                              culled_share=cull["culled_share"]["blocks_8x4"]),
        "composite_fwd": cf_row,
    }
    summary = {
        "gaussians": n, "size": f"{FULL['width']}x{FULL['height']}", "instances": k,
        "live_gaussians": live, "trimmed_live_gaussians": trimmed_live,
        "trimmed_rows_with_run": run_rows,
        "walked_pairs": walked, "evaluated_pairs": pairs, "warp_cull": cull, "setup_s": setup_s,
        "frame_ms_median": statistics.median(frame_ms), "frame_ms": frame_ms,
        "device_profile": profile,
        "kernels_per_frame": profile["kernels_per_frame"],
        "stages": profile["stage_report"]["stages"],
        "emission_tables_cases": bt_cases, "sort_instances_cases": sort_cases,
        # the library route St'' replaced: torch.sort and the gather of the gids
        "sort_ms": sort_measure["library_ms"], "launches": launches,
        "blend_full_frame_max_abs_err": blend_err,
        "peak_mem_gib": peak_gib,
    }
    return summary, rows


def phase_wide_render(device):
    """The flagship scene rendered through `render` at 4096x2160 (WIDE:
    34,560 tiles, key_bits 47, so the sort takes St' whatever K), the
    counts reset just before and read just after (each render kernel once
    a frame), against the same frame through the plain route on the card:
    the kernel projection's screen (the projection is held to its twin in
    its own phase) binned by `pack_bins_torch` (the twins of Bt', K1' and
    the sort: `torch.sort` and a gather) and blended by
    `blend_packed_torch`, composed as `render` composes. Tolerance: the
    image and the instance count equal exactly (K2' has max abs err 0 on
    the render frame). Returns the frame's numbers and the counts."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops import sort as so
    from gsplat_tpu_torch.ops.rasterize_torch import tiles_to_image
    from gsplat_tpu_torch.render import grid_dims, render
    from gsplat_tpu_torch.synthetic import tiny_scene

    params, alive, camera = tiny_scene(**WIDE, device=device)
    settings = make_render_settings(sh_degree=3, packet_dtype="float32")
    gx, gy = grid_dims(camera, 16)
    check(gx * gy == WIDE_TILES and so.sort_key_bits(gx * gy) == 47,
          f"wide render: {gx} x {gy} tiles")
    reset_counts()
    frame_ms = []
    for i in range(1 + WIDE_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = render(camera, params, alive, settings, [0.0, 0.0, 0.0], device=DEVICE)
        torch.cuda.synchronize()
        if i:
            frame_ms.append((time.perf_counter() - t) * 1e3)
    launches = read_counts()
    check_counts(launches, RENDER_KERNELS, 1 + WIDE_TIMED, "wide render path")
    route = so.sort_instances.last_route
    check(route == "onesweep", f"wide render: the sort took {route}")
    img = out["render"]
    check(img.shape == (WIDE["height"], WIDE["width"], 3) and bool(torch.isfinite(img).all())
          and float(img.std()) > 0.01, "wide render: image shape, finiteness or flat")
    screen, _, _ = screen_of((params, alive, camera), settings, device)
    t = time.perf_counter()
    pb = tb.pack_bins_torch(screen.detach(), gx, gy, 16, True)
    plain = rc.blend_packed_torch(pb.inst_t, pb.tile_start, pb.tile_end, gx, gy)
    color = plain[..., 0:3] + plain[..., 4:5] * torch.zeros(3, device=device)
    plain_img = torch.clamp(tiles_to_image(color, gx, gy, 16, camera.width, camera.height),
                            0.0, 1.0)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    err = float((img - plain_img).abs().max())
    check(pb.num_instances == out["num_instances"] and err == 0.0,
          f"wide render: {out['num_instances']} instances against the plain route's "
          f"{pb.num_instances}, max abs err {err}")
    return {"size": f"{WIDE['width']}x{WIDE['height']}", "tiles": gx * gy,
            "key_bits": so.sort_key_bits(gx * gy), "instances": out["num_instances"],
            "sort_route": route, "frame_ms_median": statistics.median(frame_ms),
            "frame_ms": frame_ms, "plain_route_s": plain_s, "max_abs_err": err,
            "launches": launches}


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
    then its stages (the program's spans) and K5''s row: K5' equal to its
    twin on the whole frame (`torch.equal`), the twin's time and its
    evaluated and kept pair counts, K5''s walked pairs and culled share."""
    from gsplat_tpu_torch import profiling
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
    check_stages(profile, profiling.RENDER_STAGES, [out["num_instances"]] * 3, "OIT render path")

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

    # --- the frame's blend, for the checks below
    gx, gy = grid_dims(camera, 16)
    num_tiles = gx * gy
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=device)
    screen, _, _ = screen_of((params, alive, camera), settings, device)
    pb = tb.pack_bins(screen, gx, gy)
    args = (pb.inst_t, pb.tile_start, pb.tile_end, gx, gy)
    raw = rc.blend_oit_fwd(*args)
    # render() bit for bit the plain composite of K5''s sums it ran before the
    # kernels; Cf' and Cb' against their twins on the frame
    final_t = raw[:, :, 5]
    w = (1.0 - final_t) / torch.clamp(raw[:, :, 4], min=1e-8)
    color = raw[:, :, 0:3] * w[..., None] + final_t[..., None] * bg_t[None, None, :]
    plain = (torch.clamp(tiles_to_image(color, gx, gy, 16, camera.width, camera.height), 0.0, 1.0),
             tiles_to_image(raw[:, :, 3] * w, gx, gy, 16, camera.width, camera.height),
             tiles_to_image(final_t, gx, gy, 16, camera.width, camera.height))
    check(all(bitwise_equal(out[key], p.contiguous())
              for key, p in zip(("render", "invdepth", "final_t"), plain)),
          "OIT render() differs from the plain composite of its blend")
    w_, h_ = camera.width, camera.height
    composite_case = composite_check("OIT render frame", raw, "oit", gx, gy, w_, h_,
                                     seeded_grads(h_, w_, device, seed=1))
    cf_oit = composite_row(raw, "oit", gx, gy, w_, h_)
    cf_oit["cases"] = [composite_case]

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
        "device_profile": profile, "stages": profile["stage_report"]["stages"],
        "launches": launches, "peak_mem_gib": peak_gib, "k5_check_tiles": CHECK_TILES,
        "k5_full_frame": {"nd_max_rel_err": full_nd, "t_max_abs_err": full_t,
                          "bitwise_equal": bool(torch.equal(raw, plain))},
    }
    row = measured(k5_ms, plain_ms, k5_bound, float((raw - plain).abs().max()), full_nd,
                   evaluated_pairs=evaluated, kept_pairs=kept, **walked, t_max_abs_err=full_t,
                   bitwise_equal=bool(torch.equal(raw, plain)))
    return summary, {"oit_fwd": row, "composite_fwd_oit_frame": cf_oit}


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
    """The arguments of the last call of each of some functions the train
    step calls, kept by swapping each module attribute for a wrapper while
    active; the kernel checks take the step's own inputs from them."""

    def __init__(self, patches):
        self.patches = patches  # (module, attribute)
        self.args, self._saved = {}, []

    def __enter__(self):
        for mod, attr in self.patches:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))

            def wrapped(*a, _fn=fn, _attr=attr, **kw):
                out = _fn(*a, **kw)
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
    its stages (the program's spans), the busy share, and the kernel rows at
    the train frame's shapes: K3', K4' and the hybrid K1' pack (sorted), K6'
    (OIT)."""
    from gsplat_tpu_torch import profiling
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import composite as cp
    from gsplat_tpu_torch.ops import projection as pj
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops import reduce as rd
    from gsplat_tpu_torch.train import losses, optim
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

    # --- device busy share and the step's stages over 3 profiled steps
    # (counts already read)
    holder, counted = [state], []

    def one_step():
        holder[0], metrics = step(holder[0], *args)
        counted.append(metrics["num_instances"])

    profile = device_profile(one_step)
    check_stages(profile, profiling.STAGES, counted[-3:], f"{blend_mode} train path")
    state = holder[0]

    # --- the inputs the blend backward (K3' or K6'), K4' and the pack get in
    # a step
    bwd_attr = "blend_oit_bwd" if oit else "blend_bwd"
    with StageMarks([(rc, bwd_attr), (rd, "reduce_by_gid_cuda"), (tb, "pack_instances"),
                     (tb, "expand_instances"), (tb, "sort_instances"), (optim, "adam_rows"),
                     (pj, "project_fwd"), (pj, "project_bwd"), (losses, "loss_fwd"),
                     (cp, "composite_bwd")]) as marks:
        state, _ = step(state, *args)
        torch.cuda.synchronize()
    (k3_args, k4_args, pack_args, exp_args, sort_args, pf_args, pb_args, adam_args, lf_args,
     cb_args) = (marks.args[a] for a in (bwd_attr, "reduce_by_gid_cuda", "pack_instances",
                                         "expand_instances", "sort_instances", "project_fwd",
                                         "project_bwd", "adam_rows", "loss_fwd", "composite_bwd"))
    summary = {
        "gaussians": FULL["n"], "capacity": TRAIN_CAPACITY,
        "size": f"{FULL['width']}x{FULL['height']}", "packet_dtype": "hybrid",
        "blend_mode": blend_mode,
        "setup_s": setup_s, "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
        "loss_first": loss[0], "loss_last": loss[-1],
        "stages": profile["stage_report"]["stages"], "device_profile": profile,
        "kernels_per_step": profile["kernels_per_frame"],
        "launches": launches, "peak_mem_gib": peak_gib,
        "instances": int(k3_args[0].shape[1]),
    }
    with torch.no_grad():  # the saved forward output carries requires_grad
        rows = (kernel_rows_oit_train(k3_args) if oit
                else kernel_rows_train(k3_args, k4_args, pack_args, exp_args, sort_args))
        rows.update(kernel_rows_composite_train(cb_args, k3_args))
    del cb_args
    if not oit:
        rows.update(kernel_rows_projection_train(pf_args, pb_args))
        rows.update(kernel_rows_adam(adam_args))
        rows.update(kernel_rows_loss(lf_args, device))
    del adam_args, lf_args, marks
    return summary, state, rows, k3_args


EXPOSURE_STEPS = (2, 10)  # warm-up and timed steps of the exposure and depth step
DEPTH_WEIGHT = 0.1


def phase_exposure_step(device):
    """The sorted flagship train step with `use_exposure=True` and the
    depth term at weight DEPTH_WEIGHT against a non-zero inverse-depth
    target (0.9 times the unperturbed scene's, mask all ones): the counts
    reset just before its steps and read just after (every train kernel
    once a step), the loss finite and the exposure moved; then one step
    with Cb''s arguments kept: Cb' with the exposure's gradient bit for bit
    its twin, and its cotangent and d exposure against autograd of the
    twin (COT_REL of `cotangent_scale`, DEXP_REL); its time; the step's median ms
    and kernels per step from a profile."""
    from types import SimpleNamespace

    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import composite as cp
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.train import step as ts

    settings = make_render_settings(sh_degree=3, packet_dtype="hybrid")
    state, args, opt = flagship_train_setup(device, settings)
    camera, target, alpha, _, _, bg, xyz_lr, exp_lr, _, idx = args
    with torch.no_grad():
        inv = render(camera, SimpleNamespace(**state.params), state.alive, settings, bg,
                     device=device)["invdepth"]
    args = (camera, target, alpha, 0.9 * inv, torch.ones_like(inv), bg, xyz_lr, exp_lr,
            DEPTH_WEIGHT, idx)
    check(float(args[3].abs().max()) > 0, "the inverse-depth target is zero")
    step = ts.make_train_step(opt, settings, use_exposure=True)
    exposure0 = state.exposure.clone()
    reset_counts()
    ms, loss = [], []
    for i in range(sum(EXPOSURE_STEPS)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, *args)
        torch.cuda.synchronize()
        if i >= EXPOSURE_STEPS[0]:
            ms.append((time.perf_counter() - t) * 1e3)
        loss.append(float(metrics["loss"]))
    launches = read_counts()
    check_counts(launches, TRAIN_KERNELS, sum(EXPOSURE_STEPS), "exposure and depth step")
    check(all(np.isfinite(loss)) and not torch.equal(state.exposure, exposure0),
          f"exposure step: loss {loss[0]} -> {loss[-1]}, exposure moved "
          f"{not torch.equal(state.exposure, exposure0)}")
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], *args)

    profile = device_profile(one_step)
    with StageMarks([(cp, "composite_bwd")]) as marks:
        one_step()
    raw, mode, bg_c, exposure, gx, gy, _, w, h, *grads = marks.args["composite_bwd"]
    raw, exposure = raw.detach(), exposure.detach()
    grads = [None if g is None else g.detach() for g in grads]
    check(grads[0] is not None and grads[1] is not None, "exposure step: no d render or d invdepth")
    got = cp.composite_bwd(raw, mode, bg_c, exposure, gx, gy, 16, w, h, *grads, want_exposure=True)
    want = cp.composite_bwd_torch(raw, mode, bg_c, exposure, gx, gy, 16, w, h, *grads,
                                  want_exposure=True)
    check(bitwise_equal(got[0], want[0]) and bitwise_equal(got[1], want[1]),
          "exposure step: Cb' with the exposure's gradient not bit for bit its twin")
    vs_autograd = composite_vs_autograd(raw, mode, bg_c, exposure, gx, gy, w, h, grads)
    row = composite_row(raw, mode, gx, gy, w, h, grads, exposure=exposure)
    del holder, state, marks, raw, grads
    return {"use_exposure": True, "depth_weight": DEPTH_WEIGHT,
            "step_ms_median": statistics.median(ms), "step_ms": ms, "loss_first": loss[0],
            "loss_last": loss[-1], "device_profile": profile,
            "kernels_per_step": profile["kernels_per_frame"], "launches": launches,
            "composite_bwd_with_exposure_grad": row, "vs_autograd": vs_autograd}


def kernel_rows_composite_train(cb_args, blend_args):
    """Cb' on the cotangents one train step gave it (the step's bg, the
    loss's d render, the depth term's d invdepth, no d final_t): against
    its twin bit for bit there and with COMPOSITE_BG and exposure; the
    cotangent against autograd of the plain composite (sorted: columns 0-3
    bit for bit); the cotangent equal to what the blend's backward received
    in that step; timed beside its twin and bound. Sorted: the
    `composite_bwd` row; OIT: `composite_bwd_oit_train_frame`."""
    raw, mode, bg, exposure, gx, gy, _, w, h, *grads = cb_args
    raw = raw.detach()
    grads = [None if g is None else g.detach() for g in grads]
    check(bitwise_equal(raw, blend_args[5].detach()), f"Cb' ({mode}) read another blend output "
          "than the blend's backward")
    check(exposure is None and grads[0] is not None and grads[1] is not None
          and grads[2] is None, f"the {mode} train step's composite cotangents: "
          f"{[g is not None for g in grads]}")
    from gsplat_tpu_torch.ops import composite as cp

    cot, _ = cp.composite_bwd(raw, mode, bg, None, gx, gy, 16, w, h, *grads)
    check(bitwise_equal(cot, blend_args[6].contiguous()),
          f"Cb' ({mode}): not the cotangent the blend's backward received")
    cases = [composite_check(f"{mode} train frame", raw, mode, gx, gy, w, h, grads)]
    vs_autograd = [composite_vs_autograd(raw, mode, b, None, gx, gy, w, h, grads)
                   for b in (bg, torch.tensor(COMPOSITE_BG, device=raw.device))]
    row = composite_row(raw, mode, gx, gy, w, h, grads)
    row.update(cases=cases, vs_autograd=vs_autograd,
               grads=[n for n, g in zip(GRAD_NAMES, grads) if g is not None])
    return {"composite_bwd" if mode == "sorted" else "composite_bwd_oit_train_frame": row}


def kernel_rows_projection_train(pf_args, pb_args):
    """The projection kernels on the inputs one train step gave them (the
    train frame: 2,097,152 rows, half dead, the densification offset, the
    blend's strided cotangents): each against its twin bit for bit, the
    backward against autograd of the forward twin, their times and
    bounds."""
    params, alive, camera, settings, gx, gy, offset = pf_args
    cot = pb_args[4]
    check(offset is not None and pb_args[5], "the train step projects without its offset")
    res = proj_check("train frame", params, alive, camera, settings, gx, gy, cot, offset=offset)
    fwd, bwd = proj_timed(params, alive, camera, settings, gx, gy, offset, cot)
    return {
        "project_fwd_train_frame": measured(fwd["ms"], fwd["plain_ms"], fwd["bound"], 0.0, 0.0,
                                            rows=res["rows"], live=res["live"]),
        "project_bwd": measured(bwd["ms"], bwd["plain_ms"], bwd["bound"], 0.0, 0.0,
                                rel_err_vs_autograd=res["bwd_rel_err_vs_autograd"],
                                twin_float64_rel_err_vs_float64_autograd=res[
                                    "bwd_twin_float64_rel_err_vs_float64_autograd"],
                                rows=res["rows"], live=res["live"],
                                cotangent_strides=[c.stride() for c in cot]),
    }


def kernel_rows_train(k3_args, k4_args, pack_args, exp_args, sort_args):
    """K3', K4', Bt', St'' and the hybrid K1' pack and expand on the inputs
    one train step gave them: time, plain twin time, error and bound."""
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

    # Bt' on the train frame (2,097,152 rows, half of them dead): bit for
    # bit its twin, timed
    screen = exp_args[5]
    bt_tables, bt_case = tables_check("train frame", screen, True)
    check(bt_tables[5] == exp_args[6], f"Bt' K {bt_tables[5]} on the train frame, the step's "
          f"{exp_args[6]}")
    bt_row = {**tables_row("train frame", screen, True, bt_tables), **bt_case}
    del bt_tables

    # the expand at the train frame (2,097,152 rows, half of them dead)
    # and the hybrid pack, each against its twin bit for bit
    exp_err = expand_errors("expand_instances (train frame)", tb.expand_instances(*exp_args),
                            tb._expand_instances_torch(*exp_args), exp_args[0])
    exp_ms = cuda_time(lambda: tb.expand_instances(*exp_args), 20)
    exp_plain_ms = cuda_time(lambda: tb._expand_instances_torch(*exp_args), 3)
    exp_bound, _, _, _ = expand_bound_of((*exp_args[:5], exp_args[6]))
    keys_sorted, gauss_sorted, packets, pt, mode = pack_args
    check(mode == "hybrid", "the train step packs hybrid instances")
    outs = tb.pack_instances(*pack_args)
    pack_err = max_abs_diff("pack_instances (hybrid)", ("inst_t", "tile_id", "bounds"),
                            outs, tb._pack_instances_torch(*pack_args))
    pack_ms = cuda_time(lambda: tb.pack_instances(*pack_args), 20)
    pack_plain_ms = cuda_time(lambda: tb._pack_instances_torch(*pack_args), 3)
    live = int(torch.unique(gauss_sorted).numel())
    pack_bound = pack_bound_of(keys_sorted.shape[0], live, pt)
    check(exp_ms >= exp_bound[0] and pack_ms >= pack_bound[0],
          f"K1' under its bound on the train frame: expand {exp_ms} / {exp_bound[0]}, "
          f"pack {pack_ms} / {pack_bound[0]}")

    # St'' on the train frame's keys: bit for bit its twin, and its output
    # the one the step packed; timed
    keys, kgid, key_bits = sort_args
    top = sort_precondition("train frame", keys, key_bits)
    (st_keys, st_gid), st_case = sort_check("train frame", keys, kgid, key_bits)
    check(torch.equal(st_keys, keys_sorted) and torch.equal(st_gid, gauss_sorted),
          "St'' on the train frame differs from what the step packed")
    st_row = {**sort_row(keys, kgid, key_bits), **st_case, "largest_live_key": top}

    return {
        # Bt' and St'' on the train frame (their rows are the render frame's)
        "emission_tables_train_frame": bt_row,
        "sort_instances_train_frame": st_row,
        "pack_instances_hybrid": measured(pack_ms, pack_plain_ms, pack_bound, pack_err, pack_err,
                                          gather_ref_ms=gather_ref_ms(packets, gauss_sorted)),
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


# the kernels of the train step's own stages replace no Pallas kernel: the
# JAX package's Adam and loss are XLA fusions
ADAM_REPLACES = ("gsplat_tpu/train/optim.py:41 adam_update + gsplat_tpu/train/step.py:159 "
                 "freeze (XLA fusions; no Pallas kernel)")
LOSS_REPLACES = ("gsplat_tpu/train/losses.py:88 ssim (_ssim_fwd :104, _ssim_bwd :133) and "
                 ":19 l1_loss, as :151 photometric_loss (XLA fusions; no Pallas kernel)")
# float32 operations per element of one Adam update: m' 3, v' 4, the two
# bias divisions 2, sqrt and + eps 2, lr * and / 2, p - 1
ADAM_OPS_PER_ELEMENT = 14
# per image value, forward: x^2, y^2, xy 3; two passes of 5 blurs of 11
# taps (11 mul + 10 add) 210; the three variances 6; the SSIM map 14; the
# partials 24; |x - y| and the two sums 4. Backward: two passes of 3 blurs
# 126; sign, the two coefficients' products and the combination 11
LOSS_FWD_OPS_PER_VALUE = 261
LOSS_BWD_OPS_PER_VALUE = 137
# W x H: seeded pairs; the forward's 64 x 16 tile and the backward's 64 x 24
# tile +-1 on each axis; a width under the 5-pixel halo
LOSS_SIZES = ((1920, 1080), (400, 304), (200, 120), (16, 16), (11, 5), (63, 15), (65, 17),
              (63, 23), (65, 25), (4, 40))
# the float32 pipe's issue rate, one multiply or add per lane and clock
# (132 SMs x 128 lanes x 1.98 GHz): the loss kernels' floor, since
# -fmad=false issues each multiply and add apart
FP32_ISSUE_PER_S = 33.5e12
ADAM_COUNTS = (0, 1, 30_000)


def adam_mismatch(got, want):
    """The first output of the Adam kernel that is not bit for bit its
    twin's (int32 views), or None."""
    for i, name in enumerate(("params", "m", "v")):
        for k, t in want[i].items():
            if not bitwise_equal(got[i][k], t):
                return f"{name}.{k}"
    return None if torch.equal(got[3], want[3]) else "counts"


def adam_bound(args):
    """Bytes: p, g, m and v read and p, m and v written per element (the
    gradient counted once, not its layout's padding), the count read and
    written, the alive and visibility bytes; operations: the update's."""
    params, counts, vis, alive = args[0], args[4], args[6], args[8]
    n = counts.shape[0]
    width = sum(p.numel() // max(n, 1) for p in params.values())
    nbytes = n * (width * 7 * 4 + 8 + (alive is not None) + (vis is not None))
    return bound(nbytes, n * width * ADAM_OPS_PER_ELEMENT), width


def kernel_rows_adam(args):
    """The Adam kernel on the inputs one train step gave it (the train
    frame's 2,097,152 rows, half dead, the projection backward's gradients)
    and on variants of them, each against its twin bit for bit on every
    row: dense as the step ran it; sparse with visibility all, none and a
    seeded half; counts 0, 1 and 30,000 (sparse) and a seeded mix (dense);
    no freeze; the first N - 77 rows (not a multiple of the kernel's 256).
    Then the kernel and its twin (the unfused update and freeze the step
    ran before, without its learning-rate copies) timed on the step's
    inputs."""
    from gsplat_tpu_torch.train import optim

    params, grads, m, v, counts, lrs, vis, eps, alive = args
    check(vis is None and alive is not None, "the train step's Adam: dense, with the freeze")
    n, dev = counts.shape[0], counts.device
    gen = torch.Generator(device=dev).manual_seed(7)
    half = torch.rand(n, generator=gen, device=dev) < 0.5
    mixed = torch.randint(0, ADAM_COUNTS[-1] + 1, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    base = (params, grads, m, v)
    cases = {"train_step": args}
    for name, mask in (("all", torch.ones_like(half)), ("none", torch.zeros_like(half)),
                       ("half", half)):
        cases[f"sparse_visibility_{name}"] = (*base, counts, lrs, mask, eps, alive)
    for c in ADAM_COUNTS:
        cases[f"sparse_counts_{c}"] = (*base, torch.full_like(counts, c), lrs, half, eps, alive)
    cases["dense_counts_mixed"] = (*base, mixed, lrs, None, eps, alive)
    cases["no_freeze"] = (*base, counts, lrs, None, eps, None)
    cut = n - 77
    check(cut % 256 != 0, "the cut row count is a multiple of the kernel's block")
    head = lambda d: {k: t[:cut] for k, t in d.items()}
    cases["rows_not_a_multiple_of_256"] = (head(params), head(grads), head(m), head(v),
                                           counts[:cut], lrs, half[:cut], eps, alive[:cut])
    results = {}
    for name, a in cases.items():
        bad = adam_mismatch(optim.adam_rows(*a), optim.adam_update_torch(*a))
        check(bad is None, f"adam_rows, {name}: {bad} differs from its twin")
        results[name] = {"rows": int(a[4].shape[0]), "sparse": a[6] is not None,
                         "freeze": a[8] is not None}
    del cases
    ms = cuda_time(lambda: optim.adam_rows(*args), 20)
    plain_ms = cuda_time(lambda: optim.adam_update_torch(*args), 3)
    bnd, width = adam_bound(args)
    check(ms >= bnd[0], f"adam_rows ran in {ms} ms, under its bound {bnd[0]}")
    strides = {k: g.stride() for k, g in grads.items()}
    return {"adam_rows": measured(ms, plain_ms, bnd, 0.0, 0.0, replaced_route_ms=plain_ms,
                                  cases=results, rows=n, alive=int(alive.sum()),
                                  floats_per_row=width, grad_strides=strides)}


def loss_pair(w, h, device, seed):
    """A seeded image pair: x uniform, y = x + noise 0.1 clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    x = rng.random((h, w, 3)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal((h, w, 3)), 0.0, 1.0).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def loss_check(what, x, y, lam, taps):
    """The loss kernels against their twins on one pair: the forward's
    partial maps of both images and its three means bit for bit (int32
    views; the twin sums the means in the kernel's order); the backward's
    gradient for each image bit for bit, with the step's incoming gradient
    (d loss = 1) and with all three given."""
    from gsplat_tpu_torch.train import losses

    want = losses.loss_fwd_torch(x, y, lam, True, True, taps)
    for launch in ("first", "second"):  # back to back: the ticket is zero again
        got = losses.loss_fwd(x, y, lam, True, True, taps)
        for i, name in ((3, "x"), (4, "y")):
            check(bitwise_equal(got[i], want[i]), f"loss_fwd, {what}, {launch} launch: the "
                  f"{name} partial maps differ from the twin's")
        g, t = [float(v) for v in got[:3]], [float(v) for v in want[:3]]
        rel = {k: abs(a - b) / abs(b) for k, a, b in zip(("loss", "l1", "ssim"), g, t)}
        check(all(bitwise_equal(a, b) for a, b in zip(got[:3], want[:3])),
              f"loss_fwd, {what}, {launch} launch: means differ from the twin's: "
              f"{dict(zip(rel, g))} against {dict(zip(rel, t))}")
    one = torch.ones((), device=x.device)
    for grads in ((one, None, None), (one, 0.25 * one, -0.5 * one)):
        for a, b, part in ((x, y, got[3]), (y, x, got[4])):
            check(bitwise_equal(losses.loss_bwd(a, b, part, *grads, lam, taps),
                                losses.loss_bwd_torch(a, b, part, *grads, lam, taps)),
                  f"loss_bwd, {what}: the gradient differs from the twin's")
    return {"size": f"{x.shape[1]}x{x.shape[0]}", "means": dict(zip(("loss", "l1", "ssim"), t)),
            "mean_rel_err": rel, "mean_abs_err": max(abs(a - b) for a, b in zip(g, t))}


def kernel_rows_loss(fwd_args, device):
    """The loss kernels on the train frame's images (the step's render and
    target, 1920x1080) and on seeded pairs at LOSS_SIZES, each against its
    twins (`loss_check`); then on the train frame the kernels, their twins
    and the route they replaced (`photometric_loss_conv`: autograd of the L1
    mean and two depthwise `F.conv2d` per blur, forward and backward)
    timed beside their bounds."""
    from gsplat_tpu_torch.train import losses

    image, gt, lam, want_x, want_y, taps = fwd_args
    check(want_x and not want_y, "the train step must ask for the image's partials alone")
    image, gt = image.detach(), gt.detach()
    cases = [loss_check("train frame", image, gt, lam, taps)]
    for i, (w, h) in enumerate(LOSS_SIZES):
        cases.append(loss_check(f"{w}x{h}", *loss_pair(w, h, device, 20 + i), lam, taps))

    one = torch.ones((), device=device)
    partials = losses.loss_fwd(image, gt, lam, True, False, taps)[3]
    fwd_ms = cuda_time(lambda: losses.loss_fwd(image, gt, lam, True, False, taps), 20)
    bwd_ms = cuda_time(lambda: losses.loss_bwd(image, gt, partials, one, None, None, lam, taps),
                       20)
    fwd_plain = cuda_time(lambda: losses.loss_fwd_torch(image, gt, lam, True, False, taps), 3)
    bwd_plain = cuda_time(lambda: losses.loss_bwd_torch(image, gt, partials, one, None, None,
                                                        lam, taps), 3)
    x = image.clone().requires_grad_(True)
    with torch.enable_grad():
        route_fwd = cuda_time(lambda: losses.photometric_loss_conv(x, gt, lam), 5)
        route_both = cuda_time(lambda: torch.autograd.grad(
            losses.photometric_loss_conv(x, gt, lam)[0], x), 5)
    n = image.numel()
    blocks = -(-image.shape[1] // 16) * -(-image.shape[0] // 16)
    fwd_bound = bound(5 * n * 4 + 2 * blocks * 4, n * LOSS_FWD_OPS_PER_VALUE)
    bwd_bound = bound(6 * n * 4, n * LOSS_BWD_OPS_PER_VALUE)
    check(fwd_ms >= fwd_bound[0] and bwd_ms >= bwd_bound[0],
          f"a loss kernel under its bound: {fwd_ms} / {fwd_bound[0]}, {bwd_ms} / {bwd_bound[0]}")
    err = max(c["mean_abs_err"] for c in cases)
    rel = max(max(c["mean_rel_err"].values()) for c in cases)
    # the issue floors are computed, not measured: they go on the `loss`
    # phase line only (main pops `loss_facts` before the kernels line)
    floor = {k: n * ops / FP32_ISSUE_PER_S * 1e3
             for k, ops in (("loss_fwd", LOSS_FWD_OPS_PER_VALUE),
                            ("loss_bwd", LOSS_BWD_OPS_PER_VALUE))}
    return {"loss_fwd": measured(fwd_ms, fwd_plain, fwd_bound, err, rel,
                                 replaced_route_ms=route_fwd, partials_bitwise=True,
                                 cases=cases),
            "loss_bwd": measured(bwd_ms, bwd_plain, bwd_bound, 0.0, 0.0,
                                 replaced_route_ms=route_both - route_fwd,
                                 replaced_route_fwd_bwd_ms=route_both),
            "loss_facts": {"fp32_issue_floor_ms": floor, "occupancy": loss_kernel_info()}}


def loss_kernel_info():
    """Each loss kernel as built and launched (`gs_loss_info`): registers
    per thread, shared memory per block in bytes, blocks per SM."""
    import ctypes

    from gsplat_tpu_torch import _kernels

    out = (ctypes.c_int * 6)()
    _kernels.check(_kernels.load("loss").gs_loss_info(out), "gs_loss_info")
    keys = ("registers", "shared_bytes_per_block", "blocks_per_sm")
    return {name: dict(zip(keys, out[3 * i:3 * i + 3]))
            for i, name in enumerate(("loss_fwd", "loss_bwd"))}


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
    from gsplat_tpu_torch.ops import sort as so
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
        # the last step's sort: its route, and under St'' its tiles over CAP
        # (the big route) and its largest tile, as its count kernel found them
        sort_last_step = {"sort_route": so.sort_instances.last_route}
        if sort_last_step["sort_route"] == "segmented":
            sort_last_step.update(zip(("tiles_over_cap", "largest_tile"), so.sort_stats(device)))
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
        "sort_last_step": sort_last_step,
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
    """Launches of a training run with `renders` evaluation renders: the
    projection forward, Bt', K1' (expand, hybrid pack), St'', K2' and Cf'
    per iteration and per render, K3', K4', the projection backward, the
    loss forward and backward, Cb' and Adam per iteration."""
    return {"project_fwd": iterations + renders, "emission_tables": iterations + renders,
            "expand_instances": iterations + renders, "sort_instances": iterations + renders,
            "pack_instances_hybrid": iterations + renders,
            "blend_fwd": iterations + renders, "blend_bwd": iterations,
            "reduce_by_gid": iterations, "project_bwd": iterations,
            "composite_fwd": iterations + renders, "composite_bwd": iterations,
            **{k: iterations for k in STEP_KERNELS}}


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
    check_launches(eval_launches, {"project_fwd": 4, "emission_tables": 4, "expand_instances": 4,
                                   "sort_instances": 4, "pack_instances_hybrid": 4,
                                   "blend_fwd": 4, "composite_fwd": 4},
                   "evaluate_test, 2 views twice")
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
    want = {"project_fwd": 3 * grad + fwd, "emission_tables": 3 * grad + fwd,
            "expand_instances": 3 * grad + fwd, "sort_instances": 3 * grad + fwd,
            "pack_instances": grad, "pack_instances_hybrid": 2 * grad + fwd,
            "blend_fwd": 3 * grad + fwd, "blend_bwd": 3 * grad, "reduce_by_gid": 3 * grad,
            "project_bwd": 3 * grad, "composite_fwd": 3 * grad + fwd, "composite_bwd": 3 * grad}
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
        want = {"project_fwd": views + n_it + renders + test_views,
                "emission_tables": views + n_it + renders + test_views,
                "expand_instances": views + n_it + renders + test_views,
                "sort_instances": views + n_it + renders + test_views,
                "pack_instances": views + test_views, "pack_instances_hybrid": n_it + renders,
                "blend_fwd": views + n_it + renders + test_views, "blend_bwd": n_it,
                "reduce_by_gid": n_it, "project_bwd": n_it, "adam_rows": n_it,
                "loss_fwd": n_it + test_views, "loss_bwd": n_it,
                "composite_fwd": views + n_it + renders + test_views, "composite_bwd": n_it}
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
        proj = projection_trained_state(model_dir, scene_dir, n_it)
    return {"iterations": n_it, "run_s": run_s, "summary": row, "self_consistency": self_err,
            "psnr_bar": QUALITY_PSNR_BAR, "trained_cloud": trained, "cull": cull,
            "oit_trained_frame": oit, "projection_trained_state": proj, "launches": launches}


def projection_trained_state(model_dir, scene_dir, iteration):
    """The projection backward on a trained state (`snapshot_check`): on
    every train view the kernel equals its twin bit for bit, and each
    gradient component over the live rows is no further from float64
    autograd, relative to its largest value, than PROJ_TRAINED_FACTOR times
    float32 autograd's distance (both are float32 orders of one sum; on a
    trained state neither is within 1e-5 of float64 on every view). These
    launches compare and are not counted on any path."""
    from gsplat_tpu_torch.scripts.plain_projection import snapshot_check

    res = snapshot_check(model_dir, scene_dir, iteration, DEVICE)
    for v in res["views"]:
        check(v["equal_to_twin"], f"project_bwd on the trained state, {v['view']}: not equal "
              "to its twin")
        check(v["kernel_vs_float64"] <= PROJ_TRAINED_FACTOR * v["autograd_vs_float64"],
              f"project_bwd on the trained state, {v['view']}: {v['kernel_vs_float64']} from "
              f"float64 autograd, float32 autograd {v['autograd_vs_float64']}")
    ratio = [v["kernel_vs_float64"] / max(v["autograd_vs_float64"], 1e-300)
             for v in res["views"]]
    return {"views": len(res["views"]), "live": res["live"],
            "kernel_vs_float64_max": max(v["kernel_vs_float64"] for v in res["views"]),
            "autograd_vs_float64_max": max(v["autograd_vs_float64"] for v in res["views"]),
            "ratio_median": statistics.median(ratio), "ratio_max": max(ratio),
            "nonfinite_max": max(max(v["nonfinite"]) for v in res["views"])}


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
        check_counts(res["launches"], MESH_TRAIN_KERNELS, 1, f"{tag}: mesh train step")
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


def sass_text(source):
    """`cuobjdump -sass` of a built library."""
    from gsplat_tpu_torch import _kernels

    tool = Path(_kernels.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(_kernels.library_path(source))],
                          capture_output=True, text=True, timeout=120, check=True).stdout


def sass_counts(source, full=False):
    """{kernel function: {opcode: count}} of a built library, from
    `cuobjdump -sass`; with `full` the key is the whole mnemonic, its
    modifiers included (`RED.E.ADD...`)."""
    counts, cur = {}, None
    for line in sass_text(source).splitlines():
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


def res_usage(source):
    """{kernel function: {REG, STACK, SHARED, LOCAL}} of a built library."""
    from gsplat_tpu_torch import _kernels

    return _kernels.res_usage(_kernels.library_path(source))


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
    """Bt', K1' and K4' as built: registers and no local memory; K4''s global
    reductions, with their whole mnemonics: three per instance (for ten
    values) in each of its two instantiations (pack_bf16 off and on), each
    a mnemonic of the vector probe kernels (v4, v2); the scalar probe's
    mnemonic is recorded beside them."""
    out = {}
    for name, source, part in (("emission_tables", "binning", "emission_tables_kernel"),
                               ("expand_instances", "binning", "expand_instances_kernel"),
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


def sass_sort():
    """The sort's kernels as built: St'' (`sort_instances_count`,
    `_scatter`, `_segment`) and St' (`sort_instances_hist` and the pass
    kernel of each digit position, `sort_instances_pass<P>`): registers,
    stack, shared and local memory (`cuobjdump -res-usage`) and the local
    loads and stores in their SASS. A spill is recorded, not refused."""
    out = {}
    for lib, pattern in (("sort", r"sort_instances_(count|scatter|segment)"),
                         ("sort_onesweep", r"sort_instances_(hist|pass)(?:ILi(\d+)E)?")):
        ops, use = sass_counts(lib), res_usage(lib)
        for f, u in use.items():
            m = re.search(pattern, f)
            if m:
                o = ops.get(f, {})
                name = m.group(1) + (f"<{m.group(2)}>" if m.lastindex == 2 and m.group(2) else "")
                out[name] = {**u, "LDL": o.get("LDL", 0), "STL": o.get("STL", 0)}
    check({"count", "scatter", "segment", "hist", "pass<0>"} <= set(out),
          f"sort: kernels found {sorted(out)}")
    return out


def sass_projection():
    """The projection kernels as built, one entry per instantiation
    (`project_fwd_kernel<degree, aa, tight>`, `project_bwd_kernel<degree,
    aa>`): registers, stack and local memory (`cuobjdump -res-usage`) and
    the local loads and stores in their SASS. A spill is recorded, not
    refused."""
    ops, use = sass_counts("projection"), res_usage("projection")
    out = {}
    for f, u in use.items():
        m = re.search(r"project_(fwd|bwd)_kernelILi(\d)ELb([01])E(?:Lb([01])E)?", f)
        if not m:
            continue
        name = f"project_{m.group(1)}<{m.group(2)},{m.group(3)}" + (
            f",{m.group(4)}>" if m.group(4) else ">")
        o = ops.get(f, {})
        out[name] = {**u, "LDL": o.get("LDL", 0), "STL": o.get("STL", 0)}
    check(len(out) == 30, f"projection: {len(out)} kernel instantiations, want 20 + 10")
    return out


def sass_step_kernels():
    """The Adam and loss kernels as built: registers, stack, shared and
    local memory (`cuobjdump -res-usage`) and the local loads and stores
    in their SASS, per kernel function (the loss forward's two
    instantiations apart: `<false>` as training launches it, `<true>` with
    the ground truth's partials). A spill is recorded, not refused."""
    out = {}
    for source, parts in (("adam", (("adam_rows_kernel", 1),)),
                          ("loss", (("loss_fwd_kernel", 2), ("loss_bwd_kernel", 1)))):
        ops, use = sass_counts(source), res_usage(source)
        for part, n in parts:
            hits = sorted(f for f in use if part in f)
            check(len(hits) == n, f"{part}: {len(hits)} functions in lib{source}, want {n}")
            for f in hits:
                name = part if n == 1 else f"{part}<{'true' if 'ILb1E' in f else 'false'}>"
                o = ops.get(f, {})
                out[name] = {**use[f], "LDL": o.get("LDL", 0), "STL": o.get("STL", 0)}
    return out


# P1''s staging in SASS: the bulk copy (cp.async.bulk) and the mbarrier
# waits (try_wait.parity), by whole mnemonic prefix
SKEL_FWD_STAGING = {"bulk_copy": "UBLKCP", "mbarrier_wait": "SYNCS.PHASECHK"}


def phase_sass():
    """Instruction counts of the probe kernels: P1' stages with bulk copies
    and waits on their mbarriers and touches no local memory; P2' keeps its
    ten staging stores (volatile, so nothing may drop them) and its
    barriers; no P3'/P4' kernel spills, and each one's hot loop
    (`probes/floors.py`) holds at least one iteration's float instructions;
    its counts by pipe (`per_iteration`) give `phase_probe_ops` its floors.
    Then the blend kernels' build facts (`sass_blend`)."""
    from gsplat_tpu_torch.probes import floors

    skel, skel_full = sass_counts("probe_skeleton"), sass_counts("probe_skeleton", full=True)
    out = {}
    ops = one_function(skel, "skel_fwd_kernel", "skel_fwd")
    full = one_function(skel_full, "skel_fwd_kernel", "skel_fwd")
    staging = {what: sum(c for m, c in full.items() if m.startswith(prefix))
               for what, prefix in SKEL_FWD_STAGING.items()}
    check(all(staging.values()), f"skel_fwd: {staging}, want bulk copies and mbarrier waits")
    check(not ops.get("LDL") and not ops.get("STL"), "skel_fwd: local memory")
    out["skel_fwd"] = {**staging, **{k: ops.get(k, 0) for k in ("STS", "LDS", "LDG", "STG", "BRA")},
                       "mnemonics": {m: c for m, c in full.items()
                                     if m.startswith(("UBLKCP", "SYNCS"))}}
    ops = one_function(skel, "skel_bwd_kernel", "skel_bwd")
    check(ops.get("STS", 0) >= 10, f"skel_bwd: {ops.get('STS', 0)} shared stores, want the ten rows")
    check(ops.get("BAR", 0) >= 2, "skel_bwd: lost its barriers")
    out["skel_bwd"] = {k: ops.get(k, 0) for k in ("STS", "LDS", "LDG", "STG", "BAR", "BRA")}
    for name, got in floors.probe_loops(sass_text("probe_ops")).items():
        _, least, uniform = floors.SASS_PROBES[name]
        fn, loop_fp = got["function"], got["float_per_body"]
        check(not fn["LDL"] and not fn["STL"], f"{name}: spills to local memory")
        check(loop_fp >= least, f"{name}: {loop_fp} float instructions in its loop, want >= {least}")
        out[name] = {"float": sum(fn[k] for k in floors.FLOAT), "loop_float": loop_fp,
                     "least": least, "per_iteration": got["per_body"], "uniform": list(uniform),
                     "loop_opcodes": dict(got["loop"].most_common(20))}
    out.update(sass_blend())
    out.update(sass_k1_k4())
    out["sort_instances"] = sass_sort()
    out["projection"] = sass_projection()
    out["step_kernels"] = sass_step_kernels()
    return out


def k2_skeleton_library():
    """K2' with its pair loop compiled out (`scripts/skeleton_ablate.py`'s
    `k2_skeleton`), built beside the committed kernels."""
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.scripts import ablation, skeleton_ablate

    libs = ablation.build("rasterize_fwd", {"k2_skeleton": (skeleton_ablate.K2_VARIANTS["k2_skeleton"], [])},
                          _kernels.BUILD_DIR / "chip_smoke_k2_skeleton")
    return libs["k2_skeleton"][0]


def phase_probe_skeleton(device, render_instances, k3_args):
    """P1' on the render frame's K2' inputs and on the edge tables of
    `scripts/skeleton_ablate.py` (K % 4 != 0, ranges off 16 bytes, longer
    than its ring, to the table's end, a (10, K) table), P2' on the train
    frame's K3' inputs, bit for bit against their twins; then K2', P1', K2'
    with its pair loop compiled out, K3' and P2' in turns (each order, then
    its reverse) on those inputs. `skeleton_share` is P1' (K2''s bytes
    through bulk copies into an mbarrier ring) over K2', `k2_staging_share`
    K2''s own staging (the pair loop compiled out) over K2'."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops import binning as tb
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.probes import ablate as ab
    from gsplat_tpu_torch.scripts import ablation
    from gsplat_tpu_torch.scripts import skeleton_ablate as sa
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
    edges = []
    for rows, k in sa.EDGE_TABLES:
        eargs = (sa.edge_table(rows, k, device), *sa.edge_ranges(k, device))
        equal = bitwise_equal(ab.skel_fwd(*eargs), ab.skel_fwd_torch(*eargs))
        check(equal, f"P1' on the ({rows}, {k}) edge table: not bit for bit its twin")
        edges.append({"rows": rows, "k": k, "bitwise_equal": equal})
    gotb, wantb = ab.skel_bwd(*k3_args), ab.skel_bwd_torch(*k3_args)
    check(bitwise_equal(gotb, wantb), "P2' on the train frame: not bit for bit its twin")

    k2_skel = k2_skeleton_library()

    def k2_skeleton():
        with ablation.loaded("rasterize_fwd", k2_skel):
            return rc.blend_fwd(*fargs)

    calls = {"blend_fwd": lambda: rc.blend_fwd(*fargs), "skel_fwd": lambda: ab.skel_fwd(*fargs),
             "k2_skeleton": k2_skeleton, "blend_bwd": lambda: rc.blend_bwd(*k3_args),
             "skel_bwd": lambda: ab.skel_bwd(*k3_args)}
    turns = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
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
        "skel_fwd_edge_tables": edges, "skel_fwd_info": ab.skel_fwd_info(),
        "ms_in_turns": turns, "ms": ms,
        "skeleton_share": {"k2": ms["skel_fwd"] / ms["blend_fwd"],
                           "k3": ms["skel_bwd"] / ms["blend_bwd"]},
        "k2_staging_share": ms["k2_skeleton"] / ms["blend_fwd"],
        "math_ms": {"k2": ms["blend_fwd"] - ms["k2_skeleton"],
                    "k3": ms["blend_bwd"] - ms["skel_bwd"]},
    }
    rows = {"skel_fwd": measured(ms["skel_fwd"], p1_plain, p1_bound, 0.0, 0.0, bitwise_equal=True),
            "skel_bwd": measured(ms["skel_bwd"], p2_plain, p2_bound, 0.0, 0.0, bitwise_equal=True)}
    return summary, rows


def sm_clock(device):
    """The SM clock in Hz while one block spins (`gs_sm_clock`: clock64
    cycles over %globaltimer ns, about 10 ms), beside what `nvidia-smi`
    reads right after."""
    from gsplat_tpu_torch import _kernels

    lib = _kernels.load("probe_ops")
    out = torch.zeros(2, dtype=torch.int64, device=device)
    for _ in range(2):  # the first spin lets the clock rise
        _kernels.check(lib.gs_sm_clock(out.data_ptr(), 20_000_000, _kernels.stream(device)),
                       "gs_sm_clock")
    cycles, ns = (int(v) for v in out.tolist())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    return cycles / ns * 1e9, smi


def rcp_check(device):
    """`k_div`'s reciprocal against `1.0 / x` on every float32 in [1, 2),
    bit for bit; and `k_div` itself, through its entry point, on the
    probe's inputs (no rerun) and on inputs whose denominators leave
    [1, 2) (x times 1e4: it reruns with the IEEE division, `sink[0]` = 1),
    bit for bit its twin both times; the second also holds an infinite x,
    whose reciprocal's Newton step makes NaN where 1 / inf is 0, so only
    the rerun gives the twin's output."""
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.probes import op_rate

    x = torch.arange(0x3F800000, 0x40000000, dtype=torch.int32, device=device).view(torch.float32)
    bad = int((op_rate.rcp_1_2(x).view(torch.int32) != (1.0 / x).view(torch.int32)).sum())
    check(bad == 0, f"k_div's reciprocal differs from 1 / x on {bad} floats in [1, 2)")
    lib = _kernels.load("probe_ops")
    (base,) = op_rate.inputs("div", device)
    out = {"values": x.numel(), "mismatches": bad}
    for key, scale, rerun in (("div_in_range", 1.0, 0), ("div_fallback", 1e4, 1)):
        xs = base * scale
        if rerun:
            xs[5, 7] = float("inf")
        d = 1.5 + xs * 1e-3
        outside = int(((d < 1) | (d >= 2)).sum())
        got, sink = torch.empty_like(xs), torch.full((op_rate.SINK_WORDS,), 7, dtype=torch.int32,
                                                      device=device)
        _kernels.check(lib.gs_op_elementwise(3, xs.data_ptr(), got.data_ptr(), sink.data_ptr(),
                                             op_rate.N_IT, op_rate.DEP_ROW,
                                             _kernels.stream(device)), "k_div")
        twin = op_rate.TWINS["div"](xs)
        check((outside > 0) == bool(rerun) and int(sink[0]) == rerun and torch.equal(got, twin),
              f"k_div with {outside} denominators outside [1, 2): rerun {int(sink[0])}, max abs "
              f"err {float((got - twin).abs().max())}")
        out[key] = {"denominators_outside": outside, "reran": rerun, "bitwise_equal": True}
    return out


def phase_probe_ops(device, sass):
    """Every P3' variant and P4' at each dtype and shape against its twin on
    the card, timed; bounds on one SM; the floors of each kernel's pipes
    from its loop's SASS counts (`sass`, from `phase_sass`) at the SM clock
    measured here; `k_div`'s reciprocal on every float in [1, 2)."""
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.probes import bf16_rate, floors, op_rate

    clock_hz, smi_clocks = sm_clock(device)
    per_pass = floors.loop_shape(_kernels.load("probe_ops"))
    pipe_floors = {}

    def counted(row, kernel, bodies):
        """The row's counted keys (its kernel's loop counts); its floors,
        computed from them, go to the phase line (`floors`), not to the
        kernels line."""
        per = sass[kernel]["per_iteration"]
        pipe_floors[row] = {**floors.floors(per, bodies, clock_hz), "bodies": bodies}
        return {"sm_clock_mhz": clock_hz / 1e6, "loop_per_iteration": per}

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
        row = f"op_{name}"
        rows[row] = measured(ms, plain_ms, bnd, err, err / scale, label=v.label,
                             us_per_iteration=us[name], bound_basis="one SM",
                             bitwise_equal=bool(torch.equal(got, want)),
                             **counted(row, row, per_pass[row] * op_rate.N_IT))
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
            kernel = f"blend_mix_{key}"
            rows[row] = measured(ms, plain_ms, bnd, err, rel, bound_basis="one SM",
                                 max_ulps=ulps, bitwise_equal=bool(torch.equal(got, want)),
                                 ns_per_element_iteration=ms * 1e6 / (x.numel() * bf16_rate.K),
                                 **counted(row, kernel,
                                           x.numel() / per_pass[kernel] * bf16_rate.K))
    summary = {
        "sm_clock_mhz": clock_hz / 1e6,
        "nvidia_smi_clocks_sm_max_sm": smi_clocks,
        "reciprocal": rcp_check(device),
        "us_per_iteration": us,
        "per_op_cost_ns": us["vpu9"] / 9 * 1e3,
        "per_chunk_us": {k: us[f"kappa{k}"] / k for k in (1, 2, 4)},
        "p4_ms": mix_ms,
        "bf16_speedup_same_shape": mix_ms["blend_mix_f32"] / mix_ms["blend_mix_bf16"],
        "bf16_speedup_512": mix_ms["blend_mix_f32_512"] / mix_ms["blend_mix_bf16_512"],
        "floors": {k: {**f, "ms_over_limiter_floor": rows[k]["ms"] / f["limiter_floor_ms"]}
                   for k, f in pipe_floors.items()},
        "limiters": {k: (f["limiter"], rows[k]["ms"] / f["limiter_floor_ms"])
                     for k, f in pipe_floors.items()},
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


# the projection's kernels replace no Pallas kernel: the JAX package's
# `preprocess` is XLA fusions; so are its binning tables
PROJECTION_REPLACES = "gsplat_tpu/ops/projection.py:120 preprocess (XLA fusions; no Pallas kernel)"
TABLES_REPLACES = ("gsplat_tpu/ops/binning.py:171 compute_row_runs + :673-675 cumsum "
                   "(XLA fusions; no Pallas kernel)")

KERNEL_ROWS = (
    # (row, path whose count is `launches`, source, TPU kernel)
    ("project_fwd", "train", "gsplat_tpu_torch/csrc/projection.cu", PROJECTION_REPLACES),
    ("emission_tables", "train", "gsplat_tpu_torch/csrc/binning.cu", TABLES_REPLACES),
    ("project_bwd", "train", "gsplat_tpu_torch/csrc/projection.cu", PROJECTION_REPLACES),
    ("adam_rows", "train", "gsplat_tpu_torch/csrc/adam.cu", ADAM_REPLACES),
    ("loss_fwd", "train", "gsplat_tpu_torch/csrc/loss.cu", LOSS_REPLACES),
    ("loss_bwd", "train", "gsplat_tpu_torch/csrc/loss.cu", LOSS_REPLACES),
    ("composite_fwd", "train", "gsplat_tpu_torch/csrc/composite.cu", COMPOSITE_REPLACES),
    ("composite_bwd", "train", "gsplat_tpu_torch/csrc/composite.cu", COMPOSITE_REPLACES),
    ("expand_instances", "train", "gsplat_tpu_torch/csrc/binning.cu",
     "gsplat_tpu/ops/binning.py:485"),
    ("sort_instances", "train", "gsplat_tpu_torch/csrc/sort.cu", SORT_REPLACES),
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
PROFILED_ROWS = (("project_fwd", "render", "project_fwd_kernel"),
                 ("emission_tables", "render", "emission_tables_kernel"),
                 ("project_bwd", "train", "project_bwd_kernel"),
                 ("expand_instances", "render", "expand_instances_kernel"),
                 ("sort_instances", "render", "sort_instances_"),
                 ("pack_instances", "render", "pack_instances_kernel"),
                 ("blend_fwd", "render", "blend_fwd_kernel"),
                 ("pack_instances_hybrid", "train", "pack_instances_kernel"),
                 ("blend_bwd", "train", "blend_bwd_kernel"),
                 ("reduce_by_gid", "train", "reduce_by_gid_kernel"),
                 ("oit_fwd", "oit_render", "oit_fwd_kernel"),
                 ("oit_bwd", "oit_train", "oit_bwd_kernel"),
                 ("adam_rows", "train", "adam_rows_kernel"),
                 ("loss_fwd", "train", "loss_fwd_kernel"),
                 ("loss_bwd", "train", "loss_bwd_kernel"),
                 ("composite_fwd", "render", "composite_fwd_kernel"),
                 ("composite_bwd", "train", "composite_bwd_kernel"))


def attach_profiled(measures, profiles):
    """Each path kernel's device time from its path's profile beside its
    timed loop (`ms`, CUDA events around back-to-back wrapper calls, which
    a slow host can stretch); neither may be under the bound. Bt', St'' and
    K1''s expand also get their train-frame time, K1' expand + pack per
    path."""
    for row, path, func in PROFILED_ROWS:
        ms = profiles[path][func]
        check(ms >= measures[row]["bound_ms"], f"{row}: {ms} ms in the {path} profile, under "
              f"its bound {measures[row]['bound_ms']}")
        measures[row]["profiled_ms"] = ms
    measures["emission_tables"]["train_frame"]["profiled_ms"] = profiles["train"][
        "emission_tables_kernel"]
    measures["sort_instances"]["train_frame"]["profiled_ms"] = profiles["train"]["sort_instances_"]
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
        # the contract's keys last: no measured field may take their place
        rows.append({**measures[name], "name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": by_path[path],
                     "launches_by_path": by_path})
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
    t = time.perf_counter()
    projection = phase_projection(device)
    emit(phase="projection", **projection, seconds=time.perf_counter() - t)

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
        wide_summary = phase_wide_render(device)
        emit(phase="wide_render_path", **wide_summary, seconds=time.perf_counter() - t)
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
    step_sass = sass["step_kernels"]
    adam = measures["adam_rows"]
    adam["sass"] = step_sass["adam_rows_kernel"]
    emit(phase="adam", cases=adam["cases"], ms=adam["ms"], plain_ms=adam["plain_ms"],
         bound_ms=adam["bound_ms"], rows=adam["rows"], alive=adam["alive"],
         grad_strides=adam["grad_strides"], sass=adam["sass"])
    measures["loss_fwd"]["sass"] = {k: v for k, v in step_sass.items()
                                    if k.startswith("loss_fwd_kernel")}
    measures["loss_bwd"]["sass"] = step_sass["loss_bwd_kernel"]
    facts = measures.pop("loss_facts")
    emit(phase="loss", cases=measures["loss_fwd"]["cases"],
         **{f"{k}_{f}": measures[k][f] for k in ("loss_fwd", "loss_bwd")
            for f in ("ms", "plain_ms", "bound_ms", "replaced_route_ms")},
         **{f"{k}_{f}": facts[f][k] for k in ("loss_fwd", "loss_bwd")
            for f in ("fp32_issue_floor_ms", "occupancy")},
         sass={k: measures[k]["sass"] for k in ("loss_fwd", "loss_bwd")})
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
    measures["emission_tables"]["train_frame"] = measures.pop("emission_tables_train_frame")
    measures["emission_tables"]["sass"] = sass["emission_tables"]
    measures["sort_instances"].update(train_frame=measures.pop("sort_instances_train_frame"),
                                      sass=sass["sort_instances"])
    exp_train = measures.pop("expand_instances_train_frame")
    measures["expand_instances"].update(
        train_frame=exp_train, sass=sass["expand_instances"],
        k1_total_ms={"render": measures["expand_instances"]["ms"]
                     + measures["pack_instances"]["ms"],
                     "train": exp_train["ms"] + measures["pack_instances_hybrid"]["ms"]})
    measures["pack_instances"]["sass"] = sass["pack_instances"]
    # the projection: the forward's row on the render frame, its train
    # frame beside it; the backward's on the train frame
    fwd = projection["render_frame_fwd"]
    measures["project_fwd"] = measured(
        fwd["ms"], fwd["plain_ms"], fwd["bound"], 0.0, 0.0,
        train_frame=measures.pop("project_fwd_train_frame"),
        sass={k: v for k, v in sass["projection"].items() if k.startswith("project_fwd<3,")})
    measures["project_bwd"]["sass"] = {k: v for k, v in sass["projection"].items()
                                       if k.startswith("project_bwd<3,")}
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
    t = time.perf_counter()
    exposure_step = phase_exposure_step(device)
    emit(phase="exposure_depth_step", **{k: v for k, v in exposure_step.items()
                                         if k != "composite_bwd_with_exposure_grad"},
         seconds=time.perf_counter() - t)
    # the composite kernels: Cf' on the render frames, Cb' on the train
    # frames and on the exposure step's
    cf, cb = measures["composite_fwd"], measures["composite_bwd"]
    cf["oit_frame"] = measures.pop("composite_fwd_oit_frame")
    cb["oit_train_frame"] = measures.pop("composite_bwd_oit_train_frame")
    cb["exposure_step"] = exposure_step["composite_bwd_with_exposure_grad"]
    emit(phase="composite", composite_fwd=cf, composite_bwd=cb,
         frame_stage_device_ms={p: summary["stages"]["composite"]["device_ms"]
                                for p, summary in (("render", render_summary),
                                                   ("oit_render", oit_render_summary),
                                                   ("train", train_summary),
                                                   ("oit_train", oit_train_summary))},
         step_backward_stage_device_ms={p: summary["stages"]["backward/composite"]["device_ms"]
                                        for p, summary in (("train", train_summary),
                                                           ("oit_train", oit_train_summary))},
         kernels_per_frame={"render": render_summary["kernels_per_frame"],
                            "oit_render": oit_render_summary["device_profile"][
                                "kernels_per_frame"]},
         kernels_per_step={"train": train_summary["kernels_per_step"],
                           "oit_train": oit_train_summary["kernels_per_step"],
                           "exposure_depth": exposure_step["kernels_per_step"]})
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
    ops_summary, ops_rows = phase_probe_ops(device, sass)
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
                                   "wide_render": wide_summary["launches"],
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
                                   "train_cli_mesh_resumed": cli_mesh_summary["launches"],
                                   "exposure_depth_step": exposure_step["launches"]})
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

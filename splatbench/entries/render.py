"""Driver of the mixes whose `"entry"` is `render`: `render` under
`torch.no_grad()` on the poses of an orbit (`width` x `height`, `poses`,
`elevation`, `background`), back to back, one client, closed loop. Each
frame is timed from its call until it is on the card and synchronised
(CUDA events: the card's clock).

Set-up renders `warmup_frames`; the window counts frames. The check
compares `sample_frames` frames of the first orbit, drawn from the seed,
with the reference's, once the window has closed and the program's state
is freed; a sampled frame the window did not reach is rendered after it,
untimed.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from splatbench import drive as common
from splatbench import program, scene, trace
from splatbench.reference import render as ref_render


def drive(run: common.Run):
    cfg, mix, dev = run.config, run.mix, run.device
    w, h, poses = mix["width"], mix["height"], mix["poses"]
    cams = scene.cameras(scene.orbit_directions(poses, mix["elevation"]), w, h, cfg["fov_x"],
                         cfg["camera_distance"], dev)
    pcams = [program.camera(c) for c in cams]
    params = scene.make_params(cfg, run.seed, dev)
    alive = torch.ones(params["xyz"].shape[0], dtype=torch.bool, device=dev)
    gparams = program.params(params)
    settings = program.settings(cfg["sh_degree"], run.settings)
    bg = torch.tensor(mix["background"], dtype=torch.float32, device=dev)
    sample = sorted(random.Random(scene.sub_seed(run.seed, 4)).sample(range(poses),
                                                                      mix["sample_frames"]))

    def frame(j):
        with torch.no_grad():
            return program.render(pcams[j % poses], gparams, alive, settings, bg, device=dev)

    for j in range(mix["warmup_frames"]):
        frame(j)
    run.setup_done()

    kept, lat = {}, []
    if run.on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    frames, ends = 0, []
    while True:
        if run.on_card:
            start.record()
            out = frame(frames)
            end.record()
            end.synchronize()
            lat.append(start.elapsed_time(end))
        else:
            out = frame(frames)
        if frames in sample:
            kept[frames] = out["render"]
        frames += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= run.seconds:
            break
    window = time.perf_counter() - t0
    run.close_window()
    run.mark("window")
    run.attempted = frames
    run.e2e["render_fps"] = frames / window
    if lat:
        run.e2e["frame_p95_ms"] = statistics.quantiles(lat, n=100, method="inclusive")[94]
        run.frame_samples = len(lat)

    # a sampled frame the window did not reach is waited for, not timed
    late = frames
    while late <= sample[-1]:
        out = frame(late)
        if late in sample:
            kept[late] = out["render"]
        late += 1
    del out

    traced = []
    if run.traced:
        def profiled(i):
            traced.append(frames + i)
            frame(frames + i)
            run.sync()

        tr = trace.Trace(trace.profile(profiled, mix["trace_frames"]))
    del gparams, params
    common.free()
    run.mark("release")

    ref_render.full_precision()
    p0 = scene.make_params(cfg, run.seed, dev)
    if run.traced:
        counts = common.sum_counts(
            ref_render.render(p0, cams[j % poses], bg, count=True)["counts"] for j in traced)
        run.layer_ctx = {"trace": tr, "calls": len(traced), "counts": counts, "config": cfg,
                         "call_s": window / frames}
        run.mark("trace")
    rel, worst = 0.0, 0.0
    for j in sample:
        want = ref_render.render(p0, cams[j % poses], bg)["render"]
        diff = (kept[j] - want).double()
        rel = max(rel, float(diff.square().mean().sqrt() / want.double().square().mean().sqrt()))
        worst = max(worst, float(diff.abs().max()))
    run.readings = {"image_rel_rms": rel, "image_max_abs": worst}
    run.mark("reference")
    run.detail = {"sample": sample, "host_ms_per_frame_by_third": common.thirds(t0, ends)}

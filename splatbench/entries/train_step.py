"""Driver of the mixes whose `"entry"` is `train_step`: the step of
`make_train_step`, one call per iteration, closed loop.

Views are the configuration's training views taken at random without
replacement (the stack refilled when empty, as `train/loop.py` takes
them); ground truth is made on the device and kept there as float32; the
position learning rate follows the loop's schedule from
`first_iteration`. The mix states the step's other inputs: `targets`, each
of `alpha_mask`, `inverse_depth` and `depth_mask` a number (a constant
plane) or `[low, high]` (uniform from the seed), `depth_weight`,
`use_exposure`, `lambda_dssim`, `optimizer_type`, the learning rates.

Set-up drives the `compared_steps` the check reads through the window's
own call, then `warmup_steps` more. The window counts steps and stops at
the first step that returns after `--seconds`, then waits for the card.
The reference follows the compared steps from the inputs made again.
"""

from __future__ import annotations

import statistics
import time

import torch

from splatbench import drive as common
from splatbench import program, scene, trace
from splatbench.reference import render as ref_render
from splatbench.reference import train as ref_train


def identity_exposure(views, device):
    """Per-view identity (3, 4) affines, as the program's state starts."""
    eye = torch.zeros((views, 3, 4), device=device)
    eye[:, :3, :3] = torch.eye(3, device=device)
    return eye


def drive(run: common.Run):
    cfg, mix, dev = run.config, run.mix, run.device
    views, w, h = cfg["train_views"], cfg["train_width"], cfg["train_height"]
    cams = scene.cameras(scene.sphere_directions(views), w, h, cfg["fov_x"],
                         cfg["camera_distance"], dev)
    pcams = [program.camera(c) for c in cams]
    gt = scene.ground_truth(views, w, h, run.seed, dev)
    targets = scene.targets(mix["targets"], w, h, run.seed, dev)
    params = scene.make_params(cfg, run.seed, dev)
    n = params["xyz"].shape[0]
    bg = torch.tensor(mix["background"], dtype=torch.float32, device=dev)
    ext = scene.extent(cams)
    lr = common.exp_schedule(mix["position_lr_init"] * ext, mix["position_lr_final"] * ext,
                             mix["position_lr_max_steps"])
    exp_lr = common.exp_schedule(mix["exposure_lr_init"], mix["exposure_lr_final"],
                                 mix["iterations"])
    exposed = mix["use_exposure"]
    order = common.ViewOrder(views, run.seed)
    opt = program.optimization(lambda_dssim=mix["lambda_dssim"],
                               optimizer_type=mix["optimizer_type"])
    step = program.make_train_step(opt, program.settings(cfg["sh_degree"], run.settings),
                                   use_exposure=exposed)
    state = program.init_train_state(params, torch.ones(n, dtype=torch.bool, device=dev),
                                     num_images=views, seed=scene.sub_seed(run.seed, 3))
    del params
    it = [mix["first_iteration"]]

    def one():
        nonlocal state
        v = order.next()
        state, metrics = step(state, pcams[v], gt[v], targets["alpha_mask"],
                              targets["inverse_depth"], targets["depth_mask"], bg, lr(it[0]),
                              exp_lr(it[0]), mix["depth_weight"], v)
        it[0] += 1
        return v, metrics

    # the compared steps: the check's readings of the program
    compared, losses = [], []
    for i in range(mix["compared_steps"]):
        v, metrics = one()
        compared.append((v, lr(it[0] - 1), exp_lr(it[0] - 1)))
        losses.append(metrics["loss"])
        if i == 0:  # the first gradient, from Adam's first moment: m = (1 - b1) g
            moments = dict(state.adam_m, **({"exposure": state.exp_m} if exposed else {}))
            grad_norms = ref_train.norms(
                {k: m / (1.0 - ref_train.ADAM_B1) for k, m in moments.items()})
            del moments
    p0 = scene.make_params(cfg, run.seed, dev)
    if exposed:
        p0["exposure"] = identity_exposure(views, dev)
    after = dict(state.params, **({"exposure": state.exposure} if exposed else {}))
    change = ref_train.norms({k: after[k] - p0[k] for k in p0})
    del p0, after
    off_count = int((state.adam_counts != mix["compared_steps"]).sum())
    losses = [float(x) for x in losses]
    for _ in range(mix["warmup_steps"]):
        one()
    run.setup_done()

    t0 = time.perf_counter()
    steps, ends = 0, []
    while True:
        one()
        steps += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= run.seconds:
            break
    run.sync()
    window = time.perf_counter() - t0
    run.close_window()
    run.mark("window")
    run.attempted = steps
    run.e2e["train_step_ms"] = window * 1e3 / steps

    traced = []
    if run.traced:
        at = state.params  # the parameters the profiled steps start from
        tr = trace.Trace(trace.profile(lambda i: traced.append(one()[0]), mix["trace_steps"]))
    del state, step, gt
    common.free()
    run.mark("release")
    if run.traced:
        counts = common.sum_counts(
            ref_render.render(at, cams[v], bg, count=True)["counts"] for v in traced)
        run.layer_ctx = {"trace": tr, "calls": len(traced), "counts": counts, "config": cfg,
                         "call_s": window / steps}
        del at
        common.free()
        run.mark("trace")

    # the reference follows the compared steps from the inputs made again
    ref_render.full_precision()
    gt = scene.ground_truth(views, w, h, run.seed, dev)
    targets = scene.targets(mix["targets"], w, h, run.seed, dev)
    p0 = scene.make_params(cfg, run.seed, dev)
    e0 = identity_exposure(views, dev) if exposed else None
    steps_in = [(cams[v], gt[v], bg, x, e, v) for v, x, e in compared]
    ref_losses, ref_grads, p_ref = ref_train.run_steps(p0, steps_in, mix["lambda_dssim"],
                                                       targets, mix["depth_weight"], e0)
    if exposed:
        p0["exposure"] = e0
    ref_change = ref_train.norms({k: p_ref[k] - p0[k] for k in p0})
    # leaves whose gradient is nought to rounding move by round-off alone
    median = statistics.median(ref_grads.values())
    still = [k for k, g in ref_grads.items() if g < 1e-3 * median]
    run.readings = {
        "loss_gap": max(common.gap(a, b, abs(b)) for a, b in zip(losses, ref_losses)),
        "grad_gap": common.leaf_gaps(grad_norms, ref_grads),
        "change_gap": common.leaf_gaps(change, ref_change, still),
        "count_gap": off_count,
    }
    run.mark("reference")
    run.detail = {"losses": losses, "ref_losses": ref_losses, "grad_norms": grad_norms,
                  "ref_grad_norms": ref_grads, "change": change, "ref_change": ref_change,
                  "still_leaves": still, "views": [v for v, _, _ in compared],
                  "host_ms_per_step_by_third": common.thirds(t0, ends)}

"""Host-side training driver on one device (the `train.py:43-190` analogue).

Counterpart of `gsplat_tpu/train/loop.py`. The device work is the train
step (`train/step.py`); this loop supplies what stays on the host: camera
sampling without replacement from `random.Random(seed)`, the xyz, exposure
and depth-weight schedules, the SH-degree ramp, the densify and
opacity-reset cadence, the gaussian-capacity controller with its resize
(`capacity.py`, `train/resize.py`), the per-view pixel cache, snapshot
saving and the progress log.

Not in this slice, each refused or skipped with a message: `--mesh`
(multi-device), checkpoints (`checkpoint_iterations`, `start_checkpoint`,
`checkpoint_every`), tensorboard and the `testing_iterations` evaluation
sweeps. The instance buffer is sized per frame, so there is no
instance-capacity controller to port.
"""

from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch

from gsplat_tpu_torch.capacity import CapacityController
from gsplat_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gsplat_tpu_torch.core.types import make_render_settings
from gsplat_tpu_torch.data.scene import Scene
from gsplat_tpu_torch.device import resolve_device
from gsplat_tpu_torch.model import init_from_pcd
from gsplat_tpu_torch.train.resize import resize_train_state
from gsplat_tpu_torch.train.step import (
    init_train_state,
    make_densify_step,
    make_train_step,
    opacity_reset_step,
)
from gsplat_tpu_torch.utils.general import expon_lr_func


def _refuse_unported(pipe, checkpoint_iterations, start_checkpoint, checkpoint_every):
    if pipe.mesh:
        raise NotImplementedError(
            "--mesh: multi-device training is not ported yet (the multi-device slice)")
    if checkpoint_iterations or start_checkpoint or checkpoint_every:
        raise NotImplementedError(
            "checkpoints are not ported yet (the checkpoint-and-eval slice); "
            "snapshots at saving_iterations are")


# Device-memory budget of the pixel cache. A lego/garden-class scene fits
# entirely (the reference keeps every camera on the GPU up front,
# `scene/cameras.py:57`); a city-scale multi-thousand-view scene would not,
# so beyond the budget the cache evicts the least recently used views and
# pays the upload again on a revisit (`gsplat_tpu/train/loop.py:39-92`).
PIXEL_CACHE_BYTES = 6 << 30


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class PixelCache:
    """Each view's pixel data on the device, uploaded once, LRU-evicted
    beyond `budget` bytes.

    Views are keyed by `(id(cam.image), cam.uid)`, as in the JAX loop: `uid`
    is a per-split index (`data/scene.py`), so the train and test views share
    uids and the key must also tell their images apart. Depthless views of
    one shape share one zeros tensor, which is never evicted.
    """

    def __init__(self, device, budget: int = PIXEL_CACHE_BYTES):
        self.device = device
        self.budget = budget
        self.entries = {}  # insertion order is recency order

    def nbytes(self) -> int:
        return sum(_nbytes(v) for v in self.entries.values() if isinstance(v, tuple))

    def get(self, cam):
        """(gt, alpha mask, inverse depth, depth mask) of `cam` on the device."""
        key = (id(cam.image), cam.uid)
        if key in self.entries:
            val = self.entries.pop(key)  # reinsert: most recently used
            self.entries[key] = val
            return val
        h, w = cam.image.shape[:2]
        dev = self.device
        gt = torch.as_tensor(cam.image, device=dev)
        mask = torch.as_tensor(cam.alpha_mask, device=dev)
        if cam.invdepth is not None:
            invd = torch.as_tensor(cam.invdepth, device=dev)
            dmask = torch.as_tensor(cam.depth_mask[..., 0], device=dev)
        else:
            zkey = ("z", h, w)
            if zkey not in self.entries:
                self.entries[zkey] = torch.zeros((h, w), dtype=torch.float32, device=dev)
            invd = dmask = self.entries[zkey]
        entry = (gt, mask, invd, dmask)
        # evict down to the budget with the incoming entry counted, so the
        # cache never overshoots by one view (a single view over the budget
        # is still cached once everything else is gone: it is in use)
        new_bytes = _nbytes(entry)
        while self.nbytes() + new_bytes > self.budget:
            oldest = next((k for k, v in self.entries.items() if isinstance(v, tuple)), None)
            if oldest is None:
                break
            self.entries.pop(oldest)
        self.entries[key] = entry
        return entry


def train(
    model_cfg: ModelConfig,
    opt: OptimizationConfig,
    pipe: PipelineConfig,
    testing_iterations=(7000, 30000),
    saving_iterations=(7000, 30000),
    checkpoint_iterations=(),
    start_checkpoint: str | None = None,
    quiet: bool = False,
    log_every: int = 10,
    on_iteration=None,
    checkpoint_every: int = 0,
    seed: int = 0,
    device=None,
):
    """Run the optimisation on `device` (`None` means `cuda`); returns
    (state, scene, results dict)."""
    _refuse_unported(pipe, checkpoint_iterations, start_checkpoint, checkpoint_every)
    dev = resolve_device(device)
    scene = Scene(
        model_cfg.source_path,
        model_path=model_cfg.model_path or None,
        images=model_cfg.images,
        depths=model_cfg.depths,
        resolution=model_cfg.resolution,
        white_background=model_cfg.white_background,
        eval=model_cfg.eval,
        train_test_exp=model_cfg.train_test_exp,
        device=dev,
    )
    train_cams = scene.get_train_cameras()
    params, alive = init_from_pcd(
        scene.info.points, scene.info.colors, max_sh_degree=model_cfg.sh_degree,
        capacity=pipe.capacity or None, device=dev,
    )
    state = init_train_state(params, alive, num_images=len(train_cams), seed=seed)
    if not quiet:
        print(f"[init] {int(alive.sum())} gaussians in {state.capacity} rows on {dev}")

    extent = float(scene.cameras_extent)
    xyz_sched = expon_lr_func(
        opt.position_lr_init * extent, opt.position_lr_final * extent,
        lr_delay_mult=opt.position_lr_delay_mult, max_steps=opt.position_lr_max_steps,
    )
    exp_sched = expon_lr_func(
        opt.exposure_lr_init, opt.exposure_lr_final,
        lr_delay_steps=opt.exposure_lr_delay_steps,
        lr_delay_mult=opt.exposure_lr_delay_mult, max_steps=opt.iterations,
    )
    depth_sched = expon_lr_func(
        opt.depth_l1_weight_init, opt.depth_l1_weight_final, max_steps=opt.iterations
    )

    bg_color = torch.full((3,), 1.0 if model_cfg.white_background else 0.0, device=dev)
    use_exposure = model_cfg.train_test_exp

    step_cache = {}

    def step_fn(active_sh):
        if active_sh not in step_cache:
            settings = make_render_settings(
                sh_degree=active_sh, antialiasing=pipe.antialiasing,
                blend_mode=pipe.blend_mode, packet_dtype=pipe.packet_dtype,
            )
            step_cache[active_sh] = make_train_step(opt, settings, use_exposure=use_exposure)
        return step_cache[active_sh]

    densify_step = make_densify_step(opt)
    if scene.model_path and not quiet:
        print("tensorboard logging is not ported yet (the checkpoint-and-eval slice): "
              "progress logs only", file=sys.stderr)

    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    # gaussian-axis controller, as the JAX loop sets it: observed once per
    # densify round, so a 10-observation window spans ~1000 iterations;
    # pipe.capacity > 0 pins the capacity (no controller)
    gauss_ctl = (
        CapacityController(
            state.capacity, window=10, event_window=3, floor=4096,
            grow_frac=0.75, grow_margin=1.5, shrink_margin=1.6,
        )
        if not pipe.capacity
        else None
    )
    pixels = PixelCache(dev)
    viewpoint_stack = []
    ema_loss = ema_depth = 0.0
    results = {"test": {}, "loss": {}}
    eval_warned = False
    active_sh = 0
    metrics = None
    t0 = time.time()

    for iteration in range(1, opt.iterations + 1):
        # SH degree ramp every 1000 iterations (`train.py:93-95`)
        if iteration % 1000 == 0 and active_sh < model_cfg.sh_degree:
            active_sh += 1

        if not viewpoint_stack:
            viewpoint_stack = list(range(len(train_cams)))
        cam = train_cams[viewpoint_stack.pop(rng.randrange(len(viewpoint_stack)))]

        gt, mask, invd, dmask = pixels.get(cam)
        bg = (torch.as_tensor(np_rng.random(3), dtype=torch.float32, device=dev)
              if opt.random_background else bg_color)
        depth_w = depth_sched(iteration) if cam.depth_reliable else 0.0

        state, metrics = step_fn(active_sh)(
            state, cam.camera, gt, mask, invd, dmask, bg,
            xyz_sched(iteration), exp_sched(iteration), depth_w, cam.uid,
        )

        if iteration in testing_iterations and not eval_warned:
            print(f"[ITER {iteration}] test evaluation is not ported yet (the "
                  "checkpoint-and-eval slice): skipped", file=sys.stderr)
            eval_warned = True

        # densification cadence (`train.py:163-174`)
        if iteration < opt.densify_until_iter:
            if iteration > opt.densify_from_iter and iteration % opt.densification_interval == 0:
                size_threshold = 20 if iteration > opt.opacity_reset_interval else 0
                state, dinfo = densify_step(state, extent, size_threshold)
                n_alive = dinfo["n_alive"]
                if gauss_ctl is not None:
                    if dinfo["n_pruned"] * 3 >= n_alive:
                        # mass prune (opacity-reset aftermath): re-evaluate
                        # the capacity on a short window
                        gauss_ctl.notify_structural_change()
                    new_gcap = gauss_ctl.update(n_alive, dinfo["n_dropped"])
                    if new_gcap is not None:
                        state = resize_train_state(state, new_gcap)
                        print(f"[auto] it {iteration}: alive {n_alive} — "
                              f"gaussian capacity -> {new_gcap}")
                if not quiet and iteration % 1000 == 0:
                    print(
                        f"[densify {iteration}] alive={dinfo['n_alive']} "
                        f"clone={dinfo['n_cloned']} split={dinfo['n_split']} "
                        f"prune={dinfo['n_pruned']} dropped={dinfo['n_dropped']}"
                    )
            if iteration % opt.opacity_reset_interval == 0 or (
                model_cfg.white_background and iteration == opt.densify_from_iter
            ):
                state = opacity_reset_step(state)

        # sync to the host only on log iterations
        if iteration % max(log_every, 1) == 0:
            loss = float(metrics["loss"])
            results["loss"][iteration] = loss
            ema_loss = 0.4 * loss + 0.6 * ema_loss
            ema_depth = 0.4 * float(metrics["depth_l1"]) + 0.6 * ema_depth
            if not quiet:
                print(
                    f"it {iteration:6d}  loss {ema_loss:.5f}  depth {ema_depth:.5f}  "
                    f"alive {int(state.alive.sum())}  vis {int(metrics['n_visible'])}  "
                    f"({(time.time() - t0):.1f}s)",
                    flush=True,
                )

        if iteration in saving_iterations and scene.model_path:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            scene.save(iteration, state.params, state.alive, state.exposure,
                       [c.image_name for c in train_cams])
        if on_iteration is not None:
            on_iteration(iteration, state, metrics)

    results["wall_s"] = time.time() - t0
    return state, scene, results

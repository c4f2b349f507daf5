"""Host-side training driver on one device (the `train.py:43-190` analogue).

Counterpart of `gsplat_tpu/train/loop.py`. The device work is the train
step (`train/step.py`); this loop supplies what stays on the host: camera
sampling without replacement from `random.Random(seed)`, the xyz, exposure
and depth-weight schedules, the SH-degree ramp, the densify and
opacity-reset cadence, the gaussian-capacity controller with its resize
(`capacity.py`, `train/resize.py`), the per-view pixel cache, the
`testing_iterations` evaluation sweeps, tensorboard, snapshot saving,
checkpoints (`chkpnt<it>.pkl`, the rolling `rolling_chkpnt.pkl` written on
a worker thread, and resume from either package's checkpoint) and the
progress log.

`--mesh GxT` trains over a (gauss=G, tile=T) mesh of ranks
(`gsplat_tpu/train/loop.py:296-360`), one process per rank as `torchrun`
starts them: rank and world size come from its environment, each rank
runs on `cuda:LOCAL_RANK` under NCCL or shares the card under gloo, and
every rank picks the same cameras from `seed`. The state is split by rows
(`parallel/sharding.py`) and each step runs the band pipeline
(`parallel/pipeline.py`). A densify round (and a resize) gathers the
state, runs the single-device `densify_and_prune` with the same generator
on every rank and places it again; rank 0 writes the checkpoints and
snapshots from the gathered state, in the single-device format, and runs
the evaluation, tensorboard and the logs while the others wait at a
barrier. `blend_mode="oit"` is refused under `--mesh`. The instance buffer
is sized per frame, so there is no instance-capacity controller to port.
"""

from __future__ import annotations

import os
import pickle
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from gsplat_tpu_torch.capacity import CapacityController
from gsplat_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gsplat_tpu_torch.convert import (
    train_state_from_jax_checkpoint,
    train_state_to_numpy,
    train_state_tree,
    tree_to_numpy,
)
from gsplat_tpu_torch.core.types import make_render_settings
from gsplat_tpu_torch.data.scene import Scene
from gsplat_tpu_torch.device import resolve_device
from gsplat_tpu_torch.model import init_from_pcd
from gsplat_tpu_torch.parallel import comm, sharding
from gsplat_tpu_torch.parallel.pipeline import make_pipeline_train_step
from gsplat_tpu_torch.render import render
from gsplat_tpu_torch.train import losses
from gsplat_tpu_torch.train.resize import resize_train_state
from gsplat_tpu_torch.train.step import (
    init_train_state,
    make_densify_step,
    make_train_step,
    opacity_reset_step,
)
from gsplat_tpu_torch.utils.general import expon_lr_func


def write_checkpoint(path: str, host_state: dict, iteration: int):
    """Pickle {"state": host_state, "iteration": iteration} to `path`
    atomically (a temporary name, then `os.replace`), so a crash mid-write
    never corrupts the file a supervisor would resume from."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"state": host_state, "iteration": int(iteration)}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def save_checkpoint(path: str, state, iteration: int):
    """The state as a plain dict of numpy arrays (`convert.train_state_to_numpy`:
    no class references, the generator's state included), written now."""
    write_checkpoint(path, train_state_to_numpy(state), iteration)


def load_checkpoint(path: str, device=None):
    """(state, iteration) from a checkpoint of either package on `device`
    (`None` means `cuda`)."""
    return train_state_from_jax_checkpoint(path, resolve_device(device))


class CheckpointWriter:
    """Rolling checkpoints on one worker thread, at most one write in flight
    (a second submit waits for the first: skipping ahead beats a queue).

    A submit keeps references to the state's tensors until the write ends
    and copies the generator's state at once; the worker copies the tensors
    to the host and pickles them. That is race-free because the train, densify, resize and
    opacity-reset steps never write a tensor in place: each returns fresh
    ones. On the card the worker copies on a side stream that first waits
    for the work queued before the submit, so the train kernels queued after
    it need not wait for the copy.
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._pending = None
        self._stream = None

    def submit(self, path: str, state, iteration: int):
        self.flush()
        tree = train_state_tree(state)
        ready = None
        dev = state.alive.device
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        self._pending = self._pool.submit(self._write, path, tree, iteration, dev, ready)

    def _write(self, path, tree, iteration, dev, ready):
        if ready is None:
            host = tree_to_numpy(tree)
        else:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=dev)
            self._stream.wait_event(ready)
            with torch.cuda.stream(self._stream):
                host = tree_to_numpy(tree)  # a copy to pageable memory: synchronous
        write_checkpoint(path, host, iteration)

    def flush(self):
        """Wait for the write in flight, raising its exception if it failed."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self):
        self._pool.shutdown(wait=True)


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
        self.eval_gt = {}  # ground truth of views only evaluated

    def nbytes(self) -> int:
        return sum(_nbytes(v) for v in self.entries.values() if isinstance(v, tuple))

    def gt(self, cam):
        """`cam`'s ground truth on the device for an evaluation: the cached
        train entry's when there is one (uploaded once either way)."""
        key = (id(cam.image), cam.uid)
        if key in self.entries:
            return self.entries[key][0]
        if key not in self.eval_gt:
            self.eval_gt[key] = torch.as_tensor(cam.image, device=self.device)
        return self.eval_gt[key]

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


def evaluate_test(state, cameras, settings, bg, pixels: PixelCache):
    """Mean L1 and PSNR of the clipped renders of `cameras` against their
    ground truth (`train.py:214-252` training_report), or None without
    cameras. `pixels` supplies each view's ground truth on the device; the
    per-view values stay there until one copy to the host at the end."""
    if not cameras:
        return None
    params = SimpleNamespace(**state.params)
    l1s, psnrs = [], []
    with torch.no_grad():
        for cam in cameras:
            gt = pixels.gt(cam)
            img = torch.clamp(render(cam.camera, params, state.alive, settings, bg,
                                     device=state.alive.device)["render"], 0.0, 1.0)
            l1s.append(losses.l1_loss(img, gt))
            psnrs.append(losses.psnr(img, gt))
        vals = torch.stack([torch.stack(l1s), torch.stack(psnrs)]).cpu().numpy()
    return {"l1": float(np.mean(vals[0])), "psnr": float(np.mean(vals[1]))}


def _report(results, tb, iteration, state, settings, bg, pixels, test_cams, train_cams):
    """The `testing_iterations` sweep: the held-out views, then the train
    views 5, 10, ..., 25 modulo their count (`train.py:220`), into
    `results["test"]` and `results["train"]` and tensorboard."""
    sel = [train_cams[i % len(train_cams)] for i in range(5, 30, 5)]
    for split, cams in (("test", test_cams), ("train", sel)):
        ev = evaluate_test(state, cams, settings, bg, pixels)
        if ev is None:
            continue
        results.setdefault(split, {})[iteration] = ev
        print(f"\n[ITER {iteration}] {split}: L1 {ev['l1']:.5f} PSNR {ev['psnr']:.2f}\n")
        if tb is not None:
            tb.add_scalar(f"{split}/loss_viewpoint - l1_loss", ev["l1"], iteration)
            tb.add_scalar(f"{split}/loss_viewpoint - psnr", ev["psnr"], iteration)
    if tb is not None:
        # scene/opacity_histogram (`train.py:248-250`); total_points goes out
        # on every log iteration
        op = torch.sigmoid(state.params["opacity"][state.alive, 0])
        tb.add_histogram("scene/opacity_histogram", op.cpu().numpy(), iteration)


def _summary_writer(model_path):
    if not model_path:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print("tensorboard unavailable — progress logs only", file=sys.stderr)
        return None
    return SummaryWriter(model_path)


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
    dist_backend: str | None = None,
):
    """Run the optimisation on `device` (`None` means `cuda`); returns
    (state, scene, results dict), the state whole on every rank of a mesh.

    `start_checkpoint` resumes from a checkpoint of either package at its
    iteration + 1, with the SH degree the ramp would have reached; the camera
    order restarts from `seed`, as in the JAX loop. Under `pipe.mesh`,
    `dist_backend` names the collectives' backend (default NCCL on `cuda`,
    gloo on the CPU; ranks sharing one card need gloo).
    """
    mesh = _join_mesh(pipe, device, dist_backend) if pipe.mesh else None
    dev = mesh.device if mesh is not None else resolve_device(device)
    main = mesh is None or mesh.rank == 0
    quiet = quiet or not main
    model_path = model_cfg.model_path or None

    def load_scene():
        return Scene(
            model_cfg.source_path,
            model_path=model_path if main else None,
            images=model_cfg.images,
            depths=model_cfg.depths,
            resolution=model_cfg.resolution,
            white_background=model_cfg.white_background,
            eval=model_cfg.eval,
            train_test_exp=model_cfg.train_test_exp,
            device=dev,
        )

    scene = load_scene() if main else None
    if mesh is not None:
        dist.barrier()  # rank 0 first: a Blender scene's random init is written once
        scene = scene or load_scene()
    train_cams = scene.get_train_cameras()
    first_iter = 0
    if start_checkpoint:
        state, first_iter = load_checkpoint(start_checkpoint, dev)
        if main:
            print(f"Resumed from {start_checkpoint} at iteration {first_iter}")
    else:
        params, alive = init_from_pcd(
            scene.info.points, scene.info.colors, max_sh_degree=model_cfg.sh_degree,
            capacity=pipe.capacity or None, device=dev,
        )
        state = init_train_state(params, alive, num_images=len(train_cams), seed=seed)
    if mesh is not None:
        state = resize_train_state(state, sharding.mesh_capacity(state.capacity, mesh))
    if not quiet:
        print(f"[init] {int(state.alive.sum())} gaussians in {state.capacity} rows on {dev}"
              + (f", mesh {pipe.mesh} over {dist.get_world_size()} ranks ({mesh.backend})"
                 if mesh is not None else ""))
    capacity = state.capacity
    if mesh is not None:
        state = sharding.place_train_state(mesh, state)

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

    def settings_for(active_sh):
        return make_render_settings(
            sh_degree=active_sh, antialiasing=pipe.antialiasing,
            blend_mode=pipe.blend_mode, packet_dtype=pipe.packet_dtype,
        )

    step_cache = {}

    def step_fn(active_sh, camera):
        key = (active_sh, camera.width, camera.height)
        if key not in step_cache:
            if mesh is None:
                step_cache[key] = make_train_step(opt, settings_for(active_sh),
                                                  use_exposure=use_exposure)
            else:
                # the band exchange where there are bands (`exchange_capacity`
                # 0 asks for the full gather), as the JAX loop sets it
                step_cache[key] = make_pipeline_train_step(
                    mesh, opt, settings_for(active_sh), camera.width, camera.height,
                    use_exposure=use_exposure,
                    exchange_capacity=pipe.exchange_capacity if mesh.sizes["tile"] > 1 else 0)
        return step_cache[key]

    def whole(state):
        """The whole state: gathered from every rank on a mesh."""
        return state if mesh is None else sharding.gather_train_state(mesh, state)

    densify_step = make_densify_step(opt)
    tb = _summary_writer(scene.model_path)  # None on ranks other than 0

    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    # gaussian-axis controller, as the JAX loop sets it: observed once per
    # densify round, so a 10-observation window spans ~1000 iterations;
    # pipe.capacity > 0 pins the capacity (no controller). Built after a
    # resume, at the checkpoint's capacity.
    gauss_ctl = (
        CapacityController(
            capacity, window=10, event_window=3, floor=4096,
            grow_frac=0.75, grow_margin=1.5, shrink_margin=1.6,
        )
        if not pipe.capacity
        else None
    )
    pixels = PixelCache(dev)
    ckpt_writer = CheckpointWriter()
    viewpoint_stack = []
    ema_loss = ema_depth = 0.0
    results = {"test": {}, "loss": {}}
    # SH degree ramps once per 1000 iterations; on resume, catch up to where
    # the ramp would be (the reference restores active_sh_degree from the
    # checkpoint tuple, `gaussian_model.py:76,89`)
    active_sh = min(first_iter // 1000, model_cfg.sh_degree)
    metrics = None
    t0 = t_iter = time.time()
    try:
        for iteration in range(first_iter + 1, opt.iterations + 1):
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

            state, metrics = step_fn(active_sh, cam.camera)(
                state, cam.camera, gt, mask, invd, dmask, bg,
                xyz_sched(iteration), exp_sched(iteration), depth_w, cam.uid,
            )

            # evaluate before the densify/reset block, as the reference's
            # training_report (`train.py:158` precedes `:163-174`): after an
            # opacity reset the render would be transparent
            if iteration in testing_iterations:
                full = whole(state)
                if main:
                    _report(results, tb, iteration, full, settings_for(active_sh), bg_color,
                            pixels, scene.get_test_cameras(), train_cams)
                if mesh is not None:
                    dist.barrier()

            # densification cadence (`train.py:163-174`)
            if iteration < opt.densify_until_iter:
                if (iteration > opt.densify_from_iter
                        and iteration % opt.densification_interval == 0):
                    size_threshold = 20 if iteration > opt.opacity_reset_interval else 0
                    # on a mesh every rank densifies the gathered state with
                    # the same generator, so the ranks stay in step
                    state, dinfo = densify_step(whole(state), extent, size_threshold)
                    n_alive = dinfo["n_alive"]
                    if gauss_ctl is not None:
                        if dinfo["n_pruned"] * 3 >= n_alive:
                            # mass prune (opacity-reset aftermath):
                            # re-evaluate the capacity on a short window
                            gauss_ctl.notify_structural_change()
                        new_gcap = gauss_ctl.update(n_alive, dinfo["n_dropped"])
                        if new_gcap is not None:
                            if mesh is not None:
                                new_gcap = sharding.mesh_capacity(new_gcap, mesh)
                            state = resize_train_state(state, new_gcap)
                            if main:
                                print(f"[auto] it {iteration}: alive {n_alive} — "
                                      f"gaussian capacity -> {new_gcap}")
                    if mesh is not None:
                        state = sharding.place_train_state(mesh, state)
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
                n_alive = state.alive.sum()
                if mesh is not None:
                    n_alive = comm.all_reduce_sum(n_alive, mesh, sharding.gauss_axes_of(mesh))
                n_alive = int(n_alive)
                if tb is not None:
                    tb.add_scalar("train_loss_patches/l1_loss", float(metrics["l1"]), iteration)
                    tb.add_scalar("train_loss_patches/total_loss", loss, iteration)
                    tb.add_scalar("iter_time", (time.time() - t_iter) * 1000.0, iteration)
                    tb.add_scalar("total_points", n_alive, iteration)
                if not quiet:
                    print(
                        f"it {iteration:6d}  loss {ema_loss:.5f}  depth {ema_depth:.5f}  "
                        f"alive {n_alive}  vis {int(metrics['n_visible'])}  "
                        f"({(time.time() - t0):.1f}s)",
                        flush=True,
                    )
            t_iter = time.time()

            save = model_path and iteration in saving_iterations
            ckpt = model_path and iteration in checkpoint_iterations
            rolling = model_path and checkpoint_every and iteration % checkpoint_every == 0
            full = whole(state) if save or ckpt or rolling else state
            if save and main:
                print(f"\n[ITER {iteration}] Saving Gaussians")
                scene.save(iteration, full.params, full.alive, full.exposure,
                           [c.image_name for c in train_cams])
            if ckpt and main:
                print(f"\n[ITER {iteration}] Saving Checkpoint")
                save_checkpoint(os.path.join(model_path, f"chkpnt{iteration}.pkl"),
                                full, iteration)
            if rolling and main:
                # rolling checkpoint for stall or crash recovery, overwritten
                # in place (`cli/train_supervised.py` resumes from it)
                ckpt_writer.submit(os.path.join(model_path, "rolling_chkpnt.pkl"),
                                   full, iteration)
            if on_iteration is not None:
                on_iteration(iteration, state, metrics)
        ckpt_writer.flush()
    finally:
        ckpt_writer.close()
        if tb is not None:
            tb.close()

    results["wall_s"] = time.time() - t0
    return whole(state), scene, results


def _join_mesh(pipe: PipelineConfig, device, backend):
    """This rank's mesh for `--mesh GxT`, joining the job's process group
    from `torchrun`'s environment unless the caller already has."""
    if pipe.blend_mode != "sorted":
        raise ValueError(f"--blend_mode {pipe.blend_mode}: the multi-device path blends sorted, "
                         "as the JAX pipeline does; OIT is refused under --mesh")
    g, t = sharding.parse_mesh(pipe.mesh)
    backend = backend or comm.default_backend(resolve_device(device))
    comm.init_distributed(backend)
    return sharding.make_mesh(g, t, backend=backend, device=device)

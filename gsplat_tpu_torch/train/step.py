"""The training step and its state.

Counterpart of `gsplat_tpu/train/step.py`. One call of the train step is
the reference's per-iteration device work (`train.py:91-186`): render,
alpha mask, L1 + SSIM (+ weighted depth-L1), backward (kernels K3' and K4'
on the card), densification stats, the exposure Adam step and the
parameter Adam step (dense or sparse). The host loop around it
(`train/loop.py`) samples cameras, runs the LR schedules and calls the
densify and opacity-reset steps on its cadence.

`TrainState` holds tensors: parameters and Adam moments as dicts {field:
(capacity, ...)} in the JAX package's layout, so rows line up one for one.
The steps are functional: they return a new state and leave the old one as
it is. The JAX PRNG key becomes a `torch.Generator` on the state's device.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from gsplat_tpu_torch.config import OptimizationConfig
from gsplat_tpu_torch.core.types import RenderSettings
from gsplat_tpu_torch.model import init_exposure
from gsplat_tpu_torch.render import render
from gsplat_tpu_torch.train import losses
from gsplat_tpu_torch.train.densify import (
    accumulate_stats,
    densify_and_prune,
    reset_opacity,
    zero_stats,
)
from gsplat_tpu_torch.train.optim import adam_update, adam_update_dense, make_lr_tree


@dataclasses.dataclass
class TrainState:
    params: dict  # {field: (C, ...) float32}
    alive: torch.Tensor  # (C,) bool
    adam_m: dict
    adam_v: dict
    adam_counts: torch.Tensor  # (C,) int32 per-row step counts
    exposure: torch.Tensor  # (M, 3, 4)
    exp_m: torch.Tensor
    exp_v: torch.Tensor
    exp_step: torch.Tensor  # () int32
    stats: dict  # grad_accum / denom / max_radii2d
    rng: torch.Generator  # split-children draws
    step: int  # global iteration

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]


def make_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return gen


def init_train_state(params: dict, alive, num_images: int, seed: int = 0) -> TrainState:
    dev = alive.device
    exposure = init_exposure(num_images, device=dev)
    return TrainState(
        params=dict(params),
        alive=alive,
        adam_m={k: torch.zeros_like(v) for k, v in params.items()},
        adam_v={k: torch.zeros_like(v) for k, v in params.items()},
        adam_counts=torch.zeros(alive.shape, dtype=torch.int32, device=dev),
        exposure=exposure,
        exp_m=torch.zeros_like(exposure),
        exp_v=torch.zeros_like(exposure),
        exp_step=torch.zeros((), dtype=torch.int32, device=dev),
        stats=zero_stats(alive.shape[0], dev),
        rng=make_generator(seed, dev),
        step=0,
    )


def make_train_step(opt: OptimizationConfig, settings: RenderSettings,
                    use_exposure: bool = False):
    """Build the train step for a given config.

    The returned function:
      step(state, camera, gt_image, alpha_mask, invdepth_gt, depth_mask, bg,
           xyz_lr, exposure_lr, depth_weight, exposure_index)
        -> (new_state, metrics dict)

    `invdepth_gt` and `depth_mask` are always passed (zeros when absent),
    with `depth_weight` 0 gating them. It runs on the device of `state`.
    Metrics are tensors (no host sync) except `num_instances`.
    """
    sparse = opt.optimizer_type == "sparse_adam"

    def train_step(state: TrainState, camera, gt_image, alpha_mask, invdepth_gt, depth_mask,
                   bg, xyz_lr, exposure_lr, depth_weight, exposure_index):
        dev = state.alive.device
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        exposure = state.exposure.detach().requires_grad_(use_exposure)
        mean2d_offset = torch.zeros((state.capacity, 2), device=dev, requires_grad=True)

        out = render(
            camera, SimpleNamespace(**leaves), state.alive, settings, bg,
            mean2d_offset=mean2d_offset,
            exposure=exposure[exposure_index] if use_exposure else None,
            device=dev,
        )
        image = out["render"] * alpha_mask
        loss, ll1 = losses.photometric_loss(image, gt_image, opt.lambda_dssim)
        dl1 = losses.depth_l1_loss(out["invdepth"], invdepth_gt, depth_mask)
        loss = loss + depth_weight * dl1

        wrt = [*leaves.values(), mean2d_offset] + ([exposure] if use_exposure else [])
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)]
        param_grads = dict(zip(leaves, grads))
        screen_grads = grads[len(leaves)]

        with torch.no_grad():
            # densification stats: the reference accumulates ||dL/d mean2D||
            # in its NDC-ish scaling = pixel grad * (0.5 W, 0.5 H)
            # (`backward.cu:626-627`, `gaussian_model.py:471-473`)
            scale_vec = torch.tensor([0.5 * camera.width, 0.5 * camera.height],
                                     dtype=torch.float32, device=dev)
            grad_norm = torch.linalg.vector_norm(screen_grads * scale_vec, dim=-1)
            visibility = out["visibility"]
            stats = accumulate_stats(state.stats, grad_norm, visibility, out["radii"])

            lr_tree = make_lr_tree(xyz_lr, opt.feature_lr, opt.opacity_lr, opt.scaling_lr,
                                   opt.rotation_lr)
            new_params, new_m, new_v, new_counts = adam_update(
                state.params, param_grads, state.adam_m, state.adam_v, state.adam_counts,
                lr_tree, visibility=visibility if sparse else None,
            )
            # dead rows must not drift (their grads are zero; keep it airtight)
            new_params = {
                k: torch.where(state.alive.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                               state.params[k])
                for k, v in new_params.items()
            }
            if use_exposure:
                new_exp, exp_m, exp_v, exp_step = adam_update_dense(
                    state.exposure, grads[-1], state.exp_m, state.exp_v, state.exp_step,
                    exposure_lr,
                )
            else:
                new_exp, exp_m, exp_v, exp_step = (
                    state.exposure, state.exp_m, state.exp_v, state.exp_step)

        new_state = dataclasses.replace(
            state, params=new_params, adam_m=new_m, adam_v=new_v, adam_counts=new_counts,
            exposure=new_exp, exp_m=exp_m, exp_v=exp_v, exp_step=exp_step, stats=stats,
            step=state.step + 1,
        )
        metrics = {
            "loss": loss.detach(),
            "l1": ll1.detach(),
            "depth_l1": dl1.detach(),
            "num_instances": out["num_instances"],
            "instance_overflow": out["instance_overflow"],
            "tile_overflow": out["tile_overflow"],
            "n_visible": visibility.sum(),
        }
        return new_state, metrics

    return train_step


def make_densify_step(opt: OptimizationConfig):
    """Densify/prune on the TrainState (the host decides when to call it);
    split children draw their normals from `state.rng`."""

    def densify_step(state: TrainState, extent, max_screen_size, normals=None):
        params, alive, m, v, counts, stats, info = densify_and_prune(
            state.params, state.alive, state.adam_m, state.adam_v, state.adam_counts,
            state.stats, opt.densify_grad_threshold, 0.005, extent, max_screen_size,
            opt.percent_dense, generator=state.rng, normals=normals,
        )
        return dataclasses.replace(
            state, params=params, alive=alive, adam_m=m, adam_v=v, adam_counts=counts,
            stats=stats,
        ), info

    return densify_step


def opacity_reset_step(state: TrainState) -> TrainState:
    params, m, v = reset_opacity(state.params, state.alive, state.adam_m, state.adam_v)
    return dataclasses.replace(state, params=params, adam_m=m, adam_v=v)

"""Configuration dataclasses + CLI reflection (the `arguments/` analogue).

The reference exposes three reflection-based ParamGroups whose *defaults are
load-bearing* (`arguments/__init__.py:47-100`); the same fields and defaults
live here as frozen dataclasses. `add_to_parser`/`extract` reproduce the
reflection behavior (every field becomes a flag; `shorthand` fields also get a
one-letter alias), and `save_cfg_args`/`load_cfg_args` reproduce the
`cfg_args` persistence + CLI re-merge (`arguments/__init__.py:102-122`,
`train.py:203-204`).

Copy of `gsplat_tpu/config.py` (numpy- and argparse-only), so `cfg_args`
files and flags carry over unchanged. The TPU-only pipeline fields are
accepted by the port and have no effect there.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from argparse import ArgumentParser, Namespace
from dataclasses import dataclass, field


_SHORTHANDS = {
    "source_path": "s",
    "model_path": "m",
    "images": "i",
    "depths": "d",
    "resolution": "r",
    "white_background": "w",
}


@dataclass(frozen=True)
class ModelConfig:
    """Reference ModelParams (`arguments/__init__.py:47-66`)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    depths: str = ""
    resolution: int = -1
    white_background: bool = False
    train_test_exp: bool = False
    eval: bool = False


@dataclass(frozen=True)
class PipelineConfig:
    """Reference PipelineParams (`arguments/__init__.py:68-74`) + TPU knobs."""

    antialiasing: bool = False
    debug: bool = False
    backend: str = "pallas"  # "jnp" | "pallas"
    # "sorted" (reference parity) | "oit" (opt-in order-independent
    # transmittance fast mode — see RenderSettings.blend_mode)
    blend_mode: str = "sorted"
    # 0 -> auto: probe the scene at startup and grow on demand (the TPU
    # analogue of the reference's dynamic buffer resize,
    # `rasterize_points.cu:27-33`). A positive value fixes the capacity.
    instance_capacity: int = 0
    max_per_tile: int = 4096
    capacity: int = 0  # 0 -> auto from init point count
    # "GxT" (e.g. "4x2") trains SPMD over a (gauss=G, tile=T) device mesh
    # (`parallel/sharding.py`); "" = single device. G*T must equal the
    # visible device count.
    mesh: str = ""
    # Band-bucketed screen-packet exchange for --mesh runs
    # (parallel/pipeline.py): each gaussian shard compacts its packets to
    # the destination tile band BEFORE the all_gather, cutting both ICI
    # bytes and every post-gather binning stage to the band's working set.
    # -1 -> auto (probe the scene, default ON); 0 -> full gather;
    # >0 -> fixed per-shard row capacity. Undersizing surfaces as the
    # band_overflow metric and auto-grows like the instance buffer.
    exchange_capacity: int = -1
    # Instance-packet mode for the Pallas binning sort + blend:
    # "hybrid" (default: positions AND inverse depth stay exact f32 —
    # invz is recomputed from the sorted depth-bits key, never bf16-routed
    # — while conic/opacity/color and the backward reduce's gradient rows
    # ride the sorts bf16-pair-packed — certified at lego-30k 35.11 PSNR /
    # 0.9806 SSIM vs the f32 runs' 35.10-35.47 / 0.9801, artifacts/cert_r4;
    # cert scope is 800px NeRF-synthetic — use "float32" for strict parity
    # on untested regimes; ~15% faster garden step) |
    # "float32" (strict parity) | "bfloat16" (everything bf16 — measured
    # to LOSE ~4.4 dB of trained quality at 800px scale; forward/serving
    # only)
    packet_dtype: str = "hybrid"


@dataclass(frozen=True)
class OptimizationConfig:
    """Reference OptimizationParams (`arguments/__init__.py:76-100`)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.025
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    exposure_lr_init: float = 0.01
    exposure_lr_final: float = 0.001
    exposure_lr_delay_steps: int = 0
    exposure_lr_delay_mult: float = 0.0
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    depth_l1_weight_init: float = 1.0
    depth_l1_weight_final: float = 0.01
    random_background: bool = False
    optimizer_type: str = "default"  # "default" | "sparse_adam"


def add_to_parser(parser: ArgumentParser, cfg, group_name: str, fill_none: bool = False):
    """Reflect dataclass fields into argparse flags (`arguments/__init__.py:19-38`)."""
    group = parser.add_argument_group(group_name)
    for f in dataclasses.fields(cfg):
        default = None if fill_none else getattr(cfg, f.name)
        names = [f"--{f.name}"]
        if f.name in _SHORTHANDS:
            names.append(f"-{_SHORTHANDS[f.name]}")
        if f.type in ("bool", bool):
            group.add_argument(*names, default=default, action="store_true")
        else:
            ftype = type(getattr(cfg, f.name))
            group.add_argument(*names, default=default, type=ftype)
    return group


def extract(cls, args: Namespace):
    """Pull this group's fields out of parsed args (`arguments/__init__.py:40-45`)."""
    kw = {}
    for f in dataclasses.fields(cls):
        if hasattr(args, f.name) and getattr(args, f.name) is not None:
            kw[f.name] = getattr(args, f.name)
    cfg = cls(**kw)
    if hasattr(cfg, "source_path") and cfg.source_path:
        cfg = dataclasses.replace(cfg, source_path=os.path.abspath(cfg.source_path))
    return cfg


def save_cfg_args(model_path: str, model_cfg: ModelConfig) -> None:
    """Persist the model config like `train.py:203-204` (Namespace repr)."""
    os.makedirs(model_path, exist_ok=True)
    ns = Namespace(**dataclasses.asdict(model_cfg))
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(ns))


def load_cfg_args(parser: ArgumentParser, argv=None) -> Namespace:
    """Merge CLI args over a stored cfg_args (`arguments/__init__.py:102-122`)."""
    cmdline = parser.parse_args(argv)
    cfg_path = os.path.join(cmdline.model_path, "cfg_args")
    merged = {}
    try:
        with open(cfg_path) as f:
            print(f"Looking for config file in {cfg_path}")
            cfg_ns = eval(f.read())  # Namespace(...) repr, like the reference
            merged = vars(cfg_ns).copy()
    except (FileNotFoundError, TypeError):
        print("Config file not found at", cfg_path, file=sys.stderr)
    for k, v in vars(cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)

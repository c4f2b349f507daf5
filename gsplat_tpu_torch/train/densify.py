"""Densification (clone / split / prune) as static-capacity masked updates.

Counterpart of `gsplat_tpu/train/densify.py`, keeping its design: a fixed
`capacity` of rows and an `alive` mask instead of the reference's tensor
rebuilds (`scene/gaussian_model.py:316-469`), so rows line up one for one
with the JAX package's:

- prune  -> clear alive bits (dead rows are sanitized to inert values);
- clone  -> copy a row into a free slot;
- split  -> two children sampled into free slots, the parent dies.

Masks (`densify.py:17-26`): clone where grad >= thr and max(scale) <=
percent_dense * extent, split where grad >= thr and max(scale) above it,
prune where opacity < min_opacity or, with `max_screen_size`, the world
extent exceeds 0.1 * extent (the reference's screen-size prune is dead code
upstream, `densify.py:116-123`). Free slots are assigned in rank order
(clone copies and first split children, then second split children).

Split children are drawn from N(0, diag(scale)) rotated into the world.
The normal draws come from a `torch.Generator`, or are given as `normals`
(2, C, 3) so a test can feed both packages the same numbers (`jax.random`
and torch give different draws from one seed).
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.core import activations as act

DEAD_PARAMS = dict(scaling=-15.0, opacity=-15.0)
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def _rows(mask, leaf):
    return mask.reshape(mask.shape[:1] + (1,) * (leaf.dim() - 1))


def sanitize_dead_rows(params: dict, alive) -> dict:
    """Force dead rows to inert values (tiny scale, ~0 opacity, identity
    quaternion) so leaked rows cannot affect renders or produce NaNs."""
    dead = ~alive[:, None]
    ident = params["rotation"].new_tensor([1.0, 0.0, 0.0, 0.0])
    return {
        **params,
        "scaling": torch.where(dead, params["scaling"].new_tensor(DEAD_PARAMS["scaling"]),
                               params["scaling"]),
        "opacity": torch.where(dead, params["opacity"].new_tensor(DEAD_PARAMS["opacity"]),
                               params["opacity"]),
        "rotation": torch.where(dead, ident, params["rotation"]),
    }


def accumulate_stats(stats, screen_grad_norm, visibility, radii):
    """Per-iteration bookkeeping (`train.py:166-167`, `gaussian_model.py:471-473`):
    grad_accum (N,), denom (N,) and max_radii2d (N,) int32."""
    vis = visibility
    return {
        "grad_accum": stats["grad_accum"] + torch.where(vis, screen_grad_norm,
                                                        torch.zeros_like(screen_grad_norm)),
        "denom": stats["denom"] + vis.to(torch.float32),
        "max_radii2d": torch.where(vis, torch.maximum(stats["max_radii2d"], radii),
                                   stats["max_radii2d"]),
    }


def zero_stats(capacity: int, device=None):
    return {
        "grad_accum": torch.zeros((capacity,), dtype=torch.float32, device=device),
        "denom": torch.zeros((capacity,), dtype=torch.float32, device=device),
        "max_radii2d": torch.zeros((capacity,), dtype=torch.int32, device=device),
    }


def densify_and_prune(
    params: dict,
    alive,
    adam_m: dict,
    adam_v: dict,
    adam_counts,
    stats: dict,
    grad_threshold: float,
    min_opacity: float,
    extent,
    max_screen_size,  # 0 disables the size prune (reference passes None)
    percent_dense: float = 0.01,
    generator: torch.Generator | None = None,
    normals=None,
):
    """One densification round. Returns (params, alive, m, v, counts, stats, info).

    `normals`: optional (2, C, 3) standard normal draws for the two split
    children; drawn from `generator` when not given.
    """
    c = alive.shape[0]
    dev = alive.device
    extent = torch.as_tensor(extent, dtype=torch.float32, device=dev)
    grads = stats["grad_accum"] / torch.clamp(stats["denom"], min=1.0)
    grads = torch.where(stats["denom"] > 0, grads, torch.zeros_like(grads))

    scales = act.scaling_activation(params["scaling"])
    max_scale = scales.amax(dim=-1)
    opacity = act.opacity_activation(params["opacity"])[:, 0]

    prune = opacity < min_opacity
    if max_screen_size:
        prune = prune | (max_scale > 0.1 * extent)
    prune = prune & alive

    hot = alive & ~prune & (grads >= grad_threshold)
    clone_mask = hot & (max_scale <= percent_dense * extent)
    split_mask = hot & (max_scale > percent_dense * extent)
    keep = alive & ~prune & ~split_mask

    # channel 0 = clone copy or split child A; channel 1 = split child B
    flat_active = torch.stack([clone_mask | split_mask, split_mask]).reshape(-1)  # (2C,)
    free = ~keep
    free_slots = torch.nonzero(free).flatten()  # slot for each free rank, ascending
    req = torch.nonzero(flat_active).flatten()  # requesting children, in rank order
    n_place = min(req.numel(), free_slots.numel())
    placed_req = req[:n_place]
    target = free_slots[:n_place]
    dropped = req.numel() - n_place

    if normals is None:
        normals = torch.randn((2, c, 3), generator=generator, device=dev)
    normals = torch.as_tensor(normals, dtype=torch.float32, device=dev)
    R = act.quat_to_rotmat(params["rotation"])  # (C, 3, 3)
    split_scaling = act.scaling_inverse_activation(scales / (0.8 * 2.0))

    def split_xyz(draw):
        return params["xyz"] + torch.einsum("nij,nj->ni", R, draw * scales)

    is_split = split_mask[:, None]
    child_a = {**params,
               "xyz": torch.where(is_split, split_xyz(normals[0]), params["xyz"]),
               "scaling": torch.where(is_split, split_scaling, params["scaling"])}
    child_b = {**params, "xyz": split_xyz(normals[1]), "scaling": split_scaling}

    new_params = {}
    for k in FIELDS:
        src = torch.cat([child_a[k], child_b[k]], dim=0)  # (2C, ...)
        leaf = params[k].clone()
        leaf[target] = src[placed_req]
        new_params[k] = leaf
    new_alive = keep.clone()
    new_alive[target] = True

    # fresh Adam state for new rows; dead rows zeroed so nothing stale
    # survives slot reuse (`cat_tensors_to_optimizer`)
    def fresh(tree):
        out = {}
        for k, leaf in tree.items():
            leaf = leaf.clone()
            leaf[target] = 0.0
            out[k] = torch.where(_rows(new_alive, leaf), leaf, torch.zeros_like(leaf))
        return out

    new_m, new_v = fresh(adam_m), fresh(adam_v)
    new_counts = adam_counts.clone()
    new_counts[target] = 0
    new_params = sanitize_dead_rows(new_params, new_alive)

    info = {
        "n_cloned": int(clone_mask.sum()),
        "n_split": int(split_mask.sum()),
        "n_pruned": int(prune.sum()),
        "n_dropped": int(dropped),  # children lost to capacity exhaustion
        "n_alive": int(new_alive.sum()),
    }
    return new_params, new_alive, new_m, new_v, new_counts, zero_stats(c, dev), info


def reset_opacity(params: dict, alive, adam_m: dict, adam_v: dict):
    """Clamp opacity to <= 0.01 and reset its Adam moments
    (`gaussian_model.py:258-261` + replace_tensor_to_optimizer)."""
    new_op = act.inverse_sigmoid(
        torch.clamp(act.opacity_activation(params["opacity"]), max=0.01)
    )
    new_op = torch.where(alive[:, None], new_op, new_op.new_tensor(DEAD_PARAMS["opacity"]))
    return (
        {**params, "opacity": new_op},
        {**adam_m, "opacity": torch.zeros_like(adam_m["opacity"])},
        {**adam_v, "opacity": torch.zeros_like(adam_v["opacity"])},
    )

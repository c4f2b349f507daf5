"""Gaussian-axis capacity resize of the training state.

Counterpart of `gsplat_tpu/train/resize.py`. The reference reallocates its
parameter and optimizer tensors every densify round
(`scene/gaussian_model.py:316-386`, cat/index_select); the port keeps the
JAX package's design, a fixed number of rows with an `alive` mask
(`train/densify.py`), so that its rows line up one for one with the JAX
package's. The loop's capacity controller (`capacity.py`) calls this on a
rare host-level resize to a new capacity on the quantized ladder:

- GROW: pad every per-gaussian tensor with dead rows.
- SHRINK: move the alive rows to the front (stable, so their relative
  order is kept; no other state keys on row ids), then truncate. Adam
  moments, per-row step counts and densification stats travel with their
  rows.

The generator and the exposure state are per state, not per row, and are
kept as they are.
"""

from __future__ import annotations

import dataclasses

import torch

from gsplat_tpu_torch.train.densify import sanitize_dead_rows

PER_GAUSSIAN = ("params", "alive", "adam_m", "adam_v", "adam_counts", "stats")


def _map(fn, tree):
    return {k: fn(v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def resize_train_state(state, new_capacity: int):
    """`state` with every per-gaussian tensor resized to `new_capacity` rows.

    Shrinking compacts the alive rows first and refuses to drop one (the
    controller's shrink margin makes room; a silent drop would corrupt
    training).
    """
    c = state.capacity
    new_capacity = int(new_capacity)
    if new_capacity == c:
        return state
    if new_capacity > c:
        def resize(leaf):
            pad = leaf.new_zeros((new_capacity - c,) + tuple(leaf.shape[1:]))
            return torch.cat([leaf, pad])
    else:
        n_alive = int(state.alive.sum())
        if n_alive > new_capacity:
            raise ValueError(f"cannot shrink capacity to {new_capacity}: {n_alive} rows alive")
        # alive-first stable permutation: sorting the dead mask keeps the
        # relative order of the alive rows (and of the dead ones)
        perm = torch.argsort((~state.alive).to(torch.uint8), stable=True)[:new_capacity]

        def resize(leaf):
            return leaf[perm]
    tree = {name: _map(resize, getattr(state, name)) for name in PER_GAUSSIAN}
    tree["params"] = sanitize_dead_rows(tree["params"], tree["alive"])
    return dataclasses.replace(state, **tree)

"""What every traffic mix's driver shares: the run (`Run`), the view order,
the learning-rate schedule and the gaps the check compares.

A mix (`traffic/<mix>.json`) is data: its `"entry"` names the driver,
`entries/<entry>.py`, which `spec.Cell.entry` finds by that name, and
every other key is a parameter the driver reads. A mix that only changes parameters adds a
data file; one that drives the program in a new way adds a driver file
beside the others. Neither edits a file that is there.

A driver's `drive(run)` makes the inputs from `run.seed`, runs the steps
or frames the check compares, warms up, calls `run.setup_done()`, drives
the program closed-loop for `run.seconds`, calls `run.close_window()`,
fills `run.e2e`, `run.attempted` and `run.layer_ctx` (with `--trace 1`),
frees the program's state and has the reference (`reference/`) fill
`run.readings` from inputs made again from the seed.
"""

from __future__ import annotations

import gc
import math
import random
import statistics
import sys
import time

import torch

from splatbench import scene

FORBIDDEN = ("jax", "jaxlib", "flax", "gsplat_tpu")


class Run:
    """One run of a cell: its inputs, options and what it measured."""

    def __init__(self, cell, seed, seconds, traced, device, started, settings=None):
        self.cell, self.seed, self.seconds, self.traced = cell, int(seed), seconds, traced
        self.device, self.started = device, started
        self.config, self.mix = cell.config, cell.traffic
        # the render settings: the configuration's, the mix's over them, then
        # the caller's (the control's lower precision)
        self.settings = {**self.config["settings"], **self.mix.get("settings", {}),
                         **(settings or {})}
        self.e2e, self.layer_ctx, self.readings = {}, None, {}
        self.attempted, self.failed = 0, 0
        self.detail, self.memory_peak_bytes, self.frame_samples = {}, None, 0
        self.timing, self._mark = {}, started
        self.on_card = torch.device(device).type == "cuda"

    def mark(self, phase):
        """Seconds since the last mark, under `phase` (to stderr's detail)."""
        now = time.perf_counter()
        self.timing[phase] = now - self._mark
        self._mark = now

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize()

    def setup_done(self):
        self.sync()
        self.e2e["setup_s"] = time.perf_counter() - self.started
        self.mark("setup")

    def close_window(self):
        """After the window: the peak, and no JAX in the process."""
        self.sync()
        if self.on_card:
            peak = torch.cuda.max_memory_allocated()
            self.e2e["peak_mem_gib"] = peak / 2**30
            self.memory_peak_bytes = peak
        found = loaded_forbidden()
        if found:
            raise SystemExit(f"modules of the JAX package or JAX loaded: {found}")


def loaded_forbidden():
    """JAX or the JAX package among the loaded modules, by whole top-level
    name (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def exp_schedule(init, final, max_steps):
    """`expon_lr_func` without delay: the log-linear decay of the loop."""

    def lr(step):
        t = min(max(step / max_steps, 0.0), 1.0)
        return math.exp(math.log(init) * (1 - t) + math.log(final) * t)

    return lr


class ViewOrder:
    """Views at random without replacement, the stack refilled when empty."""

    def __init__(self, views, seed):
        self.views, self.rng, self.stack = views, random.Random(scene.sub_seed(seed, 2)), []

    def next(self):
        if not self.stack:
            self.stack = list(range(self.views))
        return self.stack.pop(self.rng.randrange(len(self.stack)))


def gap(a, b, scale):
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)


def leaf_gaps(prog, ref, skip=()):
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of the reference's norm of that leaf and of the
    median leaf."""
    median = statistics.median(ref.values())
    return max(gap(prog[k], ref[k], max(ref[k], median)) for k in ref if k not in skip)


def thirds(t0, ends):
    """Host milliseconds per call in each third of the window's calls (the
    last call's end is read before the final wait for the card)."""
    n = len(ends) // 3
    if n == 0:
        return []
    marks = [t0, ends[n - 1], ends[2 * n - 1], ends[-1]]
    counts = [n, n, len(ends) - 2 * n]
    return [1e3 * (b - a) / c for a, b, c in zip(marks, marks[1:], counts)]


def sum_counts(items):
    total = {}
    for c in items:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total

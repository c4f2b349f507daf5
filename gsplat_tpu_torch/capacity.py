"""Row-capacity policy of the training loop: the capacity ladder and the
grow/shrink controller.

Plain-Python copy of `gsplat_tpu/capacity.py` (`next_pow2`,
`quantize_capacity`, `round128`, `CapacityController`). The port's loop uses
the controller on the gaussian axis only (`train/resize.py`): the port
sizes the (gaussian, tile)-instance buffer per frame, so the JAX package's
instance-axis probes have no counterpart here.
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n, floored at 2^17 (sub-128k buffers save
    nothing measurable but multiply recompiles)."""
    return 1 << max(17, int(n - 1).bit_length())


def quantize_capacity(n: int, floor: int = 1 << 17) -> int:
    """Smallest quarter-pow2 ladder value >= n: m * 2^e with m in
    {1, 1.25, 1.5, 1.75}, floored at `floor` (itself a pow2).

    The ladder bounds quantization overshoot at 25% where next_pow2 allows
    100% — and every capacity-proportional stage (instance sort, pack
    row-gather, backward segment reductions, per-gaussian Adam/preprocess)
    pays ~17ns/row per compiled slot (measured; see README). All rungs
    >= 512 are multiples of 128, so kernel chunk alignment holds.
    """
    n = max(int(n), floor)
    e = int(n - 1).bit_length() - 1  # 2^e < n <= 2^(e+1)
    base = 1 << e
    for m_num in (5, 6, 7):  # 1.25, 1.5, 1.75 x base
        rung = base * m_num // 4
        if rung >= n:
            return rung
    return 2 * base  # n <= 2^(e+1) by construction


def round128(n: int) -> int:
    """Smallest multiple of 128 >= n — exact sizing for a fixed camera set
    (every capacity-proportional pass pays ~17ns/row, so prefer this over
    next_pow2 whenever recompiles are not a concern)."""
    return max(128, (int(n) + 127) // 128 * 128)


class CapacityController:
    """Grow/shrink policy for a compiled row capacity during training.

    Used on both padded axes — the (gaussian, tile)-instance buffer and the
    gaussian parameter rows (see `train/resize.py`). Fed one observation per
    check (the live count and an overflow/dropped counter), it returns the
    new capacity when a resize is due, else None. Policy:

    - GROW immediately on overflow or at >`grow_frac` utilization —
      densification raises the count between observations, and overflow
      silently drops instances (or densify children) until the next
      log-gated host sync sees it. Growth targets `grow_margin * count` on
      the quarter-pow2 ladder (at least 1.25x the current capacity; 2x on
      overflow, since the observed count is clamped by the full buffer).
    - SHRINK on a sustained gap: the observation window restarts every
      `window` steps, and a shrink to `shrink_margin * peak` (quantized)
      fires when that target is at most `capacity / shrink_gap` (a recompile
      costs more than a small misfit; an all-time peak — e.g. the pre-prune
      init spike — must not block shrinking forever, hence the rolling
      restart). Post-shrink utilization is peak/(1.6*peak) = 0.625 < the
      grow threshold, so grow/shrink cannot ping-pong.
    - A `notify_structural_change()` (a mass prune / opacity-reset round)
      restarts the window at a short `event_window`, so the shrink decision
      comes a few observations after the event instead of up to a full
      window later (the init->first-prune capacity gap costs ~6x per-step
      time; waiting 500 iterations to react was ~20% of a 7k-iter run).
    """

    def __init__(
        self,
        capacity: int,
        window: int = 50,
        event_window: int = 5,
        floor: int = 1 << 17,
        grow_frac: float = 0.7,
        grow_margin: float = 1.6,
        shrink_margin: float = 1.6,
        shrink_gap: float = 2.0,
    ):
        self.capacity = int(capacity)
        self.window = window
        self.event_window = max(1, min(event_window, window))
        self.floor = floor
        self.grow_frac = grow_frac
        self.grow_margin = grow_margin
        self.shrink_margin = shrink_margin
        self.shrink_gap = shrink_gap
        self._peak = 0
        self._logs = 0
        self._target = window

    def _reset(self):
        self._peak = 0
        self._logs = 0
        self._target = self.window

    def notify_structural_change(self):
        """The row regime just changed (e.g. a big prune): restart the
        observation window short so the next shrink check comes early."""
        self._peak = 0
        self._logs = 0
        self._target = self.event_window

    def update(self, count: int, overflow: int) -> int | None:
        count = int(count)
        self._peak = max(self._peak, count)
        self._logs += 1
        if overflow > 0 or count > self.grow_frac * self.capacity:
            lo = 2 * self.capacity if overflow > 0 else (self.capacity * 5 + 3) // 4
            self.capacity = quantize_capacity(
                max(int(self.grow_margin * count), lo), self.floor
            )
            self._reset()
            return self.capacity
        if self._logs >= self._target:
            shrunk = quantize_capacity(
                int(self.shrink_margin * self._peak), self.floor
            )
            self._reset()
            if shrunk * self.shrink_gap <= self.capacity:
                self.capacity = shrunk
                return self.capacity
        return None

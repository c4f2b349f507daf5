"""Cost probes of the blend kernels: where the kernels' time goes.

Counterparts of the JAX package's probe scripts, each a hand-written kernel
in `csrc/` with a plain PyTorch twin, a launch counter and a `main()`:

- `ablate`: P1' and P2' (`csrc/probe_skeleton.cu`): the streaming of the
  sorted blend's forward K2' (its bytes through bulk copies into an
  mbarrier ring) and its backward K3' with the blend math dead, timed
  against the full kernels on the same frame (`scripts/probe_ablate2.py`);
- `op_rate`: P3' (`csrc/probe_ops.cu`), the per-iteration cost of the
  blend's building blocks on one SM (`scripts/probe_mm.py`);
- `bf16_rate`: P4' (`csrc/probe_ops.cu`), the forward blend's op mix in
  float32 and in packed bf16 arithmetic (`scripts/probe_r5_bf16vpu.py`);
- `floors`: no probe but the floors of a probe kernel's SM pipes (issue,
  FMA, ALU, MUFU, shuffle, shared memory) from its SASS, which
  `chip_smoke.py` reports beside each P3'/P4' time.

Run one with `python -m gsplat_tpu_torch.probes.<name>`: on the card by
default (it raises without one), or with `--device cpu` as a rehearsal that
runs the twins at a smaller size. Times from a CPU run are the host's.
"""

from __future__ import annotations

import time

import torch


def time_ms(fn, reps: int, device: torch.device, warmup: int = 1) -> float:
    """Mean ms of `fn()` over `reps` calls after `warmup` calls: CUDA events
    around the calls on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def warm_up_frame(device: torch.device, n: int, width: int, height: int) -> int:
    """Render one seeded frame through `render` before anything is timed;
    returns its instance count."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.synthetic import tiny_scene

    params, alive, camera = tiny_scene(n=n, width=width, height=height, device=device)
    with torch.no_grad():
        out = render(camera, params, alive, make_render_settings(sh_degree=3), [0.0, 0.0, 0.0],
                     device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return int(out["num_instances"])

"""Where the loss kernels' time goes: variants of `csrc/loss.cu`, each with
one part of the work taken out or changed, built side by side and timed in
turns on one seeded 1920x1080 pair.

    python gsplat_tpu_torch/scripts/loss_ablate.py [--reps 50] [--rounds 2]

On the card only. Each variant is the committed source with a text edit,
built by `scripts/ablation.py` (each edit must match, so a changed source
fails loudly rather than timing the unchanged kernel):

- `kernel`: as committed;
- `no_h_loads`: the blur along H reads zeros instead of the images (its
  arithmetic kept);
- `no_h_pass`: the blur along H writes zeros and nothing else;
- `fast_division`: built with `-prec-div=false` (approximate division);
- `no_writer`: the partial maps (forward) and the gradient (backward) are
  not written;
- `fwd_blocks_3`, `bwd_blocks_3`: `__launch_bounds__` asks for three
  blocks per SM of the forward, of the backward.

Prints one JSON line: the card, each variant's registers, shared memory
and blocks per SM (`gs_loss_info`) and its kernels' stack and local
memory (`cuobjdump -res-usage`: a spill shows there), and the mean device
ms of `reps`
back-to-back calls (CUDA events) of the forward as training calls it (the
image's partial maps only) and of the backward (the image's gradient, d
loss = 1), per round; and whether `kernel` equals the plain twins on the
pair bit for bit. Only `kernel` computes the loss: the others are timings.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FWD_BOUNDS = "__launch_bounds__(THREADS, 2) loss_fwd_kernel"
BWD_BOUNDS = "__launch_bounds__(THREADS, 2) loss_bwd_kernel"
H_LOAD = "v[s] = in ? __ldg(src[s] + off) : 0.0f;"
H_ENTRY = "    const int k = threadIdx.x;\n    if (k >= SPAN_F) return;\n"
H_ZEROS = ("    const int k = threadIdx.x;\n    if (k >= SPAN_F) return;\n"
           "    for (int o = 0; o < OUT; ++o)\n"
           "        for (int q = 0; q < NF; ++q)\n"
           "            hb[((q * C + k % C) * OUT + o) * SPAN + k / C] = 0.0f;\n"
           "    return;\n")
# name: (text edits, extra nvcc flags)
VARIANTS = {
    "kernel": ([], []),
    "no_h_loads": ([(H_LOAD, "v[s] = 0.0f * (float)off;")], []),
    "no_h_pass": ([(H_ENTRY, H_ZEROS)], []),
    "fast_division": ([], ["-prec-div=false"]),
    "no_writer": ([("for (int m = 0; m < 3; ++m) write_row(a.px",
                    "for (int m = 0; m < 0; ++m) write_row(a.px"),
                   ("        if (gy < a.h) {\n            // the gradient",
                    "        if (false) {\n            // the gradient")], []),
    "fwd_blocks_3": ([(FWD_BOUNDS, FWD_BOUNDS.replace("2)", "3)"))], []),
    "bwd_blocks_3": ([(BWD_BOUNDS, BWD_BOUNDS.replace("2)", "3)"))], []),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)

    import torch

    import chip_smoke as cs
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.device import card_line
    from gsplat_tpu_torch.scripts import ablation
    from gsplat_tpu_torch.train import losses

    if not torch.cuda.is_available():
        print("loss_ablate: no CUDA device", file=sys.stderr)
        return 2
    built = ablation.build("loss", VARIANTS, _kernels.BUILD_DIR / "loss_ablate")
    libs = {name: lib for name, (lib, _) in built.items()}
    dev = torch.device("cuda")
    taps = losses._window_taps(11, 1.5)
    lam = 0.2
    x, y = cs.loss_pair(1920, 1080, dev, 20)
    h, w, _ = x.shape
    f32 = dict(dtype=torch.float32, device=dev)
    px = torch.empty((3, h, w, 3), **f32)
    sums = torch.empty((2, -(-w // 16) * -(-h // 16)), **f32)
    means = [torch.empty((), **f32) for _ in range(3)]
    ticket = torch.zeros((), dtype=torch.int32, device=dev)
    ctaps = (ctypes.c_float * _kernels.LOSS_TAPS)(*taps)
    fwd_args = _kernels.LossFwdArgs(x.data_ptr(), y.data_ptr(), px.data_ptr(), None,
                                    sums.data_ptr(), *(t.data_ptr() for t in means),
                                    ticket.data_ptr(), h, w, ctaps, losses._C1, losses._C2, lam,
                                    1.0 - lam)
    want = losses.loss_fwd_torch(x, y, lam, True, False, taps)
    one = torch.ones((), device=dev)
    grad = torch.empty_like(x)
    bwd_args = _kernels.LossBwdArgs(x.data_ptr(), y.data_ptr(), want[3].data_ptr(),
                                    one.data_ptr(), None, None, grad.data_ptr(), h, w, ctaps, lam,
                                    1.0 - lam, losses._f32_inv(x.numel()))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(lib, fn, a):
        f = getattr(lib, fn)
        return lambda: _kernels.check(f(ctypes.byref(a), stream), fn)

    call(libs["kernel"], "gs_loss_fwd", fwd_args)()
    call(libs["kernel"], "gs_loss_bwd", bwd_args)()
    torch.cuda.synchronize()
    equal = {"partials": torch.equal(px, want[3]),
             "means": all(torch.equal(a, b) for a, b in zip(means, want[:3])),
             "gradient": torch.equal(grad, losses.loss_bwd_torch(x, y, want[3], one, None, None,
                                                                 lam, taps))}
    info = {}
    for name, lib in libs.items():
        buf = (ctypes.c_int * 6)()
        _kernels.check(lib.gs_loss_info(buf), "gs_loss_info")
        keys = ("registers", "shared_bytes_per_block", "blocks_per_sm")
        info[name] = {"loss_fwd": dict(zip(keys, buf[:3])), "loss_bwd": dict(zip(keys, buf[3:])),
                      "stack_local_bytes": {f[-40:]: (u["STACK"], u["LOCAL"]) for f, u in
                                            _kernels.res_usage(built[name][1]).items()}}
    ms = {name: {"loss_fwd": [], "loss_bwd": []} for name in libs}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            ms[name]["loss_fwd"].append(cs.cuda_time(call(lib, "gs_loss_fwd", fwd_args), args.reps))
            ms[name]["loss_bwd"].append(cs.cuda_time(call(lib, "gs_loss_bwd", bwd_args), args.reps))
    print(json.dumps({"card": card_line(), "size": [w, h], "kernel_equals_twins": equal,
                      "build": info, "ms": ms}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

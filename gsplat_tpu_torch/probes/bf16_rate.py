"""bf16 issue-rate probe P4': the forward blend's op mix in float32 and bf16.

Counterpart of `scripts/probe_r5_bf16vpu.py`: does bf16 arithmetic run the
blend's op mix faster than float32? On the TPU's VPU the question was
whether Mosaic packs two bf16 lanes per float32 lane; on Hopper packed
`bf16x2` instructions exist, and what caps the gain is the float32 compares
and the conversions they need.

Per element, `K` = 2000 iterations from acc = x (`probe_r5_bf16vpu.py:41-55`):

    x2 = acc * 0.5 + 1;  p = -(x2 * x2) * 0.5;  g = exp(p);  a = min(x2 * g, 1)
    keep = (float32(p) <= 0) & (float32(a) >= 1e-4);  a = keep ? a : 0
    acc = acc + a * 0.5

`blend_mix_f32` and `blend_mix_bf16` (`csrc/probe_ops.cu`, CUDA tensors
only) run it on one block, in float32 and in packed bf16 arithmetic
(each mul and add rounded to bf16 on its own); `blend_mix_torch` is the
plain twin for either dtype. Each wrapper counts its `launches`, and
`launches_512` of them at 512 rows. The bf16 kernel runs the keep compares
packed in bf16 against `KEEP_BF16`, the least bf16 whose float value is >=
1e-4f (`least_bf16_at_least`): for every bf16 b, float(b) >= 1e-4f exactly
when b >= KEEP_BF16, so the packed gate decides as the float32 one.

    python -m gsplat_tpu_torch.probes.bf16_rate [--device cpu]

renders one warm-up frame, then prints the time of each dtype at (256, 128)
and (512, 128) and the JSON keys of `probe_r5_bf16vpu.py:110-112`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

K = 2000
MIX_ILP = 8  # elements (bf16: pairs) a kernel thread walks together
SHAPES = ((256, 128), (512, 128))
# operations of one iteration per element: 2 (x2) + 3 (p) + 1 (exp) + 2 (a)
# + 3 (the compares and their and) + 1 (select) + 2 (acc); bf16 adds the two
# conversions to float32
OPS = {torch.float32: 14, torch.bfloat16: 16}
KEEP_MIN = 1e-4  # the keep threshold on a, compared in float32


def least_bf16_at_least(value: float) -> int:
    """Bit pattern of the least bf16 whose float value is >= float32(value)
    (value > 0): bf16 is the top half of a float32, and positive floats order
    as their bit patterns."""
    bits = int(np.array(value, dtype=np.float32).view(np.uint32))
    return (bits >> 16) + (bits & 0xFFFF != 0)


KEEP_BF16 = least_bf16_at_least(KEEP_MIN)


def inputs(shape, dtype, device="cpu", seed=0):
    """`probe_r5_bf16vpu.run`'s input: uniform [0, 1) from a seeded
    generator, rounded to float32 and then to `dtype`."""
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    return torch.as_tensor(x, device=device).to(dtype)


def blend_mix_torch(x, n_it=K):
    """Plain twin: the op mix in `x`'s dtype, each op rounded on its own."""
    half = torch.tensor(0.5, dtype=x.dtype, device=x.device)
    one = torch.tensor(1.0, dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    acc = x
    for _ in range(n_it):
        x2 = acc * half + one
        p = -(x2 * x2) * half
        g = torch.exp(p)
        a = torch.minimum(x2 * g, one)
        keep = (p.float() <= 0) & (a.float() >= 1e-4)
        a = torch.where(keep, a, zero)
        acc = acc + a * half
    return acc


def _wrapper(dtype, entry):
    def launch(x, n_it=K):
        from gsplat_tpu_torch import _kernels

        if not x.is_cuda:
            raise ValueError(f"{launch.__name__} launches a CUDA kernel: x must be on a CUDA device")
        if x.dtype != dtype or x.dim() != 2 or x.numel() % (2 * MIX_ILP * 1024) != 0:
            raise ValueError(f"{launch.__name__}: want a 2-d {dtype} tensor of a multiple of "
                             f"{2 * MIX_ILP * 1024} elements, got {tuple(x.shape)} {x.dtype}")
        if n_it < 1:
            raise ValueError(f"n_it must be >= 1, got {n_it}")
        x = x.contiguous()
        out = torch.empty_like(x)
        lib = _kernels.load("probe_ops")
        args = (x.data_ptr(), out.data_ptr(), x.numel(), n_it)
        if dtype == torch.bfloat16:
            args += (KEEP_BF16,)
        err = getattr(lib, entry)(*args, _kernels.stream(x.device))
        _kernels.check(err, launch.__name__)
        launch.launches += 1
        launch.launches_512 += x.shape[0] == 512
        return out

    launch.__name__ = entry[3:]
    launch.__doc__ = (f"P4' in {dtype} on the card: same contract as `blend_mix_torch`. "
                      "CUDA tensors only.")
    launch.launches = 0
    launch.launches_512 = 0
    return launch


blend_mix_f32 = _wrapper(torch.float32, "gs_blend_mix_f32")
blend_mix_bf16 = _wrapper(torch.bfloat16, "gs_blend_mix_bf16")
WRAPPERS = {torch.float32: blend_mix_f32, torch.bfloat16: blend_mix_bf16}


def main(argv=None) -> dict:
    """Time both dtypes at both shapes; returns the JSON keys of the JAX
    script (ms per call) and the speedups."""
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.probes import time_ms, warm_up_frame

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = resolve_device(parser.parse_args(argv).device)
    on_card = dev.type == "cuda"
    # the CPU rehearsal runs 3 iterations per call, once
    n_it, reps = (K, 10) if on_card else (3, 1)
    warm_up_frame(dev, *((65_536, 640, 480) if on_card else (512, 48, 32)))
    print("anchor render done", flush=True)

    res = {}
    for key, dtype, shape in (("f32", torch.float32, SHAPES[0]), ("bf16", torch.bfloat16, SHAPES[0]),
                              ("f32_512", torch.float32, SHAPES[1]),
                              ("bf16_512", torch.bfloat16, SHAPES[1])):
        x = inputs(shape, dtype, dev)
        fn = WRAPPERS[dtype] if on_card else blend_mix_torch
        res[key] = time_ms(lambda: fn(x, n_it=n_it), reps, dev)
        print(f"{key} {shape} x {n_it} it: {res[key]:.4f} ms", flush=True)
    res["bf16_speedup_same_shape"] = res["f32"] / res["bf16"]
    res["bf16_speedup_512"] = res["f32_512"] / res["bf16_512"]
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()

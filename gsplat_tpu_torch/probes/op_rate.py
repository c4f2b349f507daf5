"""Op-rate probe P3': the blend's building blocks, one SM, 1000 iterations.

Counterpart of `scripts/probe_mm.py`. Each variant runs 1000 dependent
iterations (`N_IT`) of one pattern on a block that one SM holds: every
input element is tied to the previous iteration's result by `dep`
(`probe_mm.py:49-51`: row 0 of the result times 1e-20; `k_fwd_accum`:
column 0, per row; `k_cvpu` and `k_cmatmul`: the sum of row 0), so no
iteration can be skipped. The variants, in the JAX script's order:

- `vpu9`: v = dep(x); three times v = v * x + x; v * 1.0000001;
- `cumprod`: the inclusive lane cumprod of dep(x) by 7 doubling steps;
- `exp`: exp(dep(x) * 1e-3); `div`: 1 / (1.5 + dep(x) * 1e-3);
- `cvpu`: dpix (256, 4) times feat (4, 128) as 4 broadcast multiplies and 3
  adds; `cmatmul`: the same product as a contraction;
- `two_matmuls`: basis^T x (6, 128) and dpix^T y (4, 128), 256 deep;
- `merged`: bd^T [x | y] (10, 256), 256 deep;
- `fwd_accum`: w (256, 128) times feat^T (128, 4);
- `kappa1`, `kappa2`, `kappa4`: basis (256, 8) times q (8, 128 kappa).

Each has a kernel wrapper (`csrc/probe_ops.cu`, CUDA tensors only, with a
`launches` counter) in `WRAPPERS` and a plain twin in `TWINS`, both called
with the variant's inputs (`inputs`) and `n_it`. The twins compute the JAX
bodies in torch; their contractions are `torch.matmul` in float32.
`rcp_1_2` runs `k_div`'s reciprocal alone on a CUDA tensor, to hold it to
`1.0 / x`.

    python -m gsplat_tpu_torch.probes.op_rate [--device cpu]

prints each variant's label and its time per iteration, and the derived
per-op and per-chunk costs of `probe_mm.py:171,186`.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np
import torch

N_IT = 1000
# the row (for `fwd_accum` the column) of a result that feeds the next
# iteration. The elementwise kernels take it as an argument and store every
# row in every iteration (this one to the feedback buffer); the others fold
# every output into a checksum each thread writes to a sink buffer after
# the loop (`SINK_WORDS`, allocated here and dropped). Either way no
# compiler can drop the other rows' work before the last iteration
DEP_ROW = 0
DEP_SCALE = 1e-20
SINK_WORDS = 1024  # one uint32 a thread of the largest block


class Variant(NamedTuple):
    label: str  # the JAX script's label
    out_shape: tuple
    in_shapes: tuple
    flops: int  # float32 operations of one iteration (multiply-add = 2)


def _flops_elementwise(per_element):
    return 256 * 128 * per_element + 128  # + the row of dep products


VARIANTS = {
    "vpu9": Variant("9 VPU mul/add ops (256,128)", (256, 128), ((256, 128),),
                    _flops_elementwise(8)),
    "cumprod": Variant("cumprod 7 doubling steps (21 ops)", (256, 128), ((256, 128),),
                       _flops_elementwise(8)),
    "exp": Variant("exp (256,128)", (256, 128), ((256, 128),), _flops_elementwise(3)),
    "div": Variant("divide (256,128)", (256, 128), ((256, 128),), _flops_elementwise(4)),
    "cvpu": Variant("c: 7 VPU broadcast ops", (256, 128), ((256, 4), (4, 128), (1, 1)),
                    256 * 128 * 7 + 512 + 128),
    "cmatmul": Variant("c: K=4 HIGHEST matmul", (256, 128), ((256, 4), (4, 128)),
                       2 * 256 * 128 * 4 + 512 + 128),
    "two_matmuls": Variant("two HIGHEST matmuls (6+4 x 256-deep)", (16, 128),
                           ((256, 6), (256, 4), (256, 128), (256, 128)),
                           2 * 10 * 128 * 256 + 256 * 128 + 128),
    "merged": Variant("ONE merged (10,256)@(256,256)", (16, 256),
                      ((256, 10), (256, 128), (256, 128)), 2 * 10 * 256 * 256 + 256 * 128 + 128),
    "fwd_accum": Variant("fwd accum (256,128)@(128,4)", (256, 128), ((256, 128), (4, 128)),
                         2 * 256 * 4 * 128 + 256 * 128 + 256),
    **{f"kappa{k}": Variant(f"power matmul (256,8)@(8,128*{k}) HIGHEST", (256, 128 * k),
                            ((256, 8), (8, 128 * k)), 2 * 256 * 128 * k * 8 + 9 * 128 * k)
       for k in (1, 2, 4)},
}


def inputs(name, device="cpu", seed=0):
    """The variant's inputs as `probe_mm.bench` makes them: one generator,
    standard normals times 0.1, float32."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor((rng.standard_normal(s) * 0.1).astype(np.float32), device=device)
            for s in VARIANTS[name].in_shapes]


# ---------------------------------------------------------------- twins


def _dep(x, acc):
    return x + acc[0:1, :] * DEP_SCALE


def _loop(body, out_shape, ref, n_it):
    acc = torch.zeros(out_shape, dtype=torch.float32, device=ref.device)
    for _ in range(n_it):
        acc = body(acc)
    return acc


def vpu9_torch(x, n_it=N_IT):
    def body(acc):
        v = _dep(x, acc)
        for _ in range(3):
            v = v * x + x
        return v * 1.0000001

    return _loop(body, (256, 128), x, n_it)


def cumprod_torch(x, n_it=N_IT):
    lane = torch.arange(128, device=x.device)[None, :]

    def body(acc):
        v = _dep(x, acc)
        s = 1
        while s < 128:
            v = v * torch.where(lane >= s, torch.roll(v, s, dims=1), 1.0)
            s *= 2
        return v

    return _loop(body, (256, 128), x, n_it)


def exp_torch(x, n_it=N_IT):
    return _loop(lambda acc: torch.exp(_dep(x, acc) * 1e-3), (256, 128), x, n_it)


def div_torch(x, n_it=N_IT):
    return _loop(lambda acc: 1.0 / (1.5 + _dep(x, acc) * 1e-3), (256, 128), x, n_it)


def cvpu_torch(dpix, feat, x, n_it=N_IT):
    """`x` (1, 1) is unused, as in `k_cvpu` (`probe_mm.py:95`)."""
    def body(acc):
        f = feat + acc[0:1, :].sum(dim=1, keepdim=True) * DEP_SCALE
        return (dpix[:, 0:1] * f[0:1, :] + dpix[:, 1:2] * f[1:2, :]
                + dpix[:, 2:3] * f[2:3, :] + dpix[:, 3:4] * f[3:4, :])

    return _loop(body, (256, 128), dpix, n_it)


def cmatmul_torch(dpix, feat, n_it=N_IT):
    def body(acc):
        return dpix @ (feat + acc[0:1, :].sum(dim=1, keepdim=True) * DEP_SCALE)

    return _loop(body, (256, 128), dpix, n_it)


def two_matmuls_torch(basis, dpix, x, y, n_it=N_IT):
    zeros = torch.zeros((6, 128), dtype=torch.float32, device=x.device)

    def body(acc):
        mom = basis.T @ _dep(x, acc)
        return torch.cat([mom, dpix.T @ y, zeros])

    return _loop(body, (16, 128), x, n_it)


def merged_torch(bd, x, y, n_it=N_IT):
    zeros = torch.zeros((6, 256), dtype=torch.float32, device=x.device)

    def body(acc):
        rhs = torch.cat([x + acc[0:1, 0:128] * DEP_SCALE, y], dim=1)
        return torch.cat([bd.T @ rhs, zeros])

    return _loop(body, (16, 256), x, n_it)


def fwd_accum_torch(w, feat, n_it=N_IT):
    zeros = torch.zeros((256, 124), dtype=torch.float32, device=w.device)

    def body(acc):
        return torch.cat([(w + acc[:, 0:1] * DEP_SCALE) @ feat.T, zeros], dim=1)

    return _loop(body, (256, 128), w, n_it)


def _kappa_torch(kappa):
    def twin(basis, q, n_it=N_IT):
        return _loop(lambda acc: basis @ _dep(q, acc), (256, 128 * kappa), q, n_it)

    twin.__name__ = f"kappa{kappa}_torch"
    twin.__doc__ = f"Plain twin of `make_kappa({kappa})`."
    return twin


TWINS = {
    "vpu9": vpu9_torch, "cumprod": cumprod_torch, "exp": exp_torch, "div": div_torch,
    "cvpu": cvpu_torch, "cmatmul": cmatmul_torch, "two_matmuls": two_matmuls_torch,
    "merged": merged_torch, "fwd_accum": fwd_accum_torch,
    **{f"kappa{k}": _kappa_torch(k) for k in (1, 2, 4)},
}

# ------------------------------------------------------------- wrappers

# each variant's C entry point, called with (library, input pointers, output
# pointer, sink pointer, n_it, stream); `cvpu`'s unused (1, 1) input is not
# passed
_ENTRY = {
    "cumprod": lambda lib, p, o, sk, n, st: lib.gs_op_elementwise(0, *p, o, sk, n, DEP_ROW, st),
    "vpu9": lambda lib, p, o, sk, n, st: lib.gs_op_elementwise(1, *p, o, sk, n, DEP_ROW, st),
    "exp": lambda lib, p, o, sk, n, st: lib.gs_op_elementwise(2, *p, o, sk, n, DEP_ROW, st),
    "div": lambda lib, p, o, sk, n, st: lib.gs_op_elementwise(3, *p, o, sk, n, DEP_ROW, st),
    "cvpu": lambda lib, p, o, sk, n, st: lib.gs_op_contract4(*p[:2], o, sk, 0, n, st),
    "cmatmul": lambda lib, p, o, sk, n, st: lib.gs_op_contract4(*p, o, sk, 1, n, st),
    "two_matmuls": lambda lib, p, o, sk, n, st: lib.gs_op_two_matmuls(*p, o, sk, n, st),
    "merged": lambda lib, p, o, sk, n, st: lib.gs_op_merged(*p, o, sk, n, st),
    "fwd_accum": lambda lib, p, o, sk, n, st: lib.gs_op_fwd_accum(*p, o, sk, n, st),
    **{f"kappa{k}": (lambda lib, p, o, sk, n, st, k=k: lib.gs_op_kappa(*p, o, sk, k, n, st))
       for k in (1, 2, 4)},
}


def _operands(name, args):
    """The variant's inputs checked against its shapes, float32, contiguous
    and 16-byte aligned on one CUDA device."""
    shapes = VARIANTS[name].in_shapes
    if len(args) != len(shapes):
        raise ValueError(f"{name} takes {len(shapes)} inputs, got {len(args)}")
    out = []
    for a, s in zip(args, shapes):
        if not a.is_cuda:
            raise ValueError(f"{name} launches a CUDA kernel: tensors must be on a CUDA device")
        if tuple(a.shape) != s or a.dtype != torch.float32 or a.device != args[0].device:
            raise ValueError(f"{name}: want {s} float32 on {args[0].device}, got "
                             f"{tuple(a.shape)} {a.dtype} on {a.device}")
        a = a.contiguous()
        out.append(a if a.data_ptr() % 16 == 0 else a.clone())
    return out


def _wrapper(name):
    def launch(*args, n_it=N_IT):
        from gsplat_tpu_torch import _kernels

        ops = _operands(name, args)
        if n_it < 1:
            raise ValueError(f"n_it must be >= 1, got {n_it}")
        dev = ops[0].device
        out = torch.empty(VARIANTS[name].out_shape, dtype=torch.float32, device=dev)
        sink = torch.empty(SINK_WORDS, dtype=torch.int32, device=dev)
        lib = _kernels.load("probe_ops")
        err = _ENTRY[name](lib, [a.data_ptr() for a in ops], out.data_ptr(), sink.data_ptr(),
                           n_it, _kernels.stream(dev))
        _kernels.check(err, name)
        launch.launches += 1
        return out

    launch.__name__ = f"k_{name}"
    launch.__doc__ = (f"P3' `{name}` on the card: same contract as `{TWINS[name].__name__}`. "
                      "CUDA tensors only.")
    launch.launches = 0
    return launch


WRAPPERS = {name: _wrapper(name) for name in VARIANTS}


def rcp_1_2(x):
    """`k_div`'s reciprocal of every element of a float32 CUDA tensor:
    correctly rounded for x in [1, 2), where `k_div` uses it."""
    from gsplat_tpu_torch import _kernels

    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError("rcp_1_2 launches a CUDA kernel: x must be float32 on a CUDA device")
    x = x.contiguous()
    out = torch.empty_like(x)
    _kernels.check(_kernels.load("probe_ops").gs_rcp_check(
        x.data_ptr(), out.data_ptr(), x.numel(), _kernels.stream(x.device)), "rcp_1_2")
    return out


def main(argv=None) -> dict:
    """Time every variant; returns {name: us per iteration}."""
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.probes import time_ms, warm_up_frame

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = resolve_device(parser.parse_args(argv).device)
    on_card = dev.type == "cuda"
    # the CPU rehearsal runs 2 iterations per call, once
    n_it, reps = (N_IT, 5) if on_card else (2, 1)
    warm_up_frame(dev, *((65_536, 640, 480) if on_card else (512, 48, 32)))
    print(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}", flush=True)

    fns = WRAPPERS if on_card else TWINS
    us = {}
    for name, v in VARIANTS.items():
        ins = inputs(name, dev)
        us[name] = time_ms(lambda: fns[name](*ins, n_it=n_it), reps, dev) * 1e3 / n_it
        print(f"{v.label:52s} {us[name]:8.3f} us/iter", flush=True)
        if name == "vpu9":
            print(f"  -> per-op cost {us[name] / 9 * 1e3:.1f} ns", flush=True)
        elif name.startswith("kappa"):
            kappa = int(name[5:])
            print(f"  -> per-chunk {us[name] / kappa:.3f} us (replaces ~9 VPU ops = "
                  f"{us['vpu9']:.3f})", flush=True)
    return us


if __name__ == "__main__":
    main()

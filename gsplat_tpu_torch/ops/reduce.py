"""Per-gaussian gradient reduction: kernel K4' and its plain twin.

Counterpart of `gsplat_tpu/ops/reduce.py`. `reduce_by_gid` sums per-instance
gradient rows into per-gaussian columns, with the JAX package's contract
(`reduce.py:194-208`): (16, K) rows in, (16, n_gauss) columns out, only rows
0-9 meaningful (here rows 10-15 of the result are zero). Every slot is
summed: the port's per-frame instance buffer has no invalid slots.

On a CUDA tensor it launches K4' (`csrc/reduce.cu`, replacing the Pallas
`_reduce_kernel`, `gsplat_tpu/ops/reduce.py:50`): one thread per instance
adds its ten values into its gaussian's row of a gaussian-major (N, 16)
accumulator with three vector atomics. The TPU's gid sort-back and one-hot
window exist for the TPU's engines (`reduce.py:1-23`) and are not ported.
On a CPU tensor it runs the plain twin `reduce_by_gid_torch`, `index_add_`
over the gaussian ids into the same (N, 16) layout. Both return the
accumulator's (16, N) transposed view (strides (1, 16)), so a caller's
row slices such as `out[0:2].T` are strided (N, k) views, not copies.

`pack_bf16` rounds every per-instance value to bf16 (nearest even) before
the float32 sum, as the hybrid packet mode's pair packing does
(`reduce.py:216-230`).

Summation order differs between the two and from run to run on the card
(atomics), as K4's does (unstable sort, `reduce.py:214-215`): compare
within a tolerance, never bit for bit. The CPU tests use atol 1e-4, rtol
1e-5 (`tests/test_reduce.py:45`) on O(1) values; on gradients, whose
scale varies by row, compare per row, relative to the row's largest value.
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.ops.binning import round_bf16

N_ROWS = 16  # rows of the result, as the JAX package returns them
N_GRAD = 10  # meaningful rows: d mx, d my, d conic a, b, c, d op, d rgb, d invz


def _check_rows(dinst, gauss_id):
    if dinst.dim() != 2 or dinst.shape[0] < N_GRAD or dinst.dtype != torch.float32:
        raise ValueError(f"dinst must be (>= {N_GRAD}, K) float32, got "
                         f"{tuple(dinst.shape)} {dinst.dtype}")
    if gauss_id.shape != (dinst.shape[1],):
        raise ValueError(f"gauss_id must be ({dinst.shape[1]},), got {tuple(gauss_id.shape)}")


def reduce_by_gid_torch(dinst, gauss_id, n_gauss: int, pack_bf16: bool = False):
    """Plain twin of K4': `index_add_` of rows 0-9 over `gauss_id` into an
    (N, 16) accumulator; returns its (16, N) view."""
    _check_rows(dinst, gauss_id)
    rows = dinst[:N_GRAD]
    if pack_bf16:
        rows = round_bf16(rows)
    acc = torch.zeros((n_gauss, N_ROWS), dtype=torch.float32, device=dinst.device)
    acc[:, :N_GRAD].index_add_(0, gauss_id.long(), rows.T)
    return acc.T


def reduce_by_gid_cuda(dinst, gauss_id, n_gauss: int, pack_bf16: bool = False):
    """Kernel K4' on the card: same contract as `reduce_by_gid_torch`.
    CUDA tensors only."""
    from gsplat_tpu_torch import _kernels

    if not dinst.is_cuda or not gauss_id.is_cuda:
        raise ValueError("reduce_by_gid_cuda launches a CUDA kernel: tensors must be on a CUDA device")
    _check_rows(dinst, gauss_id)
    k = dinst.shape[1]
    dinst = dinst.contiguous()
    gauss_id = gauss_id.to(torch.int32).contiguous()
    acc = torch.zeros((n_gauss, N_ROWS), dtype=torch.float32, device=dinst.device)
    # the vector atomics write 16-byte aligned float4/float2 of 16-float rows
    if acc.stride() != (N_ROWS, 1) or acc.data_ptr() % 16:
        raise ValueError(f"reduce_by_gid_cuda: accumulator strides {acc.stride()} at "
                         f"{acc.data_ptr():#x}, want ({N_ROWS}, 1), 16-byte aligned")
    if k == 0:
        return acc.T
    lib = _kernels.load("reduce")
    err = lib.gs_reduce_by_gid(
        dinst.data_ptr(), gauss_id.data_ptr(), k, int(pack_bf16), acc.data_ptr(),
        _kernels.stream(dinst.device),
    )
    _kernels.check(err, "reduce_by_gid")
    reduce_by_gid_cuda.launches += 1
    return acc.T


reduce_by_gid_cuda.launches = 0


def reduce_by_gid(dinst, gauss_id, n_gauss: int, pack_bf16: bool = False):
    """Sum (>= 10, K) per-instance gradient rows into (16, n_gauss) columns
    (the transposed view of an (n_gauss, 16) buffer).

    On a CUDA tensor through kernel K4'; on a CPU tensor through
    `reduce_by_gid_torch`.
    """
    fn = reduce_by_gid_cuda if dinst.is_cuda else reduce_by_gid_torch
    return fn(dinst, gauss_id, n_gauss, pack_bf16)

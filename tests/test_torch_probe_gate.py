"""The packed bf16 keep gate of P4' (`probes/bf16_rate.py`,
`csrc/probe_ops.cu:blend_mix_bf16_kernel`) and the guards of the probe
wrappers' new arguments. No card and no JAX.

The kernel compares bf16 values against `KEEP_BF16` and 0 where the JAX
probe compares their float32 widening against 1e-4 and 0: over all 65,536
bf16 bit patterns, NaNs and both zeros included, the two decide alike.
"""

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.probes import bf16_rate, op_rate


def every_bf16():
    return torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)


def test_keep_threshold_is_the_least_bf16_at_or_above_1e_4():
    thr = torch.tensor([bf16_rate.KEEP_BF16], dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    assert float(thr) >= np.float32(1e-4)
    below = torch.tensor([bf16_rate.KEEP_BF16 - 1], dtype=torch.int32).to(torch.int16)
    assert float(below.view(torch.bfloat16)) < np.float32(1e-4)


def test_packed_gate_decides_as_the_float32_gate_on_every_bf16():
    b = every_bf16()
    f = b.float()
    thr = torch.tensor([bf16_rate.KEEP_BF16], dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).expand_as(b)
    # the kernel's bf16 compares are exact comparisons of the bf16 values
    assert torch.equal(b >= thr, f >= torch.tensor(np.float32(1e-4)))
    assert torch.equal(b <= 0, f <= 0)
    nan = torch.isnan(f)
    assert int(nan.sum()) == 2 * 127 and not (b >= thr)[nan].any() and not (b <= 0)[nan].any()


@pytest.mark.parametrize("value", [1e-4, 0.5, 3.0, 1e-30])
def test_least_bf16_at_least(value):
    t = bf16_rate.least_bf16_at_least(value)
    as_float = np.array([t << 16], dtype=np.uint32).view(np.float32)[0]
    prev = np.array([(t - 1) << 16], dtype=np.uint32).view(np.float32)[0]
    assert as_float >= np.float32(value) > prev


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rcp_wrapper_refuses_what_its_kernel_cannot_take(dtype):
    with pytest.raises(ValueError, match="CUDA"):
        op_rate.rcp_1_2(torch.ones(4, dtype=dtype))

"""The port's per-gaussian gradient reduce vs the JAX package's.

`reduce_by_gid` on a CPU tensor is the plain twin of K4' (`index_add_`
over the gaussian ids); the JAX `reduce_by_gid` runs its Pallas K4 in
interpret mode on the CPU. Same (16, K) rows and ids from a seeded numpy
generator, `pack_bf16` off and on. Tolerance atol 1e-4, rtol 1e-5, the
JAX package's own (`tests/test_reduce.py:45`): both sum in float32 in
different orders (K4's sort is unstable, K4' adds atomically).

The bf16 rounding itself is compared bit for bit with the JAX package's
pair packing (`binning.pack2_bf16` / `unpack2_bf16`) on the edge cases:
ties to even, subnormals, signed zeros, +-inf and the largest finite floats.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsplat_tpu.ops.binning import pack2_bf16, unpack2_bf16
from gsplat_tpu.ops.reduce import reduce_by_gid as j_reduce
from gsplat_tpu_torch.ops import reduce as rd
from gsplat_tpu_torch.ops.binning import round_bf16

ATOL, RTOL = 1e-4, 1e-5


def rows_and_ids(k, n, seed, dead_share=0.0):
    rng = np.random.default_rng(seed)
    dinst = rng.standard_normal((16, k)).astype(np.float32)
    dinst[10:] = 0.0
    gid = rng.integers(0, n, k, dtype=np.int32)
    dead = rng.random(k) < dead_share
    dinst[:, dead] = 0.0  # masked-invalid slots, as the blend backward leaves them
    gid[dead] = 0
    return dinst, gid


def j_reduce_np(dinst, gid, n, pack_bf16):
    out = np.array(j_reduce(jnp.asarray(dinst), jnp.asarray(gid), n, pack_bf16=pack_bf16))
    out[10:] = 0.0  # rows 10-15 of the JAX result are scratch
    return out


@pytest.mark.parametrize("pack_bf16", [False, True])
@pytest.mark.parametrize("k,n,seed,dead", [(5000, 700, 0, 0.0), (1537, 999, 3, 0.3),
                                            (100, 130, 1, 0.0)])
def test_reduce_by_gid_matches_jax(k, n, seed, dead, pack_bf16):
    dinst, gid = rows_and_ids(k, n, seed, dead)
    got = rd.reduce_by_gid(torch.from_numpy(dinst), torch.from_numpy(gid), n, pack_bf16)
    assert got.shape == (16, n) and got.dtype == torch.float32
    assert not got[10:].any()
    np.testing.assert_allclose(got.numpy(), j_reduce_np(dinst, gid, n, pack_bf16),
                               atol=ATOL, rtol=RTOL)


def edge_values():
    """float32 values on and around the bf16 rounding edges."""
    bits = np.array([
        0x3F808000,  # 1 + 2^-8: a tie, rounds down to even 1.0
        0x3F818000,  # 1 + 3 * 2^-8: a tie, rounds up to even
        0x3F808001,  # just above a tie: rounds up
        0xBF818000,  # negative tie
        0x00000001,  # smallest subnormal
        0x00008000,  # subnormal tie, rounds to even (0)
        0x00018000,  # subnormal tie, rounds up to even
        0x007FFFFF,  # largest subnormal: rounds up to the smallest normal
        0x80000000,  # -0
        0x7F800000,  # +inf
        0xFF800000,  # -inf
        0x7F7FFFFF,  # largest finite float: rounds up to +inf
        0x7F7F7FFF,  # largest float that stays finite in bf16
    ], dtype=np.uint32)
    return bits.view(np.float32)


def test_round_bf16_matches_jax_pair_packing_bitwise():
    x = edge_values()
    hi, lo = unpack2_bf16(pack2_bf16(jnp.asarray(x), jnp.asarray(x[::-1].copy())))
    want_hi = np.asarray(hi.astype(jnp.float32))
    want_lo = np.asarray(lo.astype(jnp.float32))
    got = round_bf16(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want_hi.view(np.uint32))
    np.testing.assert_array_equal(got[::-1].view(np.uint32), want_lo.view(np.uint32))
    assert got[0] == 1.0 and np.isinf(got[11])  # the two ways a tie and an overflow go


def test_reduce_by_gid_bf16_edges_match_jax():
    """Ties and subnormals through the whole reduce, one column each, so
    the port's sums are the rounded values bit for bit. Finite values
    only: the JAX package's one-hot reduce turns an inf into NaNs across
    its window. Its matmul also flushes subnormal sums to zero, which the
    port keeps: those columns agree within atol 1e-4, the rest bit for bit
    (up to the sign of zero)."""
    x = edge_values()
    x = x[np.isfinite(x) & (np.abs(x) < 1e38)]
    k = x.shape[0]
    dinst = np.zeros((16, k), np.float32)
    dinst[:10] = x[None, :]
    gid = np.arange(k, dtype=np.int32)
    got = rd.reduce_by_gid(torch.from_numpy(dinst), torch.from_numpy(gid), k, True).numpy()
    want = j_reduce_np(dinst, gid, k, True)
    np.testing.assert_array_equal(got[:10], round_bf16(torch.from_numpy(dinst[:10])).numpy())
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    normal = np.abs(got[:10]) >= np.finfo(np.float32).tiny
    assert normal.sum() >= 40
    np.testing.assert_array_equal(got[:10][normal], want[:10][normal])


def test_reduce_by_gid_cuda_refuses_cpu_tensors():
    dinst, gid = rows_and_ids(64, 10, 0)
    with pytest.raises(ValueError, match="CUDA"):
        rd.reduce_by_gid_cuda(torch.from_numpy(dinst), torch.from_numpy(gid), 10)
    assert rd.reduce_by_gid_cuda.launches == 0
    with pytest.raises(ValueError, match="gauss_id"):
        rd.reduce_by_gid(torch.from_numpy(dinst), torch.from_numpy(gid[:5]), 10)

"""The Adam kernel's plain twin (`adam_update_torch`, what `adam_update` runs
on CPU tensors) against the JAX package's `adam_update` with the train
step's dead-row freeze (`gsplat_tpu/train/step.py:159`) applied.

Same seeded numpy parameters, gradients, moments and per-row step counts
(0 to 30,000), dense and sparse, with dead rows, the gradients handed over
as strided row views of shared buffers as the projection backward hands
them over; atol 1e-6 on parameters and moments (as `test_torch_optim.py`),
step counts exact. The kernel itself (`csrc/adam.cu`) is held to this twin
bit for bit on the card by `chip_smoke.py`'s `adam` phase.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsplat_tpu.core.types import GaussianParams
from gsplat_tpu.train import optim as jo
from gsplat_tpu_torch.convert import PARAM_FIELDS
from gsplat_tpu_torch.train import optim as to

SHAPES = dict(xyz=(3,), features_dc=(1, 3), features_rest=(15, 3), scaling=(3,),
              rotation=(4,), opacity=(1,))
LRS = (1.6e-4, 0.0025, 0.025, 0.005, 0.001)


def state(n, seed):
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal((n,) + s).astype(np.float32) for k, s in SHAPES.items()}
    m = {k: 0.01 * rng.standard_normal((n,) + s).astype(np.float32) for k, s in SHAPES.items()}
    v = {k: 1e-4 * np.abs(rng.standard_normal((n,) + s)).astype(np.float32)
         for k, s in SHAPES.items()}
    g = {k: 1e-3 * rng.standard_normal((n,) + s).astype(np.float32) for k, s in SHAPES.items()}
    counts = rng.choice([0, 1, 2, 7, 999, 30_000], n).astype(np.int32)
    counts[:3] = (0, 1, 30_000)
    vis = rng.random(n) > 0.4
    alive = rng.random(n) > 0.3
    return p, g, m, v, counts, vis, alive


def strided_grads(g):
    """The gradients as strided views: the five narrow fields side by side in
    one (N, 16) buffer, features_rest in the first 45 columns of an (N, 48)
    one."""
    n = g["xyz"].shape[0]
    narrow = torch.zeros((n, 16))
    wide = torch.zeros((n, 48))
    out, col = {}, 0
    for k, s in SHAPES.items():
        w = int(np.prod(s))
        if k == "features_rest":
            view = wide[:, :w]
        else:
            view = narrow[:, col:col + w]
            col += w
        view.copy_(torch.from_numpy(g[k].reshape(n, w)))
        out[k] = view.reshape((n,) + s)
    return out


def jax_step(p, g, m, v, counts, vis, alive, sparse):
    tree = lambda d: GaussianParams(**{k: jnp.asarray(x) for k, x in d.items()})
    jp, jm, jv, jc = jo.adam_update(tree(p), tree(g), tree(m), tree(v), jnp.asarray(counts),
                                    jo.make_lr_tree(*LRS),
                                    visibility=jnp.asarray(vis) if sparse else None)
    row = lambda leaf: jnp.asarray(alive).reshape((-1,) + (1,) * (leaf.ndim - 1))
    frozen = {k: np.asarray(jnp.where(row(getattr(jp, k)), getattr(jp, k), p[k]))
              for k in PARAM_FIELDS}
    return frozen, {k: np.asarray(getattr(jm, k)) for k in PARAM_FIELDS}, \
        {k: np.asarray(getattr(jv, k)) for k in PARAM_FIELDS}, np.asarray(jc)


@pytest.mark.parametrize("n", [3, 257])
@pytest.mark.parametrize("sparse", [False, True])
def test_twin_matches_jax_with_the_freeze(sparse, n):
    p, g, m, v, counts, vis, alive = state(n, 11 + n)
    want = jax_step(p, g, m, v, counts, vis, alive, sparse)
    t = lambda d: {k: torch.from_numpy(x) for k, x in d.items()}
    grads = strided_grads(g)
    assert not any(grads[k].is_contiguous() for k in ("xyz", "features_rest"))
    got = to.adam_update(t(p), grads, t(m), t(v), torch.from_numpy(counts),
                         to.make_lr_tree(*LRS),
                         visibility=torch.from_numpy(vis) if sparse else None,
                         alive=torch.from_numpy(alive))
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    for f in PARAM_FIELDS:
        for i in range(3):
            np.testing.assert_allclose(got[i][f].numpy(), want[i][f], rtol=0, atol=1e-6,
                                       err_msg=f"{f} output {i}")
        # dead rows keep their parameters bit for bit; sparse: invisible rows
        # keep parameters and moments bit for bit
        keep = ~alive | (~vis if sparse else False)
        np.testing.assert_array_equal(got[0][f].numpy()[keep], p[f][keep])
        if sparse:
            np.testing.assert_array_equal(got[1][f].numpy()[~vis], m[f][~vis])
            np.testing.assert_array_equal(got[2][f].numpy()[~vis], v[f][~vis])


def test_twin_equals_the_update_the_step_ran_before():
    """Without `alive` the twin is the unfrozen update; with it, dead rows
    take the moments of that update and keep their parameters."""
    p, g, m, v, counts, vis, alive = state(64, 5)
    t = lambda d: {k: torch.from_numpy(x) for k, x in d.items()}
    args = (t(p), strided_grads(g), t(m), t(v), torch.from_numpy(counts), to.make_lr_tree(*LRS))
    free = to.adam_update(*args)
    frozen = to.adam_update(*args, alive=torch.from_numpy(alive))
    a = torch.from_numpy(alive)
    for f in PARAM_FIELDS:
        row = a.reshape((-1,) + (1,) * (free[0][f].dim() - 1))
        assert torch.equal(frozen[0][f], torch.where(row, free[0][f], t(p)[f]))
        assert torch.equal(frozen[1][f], free[1][f]) and torch.equal(frozen[2][f], free[2][f])
    assert torch.equal(frozen[3], free[3])


def test_lr_tree_holds_the_jax_float32_values():
    got = to.make_lr_tree(*LRS)
    want = jo.make_lr_tree(*LRS)
    for f in PARAM_FIELDS:
        assert isinstance(got[f], float)
        assert np.float32(got[f]) == np.asarray(getattr(want, f)), f


def test_row_stride_takes_row_views_and_refuses_other_layouts():
    buf = torch.zeros((10, 16))
    assert to._row_stride(buf[:, 3:6], "g") == 16
    assert to._row_stride(torch.zeros((10, 48))[:, :45].reshape(10, 15, 3), "g") == 48
    assert to._row_stride(torch.zeros((10, 1)), "g") == 1
    with pytest.raises(ValueError, match="contiguous"):
        to._row_stride(torch.zeros((3, 10)).T, "g")

"""The port's functional Adam and LR schedule vs the JAX package's.

Same seeded numpy parameters, gradients, moments and per-row step counts
through `adam_update` (dense, and sparse with a visibility mask) and
`adam_update_dense`; atol 1e-6 on parameters and moments, step counts
exact. `expon_lr_func` is host Python on both sides: equal to rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsplat_tpu.core.types import GaussianParams
from gsplat_tpu.train import optim as jo
from gsplat_tpu.utils.general import expon_lr_func as j_expon
from gsplat_tpu_torch.convert import PARAM_FIELDS
from gsplat_tpu_torch.train import optim as to
from gsplat_tpu_torch.utils.general import expon_lr_func as t_expon

SHAPES = dict(xyz=(3,), features_dc=(1, 3), features_rest=(15, 3), scaling=(3,),
              rotation=(4,), opacity=(1,))


def trees(n, seed):
    rng = np.random.default_rng(seed)

    def tree(scale=1.0, positive=False):
        out = {}
        for k in PARAM_FIELDS:
            x = rng.standard_normal((n,) + SHAPES[k]).astype(np.float32) * scale
            out[k] = np.abs(x) if positive else x
        return out

    return tree(), tree(0.01), tree(0.001), tree(1e-5, positive=True)


def as_jax(tree):
    return GaussianParams(**{k: jnp.asarray(v) for k, v in tree.items()})


@pytest.mark.parametrize("sparse", [False, True])
def test_adam_update_matches_jax(sparse):
    n = 257
    p, g, m, v = trees(n, 1)
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 5, n).astype(np.int32)
    vis = rng.random(n) > 0.4
    lrs = (1.6e-4, 0.0025, 0.025, 0.005, 0.001)
    jp, jm, jv, jc = jo.adam_update(as_jax(p), as_jax(g), as_jax(m), as_jax(v),
                                    jnp.asarray(counts), jo.make_lr_tree(*lrs),
                                    visibility=jnp.asarray(vis) if sparse else None)
    t = {k: {f: torch.from_numpy(a[f]) for f in PARAM_FIELDS} for k, a in
         (("p", p), ("g", g), ("m", m), ("v", v))}
    tp, tm, tv, tc = to.adam_update(t["p"], t["g"], t["m"], t["v"], torch.from_numpy(counts),
                                    to.make_lr_tree(*lrs),
                                    visibility=torch.from_numpy(vis) if sparse else None)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for f in PARAM_FIELDS:
        for got, want in ((tp, jp), (tm, jm), (tv, jv)):
            np.testing.assert_allclose(got[f].numpy(), np.asarray(getattr(want, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
        if sparse:  # invisible rows untouched
            np.testing.assert_array_equal(tp[f].numpy()[~vis], p[f][~vis])
    assert not torch.equal(tp["xyz"], t["p"]["xyz"])


def test_adam_update_dense_matches_jax():
    rng = np.random.default_rng(3)
    param, grad, m = (rng.standard_normal((4, 3, 4)).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal((4, 3, 4)).astype(np.float32)) * 1e-3
    for step in (0, 7):
        want = jo.adam_update_dense(*map(jnp.asarray, (param, grad, m, v)), jnp.int32(step), 0.01)
        got = to.adam_update_dense(*map(torch.from_numpy, (param, grad, m, v)),
                                   torch.tensor(step, dtype=torch.int32), 0.01)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
        assert int(got[3]) == int(want[3]) == step + 1


@pytest.mark.parametrize("args", [
    dict(lr_init=1.6e-4 * 4.0, lr_final=1.6e-6 * 4.0, lr_delay_mult=0.01, max_steps=30000),
    dict(lr_init=0.01, lr_final=0.001, lr_delay_steps=100, lr_delay_mult=0.0, max_steps=500),
    dict(lr_init=1.0, lr_final=0.01, max_steps=30000),
    dict(lr_init=0.0, lr_final=0.0),
])
def test_expon_lr_func_matches_jax(args):
    tf, jf = t_expon(**args), j_expon(**args)
    for step in (-1, 0, 1, 50, 100, 499, 500, 7000, 30000, 40000):
        assert tf(step) == pytest.approx(jf(step), rel=1e-12, abs=0.0)

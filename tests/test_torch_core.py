"""Port core (activations, SH) vs the JAX package on the same numpy inputs.

Tolerances are those of `tests/test_sh_visibility.py:76-77` (rtol 2e-5,
atol 2e-6): the same float32 expressions, with `exp`/`sqrt`/reductions
rounded by two libraries.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsplat_tpu.core import activations as jact
from gsplat_tpu.core import sh as jsh
from gsplat_tpu_torch.core import activations as tact
from gsplat_tpu_torch.core import sh as tsh

RTOL, ATOL = 2e-5, 2e-6


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_normalize_rotation_and_covariance():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(257, 4)).astype(np.float32)
    s = np.exp(rng.normal(-3, 0.7, size=(257, 3))).astype(np.float32)
    _close(tact.normalize_rotation(torch.from_numpy(q)), jact.normalize_rotation(jnp.asarray(q)))
    for mod in (1.0, 0.5):
        _close(
            tact.covariance_from_scaling_rotation(torch.from_numpy(s), mod, torch.from_numpy(q)),
            jact.covariance_from_scaling_rotation(jnp.asarray(s), mod, jnp.asarray(q)),
        )


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh_color_matches(degree):
    rng = np.random.default_rng(degree)
    n = 300
    coeffs = (rng.normal(size=(n, 25, 3)) * 0.4).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    ct, mt = tsh.eval_sh_color(degree, torch.from_numpy(coeffs), torch.from_numpy(dirs))
    cj, mj = jsh.eval_sh_color(degree, jnp.asarray(coeffs), jnp.asarray(dirs))
    _close(ct, cj)
    # the clamp mask can only differ where the pre-clamp color rounds across 0
    assert (mt.numpy() != np.asarray(mj)).sum() <= 1
    _close(tsh.sh_to_rgb(torch.from_numpy(coeffs[:, 0])), jsh.sh_to_rgb(jnp.asarray(coeffs[:, 0])))

"""The port's densification and model init vs the JAX package's.

Hand-built static-capacity states (seeded numpy) with known clone, split
and prune sets go through both `densify_and_prune`s. The split children's
normal draws are the JAX package's own (`densify.py:146-150`: one key
split in two, one (C, 3) standard normal per child), fed to the port, so
the new rows must agree: masks, alive bits, step counts and Adam moments
exactly; parameters at atol 1e-6 (the child positions go through a
rotation product summed in a different order). `init_from_pcd` and
`mean_knn_sq_dist` are compared at rtol 1e-5, atol 1e-6: the KNN's squared
distances are |c|^2 - 2 c.p + |p|^2 in float32 on both sides, which cancel
to a few ulp of |p|^2 (points in [-1.3, 1.3]^3, so |p|^2 < 5.1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu import model as jmodel
from gsplat_tpu.core.spatial import mean_knn_sq_dist as j_knn
from gsplat_tpu.core.types import GaussianParams
from gsplat_tpu.train import densify as jd
from gsplat_tpu_torch import model as tmodel
from gsplat_tpu_torch.convert import PARAM_FIELDS
from gsplat_tpu_torch.core.spatial import mean_knn_sq_dist as t_knn
from gsplat_tpu_torch.train import densify as td


def make_state(seed, n_alive=160, capacity=256):
    """Rows of every kind: small and large scales (clone vs split), low and
    high opacity (prune), high and low gradients, random rotations."""
    rng = np.random.default_rng(seed)
    c = capacity
    scale = np.where(rng.random((c, 1)) < 0.5, 0.005, 0.05) * rng.uniform(0.5, 1.5, (c, 3))
    p = dict(
        xyz=rng.standard_normal((c, 3)),
        features_dc=rng.standard_normal((c, 1, 3)),
        features_rest=rng.standard_normal((c, 15, 3)) * 0.1,
        scaling=np.log(scale),
        rotation=rng.standard_normal((c, 4)),
        opacity=np.where(rng.random((c, 1)) < 0.1, -7.0, 2.0),
    )
    p = {k: v.astype(np.float32) for k, v in p.items()}
    alive = np.arange(c) < n_alive
    m = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.01 for k, v in p.items()}
    v = {k: np.abs(rng.standard_normal(x.shape)).astype(np.float32) * 1e-4 for k, x in p.items()}
    counts = rng.integers(0, 50, c).astype(np.int32)
    stats = dict(
        grad_accum=(rng.random(c) * 0.002).astype(np.float32),
        denom=rng.integers(0, 4, c).astype(np.float32),
        max_radii2d=rng.integers(0, 40, c).astype(np.int32),
    )
    return p, alive, m, v, counts, stats


def jax_tree(d):
    return GaussianParams(**{k: jnp.asarray(d[k]) for k in PARAM_FIELDS})


def torch_tree(d):
    return {k: torch.from_numpy(np.asarray(d[k])) for k in PARAM_FIELDS}


def jax_draws(key, c):
    key_a, key_b = jax.random.split(key)
    return np.stack([np.asarray(jax.random.normal(k, (c, 3))) for k in (key_a, key_b)])


@pytest.mark.parametrize("seed,capacity,max_screen", [(0, 256, 0), (1, 256, 20), (2, 180, 0)])
def test_densify_and_prune_matches_jax(seed, capacity, max_screen):
    p, alive, m, v, counts, stats = make_state(seed, capacity=capacity)
    key = jax.random.PRNGKey(seed)
    thr, min_op, extent, pd = 0.0002, 0.005, 2.0, 0.01
    jout = jd.densify_and_prune(jax_tree(p), jnp.asarray(alive), jax_tree(m), jax_tree(v),
                                jnp.asarray(counts), {k: jnp.asarray(x) for k, x in stats.items()},
                                key, thr, min_op, extent, max_screen, pd)
    tout = td.densify_and_prune(torch_tree(p), torch.from_numpy(alive), torch_tree(m),
                                torch_tree(v), torch.from_numpy(counts),
                                {k: torch.from_numpy(x) for k, x in stats.items()},
                                thr, min_op, extent, max_screen, pd,
                                normals=torch.from_numpy(jax_draws(key, capacity)))
    jp, ja, jm, jv, jc, js, jinfo = jout
    tp, ta, tm, tv, tc, ts, tinfo = tout
    for k in ("n_cloned", "n_split", "n_pruned", "n_dropped", "n_alive"):
        assert tinfo[k] == int(jinfo[k]), k
    assert tinfo["n_cloned"] > 0 and tinfo["n_split"] > 0 and tinfo["n_pruned"] > 0
    if capacity == 180:
        assert tinfo["n_dropped"] > 0  # capacity exhausted: children lost
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(tp[f].numpy(), np.asarray(getattr(jp, f)), rtol=0, atol=1e-6,
                                   err_msg=f)
        np.testing.assert_array_equal(tm[f].numpy(), np.asarray(getattr(jm, f)), err_msg=f)
        np.testing.assert_array_equal(tv[f].numpy(), np.asarray(getattr(jv, f)), err_msg=f)
    for k in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


def test_split_draws_come_from_the_generator():
    """Without given normals the children are drawn from the generator:
    one seed gives one result, another seed another."""
    p, alive, m, v, counts, stats = make_state(0)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return td.densify_and_prune(torch_tree(p), torch.from_numpy(alive), torch_tree(m),
                                    torch_tree(v), torch.from_numpy(counts),
                                    {k: torch.from_numpy(x) for k, x in stats.items()},
                                    0.0002, 0.005, 2.0, 0, generator=gen)[0]["xyz"]

    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))


def test_stats_sanitize_and_reset_opacity_match_jax():
    p, alive, m, v, counts, stats = make_state(3)
    rng = np.random.default_rng(9)
    c = alive.shape[0]
    norm = rng.random(c).astype(np.float32)
    vis = rng.random(c) > 0.5
    radii = rng.integers(0, 60, c).astype(np.int32)
    jstats = jd.accumulate_stats({k: jnp.asarray(x) for k, x in stats.items()},
                                 jnp.asarray(norm), jnp.asarray(vis), jnp.asarray(radii))
    tstats = td.accumulate_stats({k: torch.from_numpy(x) for k, x in stats.items()},
                                 torch.from_numpy(norm), torch.from_numpy(vis),
                                 torch.from_numpy(radii))
    for k in jstats:
        np.testing.assert_array_equal(tstats[k].numpy(), np.asarray(jstats[k]), err_msg=k)
    zs = td.zero_stats(c)
    assert all(not zs[k].any() and zs[k].shape == (c,) for k in zs)

    jsan = jd.sanitize_dead_rows(jax_tree(p), jnp.asarray(alive))
    tsan = td.sanitize_dead_rows(torch_tree(p), torch.from_numpy(alive))
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(tsan[f].numpy(), np.asarray(getattr(jsan, f)), err_msg=f)

    jp, jm, jv = jd.reset_opacity(jax_tree(p), jnp.asarray(alive), jax_tree(m), jax_tree(v))
    tp, tm, tv = td.reset_opacity(torch_tree(p), torch.from_numpy(alive), torch_tree(m),
                                  torch_tree(v))
    np.testing.assert_allclose(tp["opacity"].numpy(), np.asarray(jp.opacity), rtol=1e-6, atol=1e-6)
    assert not tm["opacity"].any() and not tv["opacity"].any()
    np.testing.assert_array_equal(tm["xyz"].numpy(), m["xyz"])


@pytest.mark.parametrize("n,capacity", [(700, None), (300, 1024)])
def test_init_from_pcd_matches_jax(n, capacity):
    rng = np.random.default_rng(n)
    pts = (rng.random((n, 3)) * 2.6 - 1.3).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    np.testing.assert_allclose(t_knn(torch.from_numpy(pts), chunk=128).numpy(),
                               np.asarray(j_knn(jnp.asarray(pts), chunk=128)), rtol=1e-5, atol=1e-6)
    jp, ja = jmodel.init_from_pcd(pts, cols, max_sh_degree=3, capacity=capacity)
    tp, ta = tmodel.init_from_pcd(pts, cols, max_sh_degree=3, capacity=capacity, device="cpu")
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(tp[f].numpy(), np.asarray(getattr(jp, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(tmodel.init_exposure(4, device="cpu").numpy(),
                                  np.asarray(jmodel.init_exposure(4)))

"""The port's multi-device path (`gsplat_tpu_torch/parallel/`) on the CPU:
ranks spawned as processes (gloo, one intra-op thread each), the JAX side
in the test process on the 8 virtual devices of `tests/conftest.py`.

The scene is `tests/test_parallel.py`'s: `make_test_scene(rng 5, n=2048,
128x128, SH 2)`, backend "jnp" (float32 packets on the port's side: the jnp
backend has no packet rounding). One spawn per mesh shape, (4, 2), (2, 4),
(1, 4) and a padded (1, 3) at 128x112 (7 tile rows over 3 bands of 3).

Against the port's single-device result, `tests/test_parallel.py`'s
tolerances (what that file holds the JAX pipeline to against the JAX
single-device render): render and invdepth atol 1e-6, radii equal;
gradients of sum(render^2) max |error| / max |gradient| below 1e-5; one
train step loss rtol 1e-5, params atol 2e-5, `grad_accum` atol 1e-5; the
band exchange against the full gather: render bit for bit, params rtol
1e-5, atol 1e-7.

Against the JAX package (single-device render and, where its tile rows
divide, its `make_sharded_render` on the same mesh shape; single-device
gradients and step): radii equal, render and invdepth atol 1e-6 at every
pixel where the port's single-device render meets JAX's at 1e-6; loss
rtol 1e-5 and `grad_accum` atol 1e-5; gradients within relative 5e-5,
the port's render-gradient tolerance against JAX
(`tests/test_torch_train_step.py`). The port's single-device render and
JAX's differ on this scene beyond test_parallel's tolerances, mesh or not:
at 2 of 16,384 pixels a (pixel, gaussian) alpha lies within rounding of
the 1/255 cut (gaussian 1441 at pixel (36, 61): 255 alpha = 0.99999892)
and the two packages' exp round it to opposite sides (1.4e-3 there); the
rotation gradient differs by 3.7e-5 relative; and the first Adam step
from zero moments moves a row by +-lr by the sign of its gradient, so a
gradient near 0 moves a parameter by up to 2 lr (0.01 in `scaling`).
Those pixels and the parameters are held to the port's single-device
result only.

Then the two collectives' transposes on a 2x2 mesh (a band's and a row's
cotangent counted once, not T or G times: exact), and both dryruns.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.parallel import comm

PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
WIDTH = 128
# mesh shape -> image height (112: 7 tile rows, padded to 9 over 3 bands)
SHAPES = {(4, 2): 128, (2, 4): 128, (1, 4): 128, (1, 3): 112}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX = {}


def jax_reference(height):
    """The JAX single-device render, gradients and train step at
    128 x `height`, and the port's inputs, as numpy."""
    if height in _JAX:
        return _JAX[height]
    import jax
    import jax.numpy as jnp

    from gsplat_tpu.config import OptimizationConfig
    from gsplat_tpu.core.types import make_render_settings
    from gsplat_tpu.render import render
    from gsplat_tpu.train import step as jstep
    from tests.oracle.reference_math import make_test_scene
    from tests.test_forward_vs_oracle import scene_to_inputs

    sc = make_test_scene(np.random.default_rng(5), n=2048, width=WIDTH, height=height,
                         sh_degree=2)
    params, camera, alive = scene_to_inputs(sc)
    js = make_render_settings(sh_degree=2, max_per_tile=512, instance_capacity=1 << 16,
                              backend="jnp")
    zeros3 = jnp.zeros(3)
    out = jax.jit(lambda p, a: render(camera, p, a, js, zeros3))(params, alive)
    grads = jax.jit(jax.grad(
        lambda p: (render(camera, p, alive, js, zeros3)["render"] ** 2).sum()))(params)
    gt = np.random.default_rng(9).random((height, WIDTH, 3), np.float32)
    ones = np.ones((height, WIDTH, 1), np.float32)
    zeros = np.zeros((height, WIDTH), np.float32)
    state, metrics = jstep.make_train_step(OptimizationConfig(), js)(
        jstep.init_train_state(params, alive, num_images=4), camera, jnp.asarray(gt),
        jnp.asarray(ones), jnp.asarray(zeros), jnp.asarray(zeros), zeros3,
        jnp.float32(1e-3), jnp.float32(1e-3), jnp.float32(0.0), jnp.int32(0))
    _JAX[height] = ref = dict(
        params={f: np.asarray(getattr(params, f)) for f in PARAMS},
        camera=dict(world_view=np.asarray(camera.world_view),
                    full_proj=np.asarray(camera.full_proj),
                    camera_center=np.asarray(camera.camera_center),
                    tan_fovx=np.asarray(camera.tan_fovx), tan_fovy=np.asarray(camera.tan_fovy),
                    width=camera.width, height=camera.height),
        alive=np.asarray(alive), gt=gt,
        render=np.asarray(out["render"]), invdepth=np.asarray(out["invdepth"]),
        radii=np.asarray(out["radii"]), grads={f: np.asarray(getattr(grads, f)) for f in PARAMS},
        loss=float(metrics["loss"]),
        grad_accum=np.asarray(state.stats["grad_accum"]),
        jax_objects=(params, camera, alive, js),
    )
    return ref


def jax_sharded_render(ref, shape):
    """The JAX explicit pipeline's render on a (G, T) mesh of the virtual
    devices."""
    import jax
    import jax.numpy as jnp

    from gsplat_tpu.parallel.pipeline import make_sharded_render
    from gsplat_tpu.parallel.sharding import make_mesh, shard_params

    params, camera, alive, js = ref["jax_objects"]
    mesh = make_mesh(n_gauss=shape[0], n_tile=shape[1],
                     devices=jax.devices()[:shape[0] * shape[1]])
    sp, sa = shard_params(params, alive, mesh)
    out = jax.jit(make_sharded_render(mesh, js, camera.width, camera.height))(
        camera, sp, sa, jnp.zeros(3))
    return np.asarray(out["render"])


def _port_inputs(inp):
    from gsplat_tpu_torch.convert import camera_from_numpy, params_from_numpy

    return (params_from_numpy(inp["params"], "cpu"), camera_from_numpy(**inp["camera"],
                                                                       device="cpu"),
            torch.tensor(inp["alive"]))


def _grad_render(render_fn, camera, params, alive):
    """The render (detached) and the gradients of sum(render^2) w.r.t.
    fresh leaves of `params`."""
    leaves = {k: getattr(params, k).detach().clone().requires_grad_(True) for k in PARAMS}
    out = render_fn(camera, SimpleNamespace(**leaves), alive)
    (out["render"] ** 2).sum().backward()
    return ({k: out[k].detach().numpy() for k in ("render", "invdepth", "radii")},
            {k: v.grad.numpy() for k, v in leaves.items()})


def _step_args(inp, camera):
    h, w = camera.height, camera.width
    return (camera, torch.tensor(inp["gt"]), torch.ones((h, w, 1)), torch.zeros((h, w)),
            torch.zeros((h, w)), torch.zeros(3), 1e-3, 1e-3, 0.0, 0)


def _step_out(state, metrics):
    return {"loss": float(metrics["loss"]), "grad_accum": state.stats["grad_accum"].numpy(),
            "params": {k: v.numpy() for k, v in state.params.items()}}


_PORT = {}


def port_reference(height):
    """The port's single-device render, gradients and train step on the
    JAX reference's inputs."""
    if height not in _PORT:
        from gsplat_tpu_torch.config import OptimizationConfig
        from gsplat_tpu_torch.core.types import make_render_settings
        from gsplat_tpu_torch.render import render
        from gsplat_tpu_torch.train.step import init_train_state, make_train_step

        inp = jax_reference(height)
        params, camera, alive = _port_inputs(inp)
        st = make_render_settings(sh_degree=2)
        out, grads = _grad_render(
            lambda c, p, a: render(c, p, a, st, [0.0, 0.0, 0.0], device="cpu"),
            camera, params, alive)
        state = init_train_state({k: getattr(params, k).detach().clone() for k in PARAMS},
                                 alive, num_images=4)
        step = _step_out(*make_train_step(OptimizationConfig(), st)(state,
                                                                    *_step_args(inp, camera)))
        _PORT[height] = {"out": out, "grads": grads, "step": step}
    return _PORT[height]


def _rank_checks(inp, shape):
    """One rank of a (G, T) gloo mesh on the CPU: the sharded render with
    the gradients of sum(render^2) w.r.t. this rank's rows (full gather),
    the band exchange's render, and one pipeline train step each way."""
    from gsplat_tpu_torch.config import OptimizationConfig
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.parallel import pipeline, sharding
    from gsplat_tpu_torch.train.step import init_train_state

    mesh = sharding.make_mesh(*shape, backend="gloo", device="cpu")
    params, camera, alive = _port_inputs(inp)
    h, w = camera.height, camera.width
    st = make_render_settings(sh_degree=2)
    lp, la = sharding.shard_params(params, alive, mesh)
    rows = sharding.param_spec(mesh, alive.shape[0])
    bg = torch.zeros(3)
    full = pipeline.make_sharded_render(mesh, st, w, h)
    out, grads = _grad_render(lambda c, p, a: full(c, p, a, bg), camera, lp, la)
    with torch.no_grad():
        band = pipeline.make_sharded_render(mesh, st, w, h, exchange_capacity=1)(
            camera, lp, la, bg)
    res = {"rows": (rows.start, rows.stop), "full": out, "grads": grads,
           "band": {k: band[k].numpy() for k in ("render", "invdepth", "radii")}}
    state = init_train_state({k: getattr(params, k).detach().clone() for k in PARAMS}, alive,
                             num_images=4)
    for name, exch in (("step", None), ("band_step", 1)):
        step = pipeline.make_pipeline_train_step(mesh, OptimizationConfig(), st, w, h,
                                                 exchange_capacity=exch)
        res[name] = _step_out(*step(sharding.place_train_state(mesh, state),
                                    *_step_args(inp, camera)))
    return res


def _assemble(results, get):
    """The whole (capacity, ...) array from each rank's `get(result)` of its
    own rows."""
    first = get(results[0])
    full = np.zeros((max(r["rows"][1] for r in results),) + first.shape[1:], first.dtype)
    for r in results:
        a, b = r["rows"]
        full[a:b] = get(r)
    return full


def rel_err(want, got):
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-8))


@pytest.mark.parametrize("shape", list(SHAPES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_torch_mesh_matches_single_device_and_jax(shape):
    ref = jax_reference(SHAPES[shape])
    port = port_reference(SHAPES[shape])
    inp = {k: ref[k] for k in ("params", "camera", "alive", "gt")}
    results = comm.run_ranks(_rank_checks, shape[0] * shape[1], "gloo", args=(inp, shape),
                             threads=1, timeout=300)
    gy = -(-SHAPES[shape] // 16)
    jax_pipeline = jax_sharded_render(ref, shape) if gy % shape[1] == 0 else None
    # the pixels where the two packages' single-device renders meet
    agree = np.abs(port["out"]["render"] - ref["render"]).max(axis=-1) <= 1e-6
    assert agree.mean() > 0.999
    for r in results:
        a, b = r["rows"]
        for k in ("render", "invdepth"):
            np.testing.assert_allclose(r["full"][k], port["out"][k], atol=1e-6, err_msg=k)
            np.testing.assert_allclose(r["full"][k][agree], ref[k][agree], atol=1e-6, err_msg=k)
            # the band exchange renders the full gather's image bit for bit
            np.testing.assert_array_equal(r["band"][k], r["full"][k], err_msg=k)
        if jax_pipeline is not None:
            np.testing.assert_allclose(r["full"]["render"][agree], jax_pipeline[agree], atol=1e-6)
        for radii in (r["full"]["radii"], r["band"]["radii"]):
            np.testing.assert_array_equal(radii, ref["radii"][a:b])
            np.testing.assert_array_equal(radii, port["out"]["radii"][a:b])
        for name in ("step", "band_step"):
            np.testing.assert_allclose(r[name]["loss"], port["step"]["loss"], rtol=1e-5)
            np.testing.assert_allclose(r[name]["loss"], ref["loss"], rtol=1e-5)
    for f in PARAMS:
        got = _assemble(results, lambda r: r["grads"][f])
        assert rel_err(port["grads"][f], got) < 1e-5, f
        assert rel_err(ref["grads"][f], got) < 5e-5, f
        step = _assemble(results, lambda r: r["step"]["params"][f])
        np.testing.assert_allclose(step, port["step"]["params"][f], atol=2e-5, err_msg=f)
        np.testing.assert_allclose(_assemble(results, lambda r: r["band_step"]["params"][f]), step,
                                   rtol=1e-5, atol=1e-7, err_msg=f"band exchange params.{f}")
    got = _assemble(results, lambda r: r["step"]["grad_accum"])
    np.testing.assert_allclose(got, port["step"]["grad_accum"], atol=1e-5)
    np.testing.assert_allclose(got, ref["grad_accum"], atol=1e-5)


def _collective_checks():
    """A 2x2 mesh: the rank layout, the two gathers and their transposes
    (exact: small integers), and a state placed and gathered again."""
    from gsplat_tpu_torch.parallel import sharding
    from gsplat_tpu_torch.train.step import init_train_state

    mesh = sharding.make_mesh(2, 2, backend="gloo", device="cpu")
    g, t = mesh.coords["gauss"], mesh.coords["tile"]
    out = {"coords": (g, t), "rank": mesh.rank}
    # bands: every rank computes the same loss on the gathered image, so the
    # cotangent of its band is that band's slice of W, not T times it
    w = torch.arange(1.0, 13.0).reshape(4, 3, 1)
    band = torch.full((2, 3, 1), float(t), requires_grad=True)
    img = comm.gather_bands(band, mesh)
    (img * w).sum().backward()
    out["image"], out["band_grad"] = img.detach(), band.grad
    # rows: the ranks of a tile column hold the same cotangent of the
    # gathered rows; a row's gradient sums its column copies once and the
    # columns' (bands') cotangents over the tile group
    base = torch.arange(1.0, 13.0).reshape(6, 2)
    for name, sel, sizes in (("rows", None, [3, 3]), ("compact", torch.tensor([0, 2]), [2, 2])):
        x = (torch.arange(6.0).reshape(3, 2) + 10 * g).requires_grad_(True)
        gathered = comm.gather_rows(x, sizes, mesh, ("gauss",), sel=sel)
        (gathered * (t + 1) * base[:sum(sizes)]).sum().backward()
        out[name] = (gathered.detach(), x.grad)
    # a state placed on the mesh and gathered again, bit for bit
    gen = torch.Generator().manual_seed(3)
    params = {k: torch.randn((8,) + s, generator=gen) for k, s in (
        ("xyz", (3,)), ("features_dc", (1, 3)), ("features_rest", (3, 3)), ("scaling", (3,)),
        ("rotation", (4,)), ("opacity", (1,)))}
    state = init_train_state(params, torch.rand(8, generator=gen) > 0.3, num_images=2)
    state.stats = {k: (torch.rand(v.shape, generator=gen) * 10).to(v.dtype)
                   for k, v in state.stats.items()}
    back = sharding.gather_train_state(mesh, sharding.place_train_state(mesh, state))

    def leaves(st):
        for k in sharding.ROW_LEAVES + ("exposure", "exp_m", "exp_v", "exp_step"):
            v = getattr(st, k)
            yield from (v.values() if isinstance(v, dict) else [v])

    out["roundtrip"] = all(torch.equal(x, y) for x, y in zip(leaves(back), leaves(state)))
    return out


def test_torch_mesh_collectives_count_each_cotangent_once():
    results = comm.run_ranks(_collective_checks, 4, "gloo", threads=1, timeout=120)
    w = torch.arange(1.0, 13.0).reshape(4, 3, 1)
    base = torch.arange(1.0, 13.0).reshape(6, 2)
    for r in results:
        g, t = r["coords"]
        assert (g, t) == divmod(r["rank"], 2)  # `devices.reshape(G, T)`
        # the image is both bands; a band's gradient is its slice of W
        assert torch.equal(r["image"][:, :, 0], torch.tensor([[0.0] * 3] * 2 + [[1.0] * 3] * 2))
        assert torch.equal(r["band_grad"], w[2 * t:2 * t + 2])
        gathered, grad = r["rows"]
        assert torch.equal(gathered, torch.cat([torch.arange(6.0).reshape(3, 2) + 10 * k
                                                for k in range(2)]))
        # tile columns 0 and 1 weigh the rows by 1 and 2: the sum is 3x once
        assert torch.equal(grad, 3 * base[3 * g:3 * g + 3])
        gathered, grad = r["compact"]
        assert torch.equal(gathered, torch.cat([(torch.arange(6.0).reshape(3, 2) + 10 * k)[[0, 2]]
                                                for k in range(2)]))
        want = torch.zeros(3, 2)
        want[[0, 2]] = 3 * base[2 * g:2 * g + 2]
        assert torch.equal(grad, want)
        assert r["roundtrip"]


def test_torch_dryrun_multichip():
    from gsplat_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(4, device="cpu")
    assert out["mesh"] == "2x2" and set(out["shapes"]) == {"4x1", "2x2", "1x4"}


def test_torch_dryrun_multihost():
    from gsplat_tpu_torch.entry import dryrun_multihost

    out = dryrun_multihost(8, 2, device="cpu")
    assert out["axes"] == ["host", "gauss", "tile"] and out["mesh"] == "2x2x2"

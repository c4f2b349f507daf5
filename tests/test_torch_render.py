"""The port's whole render path vs the JAX package.

- `render(..., device="cpu")` vs `gsplat_tpu.render.render(backend="jnp")`
  at atol 2e-5 (the blend tolerance of `tests/test_pallas_blend.py:62-66`),
  with bg 0 and 1 and with an exposure, on a size that is not a multiple
  of 16; the JAX side must report no overflow.
- the port's seeded scene generator equals `__graft_entry__._tiny_scene`;
- the port's render CLI against the top-level `render.py` on one PLY;
- `mark_visible` equals the JAX package's;
- every module of the port imports with `jax` blocked.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.core.types import make_render_settings as j_settings
from gsplat_tpu.render import render as j_render
from gsplat_tpu_torch.core.types import make_render_settings as t_settings
from gsplat_tpu_torch.render import render as t_render
from tests.oracle.reference_math import make_test_scene
from tests.test_forward_vs_oracle import scene_to_inputs
from tests.test_torch_projection import port_inputs

ROOT = Path(__file__).resolve().parents[1]
ATOL = 2e-5


def scene(n=500, width=100, height=76, seed=9):
    sc = make_test_scene(np.random.default_rng(seed), n=n, width=width,
                         height=height, sh_degree=3)
    params, camera, alive = scene_to_inputs(sc)
    return params, camera, alive.at[::5].set(False)


def render_both(params, camera, alive, bg, exposure=None, backend="jnp", **kw):
    js = j_settings(sh_degree=3, max_per_tile=1024, instance_capacity=1 << 14,
                    backend=backend, **kw)
    jexp = None if exposure is None else jnp.asarray(exposure)
    jo = jax.jit(lambda p, a: j_render(camera, p, a, js, jnp.asarray(bg), exposure=jexp))(
        params, alive)
    assert int(jo["instance_overflow"]) == 0 and int(jo["tile_overflow"]) == 0
    tp, tc, ta = port_inputs(params, camera, alive)
    with torch.no_grad():
        to = t_render(tc, tp, ta, t_settings(sh_degree=3, **kw), bg,
                      exposure=exposure, device="cpu")
    return jo, to


def assert_render_close(jo, to):
    for key in ("render", "invdepth", "final_t"):
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]), atol=ATOL, err_msg=key)
    np.testing.assert_array_equal(to["radii"].numpy(), np.asarray(jo["radii"]))
    np.testing.assert_array_equal(to["visibility"].numpy(), np.asarray(jo["visibility"]))
    assert to["num_instances"] == int(jo["num_instances"])
    assert to["instance_overflow"] == 0 and to["tile_overflow"] == 0


@pytest.mark.parametrize("bg", [0.0, 1.0])
def test_render_matches_jax_jnp(bg):
    params, camera, alive = scene()
    jo, to = render_both(params, camera, alive, [bg] * 3)
    assert to["render"].shape == (76, 100, 3)
    assert_render_close(jo, to)


def test_render_with_exposure_matches_jax_jnp():
    params, camera, alive = scene()
    exposure = np.eye(3, 4, dtype=np.float32)
    exposure[:3, :3] *= np.float32(1.3)
    exposure[:3, 3] = [0.05, -0.02, 0.01]
    jo, to = render_both(params, camera, alive, [0.2, 0.4, 0.6], exposure=exposure)
    assert_render_close(jo, to)


def test_render_empty_scene_is_background():
    params, camera, alive = scene(n=50)
    tp, tc, _ = port_inputs(params, camera, alive)
    bg = [0.25, 0.5, 0.75]
    with torch.no_grad():
        out = t_render(tc, tp, torch.zeros(50, dtype=torch.bool), t_settings(), bg, device="cpu")
    assert out["num_instances"] == 0
    np.testing.assert_array_equal(out["render"].numpy(), np.broadcast_to(np.float32(bg), (76, 100, 3)))
    assert np.all(out["invdepth"].numpy() == 0)


def test_render_refuses_unported_settings():
    """bf16 packets render, within the bounds the JAX package holds its own
    bf16 packets to (`test_pallas_blend.py:143-160`: max 0.1, mean 5e-3 of
    the float32 render); without a card the default device refuses."""
    params, camera, alive = scene(n=50)
    tp, tc, ta = port_inputs(params, camera, alive)
    with torch.no_grad():
        bf = t_render(tc, tp, ta, t_settings(packet_dtype="bfloat16"), [0, 0, 0], device="cpu")
        f32 = t_render(tc, tp, ta, t_settings(), [0, 0, 0], device="cpu")
    d = (bf["render"] - f32["render"]).abs()
    assert torch.isfinite(bf["render"]).all()
    assert 0 < float(d.max()) < 0.1 and float(d.mean()) < 5e-3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_render(tc, tp, ta, t_settings(), [0, 0, 0])


def test_tiny_scene_matches_graft_entry():
    from __graft_entry__ import _tiny_scene
    from gsplat_tpu_torch.synthetic import tiny_scene

    jp, ja, jc = _tiny_scene(n=300, width=64, height=48, sh_degree=3, capacity=320)
    tp, ta, tc = tiny_scene(n=300, width=64, height=48, sh_degree=3, capacity=320, device="cpu")
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(getattr(tp, f).detach().numpy(), np.asarray(getattr(jp, f)), err_msg=f)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for f in ("world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), err_msg=f)
    assert (tc.width, tc.height) == (jc.width, jc.height)


def _write_snapshot(model_dir, n=400, seed=1):
    from gsplat_tpu_torch.data.ply import save_gaussian_ply

    rng = np.random.default_rng(seed)
    pc = Path(model_dir) / "point_cloud" / "iteration_7"
    pc.mkdir(parents=True)
    save_gaussian_ply(
        str(pc / "point_cloud.ply"),
        (rng.normal(size=(n, 3)) * 0.6).astype(np.float32),
        rng.normal(0, 0.8, (n, 1, 3)).astype(np.float32),
        rng.normal(0, 0.05, (n, 15, 3)).astype(np.float32),
        rng.normal(0.5, 1.0, (n, 1)).astype(np.float32),
        np.log(rng.uniform(0.03, 0.15, (n, 3))).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
    )


def test_render_cli_matches_jax_cli(mini_blender, tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.syspath_prepend(str(ROOT))
    import render as jax_cli
    from gsplat_tpu_torch.cli import render as port_cli

    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path / side
        _write_snapshot(dirs[side])
    assert jax_cli.main(["-m", str(dirs["jax"]), "-s", mini_blender,
                         "--backend", "jnp", "--skip_test"]) == 0
    assert port_cli.main(["-m", str(dirs["port"]), "-s", mini_blender,
                          "--device", "cpu", "--skip_test"]) == 0
    sub = Path("train") / "ours_7" / "renders"
    names = sorted(os.listdir(dirs["jax"] / sub))
    assert len(names) == 6 and names == sorted(os.listdir(dirs["port"] / sub))
    assert len(os.listdir(dirs["port"] / "train" / "ours_7" / "gt")) == 6
    for nm in names:
        a = np.asarray(Image.open(dirs["jax"] / sub / nm), np.int16)
        b = np.asarray(Image.open(dirs["port"] / sub / nm), np.int16)
        assert a.shape == b.shape == (48, 48, 3)
        assert np.abs(a - b).max() <= 1, nm
        assert a.std() > 0  # the views show gaussians, not just background


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import gsplat_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(gsplat_tpu_torch.__path__, 'gsplat_tpu_torch.')]\n"
        "for m in names: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'gsplat_tpu' or m.startswith('gsplat_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


@pytest.mark.slow
def test_render_matches_jax_pallas_interpret():
    """The whole render against the JAX package's production path (Pallas
    kernels K1 and K2 in interpret mode on the CPU)."""
    params, camera, alive = scene(n=300, width=64, height=48)
    jo, to = render_both(params, camera, alive, [0.0] * 3, backend="pallas",
                         track_contrib=True)
    assert_render_close(jo, to)


def test_mark_visible_matches_jax():
    from gsplat_tpu.render import mark_visible as j_mark_visible
    from gsplat_tpu_torch.render import mark_visible as t_mark_visible

    params, camera, alive = scene(n=400)
    _, tc, _ = port_inputs(params, camera, alive)
    pos = np.asarray(params.xyz) * np.float32(3.0)  # some behind the near plane
    got = t_mark_visible(torch.from_numpy(pos), tc).numpy()
    want = np.asarray(j_mark_visible(jnp.asarray(pos), camera))
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got, want)

"""The port's LPIPS and metrics CLI against the JAX package's, on the CPU.

- `eval/lpips.py` against `gsplat_tpu/eval/lpips_jax.py` on the synthetic
  VGG-shaped weights of `tests/test_lpips.py` (same `.npz`, same
  `GSPLAT_LPIPS_WEIGHTS`): rtol 1e-5; LPIPS(x, x) ~ 0;
- no weights: `lpips_available()` is False and `_load_weights` raises; the
  metrics CLI reports LPIPS null with `LPIPS_status`, and raises when the
  variable names a missing file;
- `python -m gsplat_tpu_torch.cli.metrics` against the top-level
  `metrics.py` on the same render dirs: `results.json` and `per_view.json`
  with the same keys and values within rtol 1e-5.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import gsplat_tpu.eval.lpips_jax as JL
import gsplat_tpu_torch.eval.lpips as TL
from tests.test_lpips import make_weights
from tests.test_torch_train_loop import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture()
def synthetic_weights(tmp_path, monkeypatch):
    path = str(tmp_path / "lpips_synth.npz")
    make_weights(np.random.default_rng(0), path)
    monkeypatch.setenv("GSPLAT_LPIPS_WEIGHTS", path)
    JL._load_weights.cache_clear()
    TL._load_weights.cache_clear()
    yield path
    JL._load_weights.cache_clear()
    TL._load_weights.cache_clear()


def test_lpips_matches_jax(synthetic_weights):
    rng = np.random.default_rng(7)
    img1 = rng.random((40, 48, 3)).astype(np.float32)
    img2 = np.clip(img1 + rng.normal(0, 0.1, img1.shape), 0, 1).astype(np.float32)
    want = float(JL.lpips(img1, img2))
    got = TL.lpips(torch.from_numpy(img1), torch.from_numpy(img2))
    assert got.shape == () and want > 1e-5
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    assert abs(float(TL.lpips(torch.from_numpy(img1), torch.from_numpy(img1)))) < 1e-7


def write_model(root, rng, n=2, size=(32, 40)):
    mdir = root / "test" / "ours_7"
    for sub in ("renders", "gt"):
        (mdir / sub).mkdir(parents=True)
    for i in range(n):
        a = (rng.random((*size, 3)) * 255).astype(np.uint8)
        b = np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.uint8)
        Image.fromarray(a).save(mdir / "renders" / f"{i:05d}.png")
        Image.fromarray(b).save(mdir / "gt" / f"{i:05d}.png")
    return str(root)


def read_results(model):
    with open(f"{model}/results.json") as f, open(f"{model}/per_view.json") as g:
        return json.load(f), json.load(g)


def test_lpips_unavailable_and_missing_file(tmp_path, monkeypatch):
    from gsplat_tpu_torch.cli import metrics as cli

    model = write_model(tmp_path / "model", np.random.default_rng(1), n=1)
    monkeypatch.delenv("GSPLAT_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(TL, "weights_path", lambda: None)
    TL._load_weights.cache_clear()
    assert not TL.lpips_available()
    with pytest.raises(FileNotFoundError):
        TL._load_weights(torch.device("cpu"))
    assert cli.main(["-m", model, "--device", "cpu"]) == 0
    results, per_view = read_results(model)
    assert results["ours_7"]["LPIPS"] is None
    assert results["ours_7"]["LPIPS_status"] == "weights_unavailable"
    assert per_view["ours_7"]["LPIPS"] == {"00000.png": None}

    monkeypatch.setenv("GSPLAT_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        cli.main(["-m", model, "--device", "cpu"])


def test_metrics_cli_matches_metrics_py(synthetic_weights, tmp_path):
    import metrics as jax_cli
    from gsplat_tpu_torch.cli import metrics as cli

    rng = np.random.default_rng(3)
    models = [write_model(tmp_path / name, rng) for name in ("port", "jax")]
    for model in models[1:]:  # the same PNGs in both dirs
        for sub in ("renders", "gt"):
            for i in range(2):
                src = f"{models[0]}/test/ours_7/{sub}/{i:05d}.png"
                Image.open(src).save(f"{model}/test/ours_7/{sub}/{i:05d}.png")
    assert cli.main(["-m", models[0], "--device", "cpu"]) == 0
    assert jax_cli.main(["-m", models[1]]) == 0
    got, want = read_results(models[0]), read_results(models[1])
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"ours_7"}
        for metric, val in w["ours_7"].items():
            if isinstance(val, dict):
                assert set(g["ours_7"][metric]) == set(val)
                np.testing.assert_allclose([g["ours_7"][metric][k] for k in sorted(val)],
                                           [val[k] for k in sorted(val)], rtol=1e-5,
                                           err_msg=metric)
            else:
                np.testing.assert_allclose(g["ours_7"][metric], val, rtol=1e-5, err_msg=metric)
    assert set(got[0]["ours_7"]) == {"SSIM", "PSNR", "LPIPS"}

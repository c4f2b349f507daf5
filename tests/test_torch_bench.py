"""The port's bench (`python -m gsplat_tpu_torch.bench`) and entry point
(`gsplat_tpu_torch.entry.entry`) on the CPU.

- `profiling.interval_union`, which both the bench's device times and
  `chip_smoke.py`'s busy shares rest on.
- The bench at a small size on `--device cpu` prints one JSON line with
  the top-level `bench.py`'s keys, every rate finite and positive, and no
  device time (a CPU run measures no device); with no card and no
  `--device` it raises.
- `entry("cpu")` renders the same image as the JAX package's
  `__graft_entry__.entry()` (which falls back to its jnp path on the CPU),
  within atol 2e-5, the blend tolerance of `tests/test_pallas_blend.py`.
"""

import contextlib
import io
import json
import math

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import bench


def test_bench_cpu_rehearsal_prints_bench_keys():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench.main(["--device", "cpu", "--n", "512", "--width", "64", "--height", "48"]) == 0
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline", "points"} <= set(res)
    pts = res["points"]
    assert set(pts) == {"1M_gauss", "1M_gauss_f32_parity", "262k_gauss", "render_only"}
    assert set(pts["render_only"]) == {"1M_gauss_1080p"}
    rows = [pts["1M_gauss"], pts["1M_gauss_f32_parity"], pts["262k_gauss"],
            pts["render_only"]["1M_gauss_1080p"]]
    for row in rows:
        assert math.isfinite(row["pixels_per_s"]) and row["pixels_per_s"] > 0
        assert row["ms"] > 0 and row["device_ms"] is None
    assert {"instances", "ns_per_instance"} <= set(pts["1M_gauss"])
    assert {"instances", "ns_per_instance", "vs_baseline"} <= set(pts["262k_gauss"])
    assert pts["262k_gauss"]["gaussians"] == 128 and pts["1M_gauss"]["instances"] > 0
    assert res["value"] == pts["1M_gauss"]["pixels_per_s"]
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "nvidia_smi": None}


def test_interval_union():
    from gsplat_tpu_torch.profiling import interval_union

    assert interval_union([]) == 0.0
    assert interval_union([(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (6.0, 6.5), (9.0, 10.0)]) == 6.0


def test_bench_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_entry_matches_jax_entry():
    import jax

    from __graft_entry__ import entry as j_entry
    from gsplat_tpu_torch.entry import entry as t_entry

    jfn, jargs = j_entry()
    tfn, targs = t_entry("cpu")
    want = np.asarray(jax.jit(jfn)(*jargs))
    with torch.no_grad():
        got = tfn(*targs).numpy()
    assert got.shape == want.shape == (192, 256, 3)
    assert got.std() > 0.01
    np.testing.assert_allclose(got, want, atol=2e-5)

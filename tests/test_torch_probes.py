"""The port's cost probes (`gsplat_tpu_torch/probes/`) against the JAX
package's probe scripts, on the CPU.

The scripts are loaded by path (`scripts/` is not a package) and run
unedited: their Pallas kernels go through `pl.pallas_call(...,
interpret=True)` by a module-local shim, as the JAX package's own tests run
them. P1 and P2 also need `rasterize_pallas._read_protocol` cut to the two
functions the probe unpacks (it returns three since the fast drain was
added); the shim is set and restored inside each test.

Same numpy inputs, made from a seed, go to both sides. What holds:

- P1 (`skel_fwd_torch`): bit for bit. XLA on the CPU compiles the probe's
  `acc + h * 1e-30` into one fused multiply-add (its LLVM target options
  always allow FP-op fusion), and so do the port's kernels and twins.
- P2 (`skel_bwd_torch`): bit for bit on rows 0-9 over [0, total), except on
  the columns of each tile's first chunk when the tile starts mid-chunk,
  where P2 carries the earlier tile's accumulator and the port writes 0.
- P3 (`op_rate.TWINS`): `EXACT` variants bit for bit; the others within
  1e-6 of max |want|. The twins keep the JAX bodies' separate multiplies and
  adds, which XLA on the CPU fuses; its exp differs from torch's in the last
  bit; the contractions and the row sum add in other orders; XLA flushes
  some denormals of the cumprod.
- P4 (`blend_mix_torch`): bf16 bit for bit (the 2-ulp allowance is not
  needed on the CPU: every op rounds to bf16 on both sides); float32 within
  2e-7 relative per element (fused multiply-adds and exp, as for P3).
"""

from __future__ import annotations

import contextlib
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gsplat_tpu_torch.probes import ablate, bf16_rate, op_rate

ROOT = Path(__file__).resolve().parents[1]

# P3 variants whose twin equals the JAX probe bit for bit on the CPU
EXACT = {"div"}


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def interpreting_pl():
    """`pallas` with `pallas_call` forced into interpret mode."""
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    shim.pallas_call = lambda *a, **kw: pl.pallas_call(*a, **{**kw, "interpret": True})
    return shim


@contextlib.contextmanager
def skeleton_probe():
    """probe_ablate2 in interpret mode, with `_read_protocol` returning the
    two functions the probe unpacks; restored on exit."""
    import gsplat_tpu.ops.rasterize_pallas as rp

    mod = load_script("probe_ablate2")
    mod.pl = interpreting_pl()
    orig = rp._read_protocol
    rp._read_protocol = lambda *a: orig(*a)[:2]
    try:
        yield mod
    finally:
        rp._read_protocol = orig


# ------------------------------------------------------------- P1 and P2


def synthetic_ranges():
    """Ranges from seeded counts: empty tiles, ranges longer than 256, one
    ending on a multiple of 128, tiles starting mid-chunk; random rows."""
    counts = np.array([0, 300, 84, 0, 57, 400, 0, 129, 1, 640, 3, 0])
    assert (300 + 84) % 128 == 0
    ends = np.cumsum(counts).astype(np.int32)
    starts = (ends - counts).astype(np.int32)
    inst = (np.random.default_rng(3).standard_normal((16, int(ends[-1]))) * 100).astype(np.float32)
    return inst, starts, ends, 4, 3


def scene_ranges():
    """The K1' twin's table and ranges of a small seeded scene."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops.binning import pack_bins
    from gsplat_tpu_torch.ops.projection import preprocess
    from gsplat_tpu_torch.render import grid_dims
    from gsplat_tpu_torch.synthetic import tiny_scene

    params, alive, camera = tiny_scene(n=1024, width=64, height=48, device="cpu")
    gx, gy = grid_dims(camera, 16)
    screen = preprocess(params, alive, camera, make_render_settings(sh_degree=3), gx, gy)
    pb = pack_bins(screen, gx, gy)
    return pb.inst_t.numpy(), pb.tile_start.numpy(), pb.tile_end.numpy(), gx, gy


FIXTURES = {"synthetic": synthetic_ranges, "scene": scene_ranges}


def padded(inst):
    k_pad = max(128, (inst.shape[1] + 127) // 128 * 128)
    return jnp.asarray(np.pad(inst, ((0, 0), (0, k_pad - inst.shape[1]))))


def torch_args(inst, starts, ends):
    return torch.as_tensor(inst), torch.as_tensor(starts), torch.as_tensor(ends)


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_skel_fwd_twin_equals_jax_probe(fixture):
    inst, starts, ends, gx, gy = FIXTURES[fixture]()
    with skeleton_probe() as mod:
        want = np.asarray(mod.run_skel_fwd(padded(inst), jnp.asarray(starts), jnp.asarray(ends),
                                           gx, gy, 16))
    got = ablate.skel_fwd_torch(*torch_args(inst, starts, ends), gx, gy).numpy()
    assert got.shape == want.shape == (gx * gy, 256, 8)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.any(got != 0)


def carried_columns(starts, ends):
    """The columns where P2 adds an earlier tile's accumulator: a tile's
    first chunk, from its start, when it starts mid-chunk."""
    cols = np.zeros(int(ends[-1]), bool)
    for s, e in zip(starts, ends):
        if e > s and s % 128:
            cols[s:min(e, (s // 128 + 1) * 128)] = True
    return cols


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_skel_bwd_twin_equals_jax_probe_outside_carried_columns(fixture):
    inst, starts, ends, gx, gy = FIXTURES[fixture]()
    total = int(ends[-1])
    rng = np.random.default_rng(5)
    fwd, dout = (rng.standard_normal((gx * gy, 256, 8)).astype(np.float32) for _ in range(2))
    with skeleton_probe() as mod:
        want = np.asarray(mod.run_skel_bwd(padded(inst), jnp.asarray(starts), jnp.asarray(ends),
                                           jnp.asarray(fwd), jnp.asarray(dout), gx, gy, 16))
    got = ablate.skel_bwd_torch(*torch_args(inst, starts, ends), gx, gy, torch.as_tensor(fwd),
                                torch.as_tensor(dout)).numpy()
    assert got.shape == (10, total)
    carried = carried_columns(starts, ends)
    assert carried.any()
    keep = ~carried
    assert np.array_equal(got[:, keep].view(np.int32), want[:10, :total][:, keep].view(np.int32))
    assert not got[:, carried].any()
    if fixture == "synthetic":  # the difference is real: P2 carries a non-zero sum there
        assert np.any(want[:10, :total][:, carried] != 0)


# ------------------------------------------------------------------- P3


def run_jax_op(mod, kernel, out_shape, args):
    """A probe_mm kernel as `bench` calls it, in interpret mode, untimed."""
    f = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(args),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    return np.asarray(f(*[jnp.asarray(a) for a in args]))


def jax_kernel(mod, name):
    if name.startswith("kappa"):
        return mod.make_kappa(int(name[5:]))
    return getattr(mod, f"k_{name}")


@pytest.mark.parametrize("name", list(op_rate.VARIANTS))
def test_op_rate_twin_matches_jax_probe(name):
    mod = load_script("probe_mm")
    ins = op_rate.inputs(name)
    want = run_jax_op(mod, jax_kernel(mod, name), op_rate.VARIANTS[name].out_shape,
                      [a.numpy() for a in ins])
    got = op_rate.TWINS[name](*ins, n_it=mod.N_IT).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    if name in EXACT:
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


# ------------------------------------------------------------------- P4


@pytest.mark.parametrize("shape", bf16_rate.SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_rate_twin_matches_jax_probe(dtype, shape):
    mod = load_script("probe_r5_bf16vpu")
    x = bf16_rate.inputs(shape, getattr(torch, dtype))
    jdt = getattr(jnp, dtype)
    xj = jnp.asarray(x.float().numpy(), jdt)
    f = pl.pallas_call(mod.make_kernel(jdt), out_shape=jax.ShapeDtypeStruct(shape, jdt),
                       in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                       out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    want = np.asarray(f(xj).astype(jnp.float32))
    got = bf16_rate.blend_mix_torch(x, n_it=mod.K).float().numpy()
    assert np.isfinite(got).all() and got.min() > 1.0
    if dtype == "bfloat16":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


# --------------------------------------------------------------- guards


def wrapper_cases():
    cases = [("skel_fwd", lambda: ablate.skel_fwd(*torch_args(*synthetic_ranges()[:3]), 4, 3))]
    z = torch.zeros((12, 256, 8))
    cases.append(("skel_bwd", lambda: ablate.skel_bwd(*torch_args(*synthetic_ranges()[:3]), 4, 3,
                                                      z, z)))
    for name in op_rate.VARIANTS:
        cases.append((f"k_{name}", lambda name=name: op_rate.WRAPPERS[name](*op_rate.inputs(name))))
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((bf16_rate.WRAPPERS[dtype].__name__,
                      lambda dtype=dtype: bf16_rate.WRAPPERS[dtype](
                          bf16_rate.inputs(bf16_rate.SHAPES[0], dtype))))
    return cases


@pytest.mark.parametrize("case", wrapper_cases(), ids=lambda c: c[0])
def test_probe_wrappers_refuse_cpu_tensors(case):
    _, call = case
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_resolve_device_refuses_cuda_without_a_card(monkeypatch):
    from gsplat_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)


@pytest.mark.parametrize("module", [ablate, op_rate, bf16_rate], ids=lambda m: m.__name__)
def test_probe_main_raises_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


@pytest.mark.parametrize("module", [ablate, op_rate, bf16_rate], ids=lambda m: m.__name__)
def test_probe_main_rehearses_on_the_cpu(module, capsys):
    res = module.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert res and all(np.isfinite(v) and v > 0 for v in res.values() if isinstance(v, float))
    if module is bf16_rate:
        assert set(res) == {"f32", "bf16", "f32_512", "bf16_512", "bf16_speedup_same_shape",
                            "bf16_speedup_512"}
    if module is op_rate:
        assert set(res) == set(op_rate.VARIANTS) and "per-op cost" in out
    if module is ablate:
        assert "fwd skeleton" in out and res["instances"] > 0

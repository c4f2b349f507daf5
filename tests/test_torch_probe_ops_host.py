"""The probe kernels' CUDA source (`gsplat_tpu_torch/csrc/probe_ops.cu`) run
on the host, through the wrappers of `probes.op_rate` and `probes.bf16_rate`,
against their plain twins, for a few iterations.

The source is built with `g++ -O2 -ffp-contract=off` against the stub
`cuda_runtime.h` of `tests/test_torch_loss_kernel_host.py` (a block's threads
as fibers on one host thread, barriers and shuffles between them), extended
here with static `__shared__` arrays, the xor and up shuffles, bf16 pairs
(`cuda_bf16.h`: each packed op rounds its float result to nearest even) and
the kernels' PTX replaced by host code: the approximate reciprocal by the
quotient with its lowest mantissa bit cleared (1 ulp low on about half the
values, which `k_div`'s Newton step must correct), ex2 by `exp2f`, the
packed conversion by rounding, and the mbarriers by a word that counts
arrivals and flips a phase bit, a waiting thread yielding to the others;
`__syncthreads_or` is three barriers around a shared word. Every
replacement must match the source once, so an edited kernel fails here
first.

What this holds: every output row, the fed-back row or column, the slices'
partial sums, the mbarrier protocol of `cvpu` / `cmatmul` and the staging of
`kappa` and the pair exchange of `fwd_accum` are right for 1, 2 and 3 iterations (a wrong index or a missed
feedback is far off). The host's exp2f and expf differ from the card's in
the last bits, so float32 rows are held within 1e-6 of max |want| (the
card's tolerance) and bf16 rows within 2 bf16 ulps. The card runs the same
checks at 1000 and 2000 iterations (`chip_smoke.py`'s `probe_ops` phase).
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.probes import bf16_rate, floors, op_rate
from gsplat_tpu_torch.scripts import ablation, probe_ops_ablate
from tests.test_torch_loss_kernel_host import STUB

EXTRA = r"""
#include <cfloat>
#define __shared__ static
#define __align__(n)
#define __noinline__ __attribute__((noinline))
inline float2 make_float2(float x, float y) { return {x, y}; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float gs_rcp_approx(float d) { return __uint_as_float(__float_as_uint(1.0f / d) & ~1u); }
inline int gs_or_word;
// the last call's reads are done before the word is cleared, and it is
// cleared before any thread sets it
inline int __syncthreads_or(int p)
{
    __syncthreads();
    if (gs_tid == 0) gs_or_word = 0;
    __syncthreads();
    if (p) gs_or_word = 1;
    __syncthreads();
    return gs_or_word;
}
using std::isfinite;
using std::isinf;
template <typename T>
inline cudaError_t cudaFuncSetAttribute(T* f, cudaFuncAttribute attr, int v)
{
    return cudaFuncSetAttribute((const void*)f, attr, v);
}
template <typename T>
inline T __ldg(const T* p) { return *p; }
inline long long clock64() { return 0; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline void __trap() { std::abort(); }
inline void gs_yield() { gs_wait(GS_RUN); }
template <typename T>
inline T gs_shfl(T v, int src_of_lane_delta, int mode)
{
    const int t = gs_tid;
    float* slot = gs_slot[gs_parity[t] ^= 1];
    std::memcpy(&slot[t], &v, 4);
    __syncwarp();
    const int lane = t & 31;
    int src = lane;
    if (mode == 0) src = lane ^ src_of_lane_delta;
    if (mode == 1) src = lane - src_of_lane_delta >= 0 ? lane - src_of_lane_delta : lane;
    T out;
    std::memcpy(&out, &slot[t - lane + src], 4);
    return out;
}
inline float __shfl_xor_sync(unsigned, float v, int m) { return gs_shfl(v, m, 0); }
inline float __shfl_up_sync(unsigned, float v, int d) { return gs_shfl(v, d, 1); }

// the mbarrier word: pending arrivals (low 32 bits), expected (bits 32-62),
// phase parity (bit 63)
inline void gs_mbar_init(unsigned long long* bar, unsigned count)
{
    *bar = ((unsigned long long)count << 32) | count;
}
inline void gs_mbar_arrive(unsigned long long* bar)
{
    unsigned long long w = *bar;
    const unsigned pending = (unsigned)(w & 0xffffffffu) - 1;
    const unsigned long long expected = (w >> 32) & 0x7fffffffu;
    if (pending == 0)
        w = ((w & (1ull << 63)) ^ (1ull << 63)) | (expected << 32) | expected;
    else
        w = (w & ~0xffffffffull) | pending;
    *bar = w;
}
inline unsigned gs_mbar_test(unsigned long long* bar, unsigned parity)
{
    if ((*bar >> 63) != parity) return 1;
    gs_yield();
    return 0;
}
"""

BF16 = r"""
#pragma once
#include <cstring>
#include <cmath>
struct __nv_bfloat16 { unsigned short u; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) { unsigned v = (unsigned)b.u << 16; float f; std::memcpy(&f, &v, 4); return f; }
inline __nv_bfloat16 __float2bfloat16_rn(float f)
{
    unsigned u; std::memcpy(&u, &f, 4);
    if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)((u >> 16) | 0x40)};
    u += 0x7fffu + ((u >> 16) & 1);
    return {(unsigned short)(u >> 16)};
}
inline __nv_bfloat162 __float2bfloat162_rn(float f) { return {__float2bfloat16_rn(f), __float2bfloat16_rn(f)}; }
inline unsigned gs_cvt_bf16x2(float hi, float lo) { return __float2bfloat16_rn(lo).u | (unsigned)__float2bfloat16_rn(hi).u << 16; }
template <typename F> inline __nv_bfloat162 gs_map2(__nv_bfloat162 a, __nv_bfloat162 b, F f)
{
    return {__float2bfloat16_rn(f(__bfloat162float(a.x), __bfloat162float(b.x))),
            __float2bfloat16_rn(f(__bfloat162float(a.y), __bfloat162float(b.y)))};
}
inline __nv_bfloat162 __hmul2_rn(__nv_bfloat162 a, __nv_bfloat162 b) { return gs_map2(a, b, [](float p, float q) { return p * q; }); }
inline __nv_bfloat162 __hadd2_rn(__nv_bfloat162 a, __nv_bfloat162 b) { return gs_map2(a, b, [](float p, float q) { return p + q; }); }
inline __nv_bfloat162 __hmin2(__nv_bfloat162 a, __nv_bfloat162 b) { return gs_map2(a, b, [](float p, float q) { return std::fmin(p, q); }); }
template <typename F> inline unsigned gs_mask2(__nv_bfloat162 a, __nv_bfloat162 b, F f)
{
    return (f(__bfloat162float(a.x), __bfloat162float(b.x)) ? 0xffffu : 0u)
         | (f(__bfloat162float(a.y), __bfloat162float(b.y)) ? 0xffff0000u : 0u);
}
inline unsigned __hle2_mask(__nv_bfloat162 a, __nv_bfloat162 b) { return gs_mask2(a, b, [](float p, float q) { return p <= q; }); }
inline unsigned __hge2_mask(__nv_bfloat162 a, __nv_bfloat162 b) { return gs_mask2(a, b, [](float p, float q) { return p >= q; }); }
"""

# the kernels' PTX and the card-only constants, each replaced once
HOST_EDITS = (
    ('asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));', "r = gs_rcp_approx(d);"),
    ('asm("ex2.approx.ftz.f32 %0, %0;" : "+f"(lo));', "lo = exp2f(lo);"),
    ('asm("ex2.approx.ftz.f32 %0, %0;" : "+f"(hi));', "hi = exp2f(hi);"),
    ('asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));',
     "r = gs_cvt_bf16x2(hi, lo);"),
    ('asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");',
     "gs_mbar_init(bar, count);"),
    ('asm volatile("{\\n\\t.reg .b64 st;\\n\\tmbarrier.arrive.shared.b64 st, [%0];\\n\\t}"\n'
     '                 ::"r"(smem_addr(bar)) : "memory");', "gs_mbar_arrive(bar);"),
    ('        asm volatile("{\\n\\t.reg .pred p;\\n\\t"\n'
     '                     "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\\n\\t"\n'
     '                     "selp.u32 %0, 1, 0, p;\\n\\t}"\n'
     '                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");',
     "        done = gs_mbar_test(bar, parity);"),
    ("constexpr unsigned MBAR_PATIENCE = 1u << 24;", "constexpr unsigned MBAR_PATIENCE = 1u << 16;"),
    ('asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));', "t0 = 0;"),
    ('asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));', "t1 = 0;"),
    ('asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");', "(void)id; __syncthreads();"),
    ('asm volatile("" ::: "memory");', ""),
)
LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>\(([^;]*)\);")


def host_source(src: str) -> str:
    """probe_ops.cu for g++: the PTX replaced, each launch a call of the
    stub's launcher, the dynamic shared memory the stub's buffer."""
    for old, new in HOST_EDITS:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    src, launches = LAUNCH.subn(r"gs_host_launch(\1, \2, \3, \4, \6);", src)
    src, smem = re.subn(r"extern __shared__ float4 smem4\[\];",
                        "float4* smem4 = reinterpret_cast<float4*>(gs_host_smem);", src)
    assert launches >= 10 and smem == 2, (launches, smem)
    assert "asm" not in src.replace("gs_mbar", ""), "a PTX statement without a host form"
    return src


def build_host(tmp, dep_scale=None):
    """The host library of probe_ops.cu; `dep_scale` replaces the feedback's
    1e-20 (so that the fed-back row changes the outputs visibly)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    (tmp / "cuda_runtime.h").write_text(STUB + EXTRA)
    (tmp / "cuda_bf16.h").write_text(BF16)
    (tmp / "common.cuh").write_text((_kernels.CSRC / "common.cuh").read_text())
    src = host_source((_kernels.CSRC / "probe_ops.cu").read_text())
    if dep_scale is not None:
        old = "constexpr float DEP_SCALE = 1e-20f;"
        assert src.count(old) == 1
        src = src.replace(old, f"constexpr float DEP_SCALE = {dep_scale!r}f;")
    (tmp / "probe_ops_host.cpp").write_text(src)
    out = tmp / "libprobe_ops_host.so"
    subprocess.run([gxx, "-O1", "-ffp-contract=off", "-fno-strict-aliasing", "-std=c++20", "-shared",
                    "-fPIC", "-pthread", "-w", "-I", str(tmp), "-o", str(out),
                    str(tmp / "probe_ops_host.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _kernels._SIGNATURES["probe_ops"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host(tmp_path_factory.mktemp("probe_ops_host"))


@pytest.fixture(scope="module")
def host_lib_fed(tmp_path_factory):
    return build_host(tmp_path_factory.mktemp("probe_ops_host_fed"), dep_scale=0.25)


def use(monkeypatch, lib):
    monkeypatch.setattr(_kernels, "load", lambda name: lib)
    monkeypatch.setattr(_kernels, "stream", lambda device: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    use(monkeypatch, host_lib)


@pytest.mark.parametrize("n_it", [1, 2, 3])
@pytest.mark.parametrize("name", list(op_rate.VARIANTS))
def test_op_rate_kernels_on_the_host_match_their_twins(on_host, name, n_it):
    ins = op_rate.inputs(name)
    got = op_rate.WRAPPERS[name](*ins, n_it=n_it)
    want = op_rate.TWINS[name](*ins, n_it=n_it)
    assert got.shape == want.shape and torch.isfinite(got).all()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale, name


@pytest.mark.parametrize("name", list(op_rate.VARIANTS))
def test_op_rate_kernels_on_the_host_feed_back_row_0(host_lib_fed, monkeypatch, name):
    """With the feedback's scale 0.25 on both sides (1e-20 leaves no trace
    in the outputs), 6 iterations: the fed-back row or column (the sum of
    row 0 for cvpu / cmatmul, through warp 0's mbarrier-guarded publish) is
    the one the twin feeds back, in every iteration and both buffers."""
    use(monkeypatch, host_lib_fed)
    monkeypatch.setattr(op_rate, "DEP_SCALE", 0.25)
    ins = op_rate.inputs(name)
    got = op_rate.WRAPPERS[name](*ins, n_it=6)
    want = op_rate.TWINS[name](*ins, n_it=6)
    moved = op_rate.TWINS[name](*ins, n_it=1)
    scale = float(want.abs().max())
    assert torch.isfinite(got).all() and float((got - want).abs().max()) <= 1e-5 * scale, name
    assert float((want - moved).abs().max()) > 1e-4 * scale  # the feedback shows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blend_mix_kernels_on_the_host_match_their_twins(on_host, dtype):
    dt = getattr(torch, dtype)
    x = bf16_rate.inputs(bf16_rate.SHAPES[0], dt)
    got = bf16_rate.WRAPPERS[dt](x, n_it=3)
    want = bf16_rate.blend_mix_torch(x, n_it=3)
    if dt == torch.bfloat16:
        ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs().max()
        assert int(ulps) <= 2
    else:
        assert float(((got - want).abs() / want.abs()).max()) <= 1e-6


def test_blend_mix_bf16_gate_on_the_host_drops_what_float32_drops(on_host):
    """Values around the keep threshold and the sign of p: after one
    iteration acc = x + 0.5 kept(a), so the gate's decisions show in the
    output; the twin decides them in float32."""
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(-30.0, 30.0, (256, 128)).astype(np.float32)).to(torch.bfloat16)
    got = bf16_rate.blend_mix_bf16(x, n_it=1)
    want = bf16_rate.blend_mix_torch(x, n_it=1)
    ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs().max()
    assert int(ulps) <= 2


@pytest.mark.parametrize("scale", [1.0, 1e4])
def test_div_flags_denominators_outside_1_2_for_its_exact_launch(host_lib, on_host, scale):
    """Where a denominator leaves [1, 2), `k_div` reruns the probe with the
    IEEE division in the same launch and reports it (the sink's first
    word): the result is the twin's either way."""
    (x,) = op_rate.inputs("div")
    x = x * scale
    out, sink = torch.empty_like(x), torch.full((op_rate.SINK_WORDS,), 7, dtype=torch.int32)
    assert host_lib.gs_op_elementwise(3, x.data_ptr(), out.data_ptr(), sink.data_ptr(), 3, 0,
                                      None) == 0
    assert int(sink[0]) == (scale > 1)
    assert torch.equal(out, op_rate.TWINS["div"](x, n_it=3))


def test_div_rerun_is_what_makes_an_infinite_denominator_right(host_lib, on_host):
    """An infinite x gives an infinite denominator, whose reciprocal's
    Newton step makes NaN (inf times 0) where 1 / inf is 0: only the
    rerun with the IEEE division gives the twin's output."""
    (x,) = op_rate.inputs("div")
    x[5, 7] = float("inf")
    out, sink = torch.empty_like(x), torch.zeros(op_rate.SINK_WORDS, dtype=torch.int32)
    assert host_lib.gs_op_elementwise(3, x.data_ptr(), out.data_ptr(), sink.data_ptr(), 2, 0,
                                      None) == 0
    want = op_rate.TWINS["div"](x, n_it=2)
    assert int(sink[0]) == 1 and float(want[5, 7]) == 0.0 and torch.equal(out, want)


def test_rcp_on_the_host_is_a_division(on_host):
    """On the host the approximate reciprocal is 1 ulp low on about half of
    these values (its stand-in clears the quotient's lowest bit): `k_div`'s
    Newton step must bring every one back to 1 / x."""
    x = torch.linspace(1.0, 1.999, 4096)
    approx = ((1.0 / x).view(torch.int32) & ~1).view(torch.float32)
    assert int((approx != 1.0 / x).sum()) > 1000
    assert torch.equal(op_rate.rcp_1_2(x), 1.0 / x)


def test_loop_shape_lists_every_probe_kernel(host_lib):
    """`gs_probe_loop_shape`: one entry per `floors.SASS_PROBES` row, from the
    constants that size the launches (8 warps for two_matmuls and
    fwd_accum, 16 for the others; P4' 8 elements a lane, bf16 pairs), and
    an error for a caller that expects another count."""
    shape = floors.loop_shape(host_lib)
    assert list(shape) == list(floors.SASS_PROBES)
    warps = {row: n for row, n in shape.items() if row.startswith("op_")}
    assert warps == {row: 8 if row in ("op_two_matmuls", "op_fwd_accum") else 16 for row in warps}
    assert shape["blend_mix_f32"] == 32 * 8 and shape["blend_mix_bf16"] == 2 * 32 * 8
    buf = (ctypes.c_int * 3)()
    assert host_lib.gs_probe_loop_shape(buf, 3) != 0


@pytest.mark.parametrize("variant", sorted(probe_ops_ablate.LIBRARIES))
def test_each_ablation_variant_edits_its_source(variant):
    """`scripts/probe_ops_ablate.py`: each variant's edits match
    `csrc/probe_ops.cu` and change it; `kernel` is the source as it is."""
    text, _ = ablation.variant_sources("probe_ops", probe_ops_ablate.LIBRARIES)[variant]
    assert (text != (_kernels.CSRC / "probe_ops.cu").read_text()) == (variant != "kernel")

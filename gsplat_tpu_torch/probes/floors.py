"""The floors of a probe kernel on one SM, from its SASS.

A probe kernel (`csrc/probe_ops.cu`) runs one block on one SM, so its time
is bounded by the busiest of the SM's pipes. From `cuobjdump -sass` of the
built library this module takes the kernel's hot loop (`hot_loop`), counts
its instructions by pipe (`pipe_counts`) and turns the counts into
milliseconds at an SM clock (`floors`). The pipe rates are those of the CUDA
C++ Programming Guide's arithmetic-throughput table for compute capability
9.0, per SM and clock:

- issue: 4 warp instructions (one scheduler a sub-partition), every opcode;
- fma: 32-bit float add, multiply, multiply-add at 128 results (FADD, FMUL,
  FFMA) and their packed 16-bit forms (HADD2, HMUL2, HFMA2) at 256, so 4
  warp instructions either way;
- alu: compare, minimum, maximum, logic, shift, integer add and multiply at
  64 results: 2 warp instructions;
- mufu: the special functions (MUFU) and the type conversions other than
  8- and 16-bit integer ones at 16 results: half a warp instruction. The
  packed float-to-bf16 conversion (F2FP) is not one of them: on an H100
  (700 W) P4' bf16 ran its 8 a warp pass in 2.78 ms where 16 a clock
  would take 3.08 (`scripts/probe_ab.py`), so it is counted with the
  ALU's;
- shuffle: SHFL at 32 results: one warp instruction;
- shared: shared-memory wavefronts of 128 bytes, one a clock. A warp's
  access of 4, 8 or 16 bytes a lane at distinct addresses is 1, 2 or 4
  wavefronts; a warp-uniform one (every lane the same address, which the
  caller names by mnemonic) is one. That is the floor: on an H100 a
  warp-uniform 16-byte load takes about two (`scripts/probe_ops_ablate.py`,
  `fwd_accum_uniform_feat`).

The limiter is the pipe with the largest floor. Counts are per execution of
the loop body by one warp; `bodies` is how many such executions one call
makes over all warps, from what one pass covers (`loop_shape`, which the
built library reports from the constants that size its launches).

`probe_loops` counts every P3'/P4' kernel of `SASS_PROBES` from one
listing; `chip_smoke.py`'s `sass` phase checks those counts and its
`probe_ops` phase turns them into floors, and `scripts/probe_ab.py` counts
two trees' kernels with it.
"""

from __future__ import annotations

import ctypes
import re
from collections import Counter

ISSUE_PER_CLOCK = 4.0
PIPE_RATES = {  # warp instructions (shared: wavefronts) per SM and clock
    "issue": ISSUE_PER_CLOCK, "fma": 4.0, "alu": 2.0, "mufu": 0.5, "shuffle": 1.0, "shared": 1.0}
FMA = ("FADD", "FMUL", "FFMA", "HADD2", "HMUL2", "HFMA2")
ALU = ("FSETP", "FMNMX", "FSEL", "FCHK", "ISETP", "IMNMX", "VIMNMX", "SEL", "LOP3", "LOP", "SHF",
       "SHL", "SHR", "IADD3", "IADD", "VIADD", "IMAD", "IMUL", "LEA", "PRMT", "BFE", "BFI", "HSETP2",
       "HSET2", "HMNMX2", "P2R", "R2P", "PLOP3", "F2FP")
MUFU = ("MUFU", "F2F", "F2I", "I2F", "FRND")
SHARED = ("LDS", "STS", "ATOMS")
# the probes' float work (the `sass` phase's least counts are of these)
FLOAT = ("FADD", "FMUL", "FFMA", "MUFU", "HADD2", "HMUL2", "HFMA2")

# row: (part of the mangled name in libprobe_ops, least float instructions
# of one warp's pass through the kernel's hot loop, the shared-memory
# mnemonics whose every instance in that loop is warp-uniform). The loop is
# one iteration (P3', `#pragma unroll 1` or as built) or one iteration of 8
# elements a thread (P4'); the least counts are the operations the JAX body
# needs there: a P3' warp-iteration is 16 rows of 128 (fwd_accum: 64 rows
# of 64 k, their 4 partial outputs each; two_matmuls: 32 depths of 32
# column quads; merged: 32 depths of 64 column pairs; kappa: 8 KAPPA columns
# of 256 rows; their y loads, at distinct addresses, are counted as one
# wavefront like their bd loads, and so are fwd_accum's two exchange reads,
# which keeps the shared-memory floor a floor). The static count cannot show
# that every row is computed in every iteration (a compiler may move a
# row's work under a branch that rarely runs); the kernels rule that out by
# storing every row unconditionally or folding it into a checksum they
# write after the loop, and `chip_smoke.py` checks that none runs under its
# bound. The order is that of `gs_probe_loop_shape`.
SASS_PROBES = {
    "op_cumprod": ("elementwise_kernelILi0E", 16 * 32, ()),
    "op_vpu9": ("elementwise_kernelILi1E", 16 * 4 * 8, ()),
    "op_exp": ("elementwise_kernelILi2E", 16 * 4 * 3, ()),
    "op_div": ("elementwise_kernelILi3E", 16 * 4 * 4, ()),
    "op_cvpu": ("contract4_kernelILb0E", 16 * 4 * 7, ("LDS",)),
    "op_cmatmul": ("contract4_kernelILb1E", 16 * 4 * 4, ("LDS",)),
    "op_two_matmuls": ("two_matmuls_kernel", 32 * 44, ("LDS.128", "LDS.64")),
    "op_merged": ("merged_kernel", 32 * 42, ("LDS.128", "LDS.64")),
    "op_fwd_accum": ("fwd_accum_kernel", 2 * 64 * 5, ("LDS.128",)),
    **{f"op_kappa{k}": (f"kappa_kernelILi{k}E", k * 8 * 8 * 8, ("LDS.128",)) for k in (1, 2, 4)},
    "blend_mix_f32": ("blend_mix_f32_kernel", 8 * 8, ()),
    "blend_mix_bf16": ("blend_mix_bf16_kernel", 8 * 7, ()),
}

_INS = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Za-z0-9_]+)*)"
                  r"(.*?);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def parse_sass(text: str) -> dict:
    """{function: [(address, mnemonic with its modifiers, branch target or
    None, whether it is predicated)]} from `cuobjdump -sass` output."""
    funcs, cur = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            cur = funcs.setdefault(head.group(1), [])
            continue
        m = _INS.match(line)
        if m and cur is not None:
            op = m.group(3)
            target = None
            if op.split(".")[0] == "BRA":
                t = _TARGET.search(m.group(4))
                target = int(t.group(1), 16) if t else None
            cur.append((int(m.group(1), 16), op, target, m.group(2) is not None))
    return funcs


def base(op: str) -> str:
    return op.split(".")[0]


def _float_count(ops) -> int:
    return sum(1 for op in ops if base(op) in FLOAT)


def hot_loop(instrs) -> Counter:
    """Mnemonic counts of the kernel's hot loop. A loop is a backward branch
    and the addresses it spans, unless the span holds an unconditional EXIT:
    such a branch returns from code placed after the kernel's end (the
    divergent paths of shuffles and warp barriers) into the middle of it.
    A loop that calls a subroutine (CALL: `k_div`'s IEEE-division rerun,
    which runs only for denominators outside [1, 2)) is left out where a
    loop without one has float work: the callee's work is not in its span.
    Of the loops that hold no other loop with float work, take the one with
    the most float instructions; then, while the smallest loop around it
    holds more float instructions outside it than in it (a short inner loop
    of an iteration, such as a reduction), take that one instead."""
    exits = [a for a, op, _, pred in instrs if op == "EXIT" and not pred]
    spans = sorted({(t, a) for a, _, t, _ in instrs if t is not None and t < a
                    and not any(t <= e <= a for e in exits)})
    if not spans:
        raise ValueError("no loop in this function")
    bodies = {s: [op for a, op, _, _ in instrs if s[0] <= a <= s[1]] for s in spans}
    floats = {s: _float_count(ops) for s, ops in bodies.items()}
    plain = [s for s in spans if not any(base(op) == "CALL" for op in bodies[s])]
    if any(floats[s] for s in plain):
        spans = plain

    def inside(o, s):
        return o != s and s[0] <= o[0] and o[1] <= s[1]

    best = max((s for s in spans if not any(inside(o, s) and floats[o] for o in spans)),
               key=lambda s: floats[s])
    while True:
        around = [s for s in spans if inside(best, s)]
        if not around:
            break
        outer = min(around, key=lambda s: s[1] - s[0])
        if floats[outer] - floats[best] <= floats[best]:
            break
        best = outer
    return Counter(bodies[best])


def _width(op: str) -> int:
    for w in (128, 64, 32, 16, 8):
        if f".{w}" in op or f".U{w}" in op or f".S{w}" in op:
            return w // 8
    return 4


def pipe_counts(body: Counter, uniform=()) -> dict:
    """Per-pipe counts of one body: warp instructions per pipe, and for
    `shared` the wavefronts. `uniform` names the shared-memory mnemonics
    (e.g. "LDS.128") whose every instance in the body is warp-uniform."""
    out = dict.fromkeys(PIPE_RATES, 0)
    for op, n in body.items():
        b = base(op)
        out["issue"] += n
        if b in FMA:
            out["fma"] += n
        elif b in ALU:
            out["alu"] += n
        elif b in MUFU:
            out["mufu"] += n
        elif b == "SHFL":
            out["shuffle"] += n
        elif b in SHARED:
            w = _width(op)
            out["shared"] += n * (1 if op in uniform else max(1, 32 * w // 128))
    return out


def floors(per_body: dict, bodies: float, clock_hz: float) -> dict:
    """{pipe}_floor_ms for every pipe at `clock_hz`, and `limiter`, the pipe
    with the largest."""
    ms = {f"{p}_floor_ms": per_body[p] * bodies / rate / clock_hz * 1e3
          for p, rate in PIPE_RATES.items()}
    limiter = max(PIPE_RATES, key=lambda p: ms[f"{p}_floor_ms"])
    return {**ms, "limiter": limiter, "limiter_floor_ms": ms[f"{limiter}_floor_ms"]}


def kernel_loop(funcs: dict, part: str, uniform=()) -> dict:
    """The one function of `funcs` (`parse_sass`) whose name holds `part`:
    its hot loop's mnemonic counts (`loop`), their counts by pipe
    (`per_body`) and float instructions (`float_per_body`), and the whole
    function's counts by base mnemonic (`function`)."""
    hits = [f for f in funcs if part in f]
    if len(hits) != 1:
        raise ValueError(f"{part}: {len(hits)} functions")
    instrs = funcs[hits[0]]
    body = hot_loop(instrs)
    return {"loop": body, "per_body": pipe_counts(body, uniform),
            "float_per_body": _float_count(body.elements()),
            "function": Counter(base(op) for _, op, _, _ in instrs)}


def probe_loops(sass_text: str, missing_ok=False) -> dict:
    """{row: `kernel_loop`} of every `SASS_PROBES` kernel in one listing;
    with `missing_ok` a row whose function the listing lacks (another
    tree's kernels) is left out instead of raising."""
    funcs = parse_sass(sass_text)
    out = {}
    for row, (part, _, uniform) in SASS_PROBES.items():
        try:
            out[row] = kernel_loop(funcs, part, uniform)
        except ValueError:
            if not missing_ok:
                raise
    return out


def loop_shape(lib) -> dict:
    """{row: what one warp's pass through its hot loop covers} from the
    built library (`gs_probe_loop_shape`): the warps that pass once an
    iteration (P3'), the elements a pass takes (P4')."""
    buf = (ctypes.c_int * len(SASS_PROBES))()
    if lib.gs_probe_loop_shape(buf, len(buf)) != 0:
        raise RuntimeError(f"gs_probe_loop_shape: the library does not list {len(buf)} kernels")
    return dict(zip(SASS_PROBES, buf))

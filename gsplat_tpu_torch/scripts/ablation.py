"""Variants of one kernel source, built side by side: the machinery that
`loss_ablate.py` and `probe_ops_ablate.py` share.

A variant is `csrc/<source>.cu` with text edits and extra nvcc flags. Every
edit must match the committed source, so a changed source fails loudly
rather than timing the unchanged kernel. Only the unedited source computes
the kernels' functions: the others are timings. Building needs `nvcc`, so
`build` runs on the card's machine only.
"""

from __future__ import annotations

import contextlib
import ctypes
import subprocess
from pathlib import Path

from gsplat_tpu_torch import _kernels


def variant_sources(source: str, variants: dict, csrc: Path = _kernels.CSRC) -> dict:
    """{variant: (its text, extra nvcc flags)} for `variants` = {name:
    (text edits [(old, new)], flags)}, of `csrc/<source>.cu` (another
    tree's `csrc` for its kernels)."""
    src = (csrc / f"{source}.cu").read_text()
    out = {}
    for name, (edits, flags) in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in csrc/{source}.cu")
            text = text.replace(old, new)
        out[name] = (text, list(flags))
    return out


def build(source: str, variants: dict, out_dir: Path, csrc: Path = _kernels.CSRC,
          bind: bool = True) -> dict:
    """{variant: (library, its path)}: one nvcc per variant, all started
    together, each library's entry points bound as `_kernels.load` binds
    them (with `bind` false, loaded unbound: another tree's entry points)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (text, flags) in variant_sources(source, variants, csrc).items():
        cu, lib = out_dir / f"{source}_{name}.cu", out_dir / f"lib{source}_{name}.so"
        cu.write_text(text)
        cmd = [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, *flags, "-I", str(csrc), "-o",
               str(lib), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode(errors='replace')}")
        libs[name] = (_kernels.open_library(lib, source) if bind else ctypes.CDLL(str(lib)), lib)
    return libs


@contextlib.contextmanager
def loaded(source: str, lib):
    """`_kernels.load(source)` returns `lib` inside the block: the wrappers
    launch a variant."""
    load = _kernels.load
    _kernels.load = lambda name: lib if name == source else load(name)
    try:
        yield
    finally:
        _kernels.load = load

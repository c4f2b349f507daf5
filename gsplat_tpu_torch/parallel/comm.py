"""The mesh and its collectives over `torch.distributed`.

Counterpart of what `jax.lax` gives `gsplat_tpu/parallel/`: the device mesh,
the screen-packet all_gather over the gaussian axes (`pipeline.py:154-159`)
with its transpose, and the gather of the tile bands into one image.

One process per rank, as PyTorch runs a multi-device job (`torchrun` or
`torch.multiprocessing`). Rank r sits at the row-major coordinates of r in
the mesh shape: on a ("gauss", "tile") mesh of T columns at `divmod(r, T)`,
as `make_mesh` lays out `devices.reshape(G, T)` (`sharding.py:53`). Each
rank holds one process group per mesh axis (the ranks that differ from it
along that axis only) and, on a multi-host mesh, one over the gaussian axes
together.

The backend is named by the caller: "nccl" when every rank has a card of
its own, "gloo" on the CPU and for ranks that share one card (NCCL refuses
two ranks on one card). Nothing here tries a backend and falls back on a
failure. The collectives run on the tensors where they lie: gloo takes
CUDA tensors in every collective this module calls (checked on the card
with torch 2.11: all_gather_into_tensor, all_reduce, reduce_scatter_tensor,
all_to_all_single, broadcast and the list all_gather), copying them
through host memory itself.

The two gradient-carrying collectives are `torch.autograd.Function`s with
the transposes the band pipeline needs (see `gather_rows` and
`gather_bands`). Every collective adds its calls, payload bytes and (when
`Mesh.timing` is on: a synchronize before and after) host ms to
`Mesh.stats`.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pickle
import queue
import tempfile
import time
import traceback
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU. Ranks that share one card
    must be given "gloo" by name."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    return backend


def init_distributed(backend: str, rank: int | None = None, world_size: int | None = None,
                     init_method: str = "env://") -> None:
    """Join the job's default process group unless this process already has.

    With `rank`/`world_size` None they come from `torchrun`'s environment
    (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`); a spawner passes
    them with its own `init_method`.
    """
    check_backend(backend)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}, not {backend!r}")
        return
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)


def _rank_main(job, rank, world, backend, threads, results):
    if threads:
        torch.set_num_threads(threads)
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        # the rendezvous is a file beside the job: no port to race for
        init_distributed(backend, rank, world, f"file://{job}.store")
        try:
            # pickled here by value: a tensor put as it is travels as a
            # shared-memory handle, gone once this process exits
            results.put(("ok", rank, pickle.dumps(fn(*args))))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:  # reported to the spawner, which raises it
        results.put(("error", rank, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, backend: str, args=(), threads: int | None = None,
              timeout: float = 900.0) -> list:
    """Run `fn(*args)` in `world` spawned processes that form one job (a
    rendezvous through a file); returns each rank's return value, by rank.

    `fn` must be importable by name (the processes start fresh). Each
    process joins the default process group with `backend` before `fn` and
    leaves it after; `threads` sets torch's intra-op threads in each. The
    first rank that fails, or a job that outlasts `timeout` seconds, ends
    every process and raises.
    """
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="run_ranks_") as tmp:
        # the job goes through a file: a start whose payload outgrows the
        # pipe's buffer waits for that child to import torch, one at a time
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(job, r, world, check_backend(backend), threads, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out = _collect(procs, results, timeout)
    return [out[r] for r in range(world)]


def _collect(procs, results, timeout) -> dict:
    """{rank: result} of every process; on the first failure or after
    `timeout` seconds, end every process and raise."""
    world, out, deadline = len(procs), {}, time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                # poll: a rank that dies without a word is seen within 5 s
                status, rank, value = results.get(
                    timeout=min(5.0, max(deadline - time.monotonic(), 0.1)))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"run_ranks: {world} ranks, exit codes "
                                       f"{[p.exitcode for p in procs]}, no result after "
                                       f"{timeout} s or a rank died") from None
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return out


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def rank_device(device, backend: str) -> torch.device:
    """The device of this rank: `cuda:LOCAL_RANK` under NCCL; under gloo the
    ranks share the cards round-robin (one card: all on `cuda:0`)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl":
        return torch.device("cuda", local_rank())
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


@dataclasses.dataclass
class Mesh:
    """This rank's place in a device mesh and its process groups.

    `axes` names the mesh axes ("gauss", "tile") or ("host", "gauss",
    "tile"), `shape` their sizes; `coords` this rank's coordinate on each.
    `groups[axes]` is the process group through this rank along those axes
    (its members in row-major order of those axes).
    """

    axes: tuple
    shape: tuple
    rank: int
    coords: dict
    backend: str
    device: torch.device
    groups: dict
    timing: bool = False
    stats: dict = dataclasses.field(default_factory=lambda: defaultdict(
        lambda: {"calls": 0, "bytes": 0, "ms": 0.0}))

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axes, self.shape))

    def size(self, axes) -> int:
        return math.prod(self.sizes[a] for a in _axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major index along `axes` (its shard of rows)."""
        axes = _axes(axes)
        return int(np.ravel_multi_index([self.coords[a] for a in axes],
                                         [self.sizes[a] for a in axes]))

    def group(self, axes):
        return self.groups[_axes(axes)]

    def reset_stats(self) -> None:
        self.stats.clear()


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def make_mesh_groups(axes, shape, backend: str, device) -> Mesh:
    """The Mesh of this rank over the default process group, whose size must
    be the product of `shape`. Every rank of the job must call this, in the
    same order: `dist.new_group` is collective."""
    axes, shape = tuple(axes), tuple(int(s) for s in shape)
    check_backend(backend)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {math.prod(shape)} ranks, "
                         f"the job has {world}")
    rank = dist.get_rank()
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    grid = np.arange(world).reshape(shape)
    gauss_axes = tuple(a for a in axes if a != "tile")
    wanted = [(a,) for a in axes] + ([gauss_axes] if len(gauss_axes) > 1 else [])
    groups = {}
    for sub in wanted:
        keep = [axes.index(a) for a in sub]
        other = [i for i in range(len(axes)) if i not in keep]
        # one group per fiber: the other axes fixed, `sub` varying row-major
        fibers = np.transpose(grid, other + keep).reshape(-1, math.prod(shape[i] for i in keep))
        for ranks in fibers:
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                groups[sub] = g
    return Mesh(axes=axes, shape=shape, rank=rank, coords=coords, backend=backend,
                device=torch.device(device), groups=groups)


class _Timed:
    """Counts one collective on `mesh.stats[name]`."""

    def __init__(self, mesh: Mesh, name: str, nbytes: int):
        self.mesh, self.name, self.nbytes = mesh, name, nbytes

    def __enter__(self):
        if self.mesh.timing and self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        if self.mesh.timing and self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        rec = self.mesh.stats[self.name]
        rec["calls"] += 1
        rec["bytes"] += self.nbytes
        rec["ms"] += (time.perf_counter() - self.t) * 1e3


def _all_gather_fn():
    # `all_gather_single` is the newer name of `all_gather_into_tensor`
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(x: torch.Tensor, mesh: Mesh, axes, name: str = "all_gather") -> torch.Tensor:
    """Concatenation along dim 0 of `x` from every rank of the group along
    `axes`, in group order; every rank's `x` has the same shape."""
    group = mesh.group(axes)
    n = dist.get_world_size(group)
    bool_in = x.dtype == torch.bool
    src = x.view(torch.uint8) if bool_in else x
    src = src.contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    with _Timed(mesh, name, out.numel() * out.element_size()):
        _all_gather_fn()(out, src, group=group)
    return out.view(torch.bool) if bool_in else out


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axes, name: str = "all_reduce") -> torch.Tensor:
    """Sum of `x` over the group along `axes` (a new tensor)."""
    group = mesh.group(axes)
    buf = x.detach().clone()
    with _Timed(mesh, name, buf.numel() * buf.element_size()):
        dist.all_reduce(buf, group=group)
    return buf


def gather_counts(values, mesh: Mesh, axes, name: str = "counts") -> np.ndarray:
    """(group size, len(values)) int64 host array of every rank's small
    integer vector, in group order. One host sync."""
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=dev)
    out = all_gather(t[None], mesh, axes, name)
    return out.cpu().numpy()


def _gather_padded(x: torch.Tensor, member_rows, mesh: Mesh, axis: str, name: str):
    """Rows of every member along `axis` (member i holds member_rows[i]):
    padded to the largest, gathered, the padding dropped."""
    m = max(int(r) for r in member_rows)
    pad = x.new_zeros((m - x.shape[0],) + tuple(x.shape[1:]))
    full = all_gather(torch.cat([x, pad]), mesh, axis, name)
    if all(int(r) == m for r in member_rows):
        return full
    return torch.cat([full[i * m:i * m + int(r)] for i, r in enumerate(member_rows)])


def gather_ragged(x: torch.Tensor, sizes, mesh: Mesh, axes, name: str = "gather_rows"):
    """Concatenation in row-major rank order over `axes` of each rank's rows,
    rank i holding sizes[i] of them. Innermost axis first, as
    `pipeline.py:154-157` gathers: within a host before across hosts."""
    axes = _axes(axes)
    dims = [mesh.sizes[a] for a in axes]
    s = np.asarray(sizes, dtype=np.int64).reshape(dims)
    mine = [mesh.coords[a] for a in axes]
    for i in reversed(range(len(axes))):
        blocks = s.sum(axis=tuple(range(i + 1, len(dims)))) if i + 1 < len(dims) else s
        x = _gather_padded(x, blocks[tuple(mine[:i])], mesh, axes[i], name)
    return x


class _GatherRows(torch.autograd.Function):
    """Forward: this rank's screen-packet rows (compacted to `sel` when
    given) gathered from every rank of its gaussian axes. Backward: the
    exact transpose for the band pipeline.

    Every rank of one tile column blends the same band from the same
    gathered rows, so each holds the same cotangent for every gathered row;
    summing those copies over the gaussian axes (a reduce-scatter) would
    count each band's cotangent G times. The transpose keeps the block of
    rows this rank sent, scatters it back to its own rows (the compaction's
    transpose), and sums over the tile group the cotangents of the bands
    that read them, with one all_reduce.
    """

    @staticmethod
    def forward(ctx, x, sel, sizes, mesh, gauss_axes):
        ctx.mesh, ctx.gauss_axes, ctx.n = mesh, gauss_axes, x.shape[0]
        flat = mesh.index(gauss_axes)
        ctx.block = (int(np.sum(sizes[:flat])), int(sizes[flat]))
        ctx.save_for_backward(sel)
        rows = x if sel is None else x[sel]
        return gather_ragged(rows, sizes, mesh, gauss_axes, "gather_rows")

    @staticmethod
    def backward(ctx, grad):
        (sel,) = ctx.saved_tensors
        start, count = ctx.block
        own = grad[start:start + count]
        if sel is not None:
            own = own.new_zeros((ctx.n,) + tuple(own.shape[1:])).index_add_(0, sel, own)
        return all_reduce_sum(own, ctx.mesh, "tile", "reduce_row_grads"), None, None, None, None


def gather_rows(x, sizes, mesh: Mesh, gauss_axes, sel=None):
    """Differentiable gather of (n, C) packet rows over the gaussian axes;
    `sizes[i]` rows come from gaussian shard i (len(sel) from this one)."""
    return _GatherRows.apply(x, sel, np.asarray(sizes, dtype=np.int64), mesh, _axes(gauss_axes))


class _GatherBands(torch.autograd.Function):
    """Forward: the tile bands of one image, (h_band, W, C) from each rank
    of the tile group, stacked along the rows. Backward: this rank's band of
    the cotangent. Every rank computes the loss on the same gathered image,
    so the cotangent of its band is there whole on every rank: summing it
    over the group (the transpose of a plain all_gather) would count it T
    times."""

    @staticmethod
    def forward(ctx, band, mesh):
        ctx.rows = (mesh.coords["tile"] * band.shape[0], band.shape[0])
        return all_gather(band, mesh, "tile", "gather_bands")

    @staticmethod
    def backward(ctx, grad):
        start, n = ctx.rows
        return grad[start:start + n], None


def gather_bands(band, mesh: Mesh):
    return _GatherBands.apply(band, mesh)

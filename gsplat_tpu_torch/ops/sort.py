"""The instance sort: kernels St'' (`csrc/sort.cu`) and St'
(`csrc/sort_onesweep.cu`), and their plain twin.

`pack_bins` sorts K1''s instance keys `(tile << 32) | depth_bits` with
their gaussian ids as payload, in place of the JAX package's `lax.sort`
(`gsplat_tpu/ops/binning.py:758`). The result is the JAX total order
(tile, depth bits, gaussian id): slots come in gid order and the sort is
stable.

`sort_instances` launches one of two routes on CUDA tensors, by the number
of keys K and the keys' live bits (`route`):

- St'', up to ONESWEEP_MIN_KEYS keys of at most SEGMENTED_MAX_KEY_BITS (46)
  bits: a segmented sort in three launches.
  A count of each tile's keys (the tile field only partitions them), an
  unordered scatter of each key into its tile's bucket as the value
  `(depth_bits << 32) | slot`, and a sort of each bucket by that value on
  chip, which writes the keys and gathers each slot's gid. The slot rides
  in the value, so the values are unique and their order is the stable
  order: neither the order in which blocks reserve their ranges of a
  bucket nor a key's rank inside a range matters. A tile of up to 1,024
  keys takes a warp (a merge sort in its shared memory), a larger one the
  block; one of more than CAP keys (2,048; `sort_layout`) takes the big
  route, chosen on the card: its CAP runs sorted, then merged pairwise
  through device memory by the block.
- St', for more keys or wider ones (up to MAX_KEY_BITS, 62): an LSD radix
  sort over the key's live bits (bit 31 taken out), 8 bits a pass, with the
  gid as payload: a histogram launch, then a
  launch a pass, each pass ranking a tile of keys stably within its warps
  and finding each digit's place by a decoupled look-back. Its passes cost
  the same per key at any K; St'''s scatter writes into buckets that
  outgrow L2 as K grows, and more of its tiles go over CAP: on an H100 the
  two cross between 7.3M and 11.0M keys of the flagship's tiles (`PERF.md`
  §6, `scripts/sort_ablate.py`).

The plain twin `sort_instances_torch` is `torch.sort(keys, stable=True)`
and the gather of the gids by the permutation; both routes agree with it
bit for bit.

Precondition of the kernels: every key is one K1' emits for a slot whose
depth is above 0.2 (the projection's valid rows; others emit no slot), so
bit 31 of every key (the depth's sign) is 0 and the key with that bit taken
out lies under 2^key_bits. `sort_key_bits(num_tiles)` gives the key_bits
of a tile grid: 31 depth bits and the tile id's. St'' keeps a counter a
tile id in shared memory, so it takes at most 2^15 tile ids (key_bits 46:
3840x2160 has 32,400 tiles). A grid of more (4096x2160 has 34,560, key_bits
47) takes St' whatever K: it sorts keys of up to 62 bits (2^31 tile ids),
in ceil(key_bits / 8) passes, six from 41 to 48 bits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

MAX_KEY_BITS = 62  # St''s widest keys (`csrc/sort_onesweep.cu`)
SEGMENTED_MAX_KEY_BITS = 46  # St'''s: a shared counter a tile id, 2^15 of them
ONESWEEP_MIN_KEYS = 1 << 23  # St' for more keys than this, St'' up to it
_states: dict = {}  # device -> St'''s state (int64 words), zeroed once
_EPOCHS = 1 << 30  # St''s epochs: [1, 2^30) (`csrc/sort_onesweep.cu`)
_onesweep_states: dict = {}  # (device, digit bits, tile) -> (St''s state, its next epoch)


def sort_key_bits(num_tiles: int) -> int:
    """The live bits of K1''s keys on a grid of `num_tiles` tiles: 31
    depth bits and the tile id's."""
    return 31 + max(1, (num_tiles - 1).bit_length())


def live_bits(keys):
    """The keys with bit 31 taken out (int64): under 2^key_bits."""
    return ((keys >> 32) << 31) | (keys & 0x7FFFFFFF)


def sort_instances_torch(keys, gid, key_bits):
    """Plain twin of `sort_instances`: `torch.sort(keys, stable=True)` and
    the gids gathered by its permutation. `key_bits` is not read."""
    keys_sorted, perm = torch.sort(keys, stable=True)
    return keys_sorted, gid[perm]


def route(k: int, key_bits: int) -> str:
    """The kernel `sort_instances` launches for `k` keys of `key_bits` live
    bits: "segmented" (St'') or "onesweep" (St'), which also takes every
    key too wide for St'''s tile counters."""
    if key_bits > SEGMENTED_MAX_KEY_BITS or k > ONESWEEP_MIN_KEYS:
        return "onesweep"
    return "segmented"


def _check(keys, gid, key_bits):
    k, dev = keys.shape[0], keys.device
    for t, dtype, what in ((keys, torch.int64, "keys"), (gid, torch.int32, "gid")):
        if t.dtype != dtype or tuple(t.shape) != (k,) or t.device != dev:
            raise ValueError(f"sort_instances: {what} must be {dtype} ({k},) on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= key_bits <= MAX_KEY_BITS:
        raise ValueError(f"sort_instances: key_bits={key_bits}, expected 1 ... {MAX_KEY_BITS}")
    if k >= 2**31:  # the kernels' places and counts are 32-bit
        raise ValueError(f"sort_instances: {k} keys, the kernel takes < 2^31")


def _state(dev, words):
    """St'''s state on `dev`, at least `words` int64 words: zeroed when
    allocated (grown by doubling); the kernels return its counters to 0
    and write its tables before they read them."""
    state = _states.get(dev)
    if state is None or state.numel() < words:
        cap = words if state is None else max(words, 2 * state.numel())
        state = torch.zeros((cap,), dtype=torch.int64, device=dev)
        _states[dev] = state
    return state


class SortLayout(NamedTuple):
    """St'''s layout for a sort, as built (`gs_sort_layout`)."""

    words: int  # int64 words of the state
    tile_bins: int  # 2^(key_bits - 31)
    cap: int  # the largest tile a block sorts in one piece; over it the big route
    blocks: int  # the count's and the scatter's blocks
    segment_blocks: int
    warp_cap: int  # the largest tile a warp sorts


def _check_segmented(key_bits):
    if not 1 <= key_bits <= SEGMENTED_MAX_KEY_BITS:
        raise ValueError(f"St'' (segmented sort): key_bits={key_bits}, expected 1 ... "
                         f"{SEGMENTED_MAX_KEY_BITS}")


def sort_layout(k, key_bits):
    """St'''s `SortLayout` for `k` keys of `key_bits` (at most
    SEGMENTED_MAX_KEY_BITS), on the current device."""
    from gsplat_tpu_torch import _kernels

    _check_segmented(key_bits)
    out = (ctypes.c_longlong * 6)()
    err = _kernels.load("sort").gs_sort_layout(k, key_bits, ctypes.addressof(out))
    _kernels.check(err, "sort_layout")
    return SortLayout(*out)


def sort_stats(dev):
    """(tiles over CAP, keys of the largest tile) of the last St'' sort on
    `dev`, as its count kernel found them (a read that waits for the
    card)."""
    head = _states[torch.device(dev)][:2].view(torch.int32).tolist()
    return head[1], head[2]


def onesweep_layout(k, key_bits):
    """St''s layout as built: (state words for `k` keys, passes over
    `key_bits`, digit bits, keys a block of a pass)."""
    from gsplat_tpu_torch import _kernels

    out = (ctypes.c_longlong * 4)()
    err = _kernels.load("sort_onesweep").gs_sort_layout(k, key_bits, ctypes.addressof(out))
    _kernels.check(err, "sort_onesweep layout")
    return tuple(out)


def _onesweep_state(key, passes, words):
    """St''s state for `key` (device, digit bits, tile), at least `words`
    int64 words, and the first of `passes` new epochs on it. Zeroed when
    allocated (grown by doubling) and when its epochs run out: the
    look-back words, the digit counters and the ticket stay 0 or carry an
    epoch of an earlier pass."""
    state, first = _onesweep_states.get(key, (None, 1))
    if state is None or state.numel() < words:
        cap = words if state is None else max(words, 2 * state.numel())
        state, first = torch.zeros((cap,), dtype=torch.int64, device=key[0]), 1
    elif first + passes >= _EPOCHS:
        state.zero_()
        first = 1
    _onesweep_states[key] = (state, first + passes)
    return state, first


def _sort_segmented(keys, gid, key_bits, keys_out, gid_out):
    from gsplat_tpu_torch import _kernels

    _check_segmented(key_bits)
    k, dev = keys.shape[0], keys.device
    # the buckets: each key's value (depth bits and slot), grouped by tile
    bucket = torch.empty_like(keys_out)
    state = _state(dev, sort_layout(k, key_bits).words)
    err = _kernels.load("sort").gs_sort_instances(
        keys.data_ptr(), gid.data_ptr(), k, key_bits, bucket.data_ptr(), keys_out.data_ptr(),
        gid_out.data_ptr(), state.data_ptr(), state.numel(), _kernels.stream(dev),
    )
    _kernels.check(err, "sort_instances")


def _sort_onesweep(keys, gid, key_bits, keys_out, gid_out):
    from gsplat_tpu_torch import _kernels

    k, dev = keys.shape[0], keys.device
    keys_tmp, gid_tmp = torch.empty_like(keys_out), torch.empty_like(gid_out)
    words, passes, digit_bits, tile = onesweep_layout(k, key_bits)
    # one state per digit width and tile: a build of another layout
    # (`scripts/sort_ablate.py`) keeps its own
    state, epoch = _onesweep_state((dev, digit_bits, tile), passes, words)
    err = _kernels.load("sort_onesweep").gs_sort_instances(
        keys.data_ptr(), gid.data_ptr(), k, key_bits, keys_tmp.data_ptr(), gid_tmp.data_ptr(),
        keys_out.data_ptr(), gid_out.data_ptr(), state.data_ptr(), state.numel(), epoch,
        _kernels.stream(dev),
    )
    _kernels.check(err, "sort_instances (onesweep)")


def sort_instances(keys, gid, key_bits):
    """Kernel St'' or St' (`route(K, key_bits)`): (keys_sorted (K,) int64, gid_sorted
    (K,) int32), bit for bit `sort_instances_torch`. CUDA tensors only;
    K = 0 launches nothing. The keys must meet the precondition in the
    module's notes."""
    if not keys.is_cuda:
        raise ValueError("sort_instances launches a CUDA kernel: tensors must be on a CUDA device")
    _check(keys, gid, key_bits)
    k, dev = keys.shape[0], keys.device
    keys, gid = keys.contiguous(), gid.contiguous()
    if keys.data_ptr() % 16:  # the count and the histogram read two keys a load
        raise ValueError("sort_instances: keys must be 16-byte aligned")
    keys_out = torch.empty((k,), dtype=torch.int64, device=dev)
    gid_out = torch.empty((k,), dtype=torch.int32, device=dev)
    if k == 0:
        return keys_out, gid_out
    taken = route(k, key_bits)
    (_sort_onesweep if taken == "onesweep" else _sort_segmented)(keys, gid, key_bits, keys_out,
                                                               gid_out)
    sort_instances.launches += 1
    sort_instances.last_route = taken
    return keys_out, gid_out


sort_instances.launches = 0
sort_instances.last_route = None  # the route of the last launch

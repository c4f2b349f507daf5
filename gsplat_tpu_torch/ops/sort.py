"""The instance sort: kernel St' (`csrc/sort.cu`) and its plain twin.

`pack_bins` sorts K1''s instance keys `(tile << 32) | depth_bits` with
their gaussian ids as payload, in place of the JAX package's `lax.sort`
(`gsplat_tpu/ops/binning.py:758`). The result is the JAX total order
(tile, depth bits, gaussian id): slots come in gid order and the sort is
stable.

`sort_instances` launches St' on CUDA tensors: an LSD radix sort over the
key's live bits, `key_bits` of them, with the int32 gid as payload (one
histogram launch, then one launch a pass). Its plain twin
`sort_instances_torch` is `torch.sort(keys, stable=True)` and the gather
of the gids by the permutation; the two agree bit for bit.

Precondition of the kernel: every key is one K1' emits for a slot whose
depth is above 0.2 (the projection's valid rows; others emit no slot), so
bit 31 of every key (the depth's sign) is 0 and the key with that bit taken
out lies under 2^key_bits. `sort_key_bits(num_tiles)` gives the key_bits
of a tile grid: 31 depth bits and the tile id's.
"""

from __future__ import annotations

import ctypes

import torch

MAX_KEY_BITS = 62
_EPOCHS = 1 << 30  # the state's epochs: [1, 2^30) (`csrc/sort.cu`)
_states: dict = {}  # (device, digit bits, tile) -> (St''s state, its next epoch)


def sort_key_bits(num_tiles: int) -> int:
    """The live bits of K1''s keys on a grid of `num_tiles` tiles: 31
    depth bits and the tile id's."""
    return 31 + max(1, (num_tiles - 1).bit_length())


def live_bits(keys):
    """The keys with bit 31 taken out, as St' sorts them (int64)."""
    return ((keys >> 32) << 31) | (keys & 0x7FFFFFFF)


def sort_instances_torch(keys, gid, key_bits):
    """Plain twin of `sort_instances`: `torch.sort(keys, stable=True)` and
    the gids gathered by its permutation. `key_bits` is not read."""
    keys_sorted, perm = torch.sort(keys, stable=True)
    return keys_sorted, gid[perm]


def _check(keys, gid, key_bits):
    k, dev = keys.shape[0], keys.device
    for t, dtype, what in ((keys, torch.int64, "keys"), (gid, torch.int32, "gid")):
        if t.dtype != dtype or tuple(t.shape) != (k,) or t.device != dev:
            raise ValueError(f"sort_instances: {what} must be {dtype} ({k},) on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= key_bits <= MAX_KEY_BITS:
        raise ValueError(f"sort_instances: key_bits={key_bits}, expected 1 ... {MAX_KEY_BITS}")
    if k >= 2**31:  # the kernel's places and counts are 32-bit
        raise ValueError(f"sort_instances: {k} keys, the kernel takes < 2^31")


def _state(key, passes, words):
    """St''s state for `key` (device, digit bits, tile), at least `words`
    int64 words, and the first of `passes` new epochs on it. The state is
    zeroed when allocated (grown by doubling) and when its epochs run out:
    the look-back words, the digit counters and the ticket stay 0 or carry
    an epoch of an earlier pass."""
    state, first = _states.get(key, (None, 1))
    if state is None or state.numel() < words:
        cap = words if state is None else max(words, 2 * state.numel())
        state, first = torch.zeros((cap,), dtype=torch.int64, device=key[0]), 1
    elif first + passes >= _EPOCHS:
        state.zero_()
        first = 1
    _states[key] = (state, first + passes)
    return state, first


def sort_layout(k, key_bits):
    """St''s layout as built: (state words for `k` keys, passes over
    `key_bits`, digit bits, keys a block of a pass)."""
    from gsplat_tpu_torch import _kernels

    out = (ctypes.c_longlong * 4)()
    err = _kernels.load("sort").gs_sort_layout(k, key_bits, ctypes.addressof(out))
    _kernels.check(err, "sort_layout")
    return tuple(out)


def sort_instances(keys, gid, key_bits):
    """Kernel St': (keys_sorted (K,) int64, gid_sorted (K,) int32), bit for
    bit `sort_instances_torch`. CUDA tensors only; K = 0 launches nothing.
    The keys must meet the precondition in the module's notes."""
    from gsplat_tpu_torch import _kernels

    if not keys.is_cuda:
        raise ValueError("sort_instances launches a CUDA kernel: tensors must be on a CUDA device")
    _check(keys, gid, key_bits)
    k, dev = keys.shape[0], keys.device
    keys, gid = keys.contiguous(), gid.contiguous()
    if keys.data_ptr() % 16:  # the histogram reads two keys a load
        raise ValueError("sort_instances: keys must be 16-byte aligned")
    keys_out = torch.empty((k,), dtype=torch.int64, device=dev)
    gid_out = torch.empty((k,), dtype=torch.int32, device=dev)
    if k == 0:
        return keys_out, gid_out
    keys_tmp, gid_tmp = torch.empty_like(keys_out), torch.empty_like(gid_out)
    words, passes, digit_bits, tile = sort_layout(k, key_bits)
    # one state per digit width and tile: a build of another layout
    # (`scripts/sort_ablate.py`) keeps its own
    state, epoch = _state((dev, digit_bits, tile), passes, words)
    err = _kernels.load("sort").gs_sort_instances(
        keys.data_ptr(), gid.data_ptr(), k, key_bits, keys_tmp.data_ptr(), gid_tmp.data_ptr(),
        keys_out.data_ptr(), gid_out.data_ptr(), state.data_ptr(), state.numel(), epoch,
        _kernels.stream(dev),
    )
    _kernels.check(err, "sort_instances")
    sort_instances.launches += 1
    return keys_out, gid_out


sort_instances.launches = 0

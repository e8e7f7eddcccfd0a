"""Preallocated slot caches, the port of ``mxnet_tpu/serving/decode/cache.py``.

Every cache tensor's leading axis is the *slot* axis: a fixed register
file of ``slots`` in-flight sequences, so the decode step always runs
one shape and continuous batching swaps sequences in and out of slots.

The JAX package donates the cache to its compiled programs and updates
it functionally. The port updates the cache tensors **in place**
(indexed assignment), so a prefill or a step costs the rows it writes,
never a copy of the cache:

  * :func:`write_slot`     -- replace one slot's whole state (a prefill
                              landing its computed KV prefix);
  * :func:`write_position` -- write one row per slot at that slot's own
                              position (the decode-step KV append);
  * :func:`init_cache`     -- the zero-filled ``{name: tensor}`` cache.
"""
from __future__ import annotations

import numpy as onp
import torch
import torch.nn.functional as F

__all__ = ['CacheSpec', 'cache_bytes', 'init_cache', 'write_slot',
           'write_position']


class CacheSpec:
    """Metadata for one decode cache: ``{name: (per_slot_shape,
    dtype)}``; the tensor for ``slots`` sequences is ``(slots,) +
    per_slot_shape``."""

    __slots__ = ('entries',)

    def __init__(self, entries):
        self.entries = {str(k): (tuple(int(d) for d in shape), str(dt))
                        for k, (shape, dt) in dict(entries).items()}

    def items(self):
        return self.entries.items()

    def full_shape(self, name, slots):
        shape, _ = self.entries[name]
        return (int(slots),) + shape

    def __repr__(self):
        return 'CacheSpec(%r)' % (self.entries,)


def cache_bytes(spec, slots):
    """Static cache footprint in bytes for ``slots`` sequences."""
    total = 0
    for _name, (shape, dt) in spec.items():
        n = int(slots)
        for d in shape:
            n *= d
        total += n * onp.dtype(dt).itemsize
    return total


def init_cache(spec, slots, device):
    """Zero-filled cache ``{name: (slots, *per_slot_shape)}`` on
    ``device``.

    Zeros (not empty) on purpose: stale-slot garbage must stay finite so
    masked-out attention rows multiply to exact 0.0 instead of
    propagating NaNs from uninitialised memory.
    """
    return {name: torch.zeros(spec.full_shape(name, slots),
                              dtype=getattr(torch, dt), device=device)
            for name, (_, dt) in spec.items()}


def write_slot(cache_arr, slot_state, slot):
    """Replace slot ``slot``'s state in place: ``slot_state`` (n, ...)
    lands in rows ``0..n-1`` and the rest of the slot is zeroed, so
    values from the slot's previous occupant never sit under a live
    sequence. ``slot`` is an int or a one-element integer tensor on the
    cache's device (a captured program's input: no host read). Returns
    ``cache_arr``."""
    n = slot_state.shape[0]
    row = F.pad(slot_state, (0, 0) * (slot_state.dim() - 1)
                + (0, cache_arr.shape[1] - n))
    slot = torch.as_tensor(slot, dtype=torch.int64,
                           device=cache_arr.device).reshape(1)
    cache_arr.index_copy_(0, slot, row[None].to(cache_arr.dtype))
    return cache_arr


def write_position(cache_arr, rows, positions):
    """Write ``rows[s]`` at ``cache_arr[s, positions[s]]`` for every
    slot, in place -- O(slots x row), never O(slots x max_len).
    ``positions`` is a (slots,) int64 tensor on the cache's device.
    Returns ``cache_arr``."""
    slots = torch.arange(cache_arr.shape[0], device=cache_arr.device)
    cache_arr[slots, positions] = rows
    return cache_arr

"""Freezing a gluon Block into a one-shot inference program, the port of
``mxnet_tpu/serving/freeze.py`` (``FrozenProgram`` :54-236, ``freeze``
:397-465).

A :class:`FrozenProgram` holds a :class:`~..gluon.Block` of the port with
its parameters on one device, the per-example input shapes and a batch
bucket ladder. :meth:`FrozenProgram.run` zero-pads a stacked batch to its
bucket, runs the block under ``torch.inference_mode()`` and returns numpy
outputs with the padding stripped, so the batch shapes the card ever sees
are bounded by the ladder. PyTorch runs eagerly: nothing is traced or
compiled ahead of time, and :meth:`FrozenProgram.warmup` runs each bucket
once so that the first request finds the card's libraries loaded and
their algorithms chosen for every bucket.

:meth:`FrozenProgram.run_fallback` runs the same block on the CPU, from a
host copy of its parameters taken when the program is made (after a real
fault the card's context may be dead, so the fallback never reads a CUDA
tensor): the degraded path the session serves a batch on after a
transient device fault or while its breaker is open.

The JAX package's symbolic path (a ``Module``, a ``FeedForward``, a
``(symbol, arg_params, aux_params)`` triple) and the on-disk artifact
(``save`` / ``load`` / ``load_frozen``, ROADMAP: "frozen-artifact
persistence, then the HTTP server") are not ported.
"""
from __future__ import annotations

import copy
import itertools
import threading

import numpy as onp
import torch

from .. import config as _config
from ..context import resolve_device
from ..gluon.block import Block
from .bucket import BucketPolicy, unpad_axis0

__all__ = ['FrozenProgram', 'freeze']


def _host_copy(block):
    """``block`` with every parameter and buffer copied to the host, the
    copies made straight from the originals (no second copy on the
    card)."""
    memo = {}
    for t in itertools.chain(block.parameters(), block.buffers()):
        host = t.detach().to('cpu', copy=True)
        memo[id(t)] = torch.nn.Parameter(host, t.requires_grad) \
            if isinstance(t, torch.nn.Parameter) else host
    return copy.deepcopy(block, memo)


class FrozenProgram:
    """Inference program: a Block over fixed parameters on one device,
    batched through a bucket ladder.

    ``data_descs`` is ``[(name, per_example_shape, dtype)]`` for the
    request inputs (no batch axis), in the order the block's ``forward``
    takes them. The block's outputs (a tensor or a tuple of tensors) come
    back as a list of numpy arrays. The parameters are fixed: the CPU
    fallback's host copy of them is taken here.
    """

    def __init__(self, block, data_descs, policy=None, name='model'):
        self.block = block
        param = next(block.parameters(), None)
        self.device = param.device if param is not None \
            else resolve_device(None)
        self.name = name
        self.policy = policy if policy is not None else BucketPolicy()
        self.data_descs = [(str(n), tuple(int(d) for d in s), str(dt))
                           for n, s, dt in data_descs]
        self._ran = set()   # buckets run at least once
        self._lock = threading.Lock()
        with self._lock:
            self._host_block = block if self.device.type == 'cpu' \
                else _host_copy(block)

    @property
    def compile_count(self):
        """Distinct buckets run so far (warmed or served): the quantity
        the ladder bounds."""
        return len(self._ran)

    def warmup(self, buckets=None):
        """Run every bucket once on zeros (server start, not the first
        request)."""
        for b in (buckets or self.policy.buckets):
            self.run([onp.zeros((b,) + s, dtype=dt)
                      for _n, s, dt in self.data_descs])
        return self

    def run(self, arrays, n=None):
        """Run ``arrays`` (one stacked numpy array per input) at the
        bucket of ``n`` rows (default: the first array's); returns the
        outputs as numpy with the padding stripped back to ``n`` rows.
        Batches above the top bucket run as top-bucket chunks (the bulk
        path; concurrent requests are the micro-batcher's job)."""
        arrays = [onp.asarray(a) for a in arrays]
        if n is None:
            n = arrays[0].shape[0]
        top = self.policy.max_batch
        if n > top:
            chunks = [self.run([a[i:i + top] for a in arrays])
                      for i in range(0, n, top)]
            return [onp.concatenate([c[j] for c in chunks], axis=0)
                    for j in range(len(chunks[0]))]
        padded, n = self.policy.pad(arrays, n)
        with torch.inference_mode():
            data = [torch.from_numpy(onp.ascontiguousarray(
                a.astype(dt, copy=False))).to(self.device)
                for (_n, _s, dt), a in zip(self.data_descs, padded)]
            outs = self.block(*data)
            if isinstance(outs, torch.Tensor):
                outs = (outs,)
            host = [o.cpu().numpy() for o in outs]
        self._ran.add(padded[0].shape[0])
        return [unpad_axis0(o, n) for o in host]

    def run_fallback(self, arrays, n=None):
        """The degraded path: :meth:`run`'s padding and block, run on the
        CPU from the host copy of the parameters; no CUDA tensor is
        touched. Returns the outputs as numpy, unpadded to ``n`` rows."""
        arrays = [onp.asarray(a) for a in arrays]
        if n is None:
            n = arrays[0].shape[0]
        padded, n = self.policy.pad(arrays, n)
        with torch.inference_mode():
            data = [torch.from_numpy(onp.ascontiguousarray(
                a.astype(dt, copy=False)))
                for (_n, _s, dt), a in zip(self.data_descs, padded)]
            outs = self._host_block(*data)
            if isinstance(outs, torch.Tensor):
                outs = (outs,)
            host = [o.numpy() for o in outs]
        return [unpad_axis0(o, n) for o in host]


def freeze(block, data_shapes, buckets=None, max_batch=None, name=None):
    """Freeze a gluon :class:`~..gluon.Block` of the port into a
    :class:`FrozenProgram`.

    The block is switched to inference mode (``train(False)``: moving
    statistics normalize, dropout is the identity). ``data_shapes`` are
    the per-example input shapes (no batch axis),
    ``[(name, shape)]`` or ``[(name, shape, dtype)]`` (float32 by
    default). ``buckets`` is an explicit batch ladder (a sequence or a
    comma list; default ``MXNET_TPU_SERVE_BUCKETS``, else powers of two up
    to ``max_batch``, default ``MXNET_TPU_SERVE_MAX_BATCH``). The program
    runs where the block's parameters are."""
    if not isinstance(block, Block):
        raise TypeError(
            'freeze takes a gluon Block of the port; got %s. The symbolic '
            'API (Module, FeedForward, (symbol, arg_params, aux_params)) '
            'is not ported' % type(block).__name__)
    if not data_shapes:
        raise ValueError('data_shapes required: the per-example input '
                         'shapes (no batch axis)')
    descs = []
    for d in data_shapes:
        if len(d) == 3 and not isinstance(d[1], (int, float)):
            n, s, dt = d
        else:
            n, s, dt = d[0], d[1], 'float32'
        descs.append((n, tuple(int(x) for x in s), str(dt)))
    if buckets is None:
        buckets = _config.get('MXNET_TPU_SERVE_BUCKETS') or None
    if max_batch is None:
        max_batch = _config.get('MXNET_TPU_SERVE_MAX_BATCH')
    policy = BucketPolicy(buckets=buckets, max_batch=max_batch)
    block.train(False)
    return FrozenProgram(block, descs, policy=policy,
                         name=name or type(block).__name__.lower())

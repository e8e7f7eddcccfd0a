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
their algorithms chosen for every bucket. A bucket's first run is its
build: it counts one ``mxnet_tpu_serve_compiles_total`` and records
``serve_compile`` with the bucket and the run's seconds, as the
reference's ``compile`` does.

:meth:`FrozenProgram.run_fallback` runs the same block on the CPU, from a
host copy of its parameters taken when the program is made (after a real
fault the card's context may be dead, so the fallback never reads a CUDA
tensor): the degraded path the session serves a batch on after a
transient device fault or while its breaker is open.

:meth:`FrozenProgram.save` writes the reference's artifact
(``mxnet_tpu.frozen.v1``: ``MANIFEST.json`` and ``params.npz`` with
``arg:`` / ``aux:`` names) and :meth:`FrozenProgram.load` reads it back.
The port has no symbol graph to store, so the manifest's ``zoo`` key
names the model-zoo constructor that built the block, with its keyword
arguments (:mod:`~..gluon.model_zoo.stamp`); a block no zoo constructor
built cannot be saved, and a reference artifact (``symbol.json``, no
``zoo``) cannot be loaded: both raise NotImplementedError, naming the
symbolic API. :func:`load_frozen` dispatches any artifact on its
manifest: an adapter, a decode program or a one-shot program.

The JAX package's symbolic path (a ``Module``, a ``FeedForward``, a
``(symbol, arg_params, aux_params)`` triple) is not ported.
"""
from __future__ import annotations

import copy
import io
import itertools
import json
import os
import threading
import time

import numpy as onp
import torch

from .. import config as _config
from ..context import resolve_device
from ..gluon.block import Block
from ..observability import emit as _emit
from ..resilience.checkpoint import atomic_write_bytes
from .bucket import BucketPolicy, unpad_axis0

__all__ = ['FROZEN_SCHEMA', 'FrozenProgram', 'freeze', 'load_frozen']

FROZEN_SCHEMA = 'mxnet_tpu.frozen.v1'
_SYMBOLIC = ('the symbolic API (symbol.json) is not ported (ROADMAP A10 / '
             'A11): the port saves and loads one-shot programs of blocks '
             'built by a model-zoo constructor (ssd_300, ssd_detector, '
             'get_resnet and its variants, get_bert, bert_12_768_12)')


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

    def __init__(self, block, data_descs, policy=None, name='model',
                 host_block=None):
        self.block = block
        param = next(block.parameters(), None)
        self.device = param.device if param is not None \
            else resolve_device(None)
        self.name = name
        self.policy = policy if policy is not None else BucketPolicy()
        self.data_descs = [(str(n), tuple(int(d) for d in s), str(dt))
                           for n, s, dt in data_descs]
        self._ran = set()   # buckets run at least once
        self._n_outputs = None
        self._lock = threading.Lock()
        with self._lock:
            if host_block is None:
                host_block = block if self.device.type == 'cpu' \
                    else _host_copy(block)
            self._host_block = host_block

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
        t0 = time.perf_counter()
        with torch.inference_mode():
            data = [torch.from_numpy(onp.ascontiguousarray(
                a.astype(dt, copy=False))).to(self.device)
                for (_n, _s, dt), a in zip(self.data_descs, padded)]
            outs = self.block(*data)
            if isinstance(outs, torch.Tensor):
                outs = (outs,)
            host = [o.cpu().numpy() for o in outs]
        bucket = padded[0].shape[0]
        with self._lock:
            first = bucket not in self._ran
            self._ran.add(bucket)
        self._n_outputs = len(host)
        if first:
            inst = _emit.serving()
            if inst is not None:
                inst.compiles.inc()
            _emit.event('serve_compile', bucket=bucket,
                        seconds=round(time.perf_counter() - t0, 4))
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
        self._n_outputs = len(host)
        return [unpad_axis0(o, n) for o in host]

    # -- persistence (mxnet_tpu.frozen.v1) ---------------------------------

    def save(self, path, include_programs=True):
        """Write the artifact, the reference's layout
        (``mxnet_tpu/serving/freeze.py:272-331``)::

            <path>/params.npz       arg:<name> (parameters that take a
                                    gradient) and aux:<name> (those that
                                    do not: the moving statistics), under
                                    the block's collect_params() names
            <path>/MANIFEST.json    schema, name, data_descs, buckets,
                                    seq_buckets, n_outputs, and the
                                    block's zoo stamp (``zoo``)

        The parameters come from the fallback's host copy, never off the
        card, and must be float32. The port writes no ``symbol.json``
        (the stamp rebuilds the block) and no executables:
        ``include_programs`` writes nothing and ``programs`` is empty;
        ``jax_version``, ``platform`` and ``donate`` are left out, and
        ``torch_version`` and ``device`` say who wrote it. Every file is
        written atomically, the manifest last. Raises
        NotImplementedError for a block no zoo constructor built.
        Returns ``path``."""
        from ..gluon.model_zoo.stamp import stamp_of
        del include_programs
        stamp = stamp_of(self.block)
        if stamp is None:
            raise NotImplementedError(
                'cannot save %s: its block (%s) carries no zoo stamp, and %s'
                % (self.name, type(self.block).__name__, _SYMBOLIC))
        table = {}
        for key, p in self._host_block.collect_params().tensors().items():
            if p.dtype != torch.float32:
                raise TypeError('cannot save %s: parameter %s is %s, the '
                                'artifact holds float32' % (self.name, key,
                                                            p.dtype))
            tag = 'arg' if p.requires_grad else 'aux'
            table['%s:%s' % (tag, key)] = p.detach().numpy()
        if self._n_outputs is None:
            self.run_fallback([onp.zeros((1,) + s, dtype=dt)
                               for _n, s, dt in self.data_descs])
        os.makedirs(path, exist_ok=True)
        buf = io.BytesIO()
        onp.savez(buf, **table)
        with buf.getbuffer() as view:
            atomic_write_bytes(os.path.join(path, 'params.npz'), view)
        del buf
        manifest = {
            'schema': FROZEN_SCHEMA,
            'name': self.name,
            'data_descs': [[n, list(s), dt] for n, s, dt in self.data_descs],
            'buckets': list(self.policy.buckets),
            'seq_buckets': None,
            'n_outputs': self._n_outputs,
            'zoo': stamp,
            'torch_version': torch.__version__,
            'device': (torch.cuda.get_device_name(self.device)
                       if self.device.type == 'cuda' else 'cpu'),
            'programs': {},
        }
        atomic_write_bytes(
            os.path.join(path, 'MANIFEST.json'),
            (json.dumps(manifest, indent=1, sort_keys=True) + '\n').encode())
        return path

    @classmethod
    def load(cls, path, device=None):
        """Reload a one-shot artifact on ``device`` (default cuda): the
        block rebuilt from its zoo stamp, its parameters from the npz
        (the CPU fallback's host copy is a block built on the host from
        the same arrays; the card's copy goes host to device once), in
        inference mode, at the saved ladder. Nothing runs here:
        ``warmup()`` runs the buckets. Raises ValueError on another
        schema and NotImplementedError for an artifact without a stamp
        (one the JAX package wrote: its graph is ``symbol.json``).
        ``load_seconds`` on the program: ``read`` (the arrays into the
        host block) and ``to_device`` (the device's block built and
        filled)."""
        from ..gluon.model_zoo.stamp import build
        t0 = time.perf_counter()
        with open(os.path.join(path, 'MANIFEST.json')) as f:
            manifest = json.load(f)
        if manifest.get('schema') != FROZEN_SCHEMA:
            raise ValueError('not a %s artifact: %r at %s'
                             % (FROZEN_SCHEMA, manifest.get('schema'), path))
        stamp = manifest.get('zoo')
        if stamp is None:
            raise NotImplementedError(
                'cannot load %s: the artifact carries no zoo stamp%s, and %s'
                % (path, ' (it holds symbol.json)' if os.path.exists(
                    os.path.join(path, 'symbol.json')) else '', _SYMBOLIC))
        device = resolve_device(device)
        host = build(stamp, 'cpu')
        params = host.collect_params().tensors()
        with onp.load(os.path.join(path, 'params.npz')) as z:
            arrays = {key.partition(':')[2]: z[key] for key in z.files}
        if sorted(arrays) != sorted(params):
            raise ValueError('%s: params.npz names %s, the block %s'
                             % (path, sorted(set(arrays) ^ set(params)),
                                'differ'))
        with torch.no_grad():
            for key, p in params.items():
                p.copy_(torch.from_numpy(arrays[key]))
            del arrays
            block = host
            t1 = time.perf_counter()
            if device.type != 'cpu':
                block = build(stamp, device)
                for key, p in block.collect_params().tensors().items():
                    p.copy_(params[key])
        host.train(False)
        block.train(False)
        prog = cls(block, [(n, tuple(s), dt)
                           for n, s, dt in manifest['data_descs']],
                   policy=BucketPolicy(buckets=manifest['buckets']),
                   name=manifest.get('name', 'model'), host_block=host)
        prog._n_outputs = manifest.get('n_outputs')
        prog.load_seconds = {'read': t1 - t0,
                             'to_device': time.perf_counter() - t1}
        return prog


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


def load_frozen(path, device=None):
    """Load any ``mxnet_tpu.frozen.v1`` artifact on ``device`` (default
    cuda), dispatched on its manifest as the reference's
    (``freeze.py:468-492``): an adapter artifact (``mxnet_tpu.adapter.v1``)
    through :func:`~.adapters.load_adapter` (its arrays stay on the host),
    ``kind: decode`` through :meth:`~.decode.DecodeProgram.load` (paged or
    slot by the manifest), anything else through
    :meth:`FrozenProgram.load`."""
    try:
        with open(os.path.join(path, 'MANIFEST.json')) as f:
            doc = json.load(f)
        kind, schema = doc.get('kind'), doc.get('schema')
    except OSError:
        kind = schema = None
    from .adapters import ADAPTER_SCHEMA, load_adapter
    if schema == ADAPTER_SCHEMA or kind == 'adapter':
        return load_adapter(path)
    if kind == 'decode':
        from .decode.program import DecodeProgram
        return DecodeProgram.load(path, device=device)
    return FrozenProgram.load(path, device=device)

"""The whole-model optimizer update: one CUDA launch over a list of
tensors.

The counterpart of the XLA fusion the reference's ``ParallelTrainer``
compiles from its traced update (``mxnet_tpu/optimizer/fused.py:119-147``
over ``ops/optimizer_ops.py``): XLA fuses every parameter's update into a
couple of kernels. A :class:`MultiTensorPlan` applies one rule
(``RULES``: SGD, SGD with momentum, AdamW) to every tensor of a list in
one launch of ``csrc/multi_tensor_update.cu``, in one of three forms
(``FORMS``): float32; bf16 weight, gradient and state without a master;
bf16 weight and gradient with a float32 master and float32 state. Each
tensor brings its own lr (AdamW: its bias-corrected ``eta``) and wd; the
other scalars are the launch's (:func:`launch_scalars`). The plan's only
caller is ``optimizer/fused.py`` ``FusedUpdate``, whose plain version,
the per-parameter loop of ``update_multi_precision`` over the ops of
``ops/optimizer_ops.py``, the kernel is bitwise (the source says how).

The table. :func:`pack_table` writes one :data:`ENTRY` record a tensor
(its pointers, length, first chunk and float32 hyperparameters, the
layout the source's ``static_assert``s pin). A plan checks its list and
packs its table once; each launch fills in the gradients' pointers (new
tensors each step) and the hyperparameters and copies the table to the
card from a pinned buffer in one asynchronous copy. :func:`table_layout`
cuts each tensor into :data:`CHUNK`-element chunks, one block each, and
:func:`chunk_of` is the kernel's chunk -> (tensor, offset) search.

In a captured training step the gradients stay where the capture put
them, so a plan's :class:`BoundLaunch` launches it there: its
table's pointer columns packed and uploaded once, and only each record's
lr / eta, wd and flags (:data:`COLUMNS`) written each step, from a device
buffer that the host fills before the replay, by a copy the graph makes
before the kernel.

The launch counts as ``multi_tensor_update`` (float32), ``.bf16`` (no
master) or ``.mp`` (a float32 master), its rule as the instance.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..optimizer_ops import low_scalar
from ._launch import (BF16, count as _count, ptr as _ptr,
                      raise_on as _raise_on, require as _require,
                      stream as _stream)

__all__ = ['RULES', 'FORMS', 'MP', 'KERNEL', 'THREADS', 'VEC', 'UNROLL',
           'CHUNK', 'ENTRY', 'FLAG_WD', 'FLAG_VECTOR', 'form_of',
           'instance_name', 'table_layout', 'chunk_of', 'pack_table',
           'launch_scalars', 'MultiTensorPlan', 'BoundLaunch', 'COLUMNS',
           'COLUMN_WORD']

RULES = ('sgd', 'sgd_mom', 'adamw')
FORMS = ('float32', 'low', 'master')
KERNEL = 'multi_tensor_update'
# the instance with a float32 master counts under KERNEL + MP
MP = '.mp'
# csrc/multi_tensor_update.cu's block: threads, elements a thread takes
# at a time, times it takes them; a chunk is one block's elements
THREADS, VEC, UNROLL = 256, 8, 4
CHUNK = THREADS * VEC * UNROLL
FLAG_WD, FLAG_VECTOR = 1, 2
ENTRY = np.dtype({'names': ['w', 'g', 's1', 's2', 'w32', 'n', 'chunk0', 'a',
                            'wd', 'flags', 'pad'],
                  'formats': ['<u8', '<u8', '<u8', '<u8', '<u8', '<i8',
                              '<i8', '<f4', '<f4', '<i4', '<i4'],
                  'offsets': [0, 8, 16, 24, 32, 40, 48, 56, 60, 64, 68],
                  'itemsize': 72})
_SUFFIX = {'float32': '', 'low': BF16, 'master': MP}
# the record's fields a step writes (BoundLaunch), from this 4-byte word
COLUMNS = ('a', 'wd', 'flags')
COLUMN_WORD = ENTRY.fields['a'][1] // 4


def form_of(weight_dtype, master):
    """The form of a weight of ``weight_dtype`` with a float32 master
    (``master`` True) or without; None when the kernel has none."""
    if weight_dtype == torch.float32 and not master:
        return 'float32'
    if weight_dtype == torch.bfloat16:
        return 'master' if master else 'low'
    return None


def instance_name(form):
    """The name a launch of ``form`` counts under."""
    return KERNEL + _SUFFIX[form]


def table_layout(lengths):
    """(first chunk of each tensor, total chunks) for tensors of
    ``lengths`` elements: ceil(n / CHUNK) chunks each, in order."""
    chunk0, total = [], 0
    for n in lengths:
        chunk0.append(total)
        total += -(-int(n) // CHUNK)
    return chunk0, total


def chunk_of(chunk0, b):
    """(tensor, element offset) of chunk ``b``: the kernel's
    ``entry_of``, the last tensor whose first chunk is at most ``b``."""
    lo, hi = 0, len(chunk0) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if chunk0[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    return lo, (b - chunk0[lo]) * CHUNK


def _addr(t):
    return 0 if t is None else t.data_ptr()


def pack_table(weights, grads, s1, s2, masters, a, wd, wd_on):
    """The :data:`ENTRY` records of one launch (empty tensors left out)
    and its total chunks. ``a`` / ``wd``: each tensor's lr or eta and
    weight decay (Python floats, rounded to float32 here); ``wd_on``:
    whether SGD adds its weight decay."""
    keep = [i for i, w in enumerate(weights) if w.numel()]
    tab = np.zeros(len(keep), ENTRY)
    cols = {'w': weights, 'g': grads, 's1': s1, 's2': s2, 'w32': masters}
    for name, ts in cols.items():
        tab[name] = [_addr(ts[i]) for i in keep]
    tab['n'] = [weights[i].numel() for i in keep]
    chunk0, total = table_layout(tab['n'])
    tab['chunk0'] = chunk0
    tab['a'] = [a[i] for i in keep]
    tab['wd'] = [wd[i] for i in keep]
    aligned = np.ones(len(keep), bool)
    for name in cols:
        aligned &= tab[name] % 16 == 0
    tab['flags'] = (np.where([wd_on[i] for i in keep], FLAG_WD, 0)
                    | np.where(aligned, FLAG_VECTOR, 0))
    return tab, total


def launch_scalars(rule, form, rescale_grad=1.0, clip_gradient=None,
                   momentum=0.0, beta1=0.9, beta2=0.999, epsilon=1e-8,
                   lr=1.0):
    """The launch's scalars as the plain ops use them: a double rounded
    to float32 where it multiplies a float32 tensor (``1 - beta1`` formed
    in double first), and for AdamW on bf16 without a master rounded to
    bf16 first (the reference's weak Python floats take the weight's
    dtype); SGD's momentum on bf16 without a master likewise. Returns
    (rescale, clip, clip_on, momentum, beta1, beta2, c1, c2, eps, lr), the
    order of the C entry's arguments."""
    clip_on = clip_gradient is not None and clip_gradient > 0
    bf = (lambda x: low_scalar(x, torch.bfloat16)) if form == 'low' \
        else float
    adam = bf if rule == 'adamw' else float
    f32 = np.float32
    return (f32(adam(rescale_grad)), f32(adam(clip_gradient) if clip_on
                                         else 0.0),
            int(clip_on), f32(bf(momentum)), f32(adam(beta1)),
            f32(adam(beta2)), f32(adam(1 - beta1)), f32(adam(1 - beta2)),
            f32(adam(epsilon)), f32(adam(lr)))


def _lib():
    from . import _build
    fn = _build.load('multi_tensor_update').mx_multi_tensor_update
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_float] * 2 + [ctypes.c_int]
                       + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    return fn


def _states(rule, states):
    """(s1, s2) lists from ``states``: SGD with momentum its momentum,
    AdamW its (mean, var)."""
    if rule == 'adamw':
        return [s[0] for s in states], [s[1] for s in states]
    if rule == 'sgd_mom':
        return list(states), [None] * len(states)
    return [None] * len(states), [None] * len(states)


def _check(rule, form, weights, grads, s1, s2, masters):
    """One device; each weight contiguous, its gradient, state and master
    of its shape and the form's dtypes."""
    wdt = torch.float32 if form == 'float32' else torch.bfloat16
    sdt = torch.bfloat16 if form == 'low' else torch.float32
    device = weights[0].device
    for k, w in enumerate(weights):
        for label, t, dt in (('weight', w, wdt), ('grad', grads[k], wdt),
                             ('state', s1[k], sdt), ('state', s2[k], sdt),
                             ('master', masters[k], torch.float32)):
            if t is None:
                continue
            if t.dtype != dt:
                raise TypeError('%s (%s, %s form): tensor %d\'s %s is %s, '
                                'expected %s' % (KERNEL, rule, form, k,
                                                 label, t.dtype, dt))
            _require(t.device == device and t.shape == w.shape
                     and t.is_contiguous(),
                     '%s: tensor %d\'s %s must be contiguous, of its '
                     'weight\'s shape, on %s' % (KERNEL, k, label, device))
        _require((s1[k] is not None) == (rule != 'sgd')
                 and (s2[k] is not None) == (rule == 'adamw')
                 and (masters[k] is not None) == (form == 'master'),
                 '%s: tensor %d lacks the state or master of %s, %s form'
                 % (KERNEL, k, rule, form))


class MultiTensorPlan:
    """The launches of one rule over one list of weights, states and
    masters, which stay where they are between launches (a trainer's):
    their checks and table columns are made once, and each
    :meth:`launch` fills in the step's gradients and hyperparameters
    (the host's part of a step: the gradients are new tensors)."""

    def __init__(self, rule, weights, states, masters=None):
        _require(rule in RULES, '%s: rule %r (have %s)'
                 % (KERNEL, rule, ', '.join(RULES)))
        n = len(weights)
        masters = list(masters) if masters else [None] * n
        self.rule = rule
        self.form = form_of(weights[0].dtype, masters[0] is not None)
        if self.form is None:
            raise TypeError('%s: %s weights are not built (float32, or bf16 '
                            'with or without a float32 master)'
                            % (KERNEL, weights[0].dtype))
        s1, s2 = _states(rule, states)
        _check(rule, self.form, weights, [None] * n, s1, s2, masters)
        self.device = weights[0].device
        self._index = weights[0].get_device()
        self._keep = [i for i, w in enumerate(weights) if w.numel()]
        self._shapes = [weights[i].shape for i in self._keep]
        self._dtype = weights[0].dtype
        zeros = [0.0] * n
        self._table, self.chunks = pack_table(weights, [None] * n, s1, s2,
                                              masters, zeros, zeros,
                                              [False] * n)
        self._static = self._table['flags'].copy()

    def table(self, grads, lrs, wds):
        """The launch's :data:`ENTRY` records: the packed columns with the
        step's ``grads`` (None: zero; each of its weight's dtype, shape
        and device, contiguous), each tensor's lr or eta (``lrs``) and wd
        (``wds``) and the flags they decide, as :func:`pack_table` packs
        them."""
        tab, keep, dt, index = self._table, self._keep, self._dtype, \
            self._index
        gs = [grads[i] for i in keep]
        bad = [k for k, (g, shape) in enumerate(zip(gs, self._shapes))
               if g is not None and (g.dtype != dt or g.shape != shape
                                     or not g.is_contiguous()
                                     or g.get_device() != index)]
        if bad:
            g = gs[bad[0]]
            if g.dtype != dt:
                raise TypeError('%s: tensor %d\'s grad is %s, expected %s'
                                % (KERNEL, keep[bad[0]], g.dtype, dt))
            raise ValueError('%s: tensor %d\'s grad must be contiguous, of '
                             'its weight\'s shape, on %s'
                             % (KERNEL, keep[bad[0]], self.device))
        tab['g'] = [0 if g is None else g.data_ptr() for g in gs]
        tab['a'] = [lrs[i] for i in keep]
        tab['wd'] = [wds[i] for i in keep]
        wd_on = [self.rule != 'adamw' and wds[i] != 0 for i in keep]
        tab['flags'] = (np.where(wd_on, FLAG_WD, 0)
                        | (self._static & np.where(tab['g'] % 16 == 0,
                                                   FLAG_VECTOR, 0)))
        return tab

    def launch(self, grads, lrs, wds, **scalars):
        """One launch with the step's ``grads``, ``lrs`` and ``wds``
        (:meth:`table`) and the launch's scalars (``rescale_grad``,
        ``clip_gradient``, ``momentum``, ``beta1``, ``beta2``,
        ``epsilon``, ``lr``: :func:`launch_scalars`). CUDA tensors only:
        the kernel has no CPU mode."""
        _require(self.device.type == 'cuda', '%s: the kernel runs on a CUDA '
                 'device, not %s' % (KERNEL, self.device))
        if not self.chunks:
            return
        raw = self.table(grads, lrs, wds).view(np.uint8)
        host = torch.empty(raw.size, dtype=torch.uint8, pin_memory=True)
        host.numpy()[:] = raw
        with torch.cuda.device(self.device):
            self._call(host.to(self.device, non_blocking=True), scalars)

    def _call(self, table, scalars):
        """The kernel over the device ``table``, counted."""
        err = _lib()(RULES.index(self.rule), FORMS.index(self.form),
                     _ptr(table), len(self._keep), self.chunks,
                     *launch_scalars(self.rule, self.form, **scalars),
                     _stream(self.device))
        _raise_on(KERNEL, err)
        _count(instance_name(self.form), self.rule)


class BoundLaunch:
    """A plan's launch inside a captured training step, whose gradients
    stay where the capture put them; its device table is made with it
    (before the capture, outside the graph's pool). :meth:`launch` (in
    the capture) checks the gradients and packs the table's pointer
    columns once, and captures a copy of the step's columns
    (:data:`COLUMNS` of each record: a, wd, flags) from a device buffer
    into the table before the kernel; :meth:`upload` (after the capture)
    writes the packed table to the card once. Before each replay the
    host writes the step's :meth:`columns` into that buffer."""

    def __init__(self, plan):
        self.plan = plan
        self.size = len(plan._keep)
        self.table = torch.zeros(self.size * ENTRY.itemsize,
                                 dtype=torch.uint8, device=plan.device)
        self._packed = self._vector = None

    def pack(self, grads):
        """Check ``grads`` (the step's static gradients, None: zero) and
        pack the table's columns that stay: the pointers, lengths, chunks
        and the flag their alignment decides."""
        zeros = [0.0] * len(grads)
        self._packed = self.plan.table(grads, zeros, zeros)
        self._vector = self._packed['flags'] & FLAG_VECTOR

    def launch(self, grads, cols, **scalars):
        """In the capture: :meth:`pack` ``grads``, then the captured copy
        of ``cols`` ((size, 3) int32 on the card) into the table and the
        kernel with the launch's scalars."""
        self.pack(grads)
        if not self.plan.chunks:
            return
        words = self.table.view(torch.int32).view(self.size,
                                                  ENTRY.itemsize // 4)
        words[:, COLUMN_WORD:COLUMN_WORD + len(COLUMNS)].copy_(cols)
        self.plan._call(self.table, scalars)

    def upload(self):
        """After the capture: the packed table to the card, once."""
        self.table.copy_(torch.from_numpy(self._packed.view(np.uint8)))

    def columns(self, lrs, wds):
        """The step's (size, 3) int32 columns for ``lrs`` / ``wds`` (each
        tensor's, as :meth:`MultiTensorPlan.launch` takes them): the
        float32 a and wd as bits, and the flags they decide, as
        :meth:`MultiTensorPlan.table` packs them."""
        keep = self.plan._keep
        a = np.asarray([lrs[i] for i in keep], np.float32)
        wd = np.asarray([wds[i] for i in keep], np.float32)
        wd_on = np.asarray([self.plan.rule != 'adamw' and wds[i] != 0
                            for i in keep], bool)
        flags = np.where(wd_on, FLAG_WD, 0).astype(np.int32) | self._vector
        return np.stack([a.view(np.int32), wd.view(np.int32),
                         flags.astype(np.int32)], axis=1)


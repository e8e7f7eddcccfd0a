"""The whole-model optimizer update: one CUDA launch over a list of
tensors.

The counterpart of the XLA fusion the reference's ``ParallelTrainer``
compiles from its traced update (``mxnet_tpu/optimizer/fused.py:119-147``
over ``ops/optimizer_ops.py``): XLA fuses every parameter's update into a
couple of kernels. A :class:`MultiTensorPlan` applies one rule
(``RULES``: one for each fusable optimizer of ``optimizer/optimizer.py``,
and for SGD, NAG and DCASGD one without and one with momentum) to every
tensor of a list in one launch of ``csrc/multi_tensor_update.cu``, in one
of three forms (``FORMS``): float32; bf16 weight, gradient and state
without a master (SGD, SGD with momentum and AdamW only: ``LOW_RULES``);
bf16 weight and gradient with a float32 master and float32 state. Each
tensor brings its own lr or per-tensor factor (AdamW's ``eta``, Adam's
bias-corrected lr, FTML's, Adamax's, Signum's), wd and second factor; the
other scalars are the launch's (:func:`launch_scalars`). The plan's only
caller is ``optimizer/fused.py`` ``FusedUpdate``, whose plain version,
the per-parameter loop of ``update_multi_precision`` over the ops of
``ops/optimizer_ops.py``, the kernel is bitwise (the source says how).

The table. :func:`pack_table` writes one :data:`ENTRY` record a tensor
(its pointers, up to three states, length, first chunk and float32
hyperparameters, the layout the source's ``static_assert``s pin). A plan
checks its list and packs its table once; each launch fills in the
gradients' pointers (new tensors each step) and the hyperparameters and
copies the table to the card from a pinned buffer in one asynchronous
copy. :func:`table_layout` cuts each tensor into :data:`CHUNK`-element
chunks, one block each, and :func:`chunk_of` is the kernel's chunk ->
(tensor, offset) search.

In a captured training step the gradients stay where the capture put
them, so a plan's :class:`BoundLaunch` launches it there: its
table's pointer columns packed and uploaded once, and only each record's
a, wd, b and flags (:data:`COLUMNS`) written each step, from a device
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

__all__ = ['RULES', 'LOW_RULES', 'STATES', 'FORMS', 'MP', 'KERNEL',
           'THREADS', 'VEC', 'UNROLL', 'CHUNK', 'ENTRY', 'FLAG_WD',
           'FLAG_VECTOR', 'form_of', 'instance_name', 'table_layout',
           'chunk_of', 'pack_table', 'launch_scalars', 'state_lists',
           'MultiTensorPlan', 'BoundLaunch', 'COLUMNS', 'COLUMN_WORD']

# the source's enum Rule, in order
RULES = ('sgd', 'sgd_mom', 'adamw', 'adam', 'nag', 'nag_mom', 'signsgd',
         'signum', 'ftml', 'dcasgd', 'dcasgd_mom', 'adagrad', 'rmsprop',
         'rmspropalex', 'adadelta', 'ftrl', 'adamax', 'test')
# the rules with a LOW form (bf16 state, no master)
LOW_RULES = ('sgd', 'sgd_mom', 'adamw')
# the state tensors of each rule (the source's states_of), in the order
# of its optimizer's state with None left out
STATES = {'sgd': 0, 'sgd_mom': 1, 'adamw': 2, 'adam': 2, 'nag': 0,
          'nag_mom': 1, 'signsgd': 0, 'signum': 1, 'ftml': 3, 'dcasgd': 1,
          'dcasgd_mom': 2, 'adagrad': 1, 'rmsprop': 1, 'rmspropalex': 3,
          'adadelta': 2, 'ftrl': 2, 'adamax': 2, 'test': 1}
# the rules whose plain version adds wd * w only when wd != 0 (FLAG_WD
# says so per tensor); the others add it always, or never
WD_FLAG_RULES = ('sgd', 'sgd_mom', 'adam', 'signum', 'ftml', 'rmsprop',
                 'rmspropalex')
# the rules whose optimizer clips whenever clip_gradient is not None
# (``Optimizer._clipped``); the others clip when it is > 0, as the ops do
CLIP_SET_RULES = ('nag', 'nag_mom', 'dcasgd', 'dcasgd_mom', 'adadelta',
                  'adamax')
FORMS = ('float32', 'low', 'master')
KERNEL = 'multi_tensor_update'
# the instance with a float32 master counts under KERNEL + MP
MP = '.mp'
# csrc/multi_tensor_update.cu's block: threads, elements a thread takes
# at a time, times it takes them; a chunk is one block's elements
THREADS, VEC, UNROLL = 256, 8, 4
CHUNK = THREADS * VEC * UNROLL
FLAG_WD, FLAG_VECTOR = 1, 2
ENTRY = np.dtype({'names': ['w', 'g', 's1', 's2', 's3', 'w32', 'n', 'chunk0',
                            'a', 'wd', 'b', 'flags'],
                  'formats': ['<u8', '<u8', '<u8', '<u8', '<u8', '<u8',
                              '<i8', '<i8', '<f4', '<f4', '<f4', '<i4'],
                  'offsets': [0, 8, 16, 24, 32, 40, 48, 56, 64, 68, 72, 76],
                  'itemsize': 80})
_SUFFIX = {'float32': '', 'low': BF16, 'master': MP}
# the record's fields a step writes (BoundLaunch), from this 4-byte word
COLUMNS = ('a', 'wd', 'b', 'flags')
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


def pack_table(weights, grads, s1, s2, masters, a, wd, wd_on, s3=None,
               b=None):
    """The :data:`ENTRY` records of one launch (empty tensors left out)
    and its total chunks. ``s1`` / ``s2`` / ``s3``: each tensor's states
    (None where the rule keeps fewer); ``a`` / ``wd`` / ``b``: each
    tensor's lr or factor, weight decay and second factor (Python floats,
    rounded to float32 here; ``b`` 0 when not given); ``wd_on``: whether
    the rule adds its weight decay (``WD_FLAG_RULES``)."""
    n = len(weights)
    s3 = [None] * n if s3 is None else s3
    b = [0.0] * n if b is None else b
    keep = [i for i, w in enumerate(weights) if w.numel()]
    tab = np.zeros(len(keep), ENTRY)
    cols = {'w': weights, 'g': grads, 's1': s1, 's2': s2, 's3': s3,
            'w32': masters}
    for name, ts in cols.items():
        tab[name] = [_addr(ts[i]) for i in keep]
    tab['n'] = [weights[i].numel() for i in keep]
    chunk0, total = table_layout(tab['n'])
    tab['chunk0'] = chunk0
    tab['a'] = [a[i] for i in keep]
    tab['wd'] = [wd[i] for i in keep]
    tab['b'] = [b[i] for i in keep]
    aligned = np.ones(len(keep), bool)
    for name in cols:
        aligned &= tab[name] % 16 == 0
    tab['flags'] = (np.where([wd_on[i] for i in keep], FLAG_WD, 0)
                    | np.where(aligned, FLAG_VECTOR, 0))
    return tab, total


def launch_scalars(rule, form, rescale_grad=1.0, clip_gradient=None,
                   momentum=0.0, beta1=0.9, beta2=0.999, epsilon=1e-8,
                   lr=1.0, k0=0.0, k1=0.0, k_on=False):
    """The launch's scalars as the plain ops use them: a double rounded
    to float32 where it multiplies a float32 tensor (``1 - beta1`` and
    ``1 - beta2`` formed in double first), and for AdamW on bf16 without
    a master rounded to bf16 first (the reference's weak Python floats
    take the weight's dtype); SGD's momentum on bf16 without a master
    likewise. The clip is on for ``clip_gradient > 0``, or for the rules
    of ``CLIP_SET_RULES`` whenever it is set. ``beta1`` / ``beta2`` also
    carry the other rules' decay rates, ``k0`` / ``k1`` / ``k_on`` their
    constants (``FusedUpdate.scalars`` maps them). Returns (rescale,
    clip, clip_on, momentum, beta1, beta2, c1, c2, eps, lr, k0, k1,
    k_on), the order of the C entry's arguments."""
    if rule in CLIP_SET_RULES:
        clip_on = clip_gradient is not None
    else:
        clip_on = clip_gradient is not None and clip_gradient > 0
    bf = (lambda x: low_scalar(x, torch.bfloat16)) if form == 'low' \
        else float
    adam = bf if rule == 'adamw' else float
    f32 = np.float32
    return (f32(adam(rescale_grad)), f32(adam(clip_gradient) if clip_on
                                         else 0.0),
            int(clip_on), f32(bf(momentum)), f32(adam(beta1)),
            f32(adam(beta2)), f32(adam(1 - beta1)), f32(adam(1 - beta2)),
            f32(adam(epsilon)), f32(adam(lr)), f32(k0), f32(k1),
            int(bool(k_on)))


def _lib():
    from . import _build
    fn = _build.load('multi_tensor_update').mx_multi_tensor_update
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_float] * 2 + [ctypes.c_int]
                       + [ctypes.c_float] * 9 + [ctypes.c_int]
                       + [ctypes.c_void_p])
    return fn


def state_lists(rule, states):
    """(s1, s2, s3) lists from each tensor's optimizer ``states``: the
    state's tensors in order, None left out (DCASGD without momentum
    keeps ``(None, prev)``), padded with None to three. A state with
    other than ``STATES[rule]`` tensors raises."""
    out = [[], [], []]
    for k, st in enumerate(states):
        ts = [t for t in (st if isinstance(st, (tuple, list)) else (st,))
              if t is not None]
        _require(len(ts) == STATES[rule],
                 '%s: tensor %d has %d state tensors, rule %s keeps %d'
                 % (KERNEL, k, len(ts), rule, STATES[rule]))
        for j in range(3):
            out[j].append(ts[j] if j < len(ts) else None)
    return out


def _check(rule, form, weights, grads, states, masters):
    """One device; each weight contiguous, its gradient, states and master
    of its shape and the form's dtypes."""
    wdt = torch.float32 if form == 'float32' else torch.bfloat16
    sdt = torch.bfloat16 if form == 'low' else torch.float32
    device = weights[0].device
    for k, w in enumerate(weights):
        for label, t, dt in (('weight', w, wdt), ('grad', grads[k], wdt),
                             ('state', states[0][k], sdt),
                             ('state', states[1][k], sdt),
                             ('state', states[2][k], sdt),
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
        _require((masters[k] is not None) == (form == 'master'),
                 '%s: tensor %d lacks the master of the %s form'
                 % (KERNEL, k, form))


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
        if self.form is None or (self.form == 'low'
                                 and rule not in LOW_RULES):
            raise TypeError('%s: %s weights%s are not built for rule %s '
                            '(float32, or bf16 with a float32 master; bf16 '
                            'without one for %s)'
                            % (KERNEL, weights[0].dtype,
                               ' without a master' if self.form else '',
                               rule, ', '.join(LOW_RULES)))
        lists = state_lists(rule, states)
        _check(rule, self.form, weights, [None] * n, lists, masters)
        self.device = weights[0].device
        self._index = weights[0].get_device()
        self._keep = [i for i, w in enumerate(weights) if w.numel()]
        self._shapes = [weights[i].shape for i in self._keep]
        self._dtype = weights[0].dtype
        zeros = [0.0] * n
        self._table, self.chunks = pack_table(
            weights, [None] * n, lists[0], lists[1], masters, zeros, zeros,
            [False] * n, s3=lists[2])
        self._static = self._table['flags'].copy()

    def _wd_on(self, wds):
        return [self.rule in WD_FLAG_RULES and wds[i] != 0
                for i in self._keep]

    def table(self, grads, lrs, wds, bs=None):
        """The launch's :data:`ENTRY` records: the packed columns with the
        step's ``grads`` (None: zero; each of its weight's dtype, shape
        and device, contiguous), each tensor's lr or factor (``lrs``), wd
        (``wds``) and second factor (``bs``, zeros when None) and the
        flags they decide, as :func:`pack_table` packs them."""
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
        tab['b'] = [0.0 if bs is None else bs[i] for i in keep]
        tab['flags'] = (np.where(self._wd_on(wds), FLAG_WD, 0)
                        | (self._static & np.where(tab['g'] % 16 == 0,
                                                   FLAG_VECTOR, 0)))
        return tab

    def launch(self, grads, lrs, wds, bs=None, **scalars):
        """One launch with the step's ``grads``, ``lrs``, ``wds`` and
        ``bs`` (:meth:`table`) and the launch's scalars
        (:func:`launch_scalars`' keywords). CUDA tensors only: the kernel
        has no CPU mode."""
        _require(self.device.type == 'cuda', '%s: the kernel runs on a CUDA '
                 'device, not %s' % (KERNEL, self.device))
        if not self.chunks:
            return
        raw = self.table(grads, lrs, wds, bs).view(np.uint8)
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
    (:data:`COLUMNS` of each record: a, wd, b, flags) from a device
    buffer into the table before the kernel; :meth:`upload` (after the
    capture) writes the packed table to the card once. Before each replay
    the host writes the step's :meth:`columns` into that buffer."""

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
        of ``cols`` ((size, len(COLUMNS)) int32 on the card) into the
        table and the kernel with the launch's scalars."""
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

    def columns(self, lrs, wds, bs=None):
        """The step's (size, len(COLUMNS)) int32 columns for ``lrs`` /
        ``wds`` / ``bs`` (each tensor's, as :meth:`MultiTensorPlan.launch`
        takes them): the float32 a, wd and b as bits, and the flags they
        decide, as :meth:`MultiTensorPlan.table` packs them."""
        keep = self.plan._keep
        a = np.asarray([lrs[i] for i in keep], np.float32)
        wd = np.asarray([wds[i] for i in keep], np.float32)
        b = np.asarray([0.0 if bs is None else bs[i] for i in keep],
                       np.float32)
        wd_on = np.asarray(self.plan._wd_on(wds), bool)
        flags = np.where(wd_on, FLAG_WD, 0).astype(np.int32) | self._vector
        return np.stack([a.view(np.int32), wd.view(np.int32),
                         b.view(np.int32), flags.astype(np.int32)], axis=1)

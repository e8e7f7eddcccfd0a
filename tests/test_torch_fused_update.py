"""The whole-model optimizer update of the port (``optimizer/fused.py``,
``ops/kernels/multi_tensor.py``, ``csrc/multi_tensor_update.cu``).

On the CPU the update runs its plain version, the per-parameter loop of
``update_multi_precision``; on the card one kernel launch a group of
parameters of one form takes the table a ``MultiTensorPlan`` packs from
the per-parameter scalars that ``FusedUpdate._hypers`` resolves on the
host, and the launch's scalars of ``launch_scalars``. Held here, all on
the CPU:

  * the plain path, and the card's host path (the plans' tables and the
    launch's scalars fed to a Python model of the kernel's arithmetic),
    bit for bit the per-parameter loop over three steps, over mixed
    groups: float32 beside bf16 parameters without (SGD, AdamW) and with
    a float32 master; every rule (SGD, NAG and DCASGD without and with
    momentum, AdamW, Adam, signsgd, signum, FTML, AdaGrad, RMSProp plain
    and centered, AdaDelta, Ftrl, Adamax, Test); clip, rescale, lr and wd
    multipliers; a parameter the loss does not reach; update counts per
    index (one index starts late);
  * the scalars of a launch rounded as the plain ops round them;
  * a Python model of the kernel's chunk -> (tensor, offset) search and
    of its threads' element walk: every element of every tensor once, at
    odd lengths and over BERT-base's and ResNet-50's parameter lists;
    the table's layout (three state pointers) against the source's
    ``static_assert``s, its rule enum and states a rule against the
    Python mirror;
  * the typed refusal of an optimizer or form the kernel has none for,
    on a CUDA device (the LOW form of a new rule among them), and of a
    ``fusable = False`` optimizer under ``ParallelTrainer``; such an
    optimizer's per-parameter loop under the gluon ``Trainer``.

The kernel against its plain version on the card is the ``cuda``-marked
test (it skips here) and chip_smoke.py's fused-update phase.
"""
import copy
import os
import re

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.gluon.model_zoo import bert as port_bert
from mxnet_tpu_torch.gluon.model_zoo import resnet as port_resnet
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.kernels import multi_tensor as mt
from mxnet_tpu_torch.optimizer import fused
from mxnet_tpu_torch.optimizer import optimizer as optmod

torch.set_num_threads(1)

BF = torch.bfloat16
SOURCE = os.path.join(os.path.dirname(mt.__file__), 'csrc',
                      'multi_tensor_update.cu')
SHAPES = ((5, 7), (4097,), (1,), (8,), (3, 3, 2, 2), (7,))
# (optimizer, hyperparameters): every rule, with clip, rescale and wd
OPTIMIZERS = (
    ('sgd', dict(learning_rate=0.1, wd=1e-3)),
    ('sgd', dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
                 clip_gradient=0.3, rescale_grad=0.37)),
    ('adamw', dict(learning_rate=1e-2, wd=0.01)),
    ('adamw', dict(learning_rate=3e-3, wd=0.1, clip_gradient=0.2,
                   rescale_grad=0.5, beta1=0.8, beta2=0.99,
                   epsilon=1e-6)),
    ('adam', dict(learning_rate=1e-2, wd=0.01, clip_gradient=0.2,
                  rescale_grad=0.5, beta1=0.8, beta2=0.99, epsilon=1e-6)),
    ('adam', dict(learning_rate=3e-3, beta1=0.5)),
    ('nag', dict(learning_rate=0.1, wd=1e-3, clip_gradient=0.3,
                 rescale_grad=0.37)),
    ('nag', dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
                 clip_gradient=0.3)),
    ('signum', dict(learning_rate=0.01, momentum=0.0, wd=1e-3,
                    clip_gradient=0.3, rescale_grad=0.37)),
    ('signum', dict(learning_rate=0.01, momentum=0.9, wd=1e-3, wd_lh=0.01,
                    clip_gradient=0.3)),
    ('ftml', dict(learning_rate=0.01, wd=1e-3, clip_gradient=0.3,
                  rescale_grad=0.5)),
    ('dcasgd', dict(learning_rate=0.1, wd=1e-3, clip_gradient=0.3,
                    lamda=0.04)),
    ('dcasgd', dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
                    rescale_grad=0.37)),
    ('adagrad', dict(learning_rate=0.1, wd=1e-3, clip_gradient=0.3,
                     rescale_grad=0.5)),
    ('rmsprop', dict(learning_rate=0.01, wd=1e-3, clip_gradient=0.3,
                     clip_weights=1.5)),
    ('rmsprop', dict(learning_rate=0.01, centered=True, wd=1e-4,
                     rescale_grad=0.37, clip_weights=2.0)),
    ('adadelta', dict(wd=1e-3, clip_gradient=0.3, rescale_grad=0.5)),
    ('ftrl', dict(learning_rate=0.1, wd=1e-3, lamda1=0.01, beta=1,
                  clip_gradient=0.3)),
    ('adamax', dict(learning_rate=0.002, wd=1e-3, clip_gradient=0.3,
                    rescale_grad=0.5)),
    ('test', dict(rescale_grad=0.5)),
    ('ccsgd', dict(learning_rate=0.05, momentum=0.9, wd=1e-4)),
)
# the (optimizer case, form) pairs: the LOW form for SGD's and AdamW's
# rules only
CASES = [(k, form) for k, (name, _) in enumerate(OPTIMIZERS)
         for form in ('float32', 'low', 'master')
         if form != 'low' or name in ('sgd', 'adamw', 'ccsgd')]


def _params(low, seed=0):
    """Named parameters: float32 ones beside low-precision (bf16) ones
    when ``low``; the last one (``*_nograd``) never gets a gradient."""
    rs = np.random.RandomState(seed)
    out = []
    for k, shape in enumerate(SHAPES):
        name = 'p%d_%s' % (k, 'weight' if k % 2 == 0 else 'bias')
        if k == len(SHAPES) - 1:
            name = 'p%d_nograd' % k
        dt = BF if low and k % 2 else torch.float32
        t = torch.tensor(rs.randn(*shape).astype('float32')).to(dt)
        out.append((name, torch.nn.Parameter(t)))
    return out


def _grads(params, step):
    rs = np.random.RandomState(100 + step)
    return [None if n.endswith('nograd') else
            torch.tensor(rs.randn(*p.shape).astype('float32')).to(p.dtype)
            for n, p in params]


def _setup(name, hyper, low, mp):
    params = _params(low)
    opt = optmod.create(name, **dict(hyper, multi_precision=mp))
    opt.idx2name = {i: n for i, (n, _) in enumerate(params)}
    opt.set_lr_mult({'p1_bias': 0.5, 3: 2.0})
    opt.set_wd_mult({'p2_weight': 0.0, 'p4_weight': 3.0})
    # index 4 starts late: its update count (AdamW's t) runs ahead
    opt._index_update_count[4] = 5
    pairs = [(i, p) for i, (_, p) in enumerate(params)]
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')    # bf16 without a master
        states = [opt.create_state_multi_precision(i, p.detach())
                  for i, p in pairs]
    return params, pairs, opt, states


def _flat(state):
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in _flat(s)]


def _loop(pairs, opt, states, grads):
    with torch.no_grad():
        for ((i, p), st), g in zip(zip(pairs, states), grads):
            opt.update_multi_precision(
                i, p.data, torch.zeros_like(p) if g is None else g, st)


def _bits(t):
    """``t``'s bit patterns (a NaN equals a NaN of its bits)."""
    return t.detach().view({torch.float32: torch.int32,
                            BF: torch.int16}[t.dtype])


def _assert_same(a, b):
    (pa, _, oa, sa), (pb, _, ob, sb) = a, b
    for (n, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)), n
    for x, y in zip(sa, sb):
        for u, v in zip(_flat(x), _flat(y)):
            assert u.dtype == v.dtype and torch.equal(_bits(u), _bits(v))
    assert oa._index_update_count == ob._index_update_count
    assert oa.num_update == ob.num_update


def _sign(x):
    return (x > 0).float() - (x < 0).float()


def _over(x, c):
    return x / torch.full((), c, dtype=torch.float32)


def _kernel_model(rule, form, tab, scalars, by_ptr):
    """csrc/multi_tensor_update.cu's arithmetic over one launch's table:
    each entry's tensors found by their pointers, ``update<RULE, FORM>``
    in float32 ops that round once each (the kernel's ``__f*_rn``
    intrinsics, in its order), bf16 where it rounds, the stores in the
    stored dtypes. A null gradient reads as zeros."""
    (rescale, clip, clip_on, mom, b1, b2, c1, c2, eps, lr, k0, k1,
     k_on) = map(float, scalars)

    def rbf(x):
        return x.to(BF).float()

    def clipped(g):
        return torch.clamp(g, -clip, clip) if clip_on else g
    low_adam = rule == 'adamw' and form == 'low'
    for e in tab:
        w = by_ptr[int(e['w'])]
        g = (by_ptr[int(e['g'])].float() if e['g']
             else torch.zeros(w.shape))
        st = [by_ptr.get(int(e[k])) for k in ('s1', 's2', 's3')]
        w32 = by_ptr.get(int(e['w32']))
        s = [None if t is None else t.float() for t in st]
        wb = w32.clone() if w32 is not None else w.float()
        a, wd, b = float(e['a']), float(e['wd']), float(e['b'])
        wd_on = bool(e['flags'] & mt.FLAG_WD)
        g = g * rescale
        if low_adam:
            g = rbf(g)
            g = clipped(g)
            m = rbf(rbf(s[0] * b1) + rbf(g * c1))
            v = rbf(rbf(s[1] * b2) + rbf(rbf(g * g) * c2))
            q = rbf(m * lr) / rbf(rbf(torch.sqrt(v)) + eps)
            wb = wb - a * (q + wb * wd)
            s[:2] = m, v
        elif rule == 'adamw':
            g = clipped(g)
            m = s[0] * b1 + g * c1
            v = s[1] * b2 + (g * g) * c2
            q = (m * lr) / (torch.sqrt(v) + eps)
            wb = wb - a * (q + wb * wd)
            s[:2] = m, v
        elif rule in ('sgd', 'sgd_mom'):
            g = clipped(g)
            if wd_on:
                g = g + wb * wd
            if rule == 'sgd':
                wb = wb - g * a
            else:
                s[0] = s[0] * mom - g * a
                wb = wb + s[0]
        elif rule == 'adam':
            if wd_on:
                g = g + wb * wd
            g = clipped(g)
            s[0] = s[0] * b1 + g * c1
            s[1] = s[1] * b2 + (g * g) * c2
            wb = wb - (s[0] * a) / (torch.sqrt(s[1]) + eps)
        elif rule == 'nag':
            wb = wb - a * (clipped(g) + wb * wd)
        elif rule == 'nag_mom':
            g = clipped(g)
            s[0] = (s[0] * mom + g) + wb * wd
            wb = wb - a * (s[0] * mom + g)
        elif rule == 'signsgd':
            wb = wb - a * (_sign(clipped(g)) + wb * wd)
        elif rule == 'signum':
            g = clipped(g)
            if wd_on:
                g = g + wb * wd
            s[0] = s[0] * mom - g * c1
            wb = wb * b + _sign(s[0]) * a
        elif rule == 'ftml':
            if wd_on:
                g = g + wb * wd
            g = clipped(g)
            s[1] = s[1] * b2 + (g * g) * c2
            d = (torch.sqrt(_over(s[1], b)) + eps) * a
            sigma = d - s[0] * b1
            s[2] = (s[2] * b1 + g * c1) - sigma * wb
            s[0] = d
            wb = -s[2] / d
        elif rule in ('dcasgd', 'dcasgd_mom'):
            g = clipped(g)
            p = 0 if rule == 'dcasgd' else 1
            comp = ((g * k0) * g) * (wb - s[p])
            delta = ((g + wb * wd) + comp) * -a
            if rule == 'dcasgd_mom':
                s[0] = s[0] * mom + delta
                delta = s[0]
            s[p] = wb
            wb = wb + delta
        elif rule == 'adagrad':
            g = clipped(g)
            s[0] = s[0] + g * g
            wb = wb - (g / torch.sqrt(s[0] + eps) + wb * wd) * a
        elif rule in ('rmsprop', 'rmspropalex'):
            if wd_on:
                g = g + wb * wd
            g = clipped(g)
            s[0] = s[0] * b1 + (g * g) * c1
            if rule == 'rmsprop':
                wb = wb - (g * a) / torch.sqrt(s[0] + eps)
            else:
                s[1] = s[1] * b1 + g * c1
                den = torch.sqrt((s[0] - s[1] * s[1]) + eps)
                s[2] = s[2] * b2 - (g * a) / den
                wb = wb + s[2]
            if k_on:
                wb = torch.clamp(wb, -k0, k0)
        elif rule == 'adadelta':
            g = clipped(g)
            s[0] = s[0] * b1 + (g * c1) * g
            step = (torch.sqrt(s[1] + eps) / torch.sqrt(s[0] + eps)) * g
            s[1] = s[1] * b1 + (step * c1) * step
            wb = (wb - step) - wb * wd
        elif rule == 'ftrl':
            g = clipped(g)
            n = s[1] + g * g
            sigma = _over(torch.sqrt(n) - torch.sqrt(s[1]), a)
            s[0] = (s[0] + g) - sigma * wb
            s[1] = n
            wb = torch.where(torch.abs(s[0]) > k0,
                             -(s[0] - _sign(s[0]) * k0)
                             / (_over(torch.sqrt(n) + k1, a) + wd),
                             torch.zeros_like(n))
        elif rule == 'adamax':
            g = clipped(g + wb * wd)
            s[0] = s[0] * b1 + g * c1
            s[1] = torch.maximum(s[1] * b2, torch.abs(g))
            wb = wb - (s[0] * a) / s[1]
        elif rule == 'test':
            wb = wb + g
            s[0] = wb
        for t, v in zip(st, s):
            if t is not None:
                t.copy_(v)
        if w32 is not None:
            w32.copy_(wb)
        w.copy_(wb)


def _host_path(update, pairs, states):
    """One step of the card's host path with the kernel's arithmetic
    modelled on the CPU: ``FusedUpdate.__call__`` with each launch
    replaced by :func:`_kernel_model` over the plan's table and the
    launch's scalars."""
    tensors = [p for _, p in pairs] + [p.grad for _, p in pairs
                                       if p.grad is not None]
    tensors += [t for st in states for t in _flat(st)]
    by_ptr = {t.data_ptr(): t for t in tensors}
    plans = update._plans()
    a, wd, b, scal = update._hypers()
    for poses, plan in plans:
        tab = plan.table([pairs[k][1].grad for k in poses],
                         [a[k] for k in poses], [wd[k] for k in poses],
                         [b[k] for k in poses])
        with torch.no_grad():
            _kernel_model(plan.rule, plan.form, tab,
                          mt.launch_scalars(plan.rule, plan.form, **scal),
                          by_ptr)


@pytest.mark.parametrize('via', ['plain path', 'host path'])
@pytest.mark.parametrize('opt_case,form', CASES)
def test_fused_update_is_bitwise_the_per_parameter_loop(opt_case, form,
                                                        via):
    """Three steps of the whole-model update against three of the
    per-parameter loop, from copies of the same parameters and states:
    bit for bit, counts and ``num_update`` too. 'host path' runs what
    the card's path computes on the host (the plans' tables, the
    launch's scalars) through a model of the kernel's arithmetic."""
    name, hyper = OPTIMIZERS[opt_case]
    low, mp = form != 'float32', form == 'master'
    mine = _setup(name, hyper, low, mp)
    want = copy.deepcopy(mine)
    params, pairs, opt, states = mine
    update = fused.FusedUpdate(opt, pairs, states, torch.device('cpu'))
    assert set(update.groups) == {'float32'} | ({form} if low else set())
    for step in range(3):
        grads = _grads(params, step)
        for (_, p), g in zip(pairs, grads):
            p.grad = g
        if via == 'plain path':
            update()
        else:
            _host_path(update, pairs, states)
        _loop(want[1], want[2], want[3], grads)
        _assert_same(mine, want)
    # nothing launched on CPU tensors
    assert not any(kernels.launch_counts()[n] for n in
                   ('multi_tensor_update', 'multi_tensor_update.bf16',
                    'multi_tensor_update.mp'))


def test_resolve_order_and_scalars():
    """``FusedUpdate._hypers()`` resolves each parameter's lr (AdamW: eta
    from its own count) and wd as ``update_multi_precision`` would, the
    counts advanced once, and the launch's scalars; each group's plan
    holds its form's weights, states and masters."""
    params, pairs, opt, states = _setup(*OPTIMIZERS[3], low=True, mp=True)
    update = fused.FusedUpdate(opt, pairs, states, torch.device('cpu'))
    a, wd, b, scal = update._hypers()
    assert opt._index_update_count == {i: 6 if i == 4 else 1
                                       for i in range(len(SHAPES))}
    assert b == [0.0] * len(SHAPES)
    for (i, p), got_a, got_wd in zip(pairs, a, wd):
        t = opt._index_update_count[i]
        assert (got_a, got_wd) == (opt._bias_corrected(opt._get_lr(i), t),
                                   opt._get_wd(i))
    assert scal == dict(rescale_grad=0.5, clip_gradient=0.2, beta1=0.8,
                        beta2=0.99, epsilon=1e-6, lr=1.0)
    plans = dict((plan.form, (poses, plan))
                 for poses, plan in update._plans())
    assert set(plans) == {'float32', 'master'}
    for form, (poses, plan) in plans.items():
        assert plan.rule == 'adamw'
        tab = plan.table([None] * len(poses), [0.0] * len(poses),
                         [0.0] * len(poses))
        assert list(tab['w']) == [pairs[k][1].data_ptr() for k in poses]
        if form == 'master':
            assert all(pairs[k][1].dtype == BF for k in poses)
            assert list(tab['w32']) == [states[k][0].data_ptr()
                                        for k in poses]
            assert list(tab['s1']) == [states[k][1][0].data_ptr()
                                       for k in poses]
        else:
            assert all(pairs[k][1].dtype == torch.float32 for k in poses)
            assert list(tab['w32']) == [0] * len(poses)
            assert list(tab['s2']) == [states[k][1].data_ptr()
                                       for k in poses]


def test_launch_scalars_round_as_the_plain_ops():
    """Double -> float32 where a scalar meets a float32 tensor, ``1 -
    beta1`` in double first; the bf16 AdamW without a master rounds
    every constant to bf16 first, SGD's bf16 momentum likewise."""
    f32 = mt.launch_scalars('adamw', 'float32', 0.37, 0.2, 0.0, 0.9, 0.999,
                            1e-8, 1.0)
    assert f32 == (np.float32(0.37), np.float32(0.2), 1, 0.0,
                   np.float32(0.9), np.float32(0.999), np.float32(1 - 0.9),
                   np.float32(1 - 0.999), np.float32(1e-8), 1.0, 0.0, 0.0,
                   0)
    low = mt.launch_scalars('adamw', 'low', 0.37, 0.2, 0.0, 0.9, 0.999,
                            1e-8, 1.0)
    bf = [torch.tensor(x, dtype=BF).item() for x in
          (0.37, 0.2, 0.9, 0.999, 1 - 0.9, 1 - 0.999, 1e-8)]
    assert low == (bf[0], bf[1], 1, 0.0, bf[2], bf[3], bf[4], bf[5], bf[6],
                   1.0, 0.0, 0.0, 0)
    assert low[4] == 0.8984375 and low[5] == 1.0
    assert mt.launch_scalars('sgd_mom', 'low', momentum=0.9)[3] == \
        0.8984375
    assert mt.launch_scalars('sgd_mom', 'master', momentum=0.9)[3] == \
        np.float32(0.9)
    # SGD's clip meets a float32 gradient in every form
    assert mt.launch_scalars('sgd', 'low', clip_gradient=0.3)[1] == \
        np.float32(0.3)
    assert mt.launch_scalars('sgd', 'low', clip_gradient=-1.0)[2] == 0
    # the rules of Optimizer._clipped clip whenever a clip is set
    for rule in mt.RULES:
        on = mt.launch_scalars(rule, 'float32', clip_gradient=-1.0)[2]
        assert on == (rule in mt.CLIP_SET_RULES), rule
    # the rules' constants, double -> float32
    assert mt.launch_scalars('ftrl', 'float32', k0=0.01, k1=1)[10:] == \
        (np.float32(0.01), 1.0, 0)
    assert mt.launch_scalars('rmsprop', 'master', k0=1.5, k_on=True)[10:] \
        == (1.5, 0.0, 1)


# -- the kernel's chunk map, thread walk and table --------------------------


def _source_constants():
    text = open(SOURCE).read()
    enum = re.search(r'enum Rule \{([^}]*)\}', text).group(1)
    consts = {k: int(v) for k, v in re.findall(
        r'constexpr int (THREADS|VEC|UNROLL) = (\d+);', text)}
    offsets = {k: int(v) for k, v in re.findall(
        r'static_assert\(offsetof\(Entry, (\w+)\) == (\d+)', text)}
    size = int(re.search(r'static_assert\(sizeof\(Entry\) == (\d+)',
                         text).group(1))
    flags = {k: int(v) for k, v in re.findall(
        r'(WD_ON|VECTOR) = (\d+)', text)}
    rules = {k.lower(): int(v) for k, v in re.findall(r'(\w+) = (\d+)',
                                                     enum)}
    states = [int(v) for v in re.search(
        r'constexpr int STATES\[\] = \{([^}]*)\}', text).group(1).split(',')]
    return consts, offsets, size, flags, rules, states


def test_table_layout_matches_the_source():
    consts, offsets, size, flags, rules, states = _source_constants()
    assert consts == {'THREADS': mt.THREADS, 'VEC': mt.VEC,
                      'UNROLL': mt.UNROLL}
    assert mt.CHUNK == mt.THREADS * mt.VEC * mt.UNROLL
    assert size == mt.ENTRY.itemsize == 80
    for name, off in offsets.items():
        assert mt.ENTRY.fields[name][1] == off, name
    assert set(offsets) == set(mt.ENTRY.names)
    assert flags == {'WD_ON': mt.FLAG_WD, 'VECTOR': mt.FLAG_VECTOR}
    # the three state pointers, and a, wd, b, flags as the step's
    # columns, one word each from COLUMN_WORD
    assert [offsets[k] for k in ('s1', 's2', 's3')] == [16, 24, 32]
    assert [offsets[k] for k in mt.COLUMNS] == [
        4 * (mt.COLUMN_WORD + i) for i in range(len(mt.COLUMNS))]
    # the rule enum is RULES in order; each rule's states are STATES'
    assert rules == {r: i for i, r in enumerate(mt.RULES)}
    assert states == [mt.STATES[r] for r in mt.RULES]


def _walk(n, off):
    """The elements the kernel's threads take in the chunk at ``off`` of
    a tensor of ``n``, as (first, end) runs, vector or scalar."""
    runs = []
    for tid in range(mt.THREADS):
        for u in range(mt.UNROLL):
            i = off + u * mt.THREADS * mt.VEC + tid * mt.VEC
            if i >= n:
                break
            runs.append((i, min(i + mt.VEC, n), i + mt.VEC <= n))
    return runs


def _lists():
    bert = port_bert.bert_12_768_12(vocab_size=30522, max_length=512,
                                    dropout=0.1, device='cpu')
    rn = port_resnet.get_resnet(1, 50, device='cpu')
    return {name: [p.numel() for p in net.collect_params().tensors().values()
                   if p.requires_grad]
            for name, net in (('bert', bert), ('resnet', rn))}


@pytest.mark.parametrize('lengths', [(1,), (7,), (8,), (4097,),
                                     (1, 7, 8, 4097), (8192, 8193, 3),
                                     (0, 5, 0, 16384, 1)],
                         ids=str)
def test_chunks_and_thread_walk_cover_each_element_once(lengths):
    chunk0, total = mt.table_layout([n for n in lengths if n])
    kept = [n for n in lengths if n]
    seen = [np.zeros(n, np.int32) for n in kept]
    for b in range(total):
        t, off = mt.chunk_of(chunk0, b)
        assert 0 <= off < kept[t]
        for first, end, vector in _walk(kept[t], off):
            assert vector == (end - first == mt.VEC)
            seen[t][first:end] += 1
    assert all((s == 1).all() for s in seen)


def test_chunk_map_over_bert_and_resnet_parameter_lists():
    """Over BERT-base's 206 and ResNet-50's 193 updated tensors: chunk b
    maps to the tensor and offset of the b-th chunk in order, every
    tensor's chunks cover it, and the totals are the sums of ceil(n /
    CHUNK)."""
    lists = _lists()
    assert len(lists['bert']) == 206 and sum(lists['bert']) == 131367740
    assert len(lists['resnet']) == 193 and sum(lists['resnet']) == 25575912
    for lengths in lists.values():
        chunk0, total = mt.table_layout(lengths)
        want = [(t, c * mt.CHUNK) for t, n in enumerate(lengths)
                for c in range(-(-n // mt.CHUNK))]
        assert total == len(want)
        assert [mt.chunk_of(chunk0, b) for b in range(total)] == want


def test_pack_table_pointers_lengths_and_flags():
    ws = [torch.zeros(n) for n in (9, 4097, 1)] + [torch.zeros(17)[1:]]
    gs = [torch.zeros_like(w) for w in ws]
    gs[2] = None
    ms = [torch.zeros_like(w) for w in ws]
    tab, total = mt.pack_table(ws, gs, ms, [None] * 4, [None] * 4,
                               [0.1, 0.2, 0.3, 0.4], [0.0, 1e-4, 0.0, 2.0],
                               [False, True, False, True])
    assert total == 4
    assert list(tab['w']) == [w.data_ptr() for w in ws]
    assert list(tab['g']) == [gs[0].data_ptr(), gs[1].data_ptr(), 0,
                              gs[3].data_ptr()]
    assert list(tab['s2']) == [0] * 4 and list(tab['n']) == [9, 4097, 1, 16]
    assert list(tab['chunk0']) == [0, 1, 2, 3]
    assert tab['a'].dtype == np.float32 and tab['a'][1] == np.float32(0.2)
    # the offset view is 4 bytes off 16: no vector loads for it
    assert list(tab['flags']) == [mt.FLAG_VECTOR,
                                  mt.FLAG_VECTOR | mt.FLAG_WD,
                                  mt.FLAG_VECTOR, mt.FLAG_WD]


@pytest.mark.parametrize('rule', mt.RULES)
def test_plan_table_is_pack_table_of_each_step(rule):
    """A ``MultiTensorPlan`` checks and packs its weights' and states'
    columns once; each step's table (new gradients, one missing, one a
    misaligned view; the step's lrs, wds and second factors) equals
    ``pack_table`` of the whole lists, and a gradient of another dtype,
    shape or layout raises."""
    lengths = (9, 4097, 1, 0, 33, 8)
    ws = [torch.zeros(n) for n in lengths]
    k = mt.STATES[rule]

    def state(n):
        ts = [torch.zeros(n) for _ in range(k)]
        if rule == 'dcasgd':
            return (None, ts[0])     # DCASGD without momentum
        return None if not k else ts[0] if k == 1 else tuple(ts)
    states = [state(n) for n in lengths]
    s1, s2, s3 = mt.state_lists(rule, states)
    plan = mt.MultiTensorPlan(rule, ws, states)
    for step in range(2):
        gs = [torch.full((n,), float(step)) for n in lengths]
        gs[2] = None
        gs[4] = torch.zeros(n + 1)[1:] if (n := lengths[4]) else None
        lrs = [0.1 * (k + step + 1) for k in range(len(ws))]
        wds = [0.0 if k % 2 else 1e-3 * (k + 1) for k in range(len(ws))]
        bs = [0.5 + k for k in range(len(ws))]
        got = plan.table(gs, lrs, wds, bs).copy()
        want, total = mt.pack_table(ws, gs, s1, s2, [None] * len(ws), lrs,
                                    wds, [rule in mt.WD_FLAG_RULES and d != 0
                                          for d in wds], s3=s3, b=bs)
        assert total == plan.chunks
        assert got.tobytes() == want.tobytes()
    with pytest.raises(TypeError, match='grad'):
        plan.table([None if g is None else g.double() for g in gs], lrs,
                   wds)
    with pytest.raises(ValueError, match='grad'):
        plan.table([torch.zeros(n, 2)[:, 0] if n else None
                    for n in lengths], lrs, wds)


# -- refusals on a CUDA device ------------------------------------------------


class _Custom(optmod.SGD):
    """An SGD subclass: its update may differ, so the kernel takes it
    not."""


@pytest.mark.parametrize('case', ['subclass', 'float16', 'adam low',
                                  'rmsprop low'])
def test_uncovered_optimizer_or_form_raises_on_cuda(case):
    if case == 'subclass':
        opt = _Custom(learning_rate=0.1)
        p = torch.nn.Parameter(torch.zeros(3))
    elif case.endswith('low'):
        # a new rule's bf16 form without a master is not built
        opt = optmod.create(case.split()[0])
        p = torch.nn.Parameter(torch.zeros(3, dtype=BF))
    else:
        opt = optmod.AdamW(multi_precision=True)
        p = torch.nn.Parameter(torch.zeros(3, dtype=torch.float16))
    opt.idx2name = {0: 'x_weight'}
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')    # bf16 without a master
        states = [opt.create_state_multi_precision(0, p.detach())]
    with pytest.raises(fused.FusedUpdateError, match='no kernel'):
        fused.FusedUpdate(opt, [(0, p)], states, torch.device('cuda'))
    # the CPU runs the plain loop for any optimizer
    fused.FusedUpdate(opt, [(0, p)], states, torch.device('cpu'))
    assert issubclass(fused.FusedUpdateError, TypeError)


@pytest.mark.parametrize('name', ['sgld', 'nadam', 'lbsgd'])
def test_unfusable_optimizer_runs_its_loop_and_parallel_trainer_refuses(
        name):
    """``fusable = False``: the whole-model update on a CUDA device builds
    no plan and runs the per-parameter loop (as the reference's Trainer);
    ``ParallelTrainer`` refuses the optimizer with ``FusedUpdateError``,
    on any device."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn
    opt = optmod.create(name, learning_rate=0.1)
    assert opt.fusable is False and fused.rule_of(opt) is None
    p = torch.nn.Parameter(torch.zeros(3))
    update = fused.FusedUpdate(opt, [(0, p)], [opt.create_state(0, p)],
                               torch.device('cuda'))
    assert update._plain and update.groups == {'float32': [0]}
    net = nn.Dense(3, in_units=4, device='cpu')
    with pytest.raises(fused.FusedUpdateError, match='not fusable'):
        parallel.ParallelTrainer(net, gloss.SoftmaxCrossEntropyLoss(), name,
                                 {'learning_rate': 0.1})


@pytest.mark.parametrize('name', ['adam', 'nag', 'ftml', 'rmsprop', 'ftrl',
                                  'test'])
def test_parallel_trainer_takes_every_rule(name):
    """A ``ParallelTrainer`` step (its plain update on the CPU) with a new
    rule's optimizer: the update is the loop of ``update_multi_precision``
    (held bitwise against it), its rule the kernel's."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn
    torch.manual_seed(0)
    nets = []
    for _ in range(2):
        net = nn.Dense(3, in_units=4, device='cpu')
        with torch.no_grad():
            for q, v in zip(net.parameters(), (torch.arange(12.).view(3, 4)
                                               / 10, torch.ones(3))):
                q.copy_(v)
        nets.append(net)
    x, y = torch.ones(2, 4), torch.tensor([0., 2.])
    pt = parallel.ParallelTrainer(nets[0], gloss.SoftmaxCrossEntropyLoss(),
                                  name, {'learning_rate': 0.1})
    pt.step(x, y)
    assert fused.rule_of(pt._update._opt) in mt.RULES
    opt = optmod.create(name, learning_rate=0.1)
    named = list(nets[1].collect_params().tensors().items())
    opt.idx2name = {i: n for i, (n, _) in enumerate(named)}
    loss = gloss.SoftmaxCrossEntropyLoss()(nets[1](x), y).mean()
    loss.backward()
    for i, (_, q) in enumerate(named):
        opt.update_multi_precision(i, q.data, q.grad,
                                   opt.create_state_multi_precision(
                                       i, q.detach()))
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(a, b)


def test_trainer_builds_the_fused_update():
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(3, in_units=4, device='cpu')
    with torch.no_grad():
        for p in net.parameters():
            p.normal_()
    pt = parallel.ParallelTrainer(net, gloss.SoftmaxCrossEntropyLoss(),
                                  'adamw', {'learning_rate': 0.1})
    pt.step(torch.ones(2, 4), torch.tensor([0., 2.]))
    assert isinstance(pt._update, fused.FusedUpdate)
    assert set(pt._update.groups) == {'float32'}


@pytest.mark.cuda
@pytest.mark.parametrize('rule', mt.RULES)
def test_rule_kernel_is_bitwise_its_plain_loop_on_card(rule):
    """Each rule's instances on the card against the plain loop, at the
    odd lengths, over three steps (``chip_smoke.check_fused_update``)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel is CUDA C++ for sm_90a '
                    'and has no CPU mode')
    import chip_smoke
    from mxnet_tpu_torch import optimizer
    lists = {'odd': [(n,) for n in chip_smoke.ODD_LENGTHS]}
    errs = chip_smoke.check_fused_update(torch, kernels, optimizer,
                                         torch.device('cuda'), lists,
                                         rules=(rule,))
    assert set(errs.values()) == {0.0}


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(optmod.opt_registry))
def test_gluon_trainer_on_card_is_its_plain_loop(name):
    """``gluon.Trainer`` of every registered optimizer on the card: one
    launch of its rule a step (none for SGLD, Nadam and LBSGD, which run
    their loop), bitwise the plain loop (``chip_smoke.check_gluon_rule``;
    SGLD's noise from the same seed)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel is CUDA C++ for sm_90a '
                    'and has no CPU mode')
    import chip_smoke
    import mxnet_tpu_torch as mx
    chip_smoke.check_gluon_rule(torch, mx, kernels, name)


@pytest.mark.cuda
def test_kernel_is_bitwise_its_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel is CUDA C++ for sm_90a '
                    'and has no CPU mode')
    import chip_smoke
    from mxnet_tpu_torch import optimizer
    lists = {'odd': [(n,) for n in chip_smoke.ODD_LENGTHS]}
    errs = chip_smoke.check_fused_update(torch, kernels, optimizer,
                                         torch.device('cuda'), lists)
    assert errs == dict.fromkeys(('multi_tensor_update',
                                  'multi_tensor_update.bf16',
                                  'multi_tensor_update.mp'), 0.0)

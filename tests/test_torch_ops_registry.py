"""The port's op registry (``mxnet_tpu_torch/ops/registry.py``, the ops
of ``ops/math.py``, ``ops/tensor.py``, ``ops/random_ops.py`` and the
reference names of ``ops/nn.py``, ``ops/optimizer_ops.py`` and
``ops/contrib.py``) against the JAX package's, on the CPU.

Every op name both registries hold runs through ``mx.nd.<name>`` of both
packages on the inputs of ``tests/test_op_sweep.py``'s spec for it (the
aliases of a spec'd op share its spec), in three tiers:

  * exact: the elementwise, comparison, scalar, shape, index and
    ordering ops, bit for bit (values and shapes);
  * transcendental: the unary and binary ops XLA and torch each
    approximate (exp, log, the trig family, erf, sigmoid, hypot, the
    divisions XLA turns into a reciprocal product, the adaptive updates'
    square roots and quotients, ...), within 2 ULP
    (``docs/PERFORMANCE.md``'s equivalence classes);
  * reduction: sums, means, products of matrices, convolutions, the
    normalizations, softmax and the fused RNN and attention ops, and
    gamma / gammaln (XLA's float32 Lanczos lgamma, which the port
    follows step for step, loses relative precision near its zeros at 1
    and 2, where no 2-ULP bound holds), within 1e-5 of the largest
    magnitude.

The samplers are held to shape and dtype (the port draws torch's bits,
not threefry's). Gradients of ``sum(out * w)`` (a fixed random ``w``)
with respect to every float input agree within 1e-5 of the largest
gradient magnitude. Finally, the JAX names the port lacks are exactly
the sorted list ROADMAP.md A10 writes down, so the gap can only
shrink, on purpose.
"""
import os
import re

import numpy as np
import pytest

import test_op_sweep as sweep

import mxnet_tpu_torch as pmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import autograd as pag
from mxnet_tpu_torch import nd as pnd
from mxnet_tpu_torch.ops import registry as preg

ULP = 2                     # transcendental tier
REL = 1e-5                  # reduction tier and gradients

TRANSCENDENTAL = {
    'cbrt', 'rcbrt', 'exp', 'log', 'log10', 'log2', 'log1p', 'expm1', 'sin',
    'cos', 'tan', 'arcsin', 'arccos', 'arctan', 'sinh', 'cosh', 'tanh',
    'arcsinh', 'arccosh', 'arctanh', 'rsqrt', 'erf', 'erfinv', 'sigmoid',
    'softsign', 'sqrt', 'degrees', 'radians', 'reciprocal', '_hypot',
    'broadcast_hypot', 'elemwise_hypot', '_hypot_scalar', 'elemwise_power',
    'broadcast_power', '_power', '_pow', '_Power', '_power_scalar',
    '_rpower_scalar', 'elemwise_div', 'broadcast_div', '_div', '_Div',
    '_div_scalar', '_DivScalar', '_rdiv_scalar', 'Activation', 'LeakyReLU',
    'softmax', 'log_softmax', '_contrib_fused_softmax_xent', 'smooth_l1',
    'softmin', 'Softmax', 'SoftmaxActivation', 'SoftmaxOutput',
    'LogisticRegressionOutput', 'adam_update', 'rmsprop_update',
    'rmspropalex_update', 'ftml_update', 'ftrl_update', 'adagrad_update',
    '_sparse_adagrad_update', '_contrib_group_adagrad_update',
    '_adamw_update', '_contrib_adamw_update', '_mp_adamw_update',
    '_contrib_mp_adamw_update'}
REDUCTION = {
    'sum', 'sum_axis', 'mean', 'prod', 'nansum', 'nanprod', 'norm',
    '_square_sum', 'square_sum', 'dot', 'batch_dot', 'khatri_rao',
    'FullyConnected', 'Convolution', 'Pooling', 'Pooling_v1', 'BatchNorm',
    'BatchNorm_v1', 'LayerNorm', 'RNN', '_contrib_flash_attention',
    'softmax_cross_entropy', 'gamma', 'gammaln', '_contrib_box_iou',
    '_contrib_MultiBoxPrior', '_contrib_MultiBoxDetection', 'add_n',
    'ElementWiseSum', '_sum', 'CTCLoss', 'ctc_loss', '_contrib_CTCLoss',
    '_contrib_ctc_loss', '_contrib_SyncBatchNorm', 'InstanceNorm',
    'L2Normalization', 'LRN', 'Deconvolution', 'GridGenerator',
    'BilinearSampler', 'SpatialTransformer'}


# the shared names no spec of tests/test_op_sweep.py covers, with their
# aliases (inputs from the same seed as the sweep's)
OWN = {
    '_getitem': sweep.Spec([sweep.U((3, 4))],
                           attrs={'_key': (slice(0, 2), 1)}),
    '_scatter_elemwise_div': sweep.Spec([
        sweep.C(np.array([[0., 1., 2.], [3., 0., -1.]], np.float32)),
        sweep.U((2, 3), 0.5, 2)]),
    '_sparse_retain': sweep.Spec([sweep.U((4, 3)),
                                  sweep.C(np.array([0, 2], np.int32))],
                                 grad_idx=[0]),
    '_square_sum': sweep.Spec([sweep.U((2, 3))], attrs={'axis': 1}),
    'elemwise_hypot': sweep.Spec([sweep.U((2, 3), 0.3, 2),
                                  sweep.U((2, 3), 0.3, 2)]),
}
SPECS = dict(sweep.SPECS, **OWN)
GRAD_NAMES = set(sweep.GRAD_NAMES) | {'_getitem', '_sparse_retain',
                                      '_square_sum', 'elemwise_hypot'}


def _canonical(name):
    """The spec'd name an alias shares its op with."""
    op = jreg.OPS[name]
    if name in SPECS:
        return name
    for other, o in sorted(jreg.OPS.items()):
        if o is op and other in SPECS:
            return other
    return None


SHARED = sorted(set(jreg.OPS) & set(preg.list_ops()))
CASES = [n for n in SHARED if _canonical(n) is not None]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _run(nd, name, arrays, attrs):
    return _as_list(getattr(nd.op, name)(*[nd.array(a) for a in arrays],
                                         **attrs))


def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _hold(name, got, want, what):
    assert got.shape == want.shape, (name, what, got.shape, want.shape)
    if what != 'grad' and name in TRANSCENDENTAL and \
            want.dtype == np.float32:
        ulp = _ulps(got, want)
        assert ulp <= ULP, '%s %s: %d ULP (limit %d)' % (name, what, ulp,
                                                          ULP)
    elif name in REDUCTION or what == 'grad':
        scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1
        err = float(np.abs(got.astype(np.float64)
                           - want.astype(np.float64)).max()) \
            if want.size else 0.0
        assert err <= REL * scale, '%s %s: %.3g (limit %g x %.3g)' % (
            name, what, err, REL, scale)
    else:
        np.testing.assert_array_equal(got, want, err_msg='%s %s' % (name,
                                                                    what))


@pytest.mark.parametrize('name', CASES)
def test_op_matches_jax(name):
    s = SPECS[_canonical(name)]
    arrays = s.build()
    want = _run(jnd, name, arrays, s.attrs)
    with pmx.cpu():
        got = _run(pnd, name, arrays, s.attrs)
    assert len(got) == len(want)
    rng = preg.get(name).needs_rng
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.asnumpy(), np.asarray(w.asnumpy())
        if rng:
            assert g.shape == w.shape and g.dtype.kind == w.dtype.kind, (
                name, g.shape, w.shape, g.dtype, w.dtype)
            continue
        _hold(name, g, w, 'output %d' % k)


def _grad_names():
    out = []
    for n in CASES:
        s = SPECS[_canonical(n)]
        if preg.get(n).needs_rng or preg.get(n).mutate_idx:
            continue
        if n in GRAD_NAMES or _canonical(n) in GRAD_NAMES:
            out.append(n)
    return out


def _grads(nd, ag, name, arrays, attrs, idx):
    xs = [nd.array(a) for a in arrays]
    for i in idx:
        xs[i].attach_grad()
    with ag.record():
        outs = _as_list(getattr(nd.op, name)(*xs, **attrs))
        rs = np.random.RandomState(3)
        loss = None
        for o in outs:
            if not np.issubdtype(np.asarray(o.asnumpy()).dtype, np.floating):
                continue
            w = nd.array(rs.uniform(0.5, 1.5, o.shape).astype(np.float32))
            t = (o * w).sum()
            loss = t if loss is None else loss + t
    loss.backward()
    return [xs[i].grad.asnumpy() for i in idx]


@pytest.mark.parametrize('name', _grad_names())
def test_gradient_matches_jax(name):
    s = SPECS[_canonical(name)]
    arrays = s.build()
    idx = s.grad_idx if s.grad_idx is not None else [
        i for i, a in enumerate(arrays)
        if np.issubdtype(np.asarray(a).dtype, np.floating)]
    want = _grads(jnd, jag, name, arrays, s.attrs, idx)
    with pmx.cpu():
        got = _grads(pnd, pag, name, arrays, s.attrs, idx)
    for i, g, w in zip(idx, got, want):
        _hold(name, g, np.asarray(w), 'grad')


def _roadmap_gap():
    path = os.path.join(os.path.dirname(__file__), os.pardir, 'ROADMAP.md')
    text = open(path).read()
    m = re.search(r'```op-gap\n(.*?)```', text, re.S)
    assert m, 'ROADMAP.md has no ```op-gap block'
    return m.group(1).split()


def test_missing_ops_are_the_roadmap_list():
    """The JAX op names the port has not registered, sorted, against
    ROADMAP.md A10's list (a port that gains an op removes it there)."""
    missing = sorted(set(jreg.OPS) - set(preg.list_ops()))
    listed = _roadmap_gap()
    assert listed == sorted(listed), 'the ROADMAP list is not sorted'
    assert missing == listed


def test_every_shared_op_has_a_case():
    """Every name both registries hold is swept, by the sweep's spec, its
    alias's, or this file's own table."""
    assert sorted(n for n in SHARED if _canonical(n) is None) == []

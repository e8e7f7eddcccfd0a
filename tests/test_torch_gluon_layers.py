"""Port parity: the gluon layers the port adds (``gluon/nn/activations.py``,
``conv_layers.py``, ``InstanceNorm``) against the JAX package's.

Each layer built in both packages with the same arguments, the JAX
layer's parameters (drawn from a seeded ``Uniform(0.5)``, ``PReLU``'s a
seeded slope) copied into the port's in ``collect_params`` order; the
same numpy input and output gradient; the forward, the input's gradient
and every parameter's gradient held:

  * exactly: the reflection pad, the max pools (windows, ``ceil_mode``,
    global), LeakyReLU; but the input gradient of the reflection pad and
    of the ``ceil_mode`` max pool, which sum a position's reflected
    copies or overlapping windows in another order than XLA's transpose
    and select-and-scatter do: within 1e-5 (``exact_fwd``);
  * within 1e-5 of the largest magnitude: the convolutions and transposed
    convolutions (1-, 2- and 3-D; strides, padding, dilation, groups,
    ``output_padding``), the average pools (``count_include_pad`` either
    way, ``ceil_mode``, global), InstanceNorm, PReLU, and the gradients of
    ELU, SELU, GELU and Swish;
  * within 2 ULP: the forward of ELU and Swish (their ``expm1`` / ``exp``,
    rounded as the JAX expressions round); GELU's within 3 (``erfc``'s 2
    through one more product); SELU's within 4 (``expm1``'s through two,
    alpha's and the scale's).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx

REL = 1e-5
ULP = {'gelu': 3, 'selu': 4}     # else 2

# (id, layer factory (given the package's nn), input shape, tier)
LAYERS = [
    ('leakyrelu', lambda nn: nn.LeakyReLU(0.1), (3, 4, 5), 'exact'),
    ('prelu', lambda nn: nn.PReLU(), (3, 4, 5), 'rel'),
    ('elu', lambda nn: nn.ELU(), (3, 4, 5), 'ulp'),
    ('elu_half', lambda nn: nn.ELU(0.5), (3, 4, 5), 'ulp'),
    ('selu', lambda nn: nn.SELU(), (3, 4, 5), 'ulp'),
    ('gelu', lambda nn: nn.GELU(), (3, 4, 5), 'ulp'),
    ('swish', lambda nn: nn.Swish(), (3, 4, 5), 'ulp'),
    ('swish_beta', lambda nn: nn.Swish(0.5), (3, 4, 5), 'ulp'),
    ('conv1d', lambda nn: nn.Conv1D(8, 3, strides=2, padding=1,
                                    in_channels=4), (2, 4, 11), 'rel'),
    ('conv1d_groups', lambda nn: nn.Conv1D(6, 3, dilation=2, groups=2,
                                           use_bias=False, in_channels=4),
     (2, 4, 13), 'rel'),
    ('conv2d_act', lambda nn: nn.Conv2D(5, (3, 2), strides=(2, 1),
                                        padding=(1, 0), activation='tanh',
                                        in_channels=3), (2, 3, 7, 6), 'rel'),
    ('conv3d', lambda nn: nn.Conv3D(4, (2, 3, 3), padding=(1, 1, 0),
                                    in_channels=3), (2, 3, 5, 6, 7), 'rel'),
    ('conv1d_transpose', lambda nn: nn.Conv1DTranspose(
        6, 3, strides=2, padding=1, output_padding=1, in_channels=4),
     (2, 4, 7), 'rel'),
    ('conv2d_transpose', lambda nn: nn.Conv2DTranspose(
        5, 4, 2, 1, use_bias=False, in_channels=3), (2, 3, 5, 5), 'rel'),
    ('conv2d_transpose_groups', lambda nn: nn.Conv2DTranspose(
        4, 3, strides=2, dilation=2, groups=2, in_channels=4),
     (2, 4, 4, 5), 'rel'),
    ('conv3d_transpose', lambda nn: nn.Conv3DTranspose(
        3, 3, strides=2, padding=1, output_padding=(1, 0, 1), in_channels=2),
     (1, 2, 3, 4, 3), 'rel'),
    ('maxpool1d', lambda nn: nn.MaxPool1D(3, 2, 1), (2, 3, 11), 'exact'),
    ('maxpool2d_ceil', lambda nn: nn.MaxPool2D(3, 2, 1, ceil_mode=True),
     (2, 3, 8, 9), 'exact_fwd'),
    ('maxpool3d', lambda nn: nn.MaxPool3D(2), (2, 3, 4, 6, 5), 'exact'),
    ('avgpool1d_nopad', lambda nn: nn.AvgPool1D(3, 2, 1,
                                                count_include_pad=False),
     (2, 3, 11), 'rel'),
    ('avgpool2d', lambda nn: nn.AvgPool2D(3, 2, 1), (2, 3, 9, 8), 'rel'),
    ('avgpool2d_ceil', lambda nn: nn.AvgPool2D(2, ceil_mode=True),
     (2, 3, 7, 7), 'rel'),
    ('avgpool3d_nopad', lambda nn: nn.AvgPool3D(2, 1, 1,
                                                count_include_pad=False),
     (1, 2, 3, 4, 5), 'rel'),
    ('globalmaxpool1d', lambda nn: nn.GlobalMaxPool1D(), (2, 3, 9), 'exact'),
    ('globalmaxpool2d', lambda nn: nn.GlobalMaxPool2D(), (2, 3, 5, 4),
     'exact'),
    ('globalmaxpool3d', lambda nn: nn.GlobalMaxPool3D(), (2, 3, 3, 4, 2),
     'exact'),
    ('globalavgpool1d', lambda nn: nn.GlobalAvgPool1D(), (2, 3, 9), 'rel'),
    ('globalavgpool3d', lambda nn: nn.GlobalAvgPool3D(), (2, 3, 3, 4, 2),
     'rel'),
    ('instancenorm', lambda nn: nn.InstanceNorm(in_channels=4),
     (2, 4, 5, 5), 'rel'),
    ('instancenorm_affine', lambda nn: nn.InstanceNorm(
        in_channels=3, scale=True, epsilon=1e-3), (2, 3, 7), 'rel'),
    ('reflectionpad2d', lambda nn: nn.ReflectionPad2D(2), (2, 3, 6, 5),
     'exact_fwd'),
]


def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _hold(got, want, tier, what, name):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tier == 'exact' or (tier == 'exact_fwd' and what == 'out'):
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif tier == 'ulp' and what == 'out':
        limit = ULP.get(name, 2)
        assert _ulps(got, want) <= limit, (what, _ulps(got, want), limit)
    else:
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.astype(np.float64)
                           - want.astype(np.float64)).max())
        assert err <= REL * scale, (what, err, scale)


def _run(mx, nn, make, x, dy, weights=None):
    """The layer of ``make`` in package ``mx``: its parameters (the JAX
    run draws them, the port's takes ``weights``), forward and backward
    of ``x`` with output gradient ``dy``. Returns (out, dx, parameter
    gradients, parameters)."""
    layer = make(nn)
    mx.random.seed(0)
    layer.initialize(mx.init.Uniform(0.5))
    xs = mx.nd.array(x)
    layer(xs)                                    # deferred shapes
    params = list(layer.collect_params().values())
    if weights is None:
        rs = np.random.RandomState(1)
        weights = []
        for p in params:
            w = p.data().asnumpy()
            if p.name.endswith('alpha'):
                w = rs.uniform(0.05, 0.5, w.shape).astype(np.float32)
                p.set_data(mx.nd.array(w))
            weights.append(w)
    else:
        for p, w in zip(params, weights):
            p.set_data(mx.nd.array(w))
    if dy is None:
        return layer(xs).asnumpy(), None, None, weights
    xs.attach_grad()
    with mx.autograd.record():
        out = layer(xs)
    out.backward(mx.nd.array(dy))
    grads = [p.grad().asnumpy() for p in params if p.grad_req != 'null']
    return out.asnumpy(), xs.grad.asnumpy(), grads, weights


@pytest.mark.parametrize('case', LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_matches_jax(case):
    name, make, shape, tier = case
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    jout, _, _, weights = _run(jmx, jmx.gluon.nn, make, x, None)
    dy = np.random.RandomState(2).randn(*jout.shape).astype(np.float32)
    jout, jdx, jgrads, _ = _run(jmx, jmx.gluon.nn, make, x, dy, weights)
    with pmx.cpu():
        pout, pdx, pgrads, _ = _run(pmx, pmx.gluon.nn, make, x, dy,
                                    weights)
    grad_tier = 'rel' if tier == 'ulp' else tier
    _hold(pout, jout, tier, 'out', name)
    _hold(pdx, jdx, grad_tier, 'dx', name)
    assert len(pgrads) == len(jgrads)
    for k, (a, b) in enumerate(zip(pgrads, jgrads)):
        _hold(a, b, grad_tier, 'param grad %d' % k, name)


def test_layer_names_and_exports():
    """The new layers resolve in ``gluon.nn`` under the JAX names;
    ``Activation`` still comes from ``basic_layers`` too; a conv's
    parameters keep the JAX names and layouts."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.nn import activations, basic_layers
    for name in jmx.gluon.nn.conv_layers.__all__ + \
            jmx.gluon.nn.activations.__all__ + ['InstanceNorm']:
        assert hasattr(nn, name), name
    assert basic_layers.Activation is activations.Activation
    with pmx.cpu():
        c = nn.Conv2DTranspose(5, 4, in_channels=3)
        assert tuple(c.weight.shape) == (3, 5, 4, 4)
        assert [k.split('_', 1)[1] for k in c.collect_params()] == \
            ['weight', 'bias']

"""Port parity: the ResNet v1 training slice of the port (model, loss, SGD
with momentum, BatchNorm moving statistics, ``ParallelTrainer.step``)
against the JAX package's.

A narrow v1 ResNet -- ``ResNetV1(BottleneckV1, [2, 1, 1, 1], [8, 16, 32,
64, 128], classes=10)`` -- on 4 x 3 x 64 x 64 images is built in the JAX
package with ``MXNET_TPU_PALLAS=epilogue,xent`` (its epilogue and
softmax-xent kernels run in the Pallas interpreter), filled with
numpy-seeded weights (running statistics included), and carried into the
port by ``resnet.params_from_jax``. The JAX side runs once per module:
inference-mode logits, a training-mode forward and ``autograd.record()``
gradients (which also move the running statistics), then, from the same
weights again, three ``ParallelTrainer`` SGD steps (momentum 0.9, wd
1e-4 as in the bench, lr 0.001).

Why this size and this lr. Training-mode BatchNorm normalizes each
channel over N*H*W values with the one-pass ``E[x^2] - E[x]^2`` variance;
at 2 x 32 x 32 the last stage normalizes over 2 values per channel, where
that difference cancels and the two frameworks' summation orders give
logits 1e-2 apart. At 64 px it is 16 values. And at the bench's lr 0.1 a
4-image batch trains chaotically: a 1e-5 difference after the first step
grows to 1e-2 in the weights after the second, whichever framework's
rounding seeds it; at lr 0.001 the three steps stay within 2e-5.

Tolerances, all float32:
  * inference logits: 2e-5 absolute on O(1) values;
  * training-mode logits: 1e-4 relative to their max abs (measured
    2e-5: the batch statistics above);
  * gradients: 5e-4 relative to each gradient's max abs (measured
    1.4e-4 on a BatchNorm gamma, whose gradient sums over every pixel
    through the statistics), except the biases of the convs that feed a
    BatchNorm: their exact gradient is 0 (the BatchNorm subtracts the
    mean), so both sides hold rounding noise, bounded by 1e-5 of the
    net's largest gradient;
  * the loss, and the losses over three SGD steps: 1e-5 relative;
    parameters and running statistics after them (and after the
    recorded forward): 5e-5 absolute.

The full-width ``resnet50_v1`` is checked for its 299 parameter names and
shapes and for one 2 x 3 x 32 x 32 inference forward (1e-4 relative to
the logits' max abs: 53 convolutions deep).
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import autograd, config, nd
from mxnet_tpu import parallel as jax_parallel
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet
from mxnet_tpu_torch import parallel as port_parallel
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon import nn as port_gnn
from mxnet_tpu_torch.gluon.model_zoo import resnet as port_resnet
from mxnet_tpu_torch.ops import kernels

torch.set_num_threads(1)

LAYERS, CHANNELS, CLASSES = [2, 1, 1, 1], [8, 16, 32, 64, 128], 10
HYPER = {'learning_rate': 0.001, 'momentum': 0.9, 'wd': 1e-4}
STEPS = 3
FWD_TOL = 2e-5
TRAIN_FWD_REL = 1e-4
GRAD_REL = 5e-4
NOISE_REL = 1e-5
LOSS_REL = 1e-5
PARAM_TOL = 5e-5
FULL_REL = 1e-4


def _batch():
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (4, 3, 64, 64)).astype('float32')
    y = rs.randint(0, CLASSES, (4,)).astype('float32')
    return x, y


def _weights(names_shapes):
    """Random weights from a numpy seed, every tensor carrying a signal:
    He-scaled conv / dense weights, gamma near 1, beta, biases and
    running means near 0, running variances in [0.5, 1.5)."""
    rs = np.random.RandomState(1)
    out = {}
    for name, shape in names_shapes:
        w = rs.randn(*shape).astype('float32')
        if name.endswith('gamma'):
            out[name] = 1.0 + 0.1 * w
        elif name.endswith(('bias', 'beta', 'running_mean')):
            out[name] = 0.1 * w
        elif name.endswith('running_var'):
            out[name] = (0.5 + rs.rand(*shape)).astype('float32')
        else:
            fan_in = int(np.prod(shape[1:]))
            out[name] = w * np.float32(np.sqrt(2.0 / fan_in))
    return out


def _jax_net():
    return jax_resnet.ResNetV1(jax_resnet.BottleneckV1, LAYERS, CHANNELS,
                               classes=CLASSES)


def _set(params, weights):
    for n, p in params.items():
        p.set_data(nd.array(weights[n]))


@pytest.fixture(scope='module')
def ref():
    """Everything the JAX package computes for the slice, as numpy."""
    config.set('MXNET_TPU_PALLAS', 'epilogue,xent')
    try:
        net = _jax_net()
        net.initialize(mx.init.Xavier())
        x, y = _batch()
        xs, ys = nd.array(x), nd.array(y)
        net(xs)                                     # deferred shapes
        params = net.collect_params()
        weights = _weights([(n, p.shape) for n, p in params.items()])
        _set(params, weights)
        logits = net(xs).asnumpy()
        L = jax_loss.SoftmaxCrossEntropyLoss()
        with autograd.record():
            train_logits = net(xs)
            loss = L(train_logits, ys).mean()
        loss.backward()
        grads = {n: p.grad().asnumpy() for n, p in params.items()
                 if p.grad_req != 'null'}
        stats = {n: p.data().asnumpy() for n, p in params.items()
                 if n.endswith(('running_mean', 'running_var'))}
        _set(params, weights)
        mesh = jax_parallel.create_mesh({'dp': 1},
                                        devices=jax.devices()[:1])
        pt = jax_parallel.ParallelTrainer(net, L, 'sgd', dict(HYPER), mesh)
        losses = [float(pt.step(xs, ys).asnumpy()) for _ in range(STEPS)]
        after = {n: p.data().asnumpy() for n, p in params.items()}
    finally:
        config.unset('MXNET_TPU_PALLAS')
    return dict(weights=weights, logits=logits,
                train_logits=train_logits.asnumpy(),
                loss=float(loss.asnumpy()), grads=grads, stats=stats,
                losses=losses, after=after)


def _port_net(ref):
    net = port_resnet.ResNetV1(port_resnet.BottleneckV1, LAYERS, CHANNELS,
                               classes=CLASSES, device='cpu')
    return port_resnet.params_from_jax(ref['weights'], net)


def _short(name):
    return name.split('_', 1)[1]


def _inputs():
    x, y = _batch()
    return torch.tensor(x), torch.tensor(y)


def test_every_jax_parameter_maps_to_one_port_parameter(ref):
    net = _port_net(ref)
    mine = net.collect_params().tensors()
    jax_names = sorted(ref['weights'])
    assert all(n.startswith('resnetv1') for n in jax_names)
    assert sorted(_short(n) for n in jax_names) == sorted(mine)
    for n in jax_names:
        assert tuple(mine[_short(n)].shape) == ref['weights'][n].shape
    # the moving statistics are parameters that take no gradient
    frozen = sorted(n for n, p in mine.items() if not p.requires_grad)
    assert frozen == sorted(_short(n) for n in ref['stats'])
    assert sorted(n for n, p in mine.items() if p.requires_grad) == \
        sorted(_short(n) for n in ref['grads'])
    partial = dict(ref['weights'])
    partial.pop(jax_names[0])
    with pytest.raises(ValueError, match='missing'):
        port_resnet.params_from_jax(partial, net)


def test_inference_logits_match_jax(ref):
    net = _port_net(ref)
    x, _ = _inputs()
    kernels.reset_launch_counts()
    with torch.no_grad():
        logits = net(x)
    assert tuple(logits.shape) == (4, CLASSES)
    np.testing.assert_allclose(logits.numpy(), ref['logits'], rtol=0,
                               atol=FWD_TOL)
    # inference does not move the running statistics
    for n, w in ref['weights'].items():
        if n.endswith('running_var'):
            np.testing.assert_array_equal(
                net.collect_params().tensors()[_short(n)].numpy(), w)
    # CPU tensors take the plain versions: no kernel launch counted
    assert not any(kernels.launch_counts().values())


def test_step0_gradients_and_running_stats_match_jax(ref):
    net = _port_net(ref)
    x, y = _inputs()
    net.train(True)
    logits = net(x)
    loss = port_loss.SoftmaxCrossEntropyLoss()(logits, y).mean()
    loss.backward()
    net.train(False)
    want = ref['train_logits']
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0,
                               atol=TRAIN_FWD_REL * np.abs(want).max())
    assert abs(loss.item() - ref['loss']) <= LOSS_REL * abs(ref['loss'])
    mine = net.collect_params().tensors()
    largest = max(float(np.abs(g).max()) for g in ref['grads'].values())
    for n, want in ref['grads'].items():
        got = mine[_short(n)].grad.numpy()
        if '_conv' in n and n.endswith('_bias'):
            # feeds a BatchNorm: the exact gradient is 0
            assert np.abs(want).max() <= NOISE_REL * largest, n
            assert np.abs(got).max() <= NOISE_REL * largest, n
            continue
        tol = GRAD_REL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=n)
    for n, want in ref['stats'].items():
        p = mine[_short(n)]
        assert p.grad is None
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=PARAM_TOL, err_msg=n)


def test_three_sgd_steps_match_jax(ref):
    net = _port_net(ref)
    x, y = _inputs()
    pt = port_parallel.ParallelTrainer(net, port_loss.SoftmaxCrossEntropyLoss(),
                                       'sgd', dict(HYPER))
    losses = [pt.step(x, y).item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref['losses'], rtol=LOSS_REL, atol=0)
    assert pt.num_update == STEPS and pt.learning_rate == 0.001
    mine = net.collect_params().tensors()
    for n, want in ref['after'].items():
        np.testing.assert_allclose(mine[_short(n)].detach().numpy(), want,
                                   rtol=0, atol=PARAM_TOL, err_msg=n)
    # the moving statistics moved (weight decay on every parameter, the
    # JAX quirk the port copies, is held in test_torch_optimizer.py)
    rv = 'resnetv10_stage1_batchnorm0_running_var'
    assert not np.array_equal(ref['after'][rv], ref['weights'][rv])
    assert len(pt._states) == len(ref['grads'])


def test_batch_norm_layer_moving_stats_and_global_stats():
    """Training mode updates the moving averages as ``keep * running +
    (1 - keep) * batch`` with the biased batch variance; inference and
    ``use_global_stats`` leave them alone and normalize with them."""
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(4, 3, 5, 5).astype('float32') + 1.0)
    bn = port_gnn.BatchNorm(momentum=0.8, in_channels=3, device='cpu')
    bn.train(True)
    bn(x)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean.detach(), 0.2 * mean,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_var.detach(), 0.8 + 0.2 * var,
                               rtol=1e-6, atol=1e-6)
    frozen = port_gnn.BatchNorm(use_global_stats=True, in_channels=3,
                                device='cpu')
    frozen.train(True)
    xg = x.clone().requires_grad_(True)
    out = frozen(xg)
    out.sum().backward()
    assert torch.equal(frozen.running_mean.detach(), torch.zeros(3))
    torch.testing.assert_close(out.detach(), x / np.sqrt(1 + 1e-5))
    assert frozen.gamma.grad is not None and xg.grad is not None
    assert not frozen.running_var.requires_grad
    # set on a built layer, use_global_stats freezes the statistics
    before = bn.running_mean.detach().clone()
    bn.use_global_stats = True
    torch.testing.assert_close(bn(x).detach(), (x - before.view(1, 3, 1, 1))
                               / torch.sqrt(bn.running_var.detach()
                                            + 1e-5).view(1, 3, 1, 1))
    assert torch.equal(bn.running_mean.detach(), before)


@pytest.fixture(scope='module')
def full_ref():
    """resnet50_v1 in the JAX package: names, shapes, Xavier weights and
    one inference forward at 32 x 32."""
    config.set('MXNET_TPU_PALLAS', 'epilogue,xent')
    try:
        np.random.seed(5)
        net = jax_resnet.resnet50_v1()
        net.initialize(mx.init.Xavier())
        x = nd.array(np.random.RandomState(6).uniform(
            -1, 1, (2, 3, 32, 32)).astype('float32'))
        logits = net(x).asnumpy()
        weights = {n: p.data().asnumpy()
                   for n, p in net.collect_params().items()}
        trainable = sorted(n for n, p in net.collect_params().items()
                           if p.grad_req != 'null')
    finally:
        config.unset('MXNET_TPU_PALLAS')
    return dict(x=x.asnumpy(), logits=logits, weights=weights,
                trainable=trainable)


def test_resnet50_v1_names_shapes_and_forward_match_jax(full_ref):
    net = port_resnet.resnet50_v1(device='cpu')
    mine = net.collect_params().tensors()
    weights = full_ref['weights']
    assert len(mine) == len(weights) == 299
    assert sorted(_short(n) for n in weights) == sorted(mine)
    for n, w in weights.items():
        assert tuple(mine[_short(n)].shape) == w.shape, n
    assert sorted(n for n, p in mine.items() if p.requires_grad) == \
        sorted(_short(n) for n in full_ref['trainable'])
    assert sum(p.numel() for p in mine.values() if p.requires_grad) \
        == 25575912
    port_resnet.params_from_jax(weights, net)
    with torch.no_grad():
        logits = net(torch.tensor(full_ref['x'])).numpy()
    want = full_ref['logits']
    tol = FULL_REL * float(np.abs(want).max())
    np.testing.assert_allclose(logits, want, rtol=0, atol=tol)


def test_init_params_is_seeded_xavier():
    net = port_resnet.ResNetV1(port_resnet.BottleneckV1, LAYERS, CHANNELS,
                               classes=CLASSES, device='cpu')
    a = {n: p.detach().clone()
         for n, p in port_resnet.init_params(net, 0).collect_params().tensors().items()}
    b = port_resnet.init_params(net, 0).collect_params().tensors()
    assert all(torch.equal(a[n], b[n]) for n in a)
    w = a['stage1_conv1_weight']              # (4, 4, 3, 3)
    bound = np.sqrt(3.0 / ((4 * 9 + 4 * 9) / 2.0))
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > \
        0.5 * bound
    assert torch.equal(a['batchnorm0_gamma'], torch.ones(8))
    assert torch.equal(a['batchnorm0_running_var'], torch.ones(8))
    assert not a['stage1_conv0_bias'].any()
    with pytest.raises(NotImplementedError, match='the rest of training'):
        port_resnet.get_resnet(2, 50, device='cpu')

"""Port parity at the bench's SGD hyperparameters: the full-width
``resnet50_v1`` trained with lr 0.1, momentum 0.9 and wd 1e-4
(``bench.py:203-228``) on one fixed batch, in the port and in the JAX
package, from the port's ``init_params(seed=0)`` weights.

At this lr the trajectory is chaotic from the first update: a control run
of the port whose weights are scaled by ``1 + 1e-6 * randn`` agrees with
the plain run to 1e-4 on the first loss and parts from it by about 1 %
on the second (measured 1.0e-2 at 16 x 3 x 64 x 64). Two float32
implementations of the same step part the same way, so only the first
loss (1e-4 relative: the training-mode forward 53 convolutions deep,
measured 1.6e-5) and the loss after the first update (5e-2 relative, five
times the control's parting; measured 9.4e-3) are compared.

Run as a module from the repo's root, it prints the three trajectories
(the port, its perturbed control, the JAX package) for a batch of B
images of P x P pixels over S steps:

    JAX_PLATFORMS=cpu python -m tests.test_torch_resnet_sgd B P S
"""
import sys

import numpy as np
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu import parallel as jax_parallel
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet
from mxnet_tpu_torch import parallel as port_parallel
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon.model_zoo import resnet as port_resnet

torch.set_num_threads(1)

HYPER = {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-4}
BATCH, IMAGE, STEPS = 16, 64, 2
PERTURB = 1e-6
FIRST_REL = 1e-4
CONTROL_PARTS = 1e-3
UPDATE_REL = 5e-2


def _batch(batch, image):
    """Images uniform in (-1, 1) and labels in [0, 1000), as the chip
    smoke's ResNet phase makes them."""
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (batch, 3, image, image)).astype('float32')
    y = rs.randint(0, 1000, (batch,)).astype('float32')
    return x, y


def _port_losses(x, y, steps, perturb=0.0):
    net = port_resnet.init_params(port_resnet.resnet50_v1(device='cpu'), 0)
    weights = {n: p.detach().numpy().copy()
               for n, p in net.collect_params().tensors().items()}
    if perturb:
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in net.collect_params().tensors().values():
                if p.requires_grad and p.dim() > 1:
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=gen))
    pt = port_parallel.ParallelTrainer(
        net, port_loss.SoftmaxCrossEntropyLoss(), 'sgd', dict(HYPER))
    xs, ys = torch.tensor(x), torch.tensor(y)
    return [pt.step(xs, ys).item() for _ in range(steps)], weights


def _jax_losses(x, y, steps, weights):
    net = jax_resnet.resnet50_v1()
    net.initialize(mx.init.Xavier())
    net(nd.array(x[:1]))                            # deferred shapes
    for n, p in net.collect_params().items():
        p.set_data(nd.array(weights[n.split('_', 1)[1]]))
    mesh = jax_parallel.create_mesh({'dp': 1}, devices=jax.devices()[:1])
    pt = jax_parallel.ParallelTrainer(
        net, jax_loss.SoftmaxCrossEntropyLoss(), 'sgd', dict(HYPER), mesh)
    xs, ys = nd.array(x), nd.array(y)
    return [float(pt.step(xs, ys).asnumpy()) for _ in range(steps)]


def _rel(a, b):
    return [abs(p - q) / abs(q) for p, q in zip(a, b)]


def trajectories(batch, image, steps):
    """(port, perturbed port, JAX) losses over ``steps`` steps."""
    x, y = _batch(batch, image)
    port, weights = _port_losses(x, y, steps)
    control, _ = _port_losses(x, y, steps, PERTURB)
    return port, control, _jax_losses(x, y, steps, weights)


def test_first_update_at_bench_lr_matches_jax_to_the_control():
    port, control, ref = trajectories(BATCH, IMAGE, STEPS)
    first, update = _rel(port, ref)
    assert first <= FIRST_REL, (port, ref)
    # the control shows how far any change of summation order carries
    assert _rel(control, port)[0] <= FIRST_REL
    assert _rel(control, port)[1] >= CONTROL_PARTS, (control, port)
    assert update <= UPDATE_REL, (port, ref)
    assert all(np.isfinite(port + ref))


if __name__ == '__main__':
    b, p, s = (int(a) for a in sys.argv[1:4])
    port, control, ref = trajectories(b, p, s)
    print('resnet50_v1, batch %d x 3 x %d x %d, SGD %s, %d steps'
          % (b, p, p, HYPER, s))
    print('port          %s' % port)
    print('port, control %s (weights x (1 + %g randn))' % (control, PERTURB))
    print('JAX package   %s' % ref)
    print('rel port vs control %s' % ['%.3g' % r for r in _rel(control, port)])
    print('rel port vs JAX     %s' % ['%.3g' % r for r in _rel(port, ref)])

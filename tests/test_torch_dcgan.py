"""Port parity: the reference's DCGAN (``examples/dc_gan.py``) trained by
its own loop in both packages.

The example's nets at its size (nz 16, ngf = ndf = 16, 1 x 16 x 16,
batch 16): the JAX package's ``build_nets``, the port's
``chip_smoke.dcgan_nets`` (the same layers, phase 5h's builder at 64 px),
from the same ``Normal(0.02)`` weights (the JAX net's, copied in
``collect_params`` order), the example's ``real_batch`` and noise. Three
iterations of the loop (the D step on the real batch and the detached
fake, then the G step, two Adam trainers at lr 2e-4, beta1 0.5) in each:
errD / errG within 1e-4 relative each iteration, every weight within
1e-4 of its tensor's largest magnitude, but the elements whose gradient
(at the iteration's step) lies within 1e-5 of its tensor's largest |g|
of zero: Adam's first steps are about lr sign(g), so a gradient that
small may take either sign in the two packages and move the weight 2 lr
the other way. Those elements are counted, and must stay few.

The DCGAN's layers and optimizer run here as their plain versions: the
act kernels (rows 7 / 8), the BatchNorm apply (row 5) and the Adam rule
of the whole-model update (row 17) run on the card, in chip_smoke.py's
phase 5h.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx

import chip_smoke
from examples import dc_gan

CFG = dict(nz=16, ngf=16, ndf=16, channels=1, size=16, batch=16)
ITERS = 3
LOSS_RTOL = 1e-4
WEIGHT_REL = 1e-4
# the most elements a run may leave out of the weight check (of 24,016
# trainable parameters over three iterations)
FLIP_LIMIT = 100


def _params(netG, netD):
    return list(netG.collect_params().values()) + \
        list(netD.collect_params().values())


def _jax_nets():
    jmx.random.seed(0)
    netG, netD = dc_gan.build_nets(CFG['nz'], CFG['ngf'], CFG['ndf'])
    netG.initialize(jmx.init.Normal(0.02))
    netD.initialize(jmx.init.Normal(0.02))
    netD(netG(jmx.nd.zeros((1, CFG['nz'], 1, 1))))
    return netG, netD


def _run(mx, netG, netD, data, noise):
    """The example's loop for ``len(data)`` iterations: each iteration's
    (errD, errG), D's and G's gradients at their steps and the trainable
    weights after it."""
    from importlib import import_module
    gluon = import_module(mx.__name__ + '.gluon')
    autograd = import_module(mx.__name__ + '.autograd')
    nd = import_module(mx.__name__ + '.ndarray')
    hyper = {'learning_rate': 2e-4, 'beta1': 0.5}
    trainerG = gluon.Trainer(netG.collect_params(), 'adam', dict(hyper))
    trainerD = gluon.Trainer(netD.collect_params(), 'adam', dict(hyper))
    L = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    batch = CFG['batch']
    ones, zeros = nd.ones((batch,)), nd.zeros((batch,))
    out = []
    for x, z in zip(data, noise):
        keep = {}
        errD, errG = chip_smoke.dcgan_iteration(
            autograd, netG, netD, L, trainerG, trainerD, nd.array(x),
            nd.array(z), ones, zeros, batch, keep)
        out.append({'loss': (float(errD.asscalar()),
                             float(errG.asscalar())),
                    'grads': keep['gradG'] + keep['gradD'],
                    'after': [p.data().asnumpy()
                              for p in _params(netG, netD)
                              if p.grad_req != 'null']})
    return out


def test_port_nets_are_the_example_nets():
    """``dcgan_nets`` at the example's size: the example's layers, in its
    order and shapes; at 64 px the upstream widths (3.58 M + 2.77 M
    trainable parameters)."""
    from mxnet_tpu_torch.gluon import nn
    jG, jD = _jax_nets()
    with pmx.cpu():
        pG, pD = chip_smoke.dcgan_nets(nn, CFG['nz'], CFG['ngf'], CFG['ndf'],
                                       CFG['channels'], CFG['size'])
        for n in (pG, pD):
            n.initialize(pmx.init.Normal(0.02))
        pD(pG(pmx.nd.zeros((1, CFG['nz'], 1, 1))))
    for j, p in ((jG, pG), (jD, pD)):
        assert [type(b).__name__ for b in j._children.values()] == \
            [type(b).__name__ for b in p._modules.values()]
        assert [q.shape for q in j.collect_params().values()] == \
            [tuple(q.shape) for q in p.collect_params().values()]
    with pmx.cpu():
        G, D = chip_smoke.dcgan_nets(nn, 100, 64, 64, 3, 64)
        for n in (G, D):
            n.initialize(pmx.init.Normal(0.02))
        D(G(pmx.nd.zeros((1, 100, 1, 1))))
    counts = [sum(int(np.prod(q.shape)) for q in n.collect_params().values()
                  if q.grad_req != 'null') for n in (G, D)]
    assert counts == [3576704, 2765568]


@pytest.mark.parametrize('it', range(ITERS))
def test_dcgan_loop_matches_jax(it, dcgan_runs):
    """Iteration ``it`` of the loop in both packages from the same
    weights, data and noise."""
    want, got = dcgan_runs
    w, g = want[it], got[it]
    rels = [abs(a - b) / abs(b) for a, b in zip(g['loss'], w['loss'])]
    assert max(rels) <= LOSS_RTOL, (g['loss'], w['loss'])
    flipped = 0
    for k, (grad, a, b) in enumerate(zip(w['grads'], w['after'],
                                         g['after'])):
        near = np.abs(grad) <= 1e-5 * np.abs(grad).max()
        flipped += int(near.sum())
        err = float(np.abs(np.where(near, 0.0, a - b)).max())
        assert err <= WEIGHT_REL * float(np.abs(a).max()), (k, err)
    assert flipped <= FLIP_LIMIT, flipped


@pytest.fixture(scope='module')
def dcgan_runs():
    from mxnet_tpu_torch.gluon import nn
    jG, jD = _jax_nets()
    weights = [q.data().asnumpy() for q in _params(jG, jD)]
    rs = np.random.RandomState(0)
    data, noise = [], []
    for _ in range(ITERS):
        data.append(dc_gan.real_batch(rs, CFG['batch']))
        noise.append(rs.randn(CFG['batch'], CFG['nz'], 1, 1)
                     .astype(np.float32))
    want = _run(jmx, jG, jD, data, noise)
    with pmx.cpu():
        pG, pD = chip_smoke.dcgan_nets(nn, CFG['nz'], CFG['ngf'], CFG['ndf'],
                                       CFG['channels'], CFG['size'])
        pmx.random.seed(0)
        pG.initialize(pmx.init.Normal(0.02))
        pD.initialize(pmx.init.Normal(0.02))
        pD(pG(pmx.nd.zeros((1, CFG['nz'], 1, 1))))
        for q, w in zip(_params(pG, pD), weights):
            q.set_data(pmx.nd.array(w))
        got = _run(pmx, pG, pD, data, noise)
    return want, got


def test_example_real_batch_is_phase_5h_at_16px():
    """Phase 5h's images are the example's blobs scaled to 64 px: at 16 px
    and one channel the same draws and values."""
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    np.testing.assert_array_equal(dc_gan.real_batch(a, 5),
                                  chip_smoke.dcgan_real_batch(b, 5, 1, 16))
    x = chip_smoke.dcgan_real_batch(np.random.RandomState(0), 2, 3, 64)
    assert x.shape == (2, 3, 64, 64) and -0.9 <= x.min() < x.max() <= 0.9

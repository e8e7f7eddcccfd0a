"""The port's gluon core (``gluon/parameter.py``, ``gluon/block.py``, the
layers' deferred shapes) against the JAX package's, on the CPU: the
parameter and block cases of ``tests/test_gluon.py``, the names
``name_scope`` gives (the JAX names minus the model's own auto-numbered
prefix), forwards from the same weights (carried by ``params_from_jax``)
equal within 1e-5 of their magnitude (float32 convolution and product
sums in another order), ``hybridize()`` leaving them unchanged bit for
bit, and ``.params`` files crossing both ways, byte for byte from the same
arrays.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import gluon as pgluon
from mxnet_tpu_torch.gluon import nn as pnn
from mxnet_tpu_torch.gluon.block import params_from_jax

FWD_REL = 1e-5


def _close(got, want, rel=FWD_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


def _mlp(nn):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(32, activation='relu'), nn.Dense(8))
    return net


def _convnet(nn):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(), nn.Dense(7))
    return net


def _carry(jnet, make, x):
    """A port net from ``make`` holding ``jnet``'s weights (``jnet``
    initialized and run once)."""
    with pmx.cpu():
        pnet = make(pnn)
        pnet.initialize()
        pnet(pmx.nd.array(x))              # the deferred shapes
        params_from_jax({k: v.data().asnumpy()
                         for k, v in jnet.collect_params().items()}, pnet)
    return pnet


def test_parameter():
    with pmx.cpu():
        p = pgluon.Parameter('weight', shape=(10, 10))
        p.initialize(init='xavier')
        assert p.data().shape == (10, 10)
        assert p.grad().shape == (10, 10)
        assert len(p.list_data()) == 1
        assert isinstance(p.tensor, torch.nn.Parameter)
        assert p.data()._data is p.tensor


def test_parameter_invalid_access():
    p = pgluon.Parameter('weight', shape=(10, 10))
    with pytest.raises(RuntimeError):
        p.data()


def test_deferred_parameter_raises_until_the_first_forward():
    with pmx.cpu():
        net = pnn.Dense(4)
        net.initialize()
        with pytest.raises(pgluon.DeferredInitializationError):
            net.collect_params()['dense_weight'].data()
        net(pmx.nd.ones((2, 5)))
        assert net.collect_params()['dense_weight'].shape == (4, 5)


def test_paramdict_save_load_crosses_both_ways(tmp_path):
    """ParameterDict.save / load as tests/test_gluon.py's test_paramdict,
    the file of either package loading in the other."""
    jp = jmx.gluon.ParameterDict('net_')
    jp.get('weight', shape=(10, 10))
    jp.initialize(ctx=jmx.cpu())
    jf = str(tmp_path / 'j.params')
    jp.save(jf)
    with pmx.cpu():
        pp = pgluon.ParameterDict('net_')
        pp.get('weight', shape=(10, 10))
        assert list(pp.keys()) == ['net_weight']
        pp.initialize()
        pp.load(jf)
        np.testing.assert_array_equal(pp['net_weight'].data().asnumpy(),
                                      jp['net_weight'].data().asnumpy())
        pf = str(tmp_path / 'p.params')
        pp.save(pf)
    assert open(pf, 'rb').read() == open(jf, 'rb').read()
    jp.load(pf, jmx.cpu())


def test_constant():
    class Test(pgluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.value = np.asarray([[1, 2], [3, 4]], dtype='float32')
            self.const = self.params.get_constant('const', self.value)

        def hybrid_forward(self, F, x, const):
            return x + const

    with pmx.cpu():
        test = Test()
        test.initialize()
        trainer = pgluon.Trainer(test.collect_params(), 'sgd',
                                 {'learning_rate': 1.0, 'momentum': 0.5})
        with pmx.autograd.record():
            x = pmx.nd.ones((2, 2))
            x.attach_grad()
            y = test(x)
            y.backward()
        trainer.step(1)
        assert (test.collect_params()['const'].data().asnumpy()
                == test.value).all()
        assert (x.grad.asnumpy() == 1).all()
        np.testing.assert_array_equal(y.asnumpy(), test.value + 1)


def test_dense_shapes_and_names():
    with pmx.cpu():
        model = pnn.Dense(128, activation='tanh', in_units=10,
                          flatten=False, prefix='test_')
        model.initialize()
        assert model(pmx.nd.zeros((2, 3, 10))).shape == (2, 3, 128)
        assert list(model.collect_params().keys()) == ['test_weight',
                                                       'test_bias']
        model = pnn.Dense(64, in_units=30, prefix='test2_')
        model.initialize()
        assert model(pmx.nd.zeros((17, 2, 15))).shape == (17, 64)


@pytest.mark.parametrize('make', [_mlp, _convnet])
def test_name_scope_names_are_the_jax_names(make):
    jnet = make(jnn)
    with pmx.cpu():
        pnet = make(pnn)
    assert list(pnet.collect_params()) == [
        k[len(jnet.prefix):] for k in jnet.collect_params()]


def test_dense_deferred_and_hybrid_consistency():
    """tests/test_gluon.py's case, the port's outputs equal to the JAX
    net's from the same weights, and hybridize() changing nothing."""
    x = np.random.RandomState(0).randn(4, 16).astype('float32')
    jnet = _mlp(jnn)
    jnet.initialize()
    want = jnet(jmx.nd.array(x)).asnumpy()
    pnet = _carry(jnet, _mlp, x)
    with pmx.cpu():
        eager = pnet(pmx.nd.array(x)).asnumpy()
        pnet.hybridize()
        hybrid = pnet(pmx.nd.array(x)).asnumpy()
        pnet.hybridize(static_alloc=True, static_shape=True)
        static = pnet(pmx.nd.array(x)).asnumpy()
    _close(eager, want)
    np.testing.assert_array_equal(hybrid, eager)
    np.testing.assert_array_equal(static, eager)


def test_block_save_load_crosses_both_ways(tmp_path):
    """save_parameters / load_parameters by structural name: a JAX file
    loads into the port net and the port's into the JAX net, the same
    forwards; the files byte for byte equal."""
    x = np.random.RandomState(1).randn(2, 3, 8, 8).astype('float32')
    jnet = _convnet(jnn)
    jnet.initialize()
    want = jnet(jmx.nd.array(x)).asnumpy()
    jf, pf = str(tmp_path / 'j.params'), str(tmp_path / 'p.params')
    jnet.save_parameters(jf)
    with pmx.cpu():
        pnet = _convnet(pnn)
        pnet.load_parameters(jf)
        got = pnet(pmx.nd.array(x)).asnumpy()
        pnet.save_parameters(pf)
        pnet2 = _convnet(pnn)
        pnet2.load_parameters(pf)
        again = pnet2(pmx.nd.array(x)).asnumpy()
    _close(got, want)
    np.testing.assert_array_equal(again, got)
    assert open(pf, 'rb').read() == open(jf, 'rb').read()
    jnet2 = _convnet(jnn)
    jnet2.load_parameters(pf)
    _close(jnet2(jmx.nd.array(x)).asnumpy(), want)


def test_collect_params_select():
    with pmx.cpu():
        net = pnn.HybridSequential(prefix='model_')
        with net.name_scope():
            net.add(pnn.Dense(10, in_units=4), pnn.Dense(5, in_units=10))
    assert len(net.collect_params('.*weight').keys()) == 2
    assert len(net.collect_params('.*bias').keys()) == 2
    assert len(net.collect_params().keys()) == 4
    assert list(net.collect_params()) == [
        'model_dense0_weight', 'model_dense0_bias', 'model_dense1_weight',
        'model_dense1_bias']


def test_shared_params():
    with pmx.cpu():
        d1 = pnn.Dense(10, in_units=4)
        d2 = pnn.Dense(10, in_units=4, params=d1.params)
        d1.initialize()
        x = pmx.nd.array(np.random.RandomState(2).randn(2, 4))
        np.testing.assert_array_equal(d1(x).asnumpy(), d2(x).asnumpy())
        assert d2.weight is d1.weight


def test_lambda_blocks():
    with pmx.cpu():
        x = pmx.nd.array(np.random.RandomState(3).randn(3, 3))
        blk = pnn.HybridLambda(lambda F, x: F.relu(x))
        np.testing.assert_allclose(blk(x).asnumpy(),
                                   np.maximum(x.asnumpy(), 0))
        np.testing.assert_allclose(pnn.Lambda('relu')(x).asnumpy(),
                                   np.maximum(x.asnumpy(), 0))


def test_dropout_train_vs_inference():
    """Identity outside training; inside record() a mask from the input
    device's generator (no trainer set one)."""
    with pmx.cpu():
        blk = pnn.Dropout(0.5)
        x = pmx.nd.ones((100, 100))
        np.testing.assert_array_equal(blk(x).asnumpy(), np.ones((100, 100)))
        with pmx.autograd.record(train_mode=True):
            out = blk(x).asnumpy()
        with pmx.autograd.record(train_mode=False):
            out_pred = blk(x).asnumpy()
    assert 0.3 < (out == 0).mean() < 0.7
    np.testing.assert_array_equal(out_pred, np.ones((100, 100)))


def test_batchnorm_trains_exactly_when_jax_does():
    """Training mode follows autograd: record() trains (batch statistics,
    the moving averages move), record(train_mode=False), predict_mode()
    and a plain call do not, as in the JAX layer."""
    x = np.random.RandomState(4).randn(4, 3, 5, 5).astype('float32')
    outs = {}
    for name, mx, nn in (('jax', jmx, jnn), ('port', pmx, pnn)):
        ctx = pmx.cpu() if name == 'port' else jmx.cpu()
        with ctx:
            bn = nn.BatchNorm(in_channels=3)
            bn.initialize()
            got = []
            for scope in (lambda: mx.autograd.record(),
                          lambda: mx.autograd.record(train_mode=False),
                          lambda: mx.autograd.predict_mode(), None):
                if scope is None:
                    y = bn(mx.nd.array(x))
                else:
                    with scope():
                        y = bn(mx.nd.array(x))
                got.append(y.asnumpy())
                got.append(bn.running_mean.data().asnumpy()
                           if name == 'jax' else
                           bn.collect_params()['batchnorm_running_mean']
                           .data().asnumpy())
            outs[name] = got
    for g, w in zip(outs['port'], outs['jax']):
        _close(g, w)


def test_forward_hooks_apply_and_summary(capsys):
    with pmx.cpu():
        net = _mlp(pnn)
        net.initialize()
        seen = []
        h = net.register_forward_hook(
            lambda blk, args, out: seen.append(tuple(out.shape)))
        pre = net.register_forward_pre_hook(
            lambda blk, args: seen.append('pre'))
        net(pmx.nd.ones((2, 16)))
        h.detach()
        pre.detach()
        net(pmx.nd.ones((2, 16)))
        assert seen == ['pre', (2, 8)]
        kinds = []
        net.apply(lambda b: kinds.append(type(b).__name__))
        assert kinds[-1] == 'HybridSequential' and 'Dense' in kinds
        net.summary(pmx.nd.ones((2, 16)))
    out = capsys.readouterr().out
    assert 'Dense-' in out and 'Total params: %d' % (16 * 32 + 32 + 32 * 8
                                                     + 8) in out


def test_call_on_ndarrays_records_only_inside_record():
    with pmx.cpu():
        net = _mlp(pnn)
        net.initialize()
        x = pmx.nd.ones((2, 16))
        y = net(x)
        assert isinstance(y, pmx.nd.NDArray)
        assert y._data.grad_fn is None
        with pmx.autograd.record():
            z = net(x)
        assert z._data.grad_fn is not None


def test_cast_keeps_the_torch_parameters():
    with pmx.cpu():
        net = _convnet(pnn)
        net.initialize()
        net(pmx.nd.ones((1, 3, 4, 4)))
        before = {k: id(t) for k, t in net.collect_params().tensors()
                  .items()}
        net.cast('bfloat16')
        params = net.collect_params()
        assert {k: id(t) for k, t in params.tensors().items()} == before
        assert params['conv0_weight'].dtype == 'bfloat16'
        assert params['batchnorm0_gamma'].dtype == 'float32'
        assert params['conv0_weight'].data().dtype == torch.bfloat16


def test_zoo_resnet_initializes_by_initialize():
    """A zoo net is filled by net.initialize(init): Xavier's bound on
    the weights, the BatchNorm constants as the JAX layers' inits."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    with pmx.cpu():
        pmx.random.seed(0)
        net = vision.resnet18_v1(thumbnail=True, classes=10)
        net.initialize(pmx.init.Xavier())
        params = net.collect_params()
        w = params['conv0_weight'].data().asnumpy()
        bound = np.sqrt(3.0 / ((3 * 9 + 64 * 9) / 2.0))
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
        np.testing.assert_array_equal(
            params['stage1_batchnorm0_gamma'].data().asnumpy(), 1.0)
        np.testing.assert_array_equal(
            params['stage1_batchnorm0_running_mean'].data().asnumpy(), 0.0)
        y = net(pmx.nd.ones((2, 3, 32, 32)))
        assert y.shape == (2, 10) and np.isfinite(y.asnumpy()).all()

"""Port parity: automatic mixed precision (``mxnet_tpu_torch.amp`` and
``ParallelTrainer(amp=)``) against the JAX package's (``mxnet_tpu.amp``,
``tests/test_amp.py``).

The policy (``resolve``, the ``MXNET_TPU_AMP`` knob, ``scope``,
``cast_op_inputs``) is held to the JAX package's on the same inputs. Then
``test_torch_bert.py``'s tiny BERT (2 layers, units 32, vocab 50; the JAX
side with ``MXNET_TPU_PALLAS=attention,epilogue,xent``, its kernels in the
Pallas interpreter) runs under ``amp='bf16'`` in both packages from the
same numpy weights and batch. The JAX forward and step-0 gradients are
traced under the policy's scope as its trainer traces them
(``pure_forward_fn`` under ``jax.value_and_grad``).

Tolerances, bf16 compute (8 significant bits) in two frameworks that
round in other places (XLA-CPU may keep float32 between fused bf16 ops;
PyTorch rounds after each op):
  * output dtypes equal; the loss within rtol 1e-2 (measured 1.1e-3);
  * step-0 gradients within 2e-2 of each tensor's max abs (measured
    1.2e-2, the embedding LayerNorm's gamma);
  * three AdamW steps' losses within rtol 1e-2 (measured 1.7e-3);
  * the port's own bf16 against its float32 over 10 steps within rtol
    6e-2, both falling (``tests/test_amp.py:152-164``'s tier).
Masters and AdamW state stay float32, and amp off (None, False, 'off',
the knob 'off') is bitwise the float32 step as it was before AMP.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import amp as jax_amp
from mxnet_tpu import config, nd
from mxnet_tpu import parallel as jax_parallel
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo import bert as jax_bert
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu.parallel.train_step import pure_forward_fn
from mxnet_tpu_torch import amp as port_amp
from mxnet_tpu_torch import parallel as port_parallel
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon.model_zoo import bert as port_bert
from mxnet_tpu_torch.ops import kernels

torch.set_num_threads(1)

CFG = dict(vocab_size=50, max_length=16, units=32, hidden_size=64,
           num_layers=2, num_heads=2, dropout=0.0)
VOCAB = CFG['vocab_size']
HYPER = {'learning_rate': 1e-3, 'wd': 0.01}
STEPS = 3
LOSS_RTOL = 1e-2
GRAD_REL = 2e-2
TRAJ_RTOL = 6e-2


def _batch():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, VOCAB, (2, 8)).astype('float32')
    tt = (rs.rand(2, 8) > 0.5).astype('float32')
    vl = np.array([8, 5], 'float32')
    mp = rs.randint(0, 8, (2, 3)).astype('float32')
    mlm_y = rs.randint(0, VOCAB, (2, 3)).astype('float32')
    nsp_y = rs.randint(0, 2, (2,)).astype('float32')
    return [ids, tt, vl, mp], [mlm_y, nsp_y]


def _weights(names_shapes):
    rs = np.random.RandomState(1)
    out = {}
    for name, shape in names_shapes:
        w = rs.randn(*shape).astype('float32')
        if name.endswith('gamma'):
            out[name] = 1.0 + 0.1 * w
        elif name.endswith(('bias', 'beta')):
            out[name] = 0.1 * w
        else:
            out[name] = 0.2 * w
    return out


def _pretrain_loss(L):
    def fn(outs, labels):
        _, _, mlm, nsp = outs
        my, ny = labels
        return (L(mlm.reshape((-1, VOCAB)), my.reshape((-1,))).mean()
                + L(nsp, ny).mean())
    return fn


def _short(name):
    return name.split('_', 1)[1]


# -- the policy ---------------------------------------------------------------


def _policy_view(p):
    return None if p is None else (p.name, str(p.compute_dtype),
                                   p.loss_scaling)


@pytest.mark.parametrize('arg', ['bf16', 'bfloat16', 'fp16', 'float16',
                                 'off', 'OFF', '0', 'false', '', False,
                                 True], ids=repr)
def test_resolve_equals_jax(arg):
    assert _policy_view(port_amp.resolve(arg)) == \
        _policy_view(jax_amp.resolve(arg))


def test_resolve_refusals_and_passthrough_equal_jax():
    for mod in (port_amp, jax_amp):
        with pytest.raises(ValueError):
            mod.resolve('int7')
        with pytest.raises(ValueError, match='both'):
            mod.Policy('bad', 'bfloat16', cast_ops=('dot',),
                       fp32_ops=('dot',))
        p = mod.bf16()
        assert mod.resolve(p) is p
    assert port_amp.CAST_COMPUTE_OPS == jax_amp.CAST_COMPUTE_OPS
    assert port_amp.KEEP_FP32_OPS == jax_amp.KEEP_FP32_OPS


@pytest.mark.parametrize('raw', ['bf16', 'fp16', 'off', '', None], ids=repr)
def test_resolve_reads_the_knob_as_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv('MXNET_TPU_AMP', raising=False)
    else:
        monkeypatch.setenv('MXNET_TPU_AMP', raw)
    assert _policy_view(port_amp.resolve(None)) == \
        _policy_view(jax_amp.resolve(None))
    # an explicit False beats the knob
    assert port_amp.resolve(False) is None


_DTYPES = (('float32', torch.float32, jnp.float32),
           ('bfloat16', torch.bfloat16, jnp.bfloat16),
           ('float16', torch.float16, jnp.float16),
           ('int32', torch.int32, jnp.int32))


@pytest.mark.parametrize('op', ['FullyConnected', 'Convolution', 'batch_dot',
                                '_contrib_flash_attention',
                                '_contrib_fused_softmax_xent',
                                'softmax_cross_entropy', 'softmax',
                                'log_softmax', 'mean', 'Activation',
                                'LayerNorm', 'Embedding'])
@pytest.mark.parametrize('policy', ['bf16', 'fp16'])
def test_cast_op_inputs_equals_jax(op, policy):
    """Each op's inputs of every dtype recast as the JAX policy recasts
    them (dtype for dtype), non-tensors untouched, unlisted ops passing
    their inputs through by identity."""
    ours = [torch.ones(2, 3, dtype=t) for _, t, _ in _DTYPES]
    theirs = [jnp.ones((2, 3), j) for _, _, j in _DTYPES]
    got = port_amp.resolve(policy).cast_op_inputs(op, ours + [None])
    want = jax_amp.resolve(policy).cast_op_inputs(op, theirs)
    assert [str(t.dtype).replace('torch.', '') for t in got[:-1]] == \
        [str(a.dtype) for a in want]
    assert got[-1] is None
    for a, b, w, j in zip(ours, got, theirs, want):
        assert (a is b) == (w is j)


def test_scope_is_reentrant_and_a_noop_without_a_policy():
    p = port_amp.resolve('bf16')
    x = torch.ones(2)
    assert port_amp.current_policy() is None
    assert port_amp.cast_op_inputs('FullyConnected', x)[0] is x
    with port_amp.scope(p):
        assert port_amp.current_policy() is p
        assert port_amp.cast_op_inputs('FullyConnected', x)[0].dtype == \
            torch.bfloat16
        with port_amp.scope(None):              # no-op, not a clear
            assert port_amp.current_policy() is p
        with port_amp.scope(port_amp.resolve('fp16')):
            assert port_amp.current_policy().name == 'fp16'
        assert port_amp.current_policy() is p
    assert port_amp.current_policy() is None


# -- the tiny BERT under amp='bf16', against the JAX package ------------------


@pytest.fixture(scope='module')
def ref():
    """The JAX package's tiny BERT under amp='bf16': forward outputs,
    loss and step-0 gradients traced under the policy, then three
    ParallelTrainer AdamW steps; as numpy."""
    config.set('MXNET_TPU_PALLAS', 'attention,epilogue,xent')
    try:
        net = jax_bert.get_bert(**CFG)
        net.initialize(mx.init.Xavier())
        x, y = _batch()
        xs, ys = [nd.array(a) for a in x], [nd.array(a) for a in y]
        net(*xs)                                    # deferred shapes
        params = net.collect_params()
        weights = _weights([(n, p.shape) for n, p in params.items()])
        for n, p in params.items():
            p.set_data(nd.array(weights[n]))
        loss_fn = _pretrain_loss(jax_loss.SoftmaxCrossEntropyLoss())
        fwd, _, plist = pure_forward_fn(net, training=True)
        policy = jax_amp.resolve('bf16')

        def loss_of(pa, data, labels):
            with jax_amp.scope(policy):
                outs, _ = fwd(jax.random.PRNGKey(0), list(pa), data)
                loss = loss_fn([NDArray(o) for o in outs],
                               [NDArray(a) for a in labels])
            return jnp.mean(loss._data.astype(jnp.float32)), outs

        (loss, outs), grads = jax.value_and_grad(loss_of, has_aux=True)(
            [p.data()._data for p in plist], [jnp.asarray(a) for a in x],
            [jnp.asarray(a) for a in y])
        mesh = jax_parallel.create_mesh({'dp': 1},
                                        devices=jax.devices()[:1])
        pt = jax_parallel.ParallelTrainer(net, loss_fn, 'adamw',
                                          dict(HYPER), mesh, amp='bf16')
        losses = [float(pt.step(xs, ys).asnumpy()) for _ in range(STEPS)]
    finally:
        config.unset('MXNET_TPU_PALLAS')
    return dict(weights=weights, loss=float(loss),
                out_dtypes=[str(o.dtype) for o in outs],
                outs=[np.asarray(o.astype(jnp.float32)) for o in outs],
                grads={p.name: np.asarray(g) for p, g in zip(plist, grads)},
                losses=losses, amp=pt.amp)


def _port_net(ref, **over):
    net = port_bert.get_bert(device='cpu', **dict(CFG, **over))
    return port_bert.params_from_jax(ref['weights'], net)


def _inputs():
    x, y = _batch()
    return [torch.tensor(a) for a in x], [torch.tensor(a) for a in y]


def _port_loss_fn():
    return _pretrain_loss(port_loss.SoftmaxCrossEntropyLoss())


def test_amp_forward_dtypes_and_loss_match_jax(ref):
    net = _port_net(ref)
    xs, ys = _inputs()
    kernels.reset_launch_counts()
    with port_amp.scope(port_amp.bf16()):
        outs = net(*xs)
        loss = _port_loss_fn()(outs, ys)
    # seq stays float32 (the residual adds widen); pooled, mlm and nsp
    # come out of bf16 FullyConnected ops; the loss widens to float32
    assert [str(o.dtype).replace('torch.', '') for o in outs] == \
        ref['out_dtypes'] == ['float32', 'bfloat16', 'bfloat16', 'bfloat16']
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), ref['loss'], rtol=LOSS_RTOL)
    for name, a, b in zip(('seq', 'pooled', 'mlm', 'nsp'), outs,
                          ref['outs']):
        scale = float(np.abs(b).max())
        err = float(np.abs(a.detach().float().numpy() - b).max())
        assert err <= 2e-2 * scale, (name, err, scale)
    # CPU tensors take the plain versions: no kernel launch counted
    assert not any(kernels.launch_counts().values())


def test_amp_step0_gradients_match_jax(ref):
    net = _port_net(ref)
    xs, ys = _inputs()
    with port_amp.scope(port_amp.bf16()):
        loss = _port_loss_fn()(net(*xs), ys)
    loss.backward()
    mine = net.collect_params().tensors()
    for n, want in ref['grads'].items():
        p = mine[_short(n)]
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        # gradients widen to float32 at each parameter
        assert p.grad is None or p.grad.dtype == torch.float32, n
        tol = GRAD_REL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=n)


def _adamw_state_dtypes(pt):
    out = set()
    for s in pt._states:
        for t in (s if isinstance(s, (tuple, list)) else (s,)):
            if isinstance(t, torch.Tensor):
                out.add(t.dtype)
    return out


def test_amp_three_adamw_steps_match_jax(ref):
    net = _port_net(ref)
    xs, ys = _inputs()
    pt = port_parallel.ParallelTrainer(net, _port_loss_fn(), 'adamw',
                                       dict(HYPER), amp='bf16')
    assert pt.amp == ref['amp'] == 'bf16'
    losses = [pt.step(xs, ys).item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref['losses'], rtol=LOSS_RTOL, atol=0)
    assert losses[-1] < losses[0]
    # masters and AdamW state stay float32
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    assert _adamw_state_dtypes(pt) == {torch.float32}


def test_bf16_trajectory_tracks_float32():
    """The port's bf16 against its float32 over 10 AdamW steps on the same
    data and weights: within bf16 tolerance, both learning."""
    weights = _weights([(n, tuple(p.shape)) for n, p in port_bert.get_bert(
        device='cpu', **CFG).collect_params().tensors().items()])
    xs, ys = _inputs()
    runs = {}
    for amp in ('off', 'bf16'):
        net = port_bert.get_bert(device='cpu', **CFG)
        with torch.no_grad():
            for n, p in net.collect_params().tensors().items():
                p.copy_(torch.from_numpy(weights[n]))
        pt = port_parallel.ParallelTrainer(net, _port_loss_fn(), 'adamw',
                                           dict(HYPER), amp=amp)
        runs[amp] = [pt.step(xs, ys).item() for _ in range(10)]
    l32, l16 = runs['off'], runs['bf16']
    assert all(np.isfinite(l16))
    np.testing.assert_allclose(l16, l32, rtol=TRAJ_RTOL)
    assert l16[-1] < l16[0] and l32[-1] < l32[0]


def _todays_steps(net, xs, ys, n):
    """The float32 step as ``ParallelTrainer.step`` ran it before AMP:
    forward in training mode, mean loss, backward, AdamW per parameter."""
    from mxnet_tpu_torch.optimizer import optimizer as optmod
    opt = optmod.create('adamw', **HYPER)
    named = list(net.collect_params().tensors().items())
    opt.idx2name = {i: k for i, (k, _) in enumerate(named)}
    params = [(i, p) for i, (_, p) in enumerate(named) if p.requires_grad]
    states = [opt.create_state(i, p.detach()) for i, p in params]
    fn = _port_loss_fn()
    losses = []
    for _ in range(n):
        for _, p in params:
            p.grad = None
        net.train(True)
        loss = torch.mean(fn(net(*xs), ys))
        net.train(False)
        loss.backward()
        with torch.no_grad():
            for (i, p), s in zip(params, states):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                opt.update(i, p.data, g, s)
        losses.append(loss.item())
    return losses


@pytest.mark.parametrize('amp', [None, False, 'off', 'knob off'], ids=repr)
def test_amp_off_is_bitwise_todays_path(ref, monkeypatch, amp):
    xs, ys = _inputs()
    want_net = _port_net(ref)
    want = _todays_steps(want_net, xs, ys, STEPS)
    if amp == 'knob off':
        monkeypatch.setenv('MXNET_TPU_AMP', 'off')
        amp = None
    else:
        monkeypatch.delenv('MXNET_TPU_AMP', raising=False)
    net = _port_net(ref)
    pt = port_parallel.ParallelTrainer(net, _port_loss_fn(), 'adamw',
                                       dict(HYPER), amp=amp)
    assert pt.amp == 'off'
    assert [pt.step(xs, ys).item() for _ in range(STEPS)] == want
    theirs = want_net.collect_params().tensors()
    for n, p in net.collect_params().tensors().items():
        assert torch.equal(p, theirs[n]), n


def test_amp_knob_turns_bf16_on(ref, monkeypatch):
    monkeypatch.setenv('MXNET_TPU_AMP', 'bf16')
    pt = port_parallel.ParallelTrainer(_port_net(ref), _port_loss_fn(),
                                       'adamw', dict(HYPER))
    assert pt.amp == 'bf16'
    pt = port_parallel.ParallelTrainer(_port_net(ref), _port_loss_fn(),
                                       'adamw', dict(HYPER), amp=False)
    assert pt.amp == 'off'


def test_fp16_is_refused_naming_the_guardrail(ref):
    for amp in ('fp16', port_amp.fp16()):
        with pytest.raises(NotImplementedError,
                           match='loss scaling.*guardrail.*robustness'):
            port_parallel.ParallelTrainer(_port_net(ref), _port_loss_fn(),
                                          'adamw', dict(HYPER), amp=amp)

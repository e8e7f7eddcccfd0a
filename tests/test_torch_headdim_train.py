"""Port parity of the training attention at every head dim: the float32
and bf16 dq and dk/dv (rows 2, 3, 2b, 3b) and the bf16 forward (row 1b)
of ``mxnet_tpu_torch.ops.kernels``, and a tiny BERT at head dims 32 and
80, against the JAX package.

The port's training kernels take every head dim D from 1 to 128
(instances at the padded widths 16, 32, 64 and 128, columns past D zero
in shared memory); on the CPU its wrappers run their plain versions, and
the JAX kernels run through the Pallas interpreter, as the JAX package's
own tests run them. Inputs are numpy arrays from a seed, given to both.
Tolerances:
  * the float32 gradients: 1e-5 relative to each gradient's max abs, the
    flash kernels' reduction tier;
  * the bf16 plain versions against the JAX bf16 kernels: the
    reference's bf16 tier (``mxnet_tpu/ops/pallas/__main__.py:88-103``):
    out within 0.02 absolute, lse within 1e-5, dq, dk and dv within 2e-2
    of their max abs;
  * the BERTs: ``tests/test_torch_bert.py``'s (forward 2e-5 absolute,
    gradients 1e-4 relative, three AdamW steps' losses 1e-5 relative and
    parameters 2e-5 absolute); as that file holds the key bias (exact
    gradient 0) only to Adam's steps' size, so here every entry whose
    gradient lies within the gradient tier of 0: Adam turns its rounding
    noise into steps of ~lr either way.
The geometry checks hold each training kernel's ``*_geometry`` to the
constants its CUDA source declares at every width (the card's first load
holds them to the built libraries too). The kernels against their plain
versions on the card: ``test_torch_headdim_train_card.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import autograd, config, nd
from mxnet_tpu import parallel as jax_parallel
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo import bert as jax_bert
from mxnet_tpu.ops.pallas import attention as jax_attn
from mxnet_tpu_torch import parallel as port_parallel
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon.model_zoo import bert as port_bert
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.kernels import attention as attn
from test_torch_attention_bf16_tc import _jax_bf16, _structs

torch.set_num_threads(1)
GRAD_REL = 1e-5             # float32 gradients, of their max abs
BF16 = torch.bfloat16
OUT_TOL = 0.02              # the reference's bf16 tiers
LSE_TOL = 1e-5
BF16_GRAD_REL = 2e-2
DIMS = (1, 6, 8, 32, 80, 128)
BF16_DIMS = (32, 80, 128)


@pytest.fixture
def pallas():
    """The JAX package's attention kernels on, for one test."""
    config.set('MXNET_TPU_PALLAS', 'attention')
    yield
    config.unset('MXNET_TPU_PALLAS')


def _rel(got, want):
    got, want = np.asarray(got, 'float32'), np.asarray(want, 'float32')
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the kernel functions against the JAX kernels --------------------------


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('d', DIMS)
def test_flash_gradients_match_jax_at_head_dim(pallas, d, causal):
    """dq, dk and dv of the port's ``flash_attention`` (its plain dq and
    dk/dv behind ``FlashAttentionFunction`` on the CPU) against
    ``jax.grad`` of the JAX package's Pallas ``flash_attention``."""
    rs = np.random.RandomState(7 * d + causal)
    b, h, seq = 3, 2, 37
    q, k, v, g = (rs.randn(b, h, seq, d).astype('float32') for _ in range(4))
    # batch 0 below S, batch 1 sees no key at all, batch 2 full
    lengths = np.array([seq - 6, 0, seq], 'int32')

    def f(q, k, v):
        out = jax_attn.flash_attention(q, k, v, lengths=jnp.asarray(lengths),
                                       causal=causal)
        return jnp.sum(out * g)
    want = [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = kernels.flash_attention(qt, kt, vt, lengths=torch.tensor(lengths),
                                  causal=causal)
    got = [x.numpy() for x in torch.autograd.grad(out, (qt, kt, vt),
                                                  torch.tensor(g))]
    for name, a, w in zip('qkv', got, want):
        assert a.shape == (b, h, seq, d) and np.isfinite(a).all()
        assert _rel(a, w) <= GRAD_REL, ('d' + name, _rel(a, w))
    # the length-0 batch: no gradient anywhere
    assert not any(x[1].any() for x in got)


@pytest.mark.parametrize('d', BF16_DIMS)
def test_bf16_plain_versions_match_jax_bf16_kernels_at_head_dim(pallas, d):
    """The bf16 tensor-core kernels' plain versions (rows 1b, 2b, 3b)
    against the JAX package's bf16 kernels on the same bf16 values, the
    backward on the JAX forward's own out and lse."""
    rs = np.random.RandomState(100 + d)
    for b, s, causal, lengths in ((2, 128, False, [128, 77]),
                                  (2, 150, True, [150, 0])):
        q, k, v, do = (torch.tensor(rs.randn(b, 2, s, d).astype(
            'float32')).to(BF16) for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        jo, jl, jdq, jdk, jdv = _jax_bf16(q, k, v, do, lengths, causal,
                                          scale)
        lens = torch.tensor(lengths, dtype=torch.int32)
        out, lse = attn.flash_attention_bf16_reference(q, k, v, lens, causal,
                                                       scale)
        assert out.dtype == BF16 and out.shape == (b, 2, s, d)
        assert (out.float() - jo).abs().max().item() <= OUT_TOL
        fin = torch.isfinite(jl)
        assert torch.equal(torch.isneginf(lse), torch.isneginf(jl))
        assert (lse[fin] - jl[fin]).abs().max().item() <= LSE_TOL
        jout = jo.to(BF16)
        dq = attn.flash_attention_dq_bf16_reference(q, k, v, jout, jl, do,
                                                    lens, causal, scale)
        dk, dv = attn.flash_attention_dkv_bf16_reference(
            q, k, v, jout, jl, do, lens, causal, scale)
        for name, a, w in (('dq', dq, jdq), ('dk', dk, jdk), ('dv', dv, jdv)):
            assert a.dtype == BF16
            assert _rel(a.float(), w) <= BF16_GRAD_REL, (name, _rel(a.float(),
                                                                    w))


# -- geometry ----------------------------------------------------------------


SHAPES = ((96, 12, 128), (1, 12, 256), (2, 3, 17), (3, 2, 300))


@pytest.mark.parametrize('width', kernels.HEAD_WIDTHS)
def test_train_geometries_follow_the_kernel_sources(width):
    """At each padded width, the five training kernels' geometry functions
    give the block sizes and shared-memory bytes their sources declare,
    one block a work item, within a block's shared memory as many times as
    the launch bounds ask blocks an SM; every D of the width takes its
    instance."""
    bwd = _structs('flash_attention_bwd.cu', width)['Shape']
    fwd = _structs('flash_attention_fwd_bf16.cu', width)['Fwd']
    dq = _structs('flash_attention_dq_bf16.cu', width)['Dq']
    dkv = _structs('flash_attention_dkv_bf16.cu', width)['Dkv']
    row = _structs('mma_bf16.cuh', width)['Row']
    assert row['BYTES'] == 2 * width and row['CHUNKS'] == width // 8
    assert bwd['RS'] == max(width, 32) and bwd['CHUNKS'] == width // 4
    # a warp owns MT m16 tiles of the block's 128 rows (8 / MT warps), two
    # blocks an SM at MT 2, one at MT 1
    mts = (bwd['MT'], bwd['DKV_MT_PART'])
    assert bwd['ROWS'] == 128 and set(mts) <= {1, 2}
    assert fwd['BK'] == kernels.K_BLOCK
    below = max([0] + [w for w in kernels.HEAD_WIDTHS if w < width])
    dims = sorted({below + 1, max(below + 1, width // 2 + 1), width})
    for d in dims:
        assert kernels.head_width(d) == width
        for b, h, s in SHAPES:
            bh = b * h
            assert kernels.dq_geometry(b, h, s, d) == (
                bwd['ROWS'], bwd['DQ_BK'], bh * -(-s // bwd['ROWS']),
                bwd['DQ_SMEM_BYTES'])
            assert kernels.dkv_geometry(b, h, s, d) == (
                bwd['ROWS'], bwd['DKV_BQ'], bh * -(-s // bwd['ROWS']),
                bwd['DKV_SMEM_BYTES'])
            assert kernels.fwd_bf16_geometry(b, h, s, d) == (
                fwd['BQ'], bh * -(-s // fwd['BQ']), fwd['SMEM_BYTES'])
            assert kernels.dq_bf16_geometry(b, h, s, d) == (
                dq['BQ'], dq['BK'], bh * -(-s // dq['BQ']), dq['SMEM_BYTES'])
            assert kernels.dkv_bf16_geometry(b, h, s, d) == (
                dkv['BK'], dkv['BQ'], bh * -(-s // dkv['BK']),
                dkv['SMEM_BYTES'])
    for shape, blocks in ((bwd['DQ_SMEM_BYTES'], bwd['MT']),
                          (bwd['DKV_SMEM_BYTES'], max(mts)),
                          (fwd['SMEM_BYTES'], fwd['MIN_BLOCKS']),
                          (dq['SMEM_BYTES'], dq['MIN_BLOCKS']),
                          (dkv['SMEM_BYTES'], dkv['MIN_BLOCKS'])):
        assert blocks * shape <= attn.SMEM_BLOCK_MAX
    # the wrappers' constants are the sources'
    assert (attn.DQ_BLOCK_Q, attn.DQ_BLOCK_K, attn.DKV_BLOCK_K,
            attn.DKV_BLOCK_Q) == (bwd['ROWS'], bwd['DQ_BK'], bwd['ROWS'],
                                  bwd['DKV_BQ'])
    assert dkv['BK'] == (attn.DKV_BF16_BLOCK_K if width <= 64
                         else attn.DKV_BF16_BLOCK_K_WIDE)


def test_train_geometries_keep_head_dim_64():
    """The default head dim is 64: the bytes and block sizes of before."""
    assert kernels.fwd_bf16_geometry(96, 12, 128) == (128, 1152, 81920)
    assert kernels.dq_bf16_geometry(96, 12, 128) == (128, 128, 1152, 98304)
    assert kernels.dkv_bf16_geometry(96, 12, 128) == (128, 32, 1152, 57856)
    assert kernels.dq_geometry(96, 12, 128) == (128, 32, 1152, 98304)
    assert kernels.dkv_geometry(96, 12, 128) == (128, 32, 1152, 115200)


class _FakeLib:
    """A built library as the wrappers see it: the per-width entries
    from the source's constants, the launch entry a stub."""

    def __init__(self, values):
        for name, fn in values.items():
            setattr(self, name, fn)


class _Entry:
    argtypes = None
    restype = None


@pytest.mark.parametrize('kernel', ['dq', 'dkv'])
@pytest.mark.parametrize('dtype', [torch.float32, BF16])
def test_first_load_holds_the_geometry_at_every_width(monkeypatch, kernel,
                                                      dtype):
    """``_bwd_lib`` checks every width's block sizes and bytes against
    the library's entries before it binds the launch entry; a library
    built otherwise is refused."""
    from mxnet_tpu_torch.ops.kernels import _build
    bf16 = dtype == BF16
    entry = 'mx_flash_attention_%s%s' % (kernel, '_bf16' if bf16 else '')
    source = ('flash_attention_%s_bf16.cu' % kernel if bf16
              else 'flash_attention_bwd.cu')
    struct = {('dq', True): 'Dq', ('dkv', True): 'Dkv'}.get((kernel, bf16),
                                                            'Shape')
    fields = {('dq', False): ('ROWS', 'DQ_BK', 'DQ_SMEM_BYTES'),
              ('dkv', False): ('ROWS', 'DKV_BQ', 'DKV_SMEM_BYTES'),
              ('dq', True): ('BQ', 'BK', 'SMEM_BYTES'),
              ('dkv', True): ('BK', 'BQ', 'SMEM_BYTES')}[kernel, bf16]
    blocks = ('block_q', 'block_k') if kernel == 'dq' else ('block_k',
                                                             'block_q')

    def lib(skew=0):
        values = {entry: _Entry()}
        for name, field in zip(blocks + ('smem',), fields):
            values['%s_%s' % (entry, name)] = (
                lambda w, f=field: _structs(source, w)[struct][f] + skew)
        return _FakeLib(values)
    monkeypatch.setattr(_build, 'load', lambda name: lib(1))
    with pytest.raises(ValueError, match='geometry gives'):
        attn._bwd_lib(kernel, dtype)
    good = lib()
    monkeypatch.setattr(_build, 'load', lambda name: good)
    name, fn = attn._bwd_lib(kernel, dtype)
    assert name == 'flash_attention_%s%s' % (kernel, '.bf16' if bf16 else '')
    assert fn is getattr(good, entry) and len(fn.argtypes) == (
        17 if kernel == 'dq' else 18)


@pytest.mark.parametrize('d', [0, 129, 256])
def test_train_head_dims_past_the_instances_are_refused_typed(d):
    for call in (lambda: kernels.head_width(d, 'flash_attention_dq'),
                 lambda: kernels.fwd_bf16_geometry(1, 1, 1, d),
                 lambda: kernels.dq_geometry(1, 1, 1, d),
                 lambda: kernels.dkv_geometry(1, 1, 1, d),
                 lambda: kernels.dq_bf16_geometry(1, 1, 1, d),
                 lambda: kernels.dkv_bf16_geometry(1, 1, 1, d)):
        with pytest.raises(kernels.HeadDimError, match='ROADMAP B1'):
            call()


# -- a tiny BERT at head dims 32 and 80 against the JAX package -------------

BERTS = {32: dict(vocab_size=50, max_length=16, units=64, hidden_size=128,
                  num_layers=2, num_heads=2, dropout=0.0),
         80: dict(vocab_size=50, max_length=16, units=160, hidden_size=320,
                  num_layers=2, num_heads=2, dropout=0.0)}
VOCAB = 50
HYPER = {'learning_rate': 1e-3, 'wd': 0.01}
STEPS = 3
FWD_TOL = 2e-5
BERT_GRAD_REL = 1e-4
LOSS_REL = 1e-5
PARAM_TOL = 2e-5


def _batch():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, VOCAB, (2, 8)).astype('float32')
    tt = (rs.rand(2, 8) > 0.5).astype('float32')
    vl = np.array([8, 5], 'float32')
    mp = rs.randint(0, 8, (2, 3)).astype('float32')
    mlm_y = rs.randint(0, VOCAB, (2, 3)).astype('float32')
    nsp_y = rs.randint(0, 2, (2,)).astype('float32')
    return [ids, tt, vl, mp], [mlm_y, nsp_y]


def _weights(names_shapes, units):
    """Random weights from a numpy seed, every tensor: the weights' scale
    shrinks as 1 / sqrt(units) from test_torch_bert.py's 0.2 at units 32,
    so the wider encoder's activations keep their size."""
    rs = np.random.RandomState(1)
    scale = 0.2 * math.sqrt(32 / units)
    out = {}
    for name, shape in names_shapes:
        w = rs.randn(*shape).astype('float32')
        if name.endswith('gamma'):
            out[name] = 1.0 + 0.1 * w
        elif name.endswith(('bias', 'beta')):
            out[name] = 0.1 * w
        else:
            out[name] = scale * w
    return out


def _pretrain_loss(L):
    def fn(outs, labels):
        _, _, mlm, nsp = outs
        my, ny = labels
        return (L(mlm.reshape((-1, VOCAB)), my.reshape((-1,))).mean()
                + L(nsp, ny).mean())
    return fn


@pytest.fixture(scope='module', params=sorted(BERTS))
def ref(request):
    """What the JAX package computes for the tiny BERT at head dim
    ``request.param``, as numpy: forward, gradients, three AdamW steps."""
    d = request.param
    cfg = BERTS[d]
    assert cfg['units'] // cfg['num_heads'] == d
    config.set('MXNET_TPU_PALLAS', 'attention,epilogue,xent')
    try:
        net = jax_bert.get_bert(**cfg)
        net.initialize(mx.init.Xavier())
        x, y = _batch()
        xs, ys = [nd.array(a) for a in x], [nd.array(a) for a in y]
        net(*xs)                                    # deferred shapes
        params = net.collect_params()
        weights = _weights([(n, p.shape) for n, p in params.items()],
                           cfg['units'])
        for n, p in params.items():
            p.set_data(nd.array(weights[n]))
        outs = [o.asnumpy() for o in net(*xs)]
        loss_fn = _pretrain_loss(jax_loss.SoftmaxCrossEntropyLoss())
        with autograd.record():
            loss = loss_fn(net(*xs), ys)
        loss.backward()
        grads = {n: p.grad().asnumpy() for n, p in params.items()}
        mesh = jax_parallel.create_mesh({'dp': 1},
                                        devices=jax.devices()[:1])
        pt = jax_parallel.ParallelTrainer(net, loss_fn, 'adamw',
                                          dict(HYPER), mesh)
        losses = [float(pt.step(xs, ys).asnumpy()) for _ in range(STEPS)]
        after = {n: p.data().asnumpy() for n, p in params.items()}
    finally:
        config.unset('MXNET_TPU_PALLAS')
    return dict(d=d, cfg=cfg, weights=weights, outs=outs,
                loss=float(loss.asnumpy()), grads=grads, losses=losses,
                after=after)


def _port(ref):
    net = port_bert.params_from_jax(
        ref['weights'], port_bert.get_bert(device='cpu', **ref['cfg']))
    x, y = _batch()
    return net, [torch.tensor(a) for a in x], [torch.tensor(a) for a in y]


def _short(name):
    return name.split('_', 1)[1]


def test_bert_forward_matches_jax_at_head_dim(ref):
    net, xs, _ = _port(ref)
    with torch.no_grad():
        outs = net(*xs)
    u = ref['cfg']['units']
    assert [tuple(o.shape) for o in outs] == \
        [(2, 8, u), (2, u), (2, 3, VOCAB), (2, 2)]
    for name, a, b in zip(('seq', 'pooled', 'mlm', 'nsp'), outs,
                          ref['outs']):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=FWD_TOL,
                                   err_msg='D=%d %s' % (ref['d'], name))


def test_bert_gradients_match_jax_at_head_dim(ref):
    net, xs, ys = _port(ref)
    loss = _pretrain_loss(port_loss.SoftmaxCrossEntropyLoss())(net(*xs), ys)
    loss.backward()
    assert abs(loss.item() - ref['loss']) <= LOSS_REL * abs(ref['loss'])
    mine = net.collect_params().tensors()
    for n, want in ref['grads'].items():
        p = mine[_short(n)]
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        tol = BERT_GRAD_REL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg='D=%d %s' % (ref['d'], n))


def test_bert_three_adamw_steps_match_jax_at_head_dim(ref):
    net, xs, ys = _port(ref)
    pt = port_parallel.ParallelTrainer(
        net, _pretrain_loss(port_loss.SoftmaxCrossEntropyLoss()), 'adamw',
        dict(HYPER))
    losses = [pt.step(xs, ys).item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref['losses'], rtol=LOSS_REL, atol=0)
    assert losses[-1] < losses[0]
    mine = net.collect_params().tensors()
    step = 2 * STEPS * HYPER['learning_rate']
    for n, want in ref['after'].items():
        got = mine[_short(n)].detach().numpy()
        # Adam divides by sqrt(v) + eps, so an entry whose gradient lies
        # within the gradient tier of 0 (the key bias, whose exact
        # gradient is 0, among them: tests/test_torch_bert.py) takes steps
        # of ~lr either way on rounding noise: those entries are held to
        # the steps' size, every other to PARAM_TOL
        g0 = np.abs(ref['grads'][n])
        noise = g0 <= BERT_GRAD_REL * max(float(g0.max()), 1e-30)
        np.testing.assert_allclose(got[noise], want[noise], rtol=0,
                                   atol=step, err_msg=n)
        np.testing.assert_allclose(got[~noise], want[~noise], rtol=0,
                                   atol=PARAM_TOL,
                                   err_msg='D=%d %s' % (ref['d'], n))

"""Port parity: the epilogue family of the port (the act, add+act and BN
apply kernels behind ``ActFunction``, ``AddActFunction`` and
``BnApplyFunction``), the ops built on them (``activation``,
``leaky_relu``, ``add_relu``, ``batch_norm``) and the max-pool equality
backward, against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions and the
JAX kernels run through the Pallas interpreter, with
``MXNET_TPU_PALLAS=epilogue`` set as the JAX package's own tests set it.
Inputs and cotangents come from a numpy seed and go to both, and every
comparison is element by element.

Tolerances, float32:
  * exact: identity, relu, leaky (slope 0.25), add+relu, forward and
    backward; softsign too (one division, both sides IEEE);
  * the BN apply forward: one rounding of the product. XLA on the CPU
    contracts ``(x - mean) * scale + beta`` into one fused multiply-add,
    which rounds once where the port's separate ops (and the CUDA kernel,
    by design, to be bitwise equal to them on the card) round twice; the
    difference is at most half an ulp of the product plus one ulp of the
    result. Its ``dx`` is exact for identity, relu and leaky; softsign's
    ``(1 - |out|)^2`` reads outputs that may differ by that rounding, so
    its ``dx`` takes the transcendental backward's tier below;
  * transcendental activations (sigmoid, tanh, softrelu): 5e-7 relative
    forward (``tests/test_pallas.py``'s ULP tier); their backward,
    computed from the output, 5e-7 relative to the gradient's max abs
    (an output one ulp apart moves ``1 - out^2`` near |out| = 1 by more
    than 5e-7 of itself);
  * coefficient gradients (dscale, dmean, dbeta, dgamma) and the
    training-mode BatchNorm, whose statistics sum over N*H*W elements in
    another order: 1e-5 relative to the tensor's max abs.

The kernels themselves (CUDA, sm_90a) run only on the card: the test
marked ``cuda`` compares them with their plain versions there, bitwise
where the plain version is exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import config
from mxnet_tpu.ops import nn as jax_nn
from mxnet_tpu.ops.pallas import epilogue as jax_epi
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops import nn as port_nn
from mxnet_tpu_torch.ops.kernels import epilogue

torch.set_num_threads(1)
ULP = 5e-7
RED = 1e-5
EXACT_ACTS = ('identity', 'relu', 'leaky', 'softsign')
ULP_ACTS = ('sigmoid', 'tanh', 'softrelu')
SHAPE = (3, 5, 7, 9)


@pytest.fixture(scope='module', autouse=True)
def kernels_on():
    config.set('MXNET_TPU_PALLAS', 'epilogue')
    yield
    config.unset('MXNET_TPU_PALLAS')


def _arrays(seed, *shapes, scale=3.0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*s) * scale).astype('float32') for s in shapes]


def _slope(act):
    return 0.25 if act == 'leaky' else 0.0


def _port_grad(fn, arrays, g):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    out.backward(torch.tensor(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grad(fn, arrays, g):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(d) for d in vjp(jnp.asarray(g))]


def _assert_rel_max(got, want, tol, what):
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound, err_msg=what)


def _assert_fwd(got, want, act, what):
    if act in ULP_ACTS:
        np.testing.assert_allclose(got, want, rtol=ULP, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _assert_bwd(got, want, act, what):
    if act in ULP_ACTS:
        _assert_rel_max(got, want, ULP, what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize('act', EXACT_ACTS + ULP_ACTS)
def test_fused_act_matches_jax(act):
    x, g = _arrays(0, SHAPE, SHAPE)
    slope = _slope(act)
    out, (dx,) = _port_grad(lambda a: kernels.fused_act(a, act, slope),
                            [x], g)
    want, (dwant,) = _jax_grad(lambda a: jax_epi.fused_act(a, act, slope),
                               [x], g)
    _assert_fwd(out, want, act, act)
    _assert_bwd(dx, dwant, act, act)


BF16 = torch.bfloat16


def _bf16_ulps(got, want):
    """chip_smoke's count of bf16 ULPs (the card's check), over a torch
    result and a JAX one."""
    import chip_smoke
    return chip_smoke.bf16_ulps(torch, got, torch.from_numpy(
        np.asarray(want, dtype=np.float32)))


@pytest.mark.parametrize('act', EXACT_ACTS + ULP_ACTS)
def test_act_bf16_plain_versions_match_jax(act):
    """bf16 (AMP): the act forward and backward plain versions against the
    JAX kernels in bf16 (``mxnet_tpu_act_fwd`` / ``_bwd`` in the
    interpreter: upcast, compute in float32, round to the input dtype) on
    the same bf16 values, each element within one bf16 ULP; the backward
    from the JAX forward's own output, so it compares one function."""
    x, g = _arrays(7, SHAPE, SHAPE)
    slope = _slope(act)
    xt, gt = (torch.tensor(a).to(BF16) for a in (x, g))
    jx, jg = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for t in (xt, gt))
    jout, vjp = jax.vjp(lambda a: jax_epi.fused_act(a, act, slope), jx)
    jdx, = vjp(jg)
    assert jout.dtype == jdx.dtype == jnp.bfloat16
    out = kernels.act_forward(xt, act, slope)
    assert out.dtype == BF16
    assert _bf16_ulps(out.float(), np.asarray(jout.astype(jnp.float32))) \
        <= 1, act
    jo = torch.from_numpy(np.asarray(jout.astype(jnp.float32))).to(BF16)
    dx = kernels.act_backward(gt, jo, act, slope)
    assert dx.dtype == BF16
    assert _bf16_ulps(dx.float(), np.asarray(jdx.astype(jnp.float32))) \
        <= 1, act
    # the autograd Function carries bf16 through both directions
    xr = xt.clone().requires_grad_(True)
    y = kernels.fused_act(xr, act, slope)
    y.backward(gt)
    assert y.dtype == xr.grad.dtype == BF16


def test_bn_and_add_act_take_bf16_and_refuse_fp16_and_mixed_dtypes():
    """The BN apply forward and backward take bf16 activations with
    float32 (C,) coefficients and return bf16, add+act two bf16 tensors;
    fp16 and mixed activation dtypes raise ``TypeError``, and
    coefficients of another dtype than float32 are refused on the card
    by the launch check (the plain versions widen them)."""
    x = torch.randn(2, 3, 4, 5).to(BF16)
    c = torch.ones(3)
    assert kernels.bn_act_forward(x, c, c, c).dtype == BF16
    assert kernels.bn_act_backward(x, x, c).dtype == BF16
    assert kernels.add_act_forward(x, x).dtype == BF16
    h = x.half()
    for call in (lambda: kernels.bn_act_forward(h, c, c, c),
                 lambda: kernels.bn_act_backward(h, h, c),
                 lambda: kernels.bn_act_backward(x, x.float(), c),
                 lambda: kernels.add_act_forward(h, h),
                 lambda: kernels.add_act_forward(x, x.float())):
        with pytest.raises(TypeError):
            call()


def test_act_kernels_refuse_mixed_and_other_dtypes():
    x = torch.zeros(5)
    with pytest.raises(TypeError):
        kernels.act_forward(x.half(), 'relu')
    with pytest.raises(TypeError):
        kernels.act_backward(x, x.to(BF16), 'relu')
    with pytest.raises(TypeError):
        kernels.act_backward(x.half(), x.half(), 'relu')


@pytest.mark.parametrize('act', ('relu', 'leaky', 'tanh'))
def test_fused_add_act_matches_jax(act):
    x, y, g = _arrays(1, SHAPE, SHAPE, SHAPE)
    slope = _slope(act)
    out, (dx, dy) = _port_grad(
        lambda a, b: kernels.fused_add_act(a, b, act, slope), [x, y], g)
    want, (dxw, dyw) = _jax_grad(
        lambda a, b: jax_epi.fused_add_act(a, b, act, slope), [x, y], g)
    _assert_fwd(out, want, act, act)
    _assert_bwd(dx, dxw, act, act + ' dx')
    _assert_bwd(dy, dyw, act, act + ' dy')
    np.testing.assert_array_equal(dx, dy)


def _bn_coeffs(seed, c):
    rs = np.random.RandomState(seed)
    return [(rs.rand(c) + 0.5).astype('float32'),
            rs.randn(c).astype('float32'), rs.randn(c).astype('float32')]


def _bn_apply_parity(x, g, axis, act):
    """``fused_bn_apply`` of the port against the JAX package's, forward
    and every gradient, at the tolerances of the module docstring."""
    c = x.shape[axis]
    scale, mean, beta = _bn_coeffs(3, c)
    slope = _slope(act)
    jact = None if act == 'identity' else act
    out, grads = _port_grad(
        lambda *a: kernels.fused_bn_apply(*a, axis=axis, act_type=act,
                                          slope=slope),
        [x, scale, mean, beta], g)
    want, wgrads = _jax_grad(
        lambda *a: jax_epi.fused_bn_apply(*a, axis=axis, act_type=jact,
                                          slope=slope),
        [x, scale, mean, beta], g)
    if act in ULP_ACTS:
        _assert_rel_max(out, want, ULP, 'out')
    else:
        shape = [1] * x.ndim
        shape[axis % x.ndim] = c
        prod = np.abs((x - mean.reshape(shape)) * scale.reshape(shape))
        bound = 2.0 ** -23 * (prod + np.abs(want))
        assert (np.abs(out - want) <= bound).all()
        # the apply with an identity act IS the plain expression
        sep = (x - mean.reshape(shape)) * scale.reshape(shape) \
            + beta.reshape(shape)
        if act == 'identity':
            np.testing.assert_array_equal(out, sep)
    if act == 'softsign':
        # (1 - |out|)^2 of outputs that may differ by the forward's bound
        _assert_rel_max(grads[0], wgrads[0], ULP, 'dx')
    else:
        _assert_bwd(grads[0], wgrads[0], act, 'dx')
    for name, a, b in zip(('dscale', 'dmean', 'dbeta'), grads[1:],
                          wgrads[1:]):
        _assert_rel_max(a, b, RED, name)


@pytest.mark.parametrize('act', ('identity', 'relu', 'leaky', 'tanh'))
@pytest.mark.parametrize('axis', (1, 3))
def test_fused_bn_apply_matches_jax(act, axis):
    x, g = _arrays(2, SHAPE, SHAPE)
    _bn_apply_parity(x, g, axis, act)


@pytest.mark.parametrize('act', EXACT_ACTS + ULP_ACTS)
@pytest.mark.parametrize('shape,axis', (((2, 4, 7, 7), 1),
                                        ((2, 4, 7, 7), -1),
                                        ((2, 3, 1, 3), 1)))
def test_fused_bn_apply_odd_inners_match_jax(shape, axis, act):
    """Inners that are no multiple of 4, where the kernel's vectors span
    channels: 49 (the 7 x 7 maps), 1 (the last axis) and 3."""
    x, g = _arrays(15, shape, shape)
    _bn_apply_parity(x, g, axis, act)


def test_activation_and_leaky_relu_ops_match_jax():
    """The ops route the kernel-covered acts through the act kernels, as
    the JAX ops do with the epilogue family on; gelu stays plain."""
    x, g = _arrays(4, SHAPE, SHAPE)
    for act in ('relu', 'sigmoid', 'tanh', 'softrelu', 'softsign', 'gelu'):
        out, (dx,) = _port_grad(lambda a: port_nn.activation(a, act), [x], g)
        want, (dw,) = _jax_grad(
            lambda a: jax_nn.activation(a, act_type=act), [x], g)
        if act == 'gelu':
            # two erf implementations: ulps of the largest value, not of
            # each (the far negative tail is ~1e-6)
            _assert_rel_max(out, want, ULP, act)
            _assert_rel_max(dx, dw, ULP, act)
            continue
        _assert_fwd(out, want, act, act)
        _assert_bwd(dx, dw, act, act)
    out, (dx,) = _port_grad(lambda a: port_nn.leaky_relu(a, slope=0.25),
                            [x], g)
    want, (dw,) = _jax_grad(
        lambda a: jax_nn.leaky_relu([a], act_type='leaky', slope=0.25),
        [x], g)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(dx, dw)
    with pytest.raises(ValueError, match='unknown act_type'):
        port_nn.activation(torch.tensor(x), 'swish')
    # the prelu kind (ported since the gluon layers need it) computes as
    # the JAX op, a (C,) slope over axis 1; an unknown kind raises
    gamma = np.linspace(0.05, 0.5, x.shape[1]).astype('float32')
    np.testing.assert_array_equal(
        port_nn.leaky_relu(torch.tensor(x), act_type='prelu',
                           gamma=torch.tensor(gamma)).numpy(),
        np.asarray(jax_nn.leaky_relu([jnp.asarray(x), jnp.asarray(gamma)],
                                     act_type='prelu')))
    with pytest.raises(ValueError, match='unknown act_type'):
        port_nn.leaky_relu(torch.tensor(x), act_type='swish')


def test_add_relu_op_matches_jax():
    x, y, g = _arrays(5, SHAPE, SHAPE, SHAPE)
    out, (dx, dy) = _port_grad(port_nn.add_relu, [x, y], g)
    want, (dxw, dyw) = _jax_grad(jax_nn.add_relu, [x, y], g)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(dx, dxw)
    np.testing.assert_array_equal(dy, dyw)
    # broadcasting operands keep the plain spelling
    b = np.ones((1, 5, 1, 1), 'float32')
    np.testing.assert_array_equal(
        port_nn.add_relu(torch.tensor(x), torch.tensor(b)).numpy(),
        np.asarray(jax_nn.add_relu(jnp.asarray(x), jnp.asarray(b))))


def _bn_inputs(seed):
    x, g = _arrays(seed, (4, 6, 5, 7), (4, 6, 5, 7), scale=1.0)
    rs = np.random.RandomState(seed + 1)
    gamma = (rs.rand(6) + 0.5).astype('float32')
    beta = rs.randn(6).astype('float32')
    mm = rs.randn(6).astype('float32')
    mv = (rs.rand(6) + 0.1).astype('float32')
    return x + 2.0, g, gamma, beta, mm, mv


def test_batch_norm_training_matches_jax():
    x, g, gamma, beta, mm, mv = _bn_inputs(6)

    def port(a, gm, bt):
        out, mean, var = port_nn.batch_norm(
            a, gm, bt, torch.tensor(mm), torch.tensor(mv), eps=1e-5,
            fix_gamma=False, training=True)
        port.stats = (mean.detach().numpy(), var.detach().numpy())
        return out

    def jax_fn(a, gm, bt):
        return jax_nn.batch_norm(
            a, gm, bt, jnp.asarray(mm), jnp.asarray(mv), eps=1e-5,
            fix_gamma=False, training=True)

    out, grads = _port_grad(port, [x, gamma, beta], g)
    want, wgrads = _jax_grad(lambda *a: jax_fn(*a)[0], [x, gamma, beta], g)
    _assert_rel_max(out, want, RED, 'out')
    stats = [np.asarray(t) for t in jax_fn(x, gamma, beta)[1:]]
    for name, a, b in zip(('mean', 'var'), port.stats, stats):
        _assert_rel_max(a, b, RED, name)
    # the biased variance of the batch (not F.batch_norm's unbiased one)
    np.testing.assert_allclose(port.stats[1], x.var(axis=(0, 2, 3)),
                               rtol=1e-4)
    for name, a, b in zip(('dx', 'dgamma', 'dbeta'), grads, wgrads):
        _assert_rel_max(a, b, RED, name)


@pytest.mark.parametrize('use_global_stats', (False, True))
def test_batch_norm_inference_and_global_stats_match_jax(use_global_stats):
    """Inference mode, and ``use_global_stats`` under autograd (frozen-BN
    fine-tuning): the moving statistics fold into the apply kernels'
    coefficients; the data gradient is the ``bn_act_bwd`` kernel's."""
    x, g, gamma, beta, mm, mv = _bn_inputs(8)
    training = use_global_stats

    def port(a, gm, bt):
        return port_nn.batch_norm(
            a, gm, bt, torch.tensor(mm), torch.tensor(mv), eps=1e-5,
            fix_gamma=False, use_global_stats=use_global_stats,
            training=training)[0]

    def jax_fn(a, gm, bt):
        return jax_nn.batch_norm(
            a, gm, bt, jnp.asarray(mm), jnp.asarray(mv), eps=1e-5,
            fix_gamma=False, use_global_stats=use_global_stats,
            training=training)[0]

    out, grads = _port_grad(port, [x, gamma, beta], g)
    want, wgrads = _jax_grad(jax_fn, [x, gamma, beta], g)
    _assert_rel_max(out, want, ULP, 'out')
    _assert_rel_max(grads[0], wgrads[0], ULP, 'dx')
    for name, a, b in zip(('dgamma', 'dbeta'), grads[1:], wgrads[1:]):
        _assert_rel_max(a, b, RED, name)


def test_max_pool_gives_ties_every_max_position():
    """``_max_pool_core``'s backward: a window's cotangent reaches every
    position equal to its max. The input is a relu output with exact-zero
    ties and repeated values, as the ResNet stem pools."""
    rs = np.random.RandomState(9)
    x = np.maximum(np.round(rs.randn(2, 3, 11, 12) * 2) / 2,
                   0).astype('float32')
    g = rs.randn(2, 3, 6, 6).astype('float32')

    def port(a):
        return port_nn.pooling(a, kernel=3, stride=2, pad=1)

    def jax_fn(a):
        return jax_nn.pooling(a, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                              pool_type='max')

    out, (dx,) = _port_grad(port, [x], g)
    want, (dw,) = _jax_grad(jax_fn, [x], g)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(dx, dw)
    # ties do occur, and F.max_pool2d's one-winner backward differs there
    xt = torch.tensor(x, requires_grad=True)
    torch.nn.functional.max_pool2d(xt, 3, 2, 1).backward(torch.tensor(g))
    assert not np.array_equal(xt.grad.numpy(), dx)


def test_global_avg_pool_matches_jax():
    x, = _arrays(10, (2, 4, 5, 6))
    out = port_nn.pooling(torch.tensor(x), pool_type='avg',
                          global_pool=True).numpy()
    want = np.asarray(jax_nn.pooling(jnp.asarray(x), pool_type='avg',
                                     global_pool=True))
    assert out.shape == want.shape == (2, 4, 1, 1)
    np.testing.assert_allclose(out, want, rtol=ULP, atol=1e-7)


def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_launch_counts()
    x, y = (torch.tensor(a) for a in _arrays(11, SHAPE, SHAPE))
    kernels.fused_act(x, 'relu')
    kernels.fused_add_act(x, y)
    kernels.fused_bn_apply(x, torch.ones(5), torch.zeros(5), torch.zeros(5))
    assert not any(kernels.launch_counts().values())
    with pytest.raises(ValueError, match='unsupported epilogue act_type'):
        kernels.act_forward(x, 'gelu')
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.act_forward(x.to('meta'), 'relu')


def test_launch_refuses_more_elements_than_the_kernels_index(monkeypatch):
    """The kernels index in 32 bits: a launch of more elements raises
    before the library is loaded, and counts nothing."""
    from mxnet_tpu_torch.ops.kernels import epilogue
    monkeypatch.setattr(epilogue, 'MAX_ELEMENTS', 10)
    kernels.reset_launch_counts()
    x = torch.zeros(11)
    with pytest.raises(ValueError, match='more than the 10'):
        epilogue._launch('act_fwd', 'mx_act_fwd', [], {'x': x},
                         torch.empty_like(x), x.numel(), 1, 0.0)
    assert not any(kernels.launch_counts().values())


def _stream_items(n, geom, itemsize=4):
    """(first element, width) of each vector (width 16 / itemsize: 4
    floats, 8 bf16) and scalar (width 1) the stream kernels visit for
    ``n`` elements at ``geom``, as csrc/stream.cuh ``stream`` forms them
    (blocks, then threads: a vector of a whole tile, or in the block past
    the tiles a vector of the rest and a scalar of the tail)."""
    threads, vec = epilogue.EPI_THREADS, 16 // itemsize
    tile = threads * vec
    whole = n - n % vec
    for b in range(geom.grid):
        for t in range(threads):
            i = b * tile + t * vec
            if b < geom.tiles:
                yield i, vec
                continue
            if i < whole:
                yield i, vec
            if whole + t < n:
                yield whole + t, 1


def _stream_walk(n, geom, itemsize=4):
    """The element indices the stream visits, in its order."""
    for i, width in _stream_items(n, geom, itemsize):
        yield from range(i, i + width)


def _assert_partition(n, geom, itemsize=4):
    """``geom`` partitions n elements as the stream walks them, checked
    from the geometry alone: whole tiles, one block each, then one block
    for fewer than a tile of whole vectors and a tail of n % vec, every
    index in 32 bits; the C entry points' rule (tiles = n // tile, grid =
    tiles + (n % tile != 0)) holds."""
    threads, vec = epilogue.EPI_THREADS, 16 // itemsize
    tile = threads * vec
    if itemsize == 4:
        assert (vec, tile) == (epilogue.EPI_VEC, epilogue.EPI_TILE)
    assert geom.tiles == n // tile and geom.body == geom.tiles * tile
    assert geom.tail == n % vec and geom.rest % vec == 0
    assert 0 <= geom.rest < tile
    assert geom.body + geom.rest + geom.tail == n
    assert geom.grid == geom.tiles + (n % tile != 0)
    # block b < tiles takes tile b alone, so each tile once; the block
    # past them takes vector body / 4 + j on thread j, at most one a
    # thread, and threads 0..tail-1 the scalars
    assert geom.rest // vec < threads and geom.tail < vec
    # the largest index the kernel forms, before its guard, fits 32 bits
    assert geom.grid * tile <= n + tile < 2 ** 32
    assert n <= epilogue.MAX_ELEMENTS


TILE = epilogue.EPI_TILE


@pytest.mark.parametrize('n', sorted({
    0, 1, 2, 3, 4, 5, 7, 8, 1023, 1024, 1025, 3003, 9102, TILE - 4,
    TILE - 1, TILE + 1, TILE + 3, TILE + 4, 2 * TILE - 1, 2 * TILE,
    3 * TILE + 1027, 128 * 512 * 7 * 7, 128 * 64 * 112 * 112,
    128 * 64 * 112 * 112 + 5, epilogue.MAX_ELEMENTS - 3,
    epilogue.MAX_ELEMENTS}))
def test_epilogue_geometry_covers_every_element_once(n):
    """The vector body, the rest and the scalar tail of
    ``epilogue_geometry(n)`` cover the n elements exactly once: from the
    geometry for every n, and by walking the kernel's indices where n is
    small."""
    geom = kernels.epilogue_geometry(n)
    _assert_partition(n, geom)
    if n <= 4 * TILE:
        walked = list(_stream_walk(n, geom))
        assert sorted(walked) == list(range(n))


TILE_BF16 = epilogue.EPI_THREADS * 8


@pytest.mark.parametrize('n', sorted({
    0, 1, 5, 7, 8, 9, 15, 16, 3003, 9102, TILE_BF16 - 8, TILE_BF16 - 1,
    TILE_BF16 + 1, TILE_BF16 + 7, TILE_BF16 + 8, 2 * TILE_BF16 + 2051,
    96 * 768, 128 * 64 * 112 * 112 + 5, epilogue.MAX_ELEMENTS - 7,
    epilogue.MAX_ELEMENTS}))
def test_epilogue_geometry_bf16_covers_every_element_once(n):
    """The bf16 stream (8 elements a 16-byte vector, the act kernels' AMP
    instances): the body, rest and tail of ``epilogue_geometry(n, 2)``
    cover the n elements exactly once, walked where n is small; the
    output is evicted from ``EPI_EVICT_BYTES`` of bf16 on."""
    geom = kernels.epilogue_geometry(n, 2)
    _assert_partition(n, geom, 2)
    if n <= 4 * TILE_BF16:
        assert sorted(_stream_walk(n, geom, 2)) == list(range(n))
    assert geom.evict is (2 * n >= epilogue.EPI_EVICT_BYTES)


def test_epilogue_geometry_evicts_outputs_the_l2_cannot_hold():
    """Stores evict first from an output of EPI_EVICT_BYTES on: ResNet-50's
    28 x 28 relus (51.4 MB) and larger at batch 128, not its 14 x 14
    (25.7 MB) and 7 x 7 ones."""
    limit = epilogue.EPI_EVICT_BYTES
    assert not kernels.epilogue_geometry(limit // 4 - 1).evict
    assert kernels.epilogue_geometry(-(-limit // 4)).evict
    for shape, evict in (((128, 64, 112, 112), True),
                         ((128, 128, 28, 28), True),
                         ((128, 256, 14, 14), False),
                         ((128, 512, 7, 7), False),
                         ((128, 2048, 7, 7), True)):
        assert kernels.epilogue_geometry(
            int(np.prod(shape))).evict is evict, shape


def test_stream_constants_match_the_source():
    """epilogue.py's stream constants are those of the stream that
    csrc/epilogue.cu includes (csrc/stream.cuh): the threads a block, the
    floats a vector and a tile."""
    import os
    import re
    csrc = os.path.join(os.path.dirname(epilogue.__file__), 'csrc')
    assert '#include "stream.cuh"' in open(os.path.join(
        csrc, 'epilogue.cu')).read()
    src = open(os.path.join(csrc, 'stream.cuh')).read()
    assert int(re.search(r'constexpr int THREADS = (\d+);', src).group(1)) \
        == epilogue.EPI_THREADS
    assert int(re.search(r'constexpr int VEC = (\d+);', src).group(1)) \
        == epilogue.EPI_VEC
    assert 'constexpr int TILE = THREADS * VEC;' in src
    # the bf16 stream: 8 elements a 16-byte vector, as epilogue_geometry's
    # itemsize 2
    assert int(re.search(r'constexpr int VEC_BF16 = (\d+);', src).group(1)) \
        == 16 // 2


def _kernel_div(i, div):
    """``i // div.d`` as csrc/stream.cuh ``Divisor::div`` computes it:
    the high 32 bits of the 64-bit product ``i * mul`` (``__umulhi``),
    shifted right; ``mul`` 0 (d = 1) gives ``i``."""
    return (i * div.mul >> 32) >> div.shift if div.mul else i


def _channel_at(i, geom):
    """``Channels::at``: the channel of element i and its offset in the
    channel's run of ``inner`` elements, by two divisions and the
    remainders taken back from the quotients."""
    q = _kernel_div(i, geom.inner)
    r = i - q * geom.inner.d
    return q - _kernel_div(q, geom.c) * geom.c.d, r


def _channel_step(ch, r, geom):
    """``Channels::step``: (channel, offset) of the next element."""
    r += 1
    if r == geom.inner.d:
        r = 0
        ch = 0 if ch + 1 == geom.c.d else ch + 1
    return ch, r


def _bn_walk(n, geom, itemsize=4):
    """(element, channel) as the BN kernels find them: a vector (4
    floats, 8 bf16) divides its first index and each further element
    steps from the one before; a scalar of the tail divides its own
    index."""
    for i, width in _stream_items(n, geom, itemsize):
        ch, r = _channel_at(i, geom)
        yield i, ch
        for j in range(1, width):
            ch, r = _channel_step(ch, r, geom)
            yield i + j, ch


# the inners and channel counts of the BatchNorms ResNet-50 v1 (224 px)
# and ssd_300 run, and the largest divisors the kernels take
RESNET_INNERS = (112 * 112, 56 * 56, 28 * 28, 14 * 14, 7 * 7)
SSD_INNERS = tuple(s * s for s in (300, 150, 75, 38, 19, 10, 5, 3, 1))
BN_CHANNELS = (3, 32, 64, 128, 256, 512, 1024, 2048)
BIG_DIVISORS = (2 ** 16 + 1, 2 ** 30, 2 ** 30 + 1, 2 ** 31 - 2,
                epilogue.MAX_ELEMENTS)
DIVISOR_SETS = [range(k, k + 512) for k in range(1, 4097, 512)] + [
    RESNET_INNERS + SSD_INNERS + BN_CHANNELS + BIG_DIVISORS]


@pytest.mark.parametrize('divisors', DIVISOR_SETS,
                         ids=['%d-%d' % (d[0], d[-1]) for d in
                              DIVISOR_SETS[:-1]] + ['shapes'])
def test_fast_divisor_divides_exactly(divisors):
    """The kernel's division by ``fast_divisor(d)`` gives ``i // d`` and
    ``i % d`` for every divisor 1-4096 and every inner and channel count
    of the ResNet-50 and SSD BatchNorms, at numerators 0, d - 1, d,
    2**31 - 1 and a seeded sample of [0, 2**31); its multiplier fits 32
    bits."""
    rs = np.random.RandomState(16)
    top = epilogue.MAX_ELEMENTS
    for d in divisors:
        div = epilogue.fast_divisor(d)
        assert div.d == d and 0 <= div.mul < 2 ** 32 and 0 <= div.shift < 32
        nums = {0, d - 1, d, top, top - d + 1, top - 1} | set(
            int(v) for v in rs.randint(0, top, size=24, dtype=np.int64))
        for i in nums:
            if i > top or i < 0:
                continue
            q = _kernel_div(i, div)
            assert (q, i - q * d) == divmod(i, d), (i, d)


def test_fast_divisor_refuses_what_the_kernel_cannot_divide_by():
    for d in (0, -1, 2 ** 31):
        with pytest.raises(ValueError, match='not in'):
            epilogue.fast_divisor(d)
    # an empty tensor's C or inner may be 0: its launch arguments carry
    # the divisor of 1 there, and the entry points return before reading
    # them
    for c, inner in ((0, 5), (3, 0)):
        args = epilogue._bn_args(0, c, inner, 0, 0.0)
        div_inner = epilogue.fast_divisor(max(inner, 1))
        div_c = epilogue.fast_divisor(max(c, 1))
        assert args[:7] == (0, c, inner, div_inner.mul, div_inner.shift,
                            div_c.mul, div_c.shift)


@pytest.mark.parametrize('itemsize', (4, 2))
@pytest.mark.parametrize('inner', (1, 2, 3, 4, 49, 63, 196))
@pytest.mark.parametrize('c', (1, 3, 37))
def test_bn_channel_walk_matches_the_channel_of_every_element(inner, c,
                                                              itemsize):
    """Every element's channel as the kernels walk it, ``(i // inner) %
    c``: a vector spanning two runs (inner 49, 63), or up to four (inner
    1-3; eight in a bf16 vector), and the channel wrapping from c - 1 to
    0 inside a vector. Over whole tiles, the rest and a tail, for the
    float32 stream and the bf16 one (8 elements a vector)."""
    tile = epilogue.EPI_THREADS * 16 // itemsize
    for outer in (1, 5, 2 * tile // (c * inner) + 3):
        n = outer * c * inner
        geom = kernels.bn_geometry(n, c, inner, itemsize)
        walked = list(_bn_walk(n, geom, itemsize))
        assert sorted(i for i, _ in walked) == list(range(n))
        assert [ch for _, ch in sorted(walked)] == \
            [(i // inner) % c for i in range(n)], (outer, c, inner)


# ResNet-50's nine BatchNorm shapes at batch 128, SSD's at batch 16, odd
# ones of the card checks, and a tensor of the most elements the kernels
# index
BN_SHAPES = ((128, 64, 112, 112), (128, 64, 56, 56), (128, 256, 56, 56),
             (128, 128, 28, 28), (128, 512, 28, 28), (128, 256, 14, 14),
             (128, 1024, 14, 14), (128, 512, 7, 7), (128, 2048, 7, 7),
             (16, 64, 300, 300), (16, 512, 38, 38), (16, 256, 5, 5),
             (16, 256, 3, 3), (2, 4, 7, 7), (2, 3, 1, 3),
             (1, 1, 1, epilogue.MAX_ELEMENTS))


@pytest.mark.parametrize('itemsize', (4, 2))
@pytest.mark.parametrize('shape', BN_SHAPES)
def test_bn_geometry_is_the_streams_with_the_divisors(shape, itemsize):
    """``bn_geometry`` partitions the elements as ``epilogue_geometry``
    does at the element size (float32; bf16 x, 2 bytes) and carries the
    divisors of inner and C."""
    n, c, inner = int(np.prod(shape)), shape[1], int(np.prod(shape[2:]))
    geom = kernels.bn_geometry(n, c, inner, itemsize)
    assert tuple(geom[:6]) == tuple(kernels.epilogue_geometry(n, itemsize))
    _assert_partition(n, kernels.epilogue_geometry(n, itemsize), itemsize)
    assert geom.inner == epilogue.fast_divisor(inner)
    assert geom.c == epilogue.fast_divisor(c)
    # the last element's channel, as the kernel finds it
    assert _channel_at(n - 1, geom)[0] == c - 1


# ptxas -v lines of csrc/epilogue.cu, as ptxas prints them for sm_90a
PTXAS_LINES = [
    "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__54bd33e0_11_"
    "epilogue_cu_1878d3e723epilogue_act_fwd_kernelILi1ELb1EEEvPKfPfjjf' "
    "for 'sm_90a'",
    '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
    'ptxas info    : Used 20 registers, used 0 barriers',
    "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__54bd33e0_11_"
    "epilogue_cu_1878d3e723epilogue_act_bwd_kernelILi6ELb0EEEvPKfS2_"
    "Pfjjf' for 'sm_90a'",
    '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
    'ptxas info    : Used 32 registers, used 0 barriers',
    "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__54bd33e0_11_"
    "epilogue_cu_1878d3e726epilogue_bn_act_fwd_kernelILi0ELb1EEEvPKfS2_"
    "S2_S2_PfjjNS_8ChannelsEf' for 'sm_90a'",
    '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
    'ptxas info    : Used 26 registers, used 0 barriers',
    "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__54bd33e0_11_"
    "epilogue_cu_1878d3e726epilogue_bn_act_bwd_kernelILi3ELb0EEEvPKfS2_"
    "S2_PfjjNS_8ChannelsEf' for 'sm_90a'",
    '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
    'ptxas info    : Used 30 registers, used 0 barriers',
    "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__54bd33e0_11_"
    "epilogue_cu_1878d3e728epilogue_act_fwd_bf16_kernelILi3ELb0EEEvPK13__nv_"
    "bfloat16PS2_jjf' for 'sm_90a'",
    '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
    'ptxas info    : Used 32 registers, used 0 barriers',
    "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__54bd33e0_11_"
    "epilogue_cu_1878d3e728epilogue_act_bwd_bf16_kernelILi4ELb1EEEvPK13__nv_"
    "bfloat16S3_PS2_jjf' for 'sm_90a'",
    '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
    'ptxas info    : Used 31 registers, used 0 barriers',
    "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__54bd33e0_11_"
    "epilogue_cu_1878d3e727epilogue_add_act_fwd_kernelILi6EEEvPKfS2_Pfjf' "
    "for 'sm_90a'",
    'ptxas info    : Used 18 registers, used 0 barriers',
    "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__54bd33e0_11_"
    "epilogue_cu_1878d3e731epilogue_bn_act_fwd_bf16_kernelILi0ELb1EEEvPK13__"
    "nv_bfloat16PKfS5_S5_PS1_jjNS_8ChannelsEf' for 'sm_90a'",
    '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
    'ptxas info    : Used 32 registers, used 0 barriers',
    "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__54bd33e0_11_"
    "epilogue_cu_1878d3e731epilogue_bn_act_bwd_bf16_kernelILi0ELb0EEEvPK13__"
    "nv_bfloat16S3_PKfPS1_jjNS_8ChannelsEf' for 'sm_90a'",
    '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
    'ptxas info    : Used 30 registers, used 0 barriers',
    "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__54bd33e0_11_"
    "epilogue_cu_1878d3e732epilogue_add_act_fwd_bf16_kernelILi1ELb1EEEvPK13__"
    "nv_bfloat16S3_PS1_jjf' for 'sm_90a'",
    '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
    'ptxas info    : Used 24 registers, used 0 barriers',
]


def test_ptxas_report_of_the_act_kernels():
    """chip_smoke's phase-1 check reads the registers and spills of the
    stream kernels' instances (act and BN apply, their bf16 instances and
    add+act's bf16 one) from ptxas's report, keyed by store kind, and
    fails on a spill or when ptxas ran and did not name all nine
    kernels."""
    import chip_smoke
    assert chip_smoke.check_epilogue_build(PTXAS_LINES) == {
        'act_fwd': {'cs': 20}, 'act_bwd': {'st': 32},
        'bn_act_fwd': {'cs': 26}, 'bn_act_bwd': {'st': 30},
        'act_fwd_bf16': {'st': 32}, 'act_bwd_bf16': {'cs': 31},
        'bn_act_fwd_bf16': {'cs': 32}, 'bn_act_bwd_bf16': {'st': 30},
        'add_act_fwd_bf16': {'cs': 24}}
    for line in (1, 7, 21):
        spilled = list(PTXAS_LINES)
        spilled[line] = '    0 bytes stack frame, 8 bytes spill stores, ' \
            '8 bytes spill loads'
        with pytest.raises(AssertionError, match='spill'):
            chip_smoke.check_epilogue_build(spilled)
    with pytest.raises(AssertionError,
                       match='no act_bwd / act_bwd_bf16 / act_fwd / '
                       'act_fwd_bf16 / add_act_fwd_bf16 / bn_act_bwd / '
                       'bn_act_bwd_bf16 / bn_act_fwd / bn_act_fwd_bf16'):
        chip_smoke.check_epilogue_build(PTXAS_LINES[18:20])
    with pytest.raises(AssertionError, match='no act_bwd_bf16 / act_fwd_bf16 '
                       '/ add_act_fwd_bf16 / bn_act_bwd / bn_act_bwd_bf16 / '
                       'bn_act_fwd / bn_act_fwd_bf16'):
        chip_smoke.check_epilogue_build(PTXAS_LINES[:6])
    with pytest.raises(AssertionError, match='no act_bwd_bf16 / act_fwd_bf16 '
                       '/ add_act_fwd_bf16 / bn_act_bwd_bf16 / '
                       'bn_act_fwd_bf16'):
        chip_smoke.check_epilogue_build(PTXAS_LINES[:12])
    with pytest.raises(AssertionError, match='no add_act_fwd_bf16 / '
                       'bn_act_bwd_bf16 / bn_act_fwd_bf16'):
        chip_smoke.check_epilogue_build(PTXAS_LINES[:20])
    assert chip_smoke.check_epilogue_build([]) == {}


@pytest.mark.cuda
def test_act_bf16_instances_are_the_float32_kernels_rounded_on_card():
    """The act kernels' bf16 instances (AMP): bitwise the float32 kernels
    on the widened inputs, rounded, for every act type, at sizes with
    whole 2048-element tiles, a rest and tails (9102, 3003) and below a
    tile (5)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are CUDA C++ for '
                    'sm_90a and have no CPU mode')
    for n in (9102, 3003, 5):
        x, g = (torch.tensor(a, device='cuda').to(BF16)
                for a in _arrays(n, (n,), (n,)))
        for act in EXACT_ACTS + ULP_ACTS:
            slope = _slope(act)
            out = kernels.act_forward(x, act, slope)
            assert torch.equal(out, kernels.act_forward(
                x.float(), act, slope).to(BF16)), (act, n)
            assert torch.equal(
                kernels.act_backward(g, out, act, slope),
                kernels.act_backward(g.float(), out.float(), act,
                                     slope).to(BF16)), (act, n)


@pytest.mark.cuda
def test_epilogue_kernels_match_plain_versions_on_card():
    """The five kernels against their plain versions on the card: bitwise
    for identity, relu, leaky, add+relu and the BN apply, forward and
    backward; 5e-7 relative for the transcendental acts. The BN apply
    also along other axes, at inners that are no multiple of 4
    (``chip_smoke.EPI_BN_CASES``: 1, 2, 3, 9, 25, 49). A non-contiguous
    cotangent (an expanded view) is made dense, not refused."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are CUDA C++ for '
                    'sm_90a and have no CPU mode')
    x, y, g = (torch.tensor(a, device='cuda')
               for a in _arrays(12, SHAPE, SHAPE, SHAPE))
    scale, mean, beta = (torch.tensor(a, device='cuda')
                         for a in _bn_coeffs(13, SHAPE[1]))
    for act in EXACT_ACTS + ULP_ACTS:
        slope = _slope(act)
        pairs = [
            (kernels.act_forward(x, act, slope),
             kernels.act_forward_reference(x, act, slope)),
            (kernels.act_backward(g, x, act, slope),
             kernels.act_backward_reference(g, x, act, slope)),
            (kernels.add_act_forward(x, y, act, slope),
             kernels.add_act_forward_reference(x, y, act, slope)),
            (kernels.bn_act_forward(x, scale, mean, beta, 1, act, slope),
             kernels.bn_act_forward_reference(x, scale, mean, beta, 1, act,
                                              slope)),
            (kernels.bn_act_backward(g, x, scale, 1, act, slope),
             kernels.bn_act_backward_reference(g, x, scale, 1, act, slope)),
        ]
        for got, want in pairs:
            if act in ULP_ACTS:
                tol = ULP * want.abs().max().item()
                assert (got - want).abs().max().item() <= tol, act
            else:
                assert torch.equal(got, want), act
    gexp = g[:1, :1, :1, :1].expand(SHAPE)
    assert torch.equal(kernels.act_backward(gexp, x, 'relu'),
                       kernels.act_backward_reference(gexp, x, 'relu'))
    import chip_smoke
    for k, (shape, axis) in enumerate(chip_smoke.EPI_BN_CASES):
        xb, gb = (torch.tensor(a, device='cuda')
                  for a in _arrays(30 + k, shape, shape))
        coeffs = [torch.tensor(a, device='cuda')
                  for a in _bn_coeffs(31 + k, shape[axis])]
        for act in EXACT_ACTS + ULP_ACTS:
            slope = _slope(act)
            out = kernels.bn_act_forward_reference(xb, *coeffs, axis, act,
                                                   slope)
            for got, want in (
                    (kernels.bn_act_forward(xb, *coeffs, axis, act, slope),
                     out),
                    (kernels.bn_act_backward(gb, out, coeffs[0], axis, act,
                                             slope),
                     kernels.bn_act_backward_reference(gb, out, coeffs[0],
                                                       axis, act, slope))):
                if act in ULP_ACTS:
                    tol = ULP * want.abs().max().item()
                    assert (got - want).abs().max().item() <= tol, \
                        (act, shape, axis)
                else:
                    assert torch.equal(got, want), (act, shape, axis)
    # the activation stream's tails: below a tile, and a tile plus 3
    for n in (1, 3, 5, 1025, TILE + 3):
        x, g = (torch.tensor(a, device='cuda')
                for a in _arrays(14 + n, (n,), (n,)))
        for act in EXACT_ACTS + ULP_ACTS:
            slope = _slope(act)
            out = kernels.act_forward_reference(x, act, slope)
            for got, want in (
                    (kernels.act_forward(x, act, slope), out),
                    (kernels.act_backward(g, out, act, slope),
                     kernels.act_backward_reference(g, out, act, slope))):
                if act in ULP_ACTS:
                    tol = ULP * want.abs().max().item()
                    assert (got - want).abs().max().item() <= tol, (act, n)
                else:
                    assert torch.equal(got, want), (act, n)

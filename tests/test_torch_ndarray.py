"""The port's NDArray (``mxnet_tpu_torch/ndarray``) against the JAX
package's, on the CPU: the cases of ``tests/test_ndarray.py``, each run
through both packages on the same inputs (``tests/test_ndarray.py``'s
own expectations held in each), the results equal within 1e-6 of their
magnitude; and the ``.params`` container byte for byte.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx

TOL = 1e-6


def _creation(mx):
    nd = mx.nd
    a = nd.array([[1, 2], [3, 4]])
    assert a.shape == (2, 2) and a.dtype == np.float32
    z = nd.zeros((2, 3), dtype='float16')
    assert z.dtype == np.float16
    o = nd.ones(4)
    assert o.sum().asscalar() == 4.0
    f = nd.full((2, 2), 7)
    r = nd.arange(0, 10, 2)
    assert np.array_equal(r.asnumpy(), [0, 2, 4, 6, 8])
    e = nd.empty((2, 2))
    return [a.asnumpy(), z.asnumpy(), f.asnumpy(), r.asnumpy(),
            nd.arange(1.5, 4, 0.5, repeat=2).asnumpy(), e.shape]


def _arithmetic(mx):
    nd = mx.nd
    a = nd.array([1.0, 2.0, 3.0])
    b = nd.array([4.0, 5.0, 6.0])
    return [(a + b).asnumpy(), (b - a).asnumpy(), (a * b).asnumpy(),
            (b / a).asnumpy(), (a + 1).asnumpy(), (1 - a).asnumpy(),
            (a ** 2).asnumpy(), (2 ** a).asnumpy(), (-a).asnumpy(),
            abs(nd.array([-1.0, 2.0])).asnumpy(), (a % 2).asnumpy(),
            (7 % a).asnumpy(), (3 / a).asnumpy()]


def _comparison(mx):
    a = mx.nd.array([1.0, 2.0, 3.0])
    return [(a > 2).asnumpy(), (a >= 2).asnumpy(), (a == 2).asnumpy(),
            (a != 2).asnumpy(), (2 < a).asnumpy(), (a <= 2).asnumpy()]


def _inplace(mx):
    a = mx.nd.ones((3,))
    a += 2
    first = a.asnumpy()
    a *= 2
    a -= 1
    a /= 5
    return [first, a.asnumpy()]


def _indexing(mx):
    a = mx.nd.array(np.arange(12).reshape(3, 4))
    out = [a[1].asnumpy(), a[1:3, 0].asnumpy(), a[2, 3].asnumpy()]
    a[0, 0] = 99
    a[1] = 0
    out.append(a.asnumpy())
    a[:] = 5
    out.append(a.asnumpy())
    a[0:2, 1:3] = mx.nd.ones((2, 2)) * 3
    out.append(a.asnumpy())
    return out


def _reshape_transpose(mx):
    a = mx.nd.array(np.arange(24).reshape(2, 3, 4))
    shapes = [a.reshape((6, 4)).shape, a.reshape((-1, 4)).shape,
              a.reshape((0, -1)).shape, a.reshape((-3, 4)).shape,
              a.reshape((-4, 1, 2, 0, 4)).shape, a.reshape((2, -2)).shape,
              a.transpose().shape, a.transpose((1, 0, 2)).shape, a.T.shape,
              a.flatten().shape, a.expand_dims(1).shape,
              a.swapaxes(0, 2).shape]
    return [np.array([str(sh) for sh in shapes]),
            a.transpose((1, 0, 2)).asnumpy(), a.reshape((-3, 4)).asnumpy()]


def _reductions(mx):
    nd = mx.nd
    a = nd.array(np.arange(6, dtype='f').reshape(2, 3))
    return [a.sum().asnumpy(), a.sum(axis=0).asnumpy(),
            nd.sum(a, axis=1).asnumpy(), a.mean().asnumpy(),
            a.max().asnumpy(), a.min().asnumpy(), nd.norm(a).asnumpy(),
            nd.argmax(a, axis=1).asnumpy(),
            nd.sum(a, axis=1, exclude=True).asnumpy(),
            a.prod(axis=1, keepdims=True).asnumpy()]


def _dot(mx):
    nd = mx.nd
    rs = np.random.RandomState(0)
    a = nd.array(rs.rand(3, 4).astype('f'))
    b = nd.array(rs.rand(4, 5).astype('f'))
    c = nd.dot(a, b)
    assert np.allclose(c.asnumpy(), a.asnumpy() @ b.asnumpy(), atol=1e-5)
    bt = nd.dot(a, nd.array(rs.rand(5, 4).astype('f')), transpose_b=True)
    d = nd.batch_dot(nd.ones((2, 3, 4)), nd.ones((2, 4, 5)))
    return [c.asnumpy(), bt.asnumpy(), d.asnumpy()]


def _concat_split_stack(mx):
    nd = mx.nd
    a, b = nd.ones((2, 3)), nd.zeros((2, 3))
    c = nd.concat(a, b, dim=0)
    s = nd.stack(a, b, axis=0)
    parts = nd.split(c, num_outputs=2, axis=0)
    return [c.asnumpy(), s.asnumpy(), parts[0].asnumpy(),
            parts[1].asnumpy(), nd.concatenate([a, b], axis=1).asnumpy()]


def _slice_ops(mx):
    nd = mx.nd
    a = nd.array(np.arange(24).reshape(2, 3, 4))
    return [nd.slice(a, begin=(0, 1), end=(2, 3)).asnumpy(),
            nd.slice_axis(a, axis=2, begin=1, end=3).asnumpy(),
            nd.slice(a, begin=(None, None, 3), end=(None, None, 0),
                     step=(1, 1, -1)).asnumpy()]


def _take_one_hot_pick(mx):
    nd = mx.nd
    w = nd.array(np.arange(12).reshape(4, 3))
    return [nd.take(w, nd.array([0, 3])).asnumpy(),
            nd.one_hot(nd.array([0, 2]), depth=3).asnumpy(),
            nd.pick(nd.array([[1., 2.], [3., 4.]]), nd.array([0, 1]),
                    axis=1).asnumpy()]


def _topk_sort(mx):
    nd = mx.nd
    a = nd.array([[3.0, 1.0, 2.0], [0.0, 5.0, 4.0]])
    both = nd.topk(a, k=1, ret_typ='both')
    return [nd.topk(a, k=2).asnumpy(), both[0].asnumpy(),
            both[1].asnumpy(), nd.sort(a, axis=1).asnumpy(),
            nd.argsort(a, axis=1).asnumpy(),
            nd.sort(a, axis=1, is_ascend=False).asnumpy()]


def _cast_copy_context(mx):
    nd = mx.nd
    a = nd.array([1.5, 2.5])
    b = a.astype('int32')
    assert b.dtype == np.int32
    c = a.copy()
    c[0] = 9
    assert a[0].asscalar() == 1.5
    d = a.as_in_context(mx.cpu(0))
    assert d.context.device_type == 'cpu'
    a.wait_to_read()
    e = nd.zeros((2,))
    a.copyto(e)
    return [b.asnumpy(), c.asnumpy(), d.asnumpy(), e.asnumpy()]


def _broadcast(mx):
    nd = mx.nd
    a = nd.array([[1.0], [2.0]])
    return [nd.broadcast_to(a, shape=(2, 3)).asnumpy(),
            nd.broadcast_add(nd.ones((2, 1)), nd.ones((1, 3))).asnumpy(),
            a.broadcast_like(nd.ones((2, 4))).asnumpy()]


def _where_clip(mx):
    nd = mx.nd
    cond = nd.array([1.0, 0.0, 1.0])
    x = nd.array([1.0, 2.0, 3.0])
    y = nd.array([4.0, 5.0, 6.0])
    return [nd.where(cond, x, y).asnumpy(),
            nd.clip(x, a_min=1.5, a_max=2.5).asnumpy(),
            nd.maximum(x, 2).asnumpy(), nd.minimum(x, y).asnumpy()]


def _elementwise_math(mx):
    nd = mx.nd
    a = nd.array([1.0, 4.0, 9.0])
    return [nd.sqrt(a).asnumpy(), nd.square(a).asnumpy(),
            nd.log(nd.exp(a)).asnumpy(),
            nd.sigmoid(nd.zeros((2,))).asnumpy(),
            nd.relu(nd.array([-1.0, 1.0])).asnumpy(),
            nd.tanh(nd.zeros((2,))).asnumpy()]


def _random_ops(mx):
    nd = mx.nd
    mx.random.seed(42)
    a = nd.random.uniform(0, 1, shape=(100,))
    assert 0 <= a.asnumpy().min() and a.asnumpy().max() <= 1
    mx.random.seed(42)
    b = nd.random.uniform(0, 1, shape=(100,))
    assert np.array_equal(a.asnumpy(), b.asnumpy())
    n = nd.random.normal(0, 1, shape=(1000,))
    assert abs(float(n.asnumpy().mean())) < 0.2
    r = nd.random.randint(0, 10, shape=(50,))
    assert r.asnumpy().min() >= 0 and r.asnumpy().max() < 10
    return [a.shape, n.shape, r.shape]      # the draws are each package's


CASES = {f.__name__.lstrip('_'): f for f in (
    _creation, _arithmetic, _comparison, _inplace, _indexing,
    _reshape_transpose, _reductions, _dot, _concat_split_stack, _slice_ops,
    _take_one_hot_pick, _topk_sort, _cast_copy_context, _broadcast,
    _where_clip, _elementwise_math, _random_ops)}


@pytest.mark.parametrize('case', sorted(CASES))
def test_ndarray_matches_jax(case):
    want = CASES[case](jmx)
    with pmx.cpu():
        got = CASES[case](pmx)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert tuple(g) == w
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, case
        if w.dtype.kind in 'OUS':
            assert (g == w).all(), case
            continue
        np.testing.assert_allclose(
            g.astype(np.float64), w.astype(np.float64), rtol=0,
            atol=TOL * max(1.0, float(np.abs(w.astype(np.float64)).max())),
            err_msg=case)


def _arrays(mx):
    rs = np.random.RandomState(1)
    return {'w': mx.nd.array(rs.randn(3, 4).astype('float32')),
            'b': mx.nd.array(rs.randn(4).astype('float32')),
            'i': mx.nd.array(np.arange(6, dtype='int32').reshape(2, 3),
                             dtype='int32'),
            'h': mx.nd.array(rs.randn(5).astype('float16'),
                             dtype='float16')}


def test_params_files_are_byte_identical(tmp_path):
    """The same arrays saved by both packages: the same bytes, a dict and
    a list."""
    jf, pf = str(tmp_path / 'j.params'), str(tmp_path / 'p.params')
    jmx.nd.save(jf, _arrays(jmx))
    with pmx.cpu():
        pmx.nd.save(pf, _arrays(pmx))
    assert open(jf, 'rb').read() == open(pf, 'rb').read()
    jmx.nd.save(jf, list(_arrays(jmx).values()))
    with pmx.cpu():
        pmx.nd.save(pf, list(_arrays(pmx).values()))
    assert open(jf, 'rb').read() == open(pf, 'rb').read()


def test_params_files_cross_both_ways(tmp_path):
    """A file of either package loads in the other, values and dtypes
    kept."""
    jf, pf = str(tmp_path / 'j.params'), str(tmp_path / 'p.params')
    jmx.nd.save(jf, _arrays(jmx))
    with pmx.cpu():
        pmx.nd.save(pf, _arrays(pmx))
        mine = pmx.nd.load(jf)
    theirs = jmx.nd.load(pf)
    for k in ('w', 'b', 'i', 'h'):
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k].asnumpy(),
                                      theirs[k].asnumpy())
    assert sorted(mine) == sorted(theirs) == ['b', 'h', 'i', 'w']


def test_bf16_saves_as_float32(tmp_path):
    """A bf16 array goes into the file as float32, in both packages."""
    jf, pf = str(tmp_path / 'j.params'), str(tmp_path / 'p.params')
    vals = np.array([1.5, -2.25, 3.0], np.float32)
    jmx.nd.save(jf, {'x': jmx.nd.array(vals, dtype='bfloat16')})
    with pmx.cpu():
        pmx.nd.save(pf, {'x': pmx.nd.array(vals, dtype='bfloat16')})
    assert open(jf, 'rb').read() == open(pf, 'rb').read()


def test_generated_namespace_covers_the_registry():
    """``mx.nd.<name>`` exists for every registered op name."""
    from mxnet_tpu_torch.ops import registry
    missing = [n for n in registry.list_ops() if not hasattr(pmx.nd, n)]
    assert missing == []

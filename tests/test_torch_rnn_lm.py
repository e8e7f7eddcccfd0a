"""Port parity of the RNN-LM family's math: the fused ``rnn`` op
(``mxnet_tpu/ops/nn.py:1151-1297``), gluon's ``RNN`` / ``LSTM`` / ``GRU``
layers (``mxnet_tpu/gluon/rnn/rnn_layer.py``) and the decode model
``RNNLM`` (``mxnet_tpu/serving/decode/model.py:107-254``) of
``mxnet_tpu_torch`` against the JAX package's, on the same numpy inputs
and weights, both on the CPU.

Tolerances: outputs, states and logits within 1e-5 absolute (float32
products and sigmoid / tanh summed and rounded in another order by each
framework over a handful of steps); greedy tokens equal; the packed
layout and the parameter count exactly equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon import rnn as jax_rnn
from mxnet_tpu.ops import nn as jax_ops
from mxnet_tpu.serving.decode.model import init_rnn_lm as jax_init_rnn
from mxnet_tpu_torch.gluon import rnn as port_rnn
from mxnet_tpu_torch.gluon.block import params_from_jax as gluon_from_jax
from mxnet_tpu_torch.ops import nn as port_ops
from mxnet_tpu_torch.serving.decode import (RNNLM, init_rnn_lm,
                                            model_from_config,
                                            params_from_jax)

torch.set_num_threads(1)

TOL = 1e-5
MODES = ('lstm', 'gru', 'rnn_relu', 'rnn_tanh')
T, B, I, H = 7, 3, 5, 6
LM = dict(vocab=19, embed=8, hidden=12, layers=2, max_len=32)


def _op_inputs(mode, layers, bidirectional, seed=0):
    rs = np.random.RandomState(seed)
    D = 2 if bidirectional else 1
    n = jax_ops.rnn_param_size(mode, layers, I, H, bidirectional)
    args = [rs.randn(T, B, I).astype('float32'),
            (rs.randn(n) * 0.3).astype('float32'),
            rs.randn(layers * D, B, H).astype('float32')]
    if mode == 'lstm':
        args.append(rs.randn(layers * D, B, H).astype('float32'))
    return args


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want.asnumpy() if hasattr(want, 'asnumpy') else want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=what)


# -- the fused op -------------------------------------------------------------


@pytest.mark.parametrize('state_outputs', [True, False])
@pytest.mark.parametrize('bidirectional', [False, True])
@pytest.mark.parametrize('layers', [1, 2])
@pytest.mark.parametrize('mode', MODES)
def test_rnn_op_matches_jax(mode, layers, bidirectional, state_outputs):
    args = _op_inputs(mode, layers, bidirectional)
    kw = dict(state_size=H, num_layers=layers, bidirectional=bidirectional,
              mode=mode, state_outputs=state_outputs)
    want = jax_ops.rnn([jnp.asarray(a) for a in args], **kw)
    got = port_ops.rnn(*[torch.tensor(a) for a in args], **kw)
    if not state_outputs:
        want, got = (want,), (got,)
    assert len(got) == len(want) == (
        1 if not state_outputs else 3 if mode == 'lstm' else 2)
    D = 2 if bidirectional else 1
    assert tuple(got[0].shape) == (T, B, H * D)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 'output %d' % i)


@pytest.mark.parametrize('bidirectional', [False, True])
@pytest.mark.parametrize('layers', [1, 2])
@pytest.mark.parametrize('mode', MODES)
def test_rnn_param_size_and_unpacked_layout_equal(mode, layers,
                                                  bidirectional):
    n = jax_ops.rnn_param_size(mode, layers, I, H, bidirectional)
    assert port_ops.rnn_param_size(mode, layers, I, H, bidirectional) == n
    flat = np.arange(n, dtype='float32')
    jw, jb = jax_ops._rnn_unpack_params(jnp.asarray(flat), mode, layers, I,
                                        H, bidirectional)
    pw, pb = port_ops._rnn_unpack_params(torch.tensor(flat), mode, layers, I,
                                         H, bidirectional)
    for jl, pl in zip(jw + jb, pw + pb):
        for jd, pd in zip(jl, pl):
            for a, b in zip(jd, pd):
                assert np.array_equal(b.numpy(), np.asarray(a))
    # the pieces cover the vector once, in order
    covered = np.concatenate([t.numpy().reshape(-1) for layer in pw + pb
                              for d in layer for t in d])
    assert np.array_equal(covered, flat)
    pieces = [torch.tensor(flat[:3]), torch.tensor(flat[3:].reshape(-1, 1))]
    assert np.array_equal(port_ops._rnn_param_concat(*pieces).numpy(), flat)


@pytest.mark.parametrize('arg,value', [
    ('p', 0.5), ('projection_size', 4), ('lstm_state_clip_min', -1.0),
    ('lstm_state_clip_max', 1.0), ('lstm_state_clip_nan', True),
    ('use_sequence_length', True)])
def test_rnn_refuses_the_arguments_the_jax_op_ignores(arg, value):
    args = [torch.tensor(a) for a in _op_inputs('lstm', 1, False)]
    with pytest.raises(NotImplementedError, match=arg):
        port_ops.rnn(*args, state_size=H, mode='lstm', **{arg: value})
    # the default value runs
    port_ops.rnn(*args, state_size=H, mode='lstm',
                 **{arg: dict(port_ops._RNN_UNPORTED)[arg]})


def test_rnn_refuses_an_lstm_without_its_cell_and_an_unknown_mode():
    args = [torch.tensor(a) for a in _op_inputs('lstm', 1, False)]
    with pytest.raises(ValueError, match='state_cell'):
        port_ops.rnn(*args[:3], state_size=H, mode='lstm')
    with pytest.raises(ValueError, match='mode'):
        port_ops.rnn_param_size('elman', 1, I, H, False)


# -- gluon's fused layers -----------------------------------------------------


def _layers(kind, layout, bidirectional, layers=2):
    """A JAX layer (initialised from a seed) and the port's, filled from
    its ``collect_params()`` by ``gluon.block.params_from_jax``."""
    mx.random.seed(3)
    kw = dict(num_layers=layers, layout=layout, bidirectional=bidirectional,
              input_size=I)
    if kind.startswith('rnn_'):
        act = kind[4:]
        jl = jax_rnn.RNN(H, activation=act, **kw)
        pl = port_rnn.RNN(H, activation=act, device='cpu', **kw)
    else:
        cls = {'lstm': 'LSTM', 'gru': 'GRU'}[kind]
        jl = getattr(jax_rnn, cls)(H, **kw)
        pl = getattr(port_rnn, cls)(H, device='cpu', **kw)
    jl.initialize(mx.init.Uniform(0.3))
    gluon_from_jax({k: v.data().asnumpy()
                    for k, v in jl.collect_params().items()}, pl)
    return jl, pl


@pytest.mark.parametrize('bidirectional', [False, True])
@pytest.mark.parametrize('layout', ['TNC', 'NTC'])
@pytest.mark.parametrize('kind', MODES)
def test_gluon_layer_matches_jax(kind, layout, bidirectional):
    jl, pl = _layers(kind, layout, bidirectional)
    rs = np.random.RandomState(5)
    shape = (T, B, I) if layout == 'TNC' else (B, T, I)
    x = rs.randn(*shape).astype('float32')
    # no states: the output alone, from begin_state's zeros
    _close(pl(torch.tensor(x)), jl(nd.array(x)), 'output without states')
    # begin_state, then random states: the output and the new states
    jstates = jl.begin_state(batch_size=B)
    pstates = pl.begin_state(batch_size=B)
    assert [tuple(s.shape) for s in pstates] == \
        [tuple(s.shape) for s in jstates]
    assert all(not s.any() for s in pstates)
    for states in ([s.asnumpy() for s in jstates],
                   [rs.randn(*s.shape).astype('float32') for s in jstates]):
        jout, jnew = jl(nd.array(x), [nd.array(s) for s in states])
        pout, pnew = pl(torch.tensor(x), [torch.tensor(s) for s in states])
        _close(pout, jout, 'output')
        assert len(pnew) == len(jnew)
        for i, (a, b) in enumerate(zip(pnew, jnew)):
            _close(a, b, 'state %d' % i)


def test_gluon_layer_names_states_and_refusals():
    jl, pl = _layers('rnn_tanh', 'TNC', True)
    # the JAX names, its auto prefix (rnn_tanh0_) stripped, in its order
    assert list(pl.collect_params()) == [
        k[len(jl.prefix):] for k in jl.collect_params()]
    assert repr(pl) == 'RNN(5 -> 6, TNC, num_layers=2, bidirectional)'
    with pytest.raises(ValueError, match='Invalid recurrent state shape'):
        pl(torch.zeros(T, B, I), [torch.zeros(4, B + 1, H)])
    with pytest.raises(ValueError, match='layout'):
        port_rnn.GRU(H, layout='TCN', input_size=I, device='cpu')
    with pytest.raises(ValueError, match='input_size'):
        port_rnn.GRU(H, device='cpu')
    with pytest.raises(NotImplementedError, match='projection_size'):
        port_rnn.LSTM(H, input_size=I, projection_size=3, device='cpu')
    # dropout is the identity in inference and not ported in training
    drop = port_rnn.LSTM(H, num_layers=2, dropout=0.5, input_size=I,
                         device='cpu')
    with torch.no_grad():
        for p in drop.parameters():
            p.uniform_(-0.3, 0.3)
    drop(torch.zeros(T, B, I))
    drop.train()
    with pytest.raises(NotImplementedError, match='p=0.5'):
        drop(torch.zeros(T, B, I))


# -- the decode model ---------------------------------------------------------


def _jax_params(np_params):
    return {k: jnp.asarray(v) for k, v in np_params.items()}


@pytest.mark.parametrize('mode', MODES)
def test_init_params_same_draws_as_jax(mode):
    jmodel, np_params = jax_init_rnn(mode=mode, seed=2, **LM)
    pmodel, mine = init_rnn_lm(mode=mode, seed=2, **LM)
    assert sorted(mine) == sorted(np_params)
    for k, v in np_params.items():
        assert np.array_equal(mine[k], v), k
    assert pmodel.cache_spec().entries == jmodel.cache_spec().entries
    assert model_from_config('rnn_lm', pmodel.config).config == \
        pmodel.config


@pytest.mark.parametrize('mode', MODES)
def test_rnnlm_prefill_step_full_forward_match_jax(mode):
    jmodel, np_params = jax_init_rnn(mode=mode, seed=1, **LM)
    pmodel = RNNLM(jmodel.config)
    jp, pp = _jax_params(np_params), params_from_jax(np_params, 'cpu')
    rs = np.random.RandomState(7)
    tokens = rs.randint(0, LM['vocab'], size=(2, 9)).astype('int32')
    _close(pmodel.full_forward(pp, torch.tensor(tokens).long()),
           jmodel.full_forward(jp, jnp.asarray(tokens)), 'full_forward')
    # a 5-token prompt padded to 8, landed in slot 1 of 3
    slots, length, slot = 3, 5, 1
    padded = np.zeros((1, 8), 'int32')
    padded[0, :length] = tokens[0, :length]
    from mxnet_tpu.serving.decode.cache import init_cache as jax_init_cache
    from mxnet_tpu_torch.serving.decode.cache import init_cache
    jcache = jax_init_cache(jmodel.cache_spec(), slots)
    pcache = init_cache(pmodel.cache_spec(), slots, torch.device('cpu'))
    jcache, jl = jmodel.prefill(jp, jcache, jnp.asarray(padded),
                                jnp.asarray(length, 'int32'),
                                jnp.asarray(slot, 'int32'))
    pcache, pl = pmodel.prefill(pp, pcache, torch.tensor(padded).long(),
                                torch.tensor([length], dtype=torch.int32),
                                torch.tensor([slot], dtype=torch.int32))
    _close(pl, jl, 'prefill logits')
    for k in jcache:
        _close(pcache[k], jcache[k], 'cache %s after prefill' % k)
    # two steps of every slot
    for step in range(2):
        toks = rs.randint(0, LM['vocab'], size=slots).astype('int32')
        pos = np.full(slots, length + step, 'int32')
        jcache, jl = jmodel.step(jp, jcache, jnp.asarray(toks),
                                 jnp.asarray(pos))
        pcache, pl = pmodel.step(pp, pcache, torch.tensor(toks).long(),
                                 torch.tensor(pos))
        _close(pl, jl, 'step %d logits' % step)
        for k in jcache:
            _close(pcache[k], jcache[k], 'cache %s after step %d' % (k, step))


@pytest.mark.parametrize('mode', MODES)
def test_cached_decode_equals_full_forward(mode):
    """The twin of ``tests/test_decode.py:109`` over every mode: the
    greedy tokens of a prefill and steps through the program equal the
    argmax of ``full_forward`` re-run after every token; logits within
    1e-5."""
    from mxnet_tpu_torch.serving.decode import DecodeProgram
    model, params = init_rnn_lm(vocab=19, embed=8, hidden=12, layers=2,
                                mode=mode, max_len=32)
    prog = DecodeProgram(model, params, slots=3, prefill_buckets=(4, 8),
                         device='cpu')
    pp = prog.params
    prompt, n, slot = [3, 1, 4, 1, 5], 6, 1
    cache = prog.new_cache()
    cache, tok, logits = prog.run_prefill(cache, prompt, slot)
    got, got_logits, pos = [tok], [logits], len(prompt)
    while len(got) < n:
        tk = np.zeros(prog.slots, 'int32')
        ps = np.zeros(prog.slots, 'int32')
        tk[slot], ps[slot] = got[-1], pos
        cache, toks, logits = prog.run_step(cache, tk, ps)
        got.append(int(toks[slot]))
        got_logits.append(logits[slot])
        pos += 1
    toks = list(prompt)
    for t in range(n):
        ref = model.full_forward(pp, torch.tensor([toks]))[0, -1].numpy()
        assert got[t] == int(ref.argmax())
        np.testing.assert_allclose(got_logits[t], ref, atol=TOL, rtol=0)
        toks.append(got[t])


def test_params_from_jax_checks_an_rnn_dict():
    _jm, np_params = jax_init_rnn(mode='gru', seed=0, **LM)
    pp = params_from_jax(np_params, 'cpu')
    assert sorted(pp) == sorted(np_params)
    assert all(t.dtype == torch.float32 for t in pp.values())
    model = RNNLM(dict(LM, mode='gru'))
    assert sorted(params_from_jax(np_params, 'cpu', model)) \
        == sorted(np_params)
    with pytest.raises(ValueError, match='rnn_params'):
        params_from_jax(dict(np_params, rnn_params=np_params['rnn_params']
                             [:-1]), 'cpu', model)
    with pytest.raises(ValueError, match='stray'):
        params_from_jax(dict(np_params, stray=np.zeros(3, 'float32')), 'cpu',
                        model)
    with pytest.raises(ValueError, match='out_weight'):
        params_from_jax(dict(np_params, out_weight=np_params['out_weight']
                             [:-1]), 'cpu', model)
    # a program checks the mode and the layers against its model
    from mxnet_tpu_torch.serving.decode import DecodeProgram
    with pytest.raises(ValueError, match='rnn_params'):
        DecodeProgram(RNNLM(dict(LM, mode='lstm')), np_params, slots=2,
                      prefill_buckets=(8,), device='cpu')
    with pytest.raises(ValueError, match='unsupported RNN mode'):
        RNNLM(dict(LM, mode='elman'))

"""Port parity of the RNN-LM family served: ``RNNLM`` through
``freeze_decode`` -> ``DecodeProgram`` -> ``DecodeEngine`` /
``InferenceSession`` of ``mxnet_tpu_torch`` against the JAX package's
(``tests/test_decode.py``, ``tests/test_paged_decode.py``,
``tests/test_migration.py`` and ``tests/test_adapters.py``'s RNN tests),
on the same numpy weights, both on the CPU.

What is held:

  * greedy tokens through the program and the engine equal the JAX
    engine's, token for token, in every mode;
  * sampled tokens equal the JAX engine's at the same seeds, but past a
    near tie (the JAX run's top two perturbed scores within 1e-4, as
    ``tests/test_torch_sampling.py`` counts them);
  * the CPU fallback is bitwise the program's path, greedy and sampled;
  * ``freeze_decode`` of a gluon triple and of a ``word_lm``-shaped
    object serves the gluon forward's argmax (logits within 1e-5), a
    bidirectional RNN and anything else unfreezable refused;
  * the slot cache: paged requests refused typed, an RNN draft refused
    for a paged target, no adapter operand and ``adapter_rank > 0``
    refused;
  * the O(1) ``slot`` payload splices in the port and across packages
    both ways, with no prefill on the importing side;
  * an ``rnn_lm`` artifact saved by either package loads in the other and
    serves the same tokens;
  * the session and the HTTP endpoint over an RNN program.
"""
import http.client
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon import nn as jax_nn
from mxnet_tpu.gluon import rnn as jax_rnn
from mxnet_tpu.serving.decode import DecodeEngine as JaxEngine
from mxnet_tpu.serving.decode import DecodeProgram as JaxProgram
from mxnet_tpu.serving.decode import sampling as jax_sampling
from mxnet_tpu.serving.decode.model import init_rnn_lm as jax_init_rnn
from mxnet_tpu.serving.decode.program import load_decode as jax_load_decode
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon import rnn
from mxnet_tpu_torch.gluon.block import params_from_jax as gluon_from_jax
from mxnet_tpu_torch.serving.decode import (DecodeEngine, DecodeProgram,
                                            PagedDecodeProgram, RNNLM,
                                            SeqStateError, freeze_decode,
                                            from_gluon_rnn_lm, init_rnn_lm,
                                            init_transformer_lm, load_decode)

torch.set_num_threads(1)

LM = dict(vocab=23, embed=8, hidden=16, layers=2, max_len=64)
MODES = ('lstm', 'gru', 'rnn_relu', 'rnn_tanh')
ARGS = dict(slots=2, prefill_buckets=(8, 16))
PROMPTS = ([3, 5, 7, 11, 2, 9, 4, 6, 8, 10], [1, 2, 3], [7])
TEMP, TOP_P = 0.8, 0.9
MARGIN = 1e-4              # a top-2 perturbed-score gap below it: a tie
TOL = 1e-5
NEW = 12
WAIT = 60


def _weights(mode, seed=1):
    jmodel, np_params = jax_init_rnn(mode=mode, seed=seed, **LM)
    return jmodel, RNNLM(jmodel.config), np_params


def _port(pmodel, np_params, **kw):
    return DecodeProgram(pmodel, np_params, device='cpu', **dict(ARGS, **kw))


def _jax_tokens(jmodel, np_params, requests, **kw):
    eng = JaxEngine(JaxProgram(jmodel, np_params, **dict(ARGS, **kw)),
                    timeout_s=120)
    try:
        return [eng.generate(p, max_new_tokens=NEW, **law).result(120)
                for p, law in requests]
    finally:
        eng.close()


def _port_tokens(prog, requests):
    eng = DecodeEngine(prog, timeout_s=WAIT)
    try:
        return [eng.generate(p, max_new_tokens=NEW, **law).result(WAIT)
                for p, law in requests]
    finally:
        eng.close()


# -- greedy and sampled tokens against the JAX engine ------------------------


@pytest.mark.parametrize('mode', MODES)
def test_greedy_tokens_equal_jax_engine(mode):
    jmodel, pmodel, np_params = _weights(mode)
    requests = [(p, {}) for p in PROMPTS]
    want = _jax_tokens(jmodel, np_params, requests)
    prog = _port(pmodel, np_params)
    assert _port_tokens(prog, requests) == want
    # the reference's program set, no other
    assert sorted(prog.compile_seconds) == ['prefill:16', 'prefill:8',
                                            'step']


def _perturbed_margins(jmodel, np_params, prompt, out, seed):
    """The JAX run's top-2 perturbed-score gap at each served position
    (teacher-forced on ``out``; the reference's own expressions)."""
    dev = {k: jnp.asarray(v) for k, v in np_params.items()}
    toks = jnp.asarray([list(prompt) + out[:-1]], 'int32')
    logits = np.asarray(jmodel.full_forward(dev, toks))[0, len(prompt) - 1:]
    n = len(out)
    logp = jax.nn.log_softmax(jnp.asarray(logits) / TEMP, axis=-1)
    probs = jnp.exp(logp)
    order = jnp.argsort(-probs, axis=-1)
    sp = jnp.take_along_axis(probs, order, axis=-1)
    keep_sorted = (jnp.cumsum(sp, axis=-1) - sp) < TOP_P
    keep = jnp.zeros(logits.shape, bool).at[
        jnp.arange(n)[:, None], order].set(keep_sorted)
    keys = jax_sampling.keys_for(seed, range(len(prompt) - 1,
                                             len(prompt) - 1 + n))
    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (logits.shape[1],)))(
        jnp.asarray(keys))
    scores = np.asarray(jnp.where(keep, logp, -jnp.inf) + gumbel)
    top2 = np.sort(scores, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize('mode', ['lstm', 'gru'])
def test_sampled_tokens_equal_jax_engine_but_near_ties(mode):
    jmodel, pmodel, np_params = _weights(mode)
    rs = np.random.RandomState(4)
    requests = [(rs.randint(0, LM['vocab'], rs.randint(3, 15)).tolist(),
                 dict(temperature=TEMP, top_p=TOP_P, seed=s))
                for s in range(6)]
    want = _jax_tokens(jmodel, np_params, requests)
    got = _port_tokens(_port(pmodel, np_params), requests)
    near = total = compared = 0
    for (prompt, law), g, w in zip(requests, got, want):
        margins = _perturbed_margins(jmodel, np_params, prompt, w,
                                     law['seed'])
        near += int((margins <= MARGIN).sum())
        total += len(w)
        for t, (a, b) in enumerate(zip(g, w)):
            if a != b:
                assert margins[t] <= MARGIN, (law['seed'], t, margins[t])
                break
            compared += 1
    assert compared >= 0.9 * total, (compared, total, near)


@pytest.mark.parametrize('temperature', [0.0, TEMP],
                         ids=['greedy', 'sampled'])
def test_fallback_generate_bitwise_the_program_path(temperature):
    """The twin of ``tests/test_decode.py:139``: the CPU fallback (no
    adapter operand) gives the program path's tokens."""
    _jm, pmodel, np_params = _weights('lstm')
    prog = _port(pmodel, np_params)
    law = dict(temperature=temperature, top_p=TOP_P, seed=3)
    want = _port_tokens(prog, [(PROMPTS[0], law)])[0]
    assert prog.fallback_generate(PROMPTS[0], NEW, **law) == want


# -- gluon blocks frozen ------------------------------------------------------


def _gluon_blocks(mode='lstm', layers=1, bidirectional=False):
    """JAX gluon blocks initialised from a seed and the port's, filled
    with the same weights."""
    mx.random.seed(11)
    vocab, embed, hidden = 17, 8, 12
    j_emb = jax_nn.Embedding(vocab, embed)
    kw = dict(num_layers=layers, bidirectional=bidirectional,
              input_size=embed)
    if mode == 'lstm':
        j_rnn, p_rnn = jax_rnn.LSTM(hidden, **kw), \
            rnn.LSTM(hidden, device='cpu', **kw)
    else:
        j_rnn, p_rnn = jax_rnn.GRU(hidden, **kw), \
            rnn.GRU(hidden, device='cpu', **kw)
    j_dec = jax_nn.Dense(vocab, flatten=False, in_units=hidden)
    for blk in (j_emb, j_rnn, j_dec):
        blk.initialize(mx.init.Xavier())
    p_emb = nn.Embedding(vocab, embed, device='cpu')
    p_dec = nn.Dense(vocab, flatten=False, in_units=hidden, device='cpu')
    gluon_from_jax({k: v.data().asnumpy()
                    for k, v in j_rnn.collect_params().items()}, p_rnn)
    with torch.no_grad():
        p_emb.weight.copy_(torch.tensor(j_emb.weight.data().asnumpy()))
        p_dec.weight.copy_(torch.tensor(j_dec.weight.data().asnumpy()))
        p_dec.bias.copy_(torch.tensor(j_dec.bias.data().asnumpy()))
    return (j_emb, j_rnn, j_dec), (p_emb, p_rnn, p_dec)


class _WordLM:
    """``examples/word_lm.py``'s ``RNNModel`` shape: the three blocks as
    attributes."""

    def __init__(self, embedding, lstm, decoder):
        self.embedding, self.lstm, self.decoder = embedding, lstm, decoder


@pytest.mark.parametrize('form', ['triple', 'word_lm'])
@pytest.mark.parametrize('mode', ['lstm', 'gru'])
def test_freeze_decode_of_gluon_blocks_matches_gluon_forward(mode, form):
    """The twin of ``tests/test_decode.py:577``: the program's first
    token and logits are the gluon forward's at the last position (the
    JAX blocks' and the port's), and the cached stream equals
    ``full_forward`` re-run after every token."""
    jblocks, pblocks = _gluon_blocks(mode, layers=2)
    prompt = [3, 1, 4, 1, 5]
    x = np.asarray(prompt, 'float32')[:, None]                # (T, B=1)
    j_emb, j_rnn, j_dec = jblocks
    out, _ = j_rnn(j_emb(nd.array(x)), j_rnn.begin_state(batch_size=1))
    jax_logits = j_dec(out).asnumpy()[:, 0]                     # (T, V)
    p_emb, p_rnn, p_dec = pblocks
    with torch.no_grad():
        port_logits = p_dec(p_rnn(p_emb(torch.tensor(x).long())))[:, 0]
    np.testing.assert_allclose(port_logits.numpy(), jax_logits, atol=TOL,
                               rtol=0)
    obj = pblocks if form == 'triple' else _WordLM(*pblocks)
    prog = freeze_decode(obj, max_len=32, slots=2, prefill_buckets=(8,),
                         device='cpu')
    assert type(prog) is DecodeProgram and prog.model.mode == mode
    assert prog.max_len == 32 and prog.model.layers == 2
    cache = prog.new_cache()
    cache, tok, logits = prog.run_prefill(cache, prompt, 0)
    np.testing.assert_allclose(logits, jax_logits[-1], atol=TOL, rtol=0)
    assert tok == int(jax_logits[-1].argmax())
    got = _port_tokens(prog, [(prompt, {})])[0]
    toks = list(prompt)
    for t in got:
        ref = prog.model.full_forward(prog.params, torch.tensor([toks]))
        assert t == int(ref[0, -1].argmax())
        toks.append(t)


def test_from_gluon_rnn_lm_refusals_and_knob(monkeypatch):
    _jb, (p_emb, p_rnn, p_dec) = _gluon_blocks()
    model, params = from_gluon_rnn_lm(p_emb, p_rnn, p_dec, max_len=40)
    assert model.config == dict(vocab=17, embed=8, hidden=12, layers=1,
                                mode='lstm', max_len=40)
    assert sorted(params) == ['embed_weight', 'out_bias', 'out_weight',
                              'rnn_params']
    _jb, (b_emb, b_rnn, b_dec) = _gluon_blocks(bidirectional=True)
    with pytest.raises(ValueError, match='unidirectional'):
        from_gluon_rnn_lm(b_emb, b_rnn, b_dec)
    with pytest.raises(ValueError, match='unidirectional'):
        freeze_decode((b_emb, b_rnn, b_dec), device='cpu')
    wrong = nn.Dense(5, flatten=False, in_units=12, device='cpu')
    with pytest.raises(ValueError, match='does not map'):
        from_gluon_rnn_lm(p_emb, p_rnn, wrong)
    for bad in (object(), (p_emb, p_rnn), _WordLM(p_emb, None, p_dec)):
        with pytest.raises(TypeError, match='cannot freeze'):
            freeze_decode(bad, device='cpu')
    # max_len defaults to MXNET_TPU_SERVE_MAX_SEQ_LEN, as in the reference
    monkeypatch.setenv('MXNET_TPU_SERVE_MAX_SEQ_LEN', '48')
    prog = freeze_decode((p_emb, p_rnn, p_dec), prefill_buckets=(8,),
                         device='cpu')
    assert prog.max_len == 48


# -- the slot cache only ------------------------------------------------------


def test_paged_refused_typed_and_slot_by_default(tmp_path):
    """The twins of ``tests/test_paged_decode.py:263, 274``."""
    _jm, pmodel, np_params = _weights('lstm')
    with pytest.raises(TypeError, match='paged'):
        PagedDecodeProgram(pmodel, np_params, device='cpu', **ARGS)
    with pytest.raises(TypeError, match='paged'):
        freeze_decode(pmodel, np_params, paged=True, device='cpu', **ARGS)
    prog = freeze_decode(pmodel, np_params, device='cpu', **ARGS)
    assert type(prog) is DecodeProgram and not prog.paged
    # a saved slot artifact reloads as a slot program
    again = load_decode(prog.save(str(tmp_path / 'slot.frozen')),
                        device='cpu')
    assert type(again) is DecodeProgram and not again.paged


def test_rnn_draft_refused_for_a_paged_target():
    """The twin of ``tests/test_paged_decode.py:607-622``: an RNN cannot
    roll back rejected proposals."""
    tmodel, tparams = init_transformer_lm(vocab=23, units=16, hidden=24,
                                          layers=1, heads=2, max_len=32)
    target = PagedDecodeProgram(tmodel, tparams, slots=2,
                                prefill_buckets=(4,), page_size=8, spec_k=2,
                                device='cpu')
    rmodel, rparams = init_rnn_lm(vocab=23, embed=8, hidden=12, layers=1,
                                  max_len=32)
    draft = DecodeProgram(rmodel, rparams, slots=2, prefill_buckets=(4,),
                          device='cpu')
    with pytest.raises(ValueError, match='roll back'):
        DecodeEngine(target, draft=draft)


def test_rnn_samples_without_adapter_operand_and_refuses_adapters():
    """The twin of ``tests/test_adapters.py:282``."""
    model, params = init_rnn_lm(vocab=LM['vocab'], embed=16, hidden=24,
                                layers=1, max_len=64, seed=3)
    prog = freeze_decode(model, params, slots=2, prefill_buckets=(16,),
                         paged=False, sample_args=True, device='cpu')
    assert prog.sample_args and prog.apool is None
    with DecodeEngine(prog, name='rnn-sample') as eng:
        greedy = list(eng.generate(PROMPTS[0], max_new_tokens=6))
        a = list(eng.generate(PROMPTS[0], max_new_tokens=6, temperature=0.9,
                              seed=11))
        b = list(eng.generate(PROMPTS[0], max_new_tokens=6, temperature=0.9,
                              seed=11))
    assert len(greedy) == 6 and a == b
    with pytest.raises(TypeError, match='no LoRA targets'):
        freeze_decode(model, params, adapter_rank=4, device='cpu', **ARGS)


# -- migration: the O(1) slot payload -----------------------------------------


def _export_after_first_token(eng, prompt, n):
    s = eng.generate(prompt, max_new_tokens=n)
    next(iter(s))
    payload = eng.export_sequence(s, timeout=30)
    assert s.finish_reason == 'migrated'
    return payload


def _continue_on(dst, payload):
    return list(payload['emitted']) + list(dst.import_sequence(payload,
                                                               timeout=30))


def test_slot_state_exports_o1_and_splices():
    """The twin of ``tests/test_migration.py:187``: the recurrent state
    travels (no KV rows), and the continuation is the unmigrated
    stream; a neighbour's state is untouched."""
    _jm, pmodel, np_params = _weights('lstm')
    want = _port_tokens(_port(pmodel, np_params), [(PROMPTS[0], {}),
                                                   (PROMPTS[1], {})])
    src = DecodeEngine(_port(pmodel, np_params), timeout_s=WAIT)
    dst = DecodeEngine(_port(pmodel, np_params), timeout_s=WAIT)
    try:
        neighbour = src.generate(PROMPTS[1], max_new_tokens=NEW)
        payload = _export_after_first_token(src, PROMPTS[0], NEW)
        assert payload['kind'] == 'slot'
        assert sorted(payload['entries']) == ['c', 'h']
        assert all(e['shape'] == [LM['layers'], LM['hidden']]
                   for e in payload['entries'].values())
        assert _continue_on(dst, payload) == want[0]
        assert neighbour.result(WAIT) == want[1]
        assert dst.stats()['counts']['prefills'] == 0
        assert src.stats()['counts']['migrated_out'] == 1
        assert dst.stats()['counts']['migrated_in'] == 1
        # a slot payload cannot land in a paged engine
        tmodel, tparams = init_transformer_lm(vocab=23, units=16, hidden=24,
                                              layers=1, heads=2, max_len=64)
        paged = DecodeEngine(PagedDecodeProgram(
            tmodel, tparams, page_size=8, pages=16, device='cpu', **ARGS),
            timeout_s=WAIT)
        try:
            with pytest.raises(SeqStateError):
                paged.import_sequence(_export_after_first_token(
                    src, PROMPTS[0], NEW))
        finally:
            paged.close()
    finally:
        src.close()
        dst.close()


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
@pytest.mark.parametrize('mode', ['lstm', 'gru'])
def test_slot_payload_continues_across_packages(mode, direction):
    jmodel, pmodel, np_params = _weights(mode)
    want = _jax_tokens(jmodel, np_params, [(PROMPTS[0], {})])[0]
    jeng = JaxEngine(JaxProgram(jmodel, np_params, **ARGS), timeout_s=120)
    peng = DecodeEngine(_port(pmodel, np_params), timeout_s=WAIT)
    src, dst = (jeng, peng) if direction == 'jax_to_port' else (peng, jeng)
    try:
        payload = _export_after_first_token(src, PROMPTS[0], NEW)
        assert payload['kind'] == 'slot'
        got = list(payload['emitted']) + list(dst.import_sequence(
            json.loads(json.dumps(payload)), timeout=120))
        assert got == want
        assert dst.stats()['counts']['prefills'] == 0
        assert dst.stats()['counts']['migrated_in'] == 1
    finally:
        jeng.close()
        peng.close()


# -- artifacts ----------------------------------------------------------------


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_rnn_lm_artifact_crosses_packages(writer, tmp_path):
    jmodel, pmodel, np_params = _weights('gru')
    requests = [(p, {}) for p in PROMPTS]
    want = _jax_tokens(jmodel, np_params, requests)
    art = str(tmp_path / 'rnn.frozen')
    if writer == 'jax':
        JaxProgram(jmodel, np_params, **ARGS).save(
            art, include_programs=False)
        prog = load_decode(art, device='cpu')
        assert type(prog) is DecodeProgram
        assert prog.model.config == jmodel.config
        assert prog.warmup().compile_count == 3
        assert _port_tokens(prog, requests) == want
        return
    _port(pmodel, np_params).save(art)
    again = jax_load_decode(art)
    assert type(again) is JaxProgram
    eng = JaxEngine(again, timeout_s=120)
    try:
        assert [eng.generate(p, max_new_tokens=NEW).result(120)
                for p, _ in requests] == want
    finally:
        eng.close()


# -- the session and the endpoint ---------------------------------------------


def test_session_and_http_endpoint_over_an_rnn_program():
    _jm, pmodel, np_params = _weights('lstm')
    want = _port_tokens(_port(pmodel, np_params), [(PROMPTS[0], {})])[0]
    with serving.InferenceSession(_port(pmodel, np_params),
                                  timeout_s=WAIT) as sess, \
            serving.ServingHTTPServer(sess, 0) as srv:
        assert sess.generate(PROMPTS[0], max_new_tokens=NEW).result(
            WAIT) == want
        conn = http.client.HTTPConnection('127.0.0.1', srv.port, timeout=30)
        try:
            conn.request('POST', '/generate', body=json.dumps(
                {'tokens': PROMPTS[0], 'max_new_tokens': NEW}).encode(),
                headers={'Content-Type': 'application/json'})
            resp = conn.getresponse()
            lines = [json.loads(ln) for ln in
                     resp.read().decode().strip().split('\n')]
        finally:
            conn.close()
        assert resp.status == 200
        assert lines[-1] == {'done': True, 'tokens': want,
                             'finish_reason': 'length', 'degraded': False}
        assert sess.status()['status'] == 'ok'

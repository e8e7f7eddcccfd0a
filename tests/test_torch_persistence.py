"""Port parity of frozen-artifact persistence: ``DecodeProgram.save`` /
``load`` / ``load_decode``, ``FrozenProgram.save`` / ``load`` and
``load_frozen`` of ``mxnet_tpu_torch.serving`` against the JAX package's
(``mxnet_tpu/serving/freeze.py``, ``mxnet_tpu/serving/decode/program.py``).

A small causal LM (vocab 50, units 32, 2 layers, 4 heads, max_len 64) from
a numpy seed, its adapters, and a tiny SSD from the port's zoo. What is
held:

  * a JAX-written decode artifact (``include_programs=False``), slot and
    paged with ``spec_k``, sampling, the logit mask and an adapter pool,
    loads in the port as the same class, ladders, geometry and extras;
    its greedy tokens equal the JAX program's token for token, its sampled
    tokens equal them but at near-ties (the JAX run's top two perturbed
    scores within 1e-4, as ``tests/test_torch_sampling.py`` counts them);
  * a port-written artifact loads in the JAX package with the same tokens,
    and every manifest key both writers emit is equal, but the provenance
    keys and ``programs``;
  * a round trip in a fresh ``sys.executable`` process gives the same
    tokens, and the reloaded program's ``compile_count`` after
    ``warmup()`` is the reference's program set, no request adding to it;
  * the reference's rejection and dispatch tests, mirrored
    (``tests/test_serving.py:356``, ``tests/test_decode.py:189``,
    ``tests/test_paged_decode.py:262``, ``tests/test_adapters.py:133``);
    a one-shot block without a zoo stamp and a JAX-written one-shot
    artifact raise NotImplementedError; a JAX-written ``rnn_lm`` artifact
    loads as a slot program serving the JAX program's tokens;
  * a one-shot round trip (tiny SSD, ResNet, BERT) is bitwise the
    in-memory program, and its ``aux:`` keys are exactly the moving
    statistics.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import serving as jax_serving
from mxnet_tpu.serving import adapters as jax_adapters
from mxnet_tpu.serving.decode import engine as jax_engine
from mxnet_tpu.serving.decode import DecodeProgram as JaxDecodeProgram
from mxnet_tpu.serving.decode import sampling as jax_sampling
from mxnet_tpu.serving.decode.model import init_rnn_lm as jax_init_rnn
from mxnet_tpu.serving.decode.model import \
    init_transformer_lm as jax_init_lm
from mxnet_tpu.serving.decode.program import \
    freeze_decode as jax_freeze_decode
from mxnet_tpu.serving.decode.program import load_decode as jax_load_decode
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import bert, resnet, ssd, stamp
from mxnet_tpu_torch.serving import adapters
from mxnet_tpu_torch.serving.decode import (DecodeEngine, DecodeProgram,
                                            PagedDecodeProgram,
                                            init_transformer_lm, load_decode,
                                            model_from_config)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CFG = dict(vocab=50, units=32, hidden=48, layers=2, heads=4, max_len=64)
BUCKETS = (8, 16)
RANK = 4
TEMP, TOP_P = 0.8, 0.9
MARGIN = 1e-4              # a top-2 perturbed-score gap below it: a tie
NEW = 10
WAIT = 120
PROVENANCE = {'jax_version', 'platform', 'pallas', 'donate',
              'torch_version', 'device', 'programs'}
# (name, freeze_decode arguments): the slot program, and the paged one
# with speculation, sampling, the mask and an adapter pool
LAYOUTS = {
    'slot': dict(slots=3, prefill_buckets=BUCKETS, paged=False),
    'paged': dict(slots=3, prefill_buckets=BUCKETS, paged=True, page_size=8,
                  spec_k=2, sample_args=True, logit_mask=True,
                  adapter_rank=RANK, adapter_slots=3),
}


@pytest.fixture(scope='module')
def weights():
    jmodel, np_params = jax_init_lm(**CFG)
    pmodel, _ = init_transformer_lm(**CFG)
    return jmodel, pmodel, np_params


def _requests(n=4, seed=4):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, CFG['vocab'], rs.randint(3, 15)).tolist()
            for _ in range(n)]


def _jax_tokens(prog, requests, **kw):
    eng = jax_engine.DecodeEngine(prog, timeout_s=WAIT)
    try:
        return [eng.generate(p, max_new_tokens=NEW, seed=s, **kw).result(WAIT)
                for s, p in enumerate(requests)]
    finally:
        eng.close()


def _port_tokens(prog, requests, **kw):
    eng = DecodeEngine(prog, timeout_s=WAIT)
    try:
        return [eng.generate(p, max_new_tokens=NEW, seed=s, **kw).result(WAIT)
                for s, p in enumerate(requests)]
    finally:
        eng.close()


def _manifest(path):
    with open(os.path.join(path, 'MANIFEST.json')) as f:
        return json.load(f)


def _same_program(a, b):
    """The class, ladders, geometry and extras of two programs."""
    assert type(a) is type(b)
    assert (a.slots, tuple(a.prefill_buckets), a.max_len, a.emit_logits,
            a.sample_args, a.logit_mask, a.name) == \
        (b.slots, tuple(b.prefill_buckets), b.max_len, b.emit_logits,
         b.sample_args, b.logit_mask, b.name)
    assert a.adapter_spec == b.adapter_spec
    assert a.model.config == b.model.config
    if a.paged:
        assert (a.page_size, a.pages, a.max_pages, a.spec_k) == \
            (b.page_size, b.pages, b.max_pages, b.spec_k)


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


# -- (1) a JAX-written decode artifact in the port -----------------------------


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_jax_decode_artifact_loads_in_the_port(weights, tmp_path, layout):
    jmodel, _pm, np_params = weights
    jprog = jax_freeze_decode(jmodel, np_params, **LAYOUTS[layout])
    art = jprog.save(str(tmp_path / 'jax.frozen'), include_programs=False)
    got = load_decode(art, device='cpu')
    assert type(got) is (PagedDecodeProgram if layout == 'paged'
                         else DecodeProgram)
    assert (got.slots, tuple(got.prefill_buckets), got.max_len,
            got.emit_logits, got.sample_args, got.logit_mask, got.name) == \
        (jprog.slots, tuple(jprog.prefill_buckets), jprog.max_len,
         jprog.emit_logits, jprog.sample_args, jprog.logit_mask, jprog.name)
    if layout == 'paged':
        assert (got.page_size, got.pages, got.max_pages, got.spec_k) == \
            (jprog.page_size, jprog.pages, jprog.max_pages, jprog.spec_k)
        assert got.adapter_spec.to_manifest() == \
            jprog.adapter_spec.to_manifest()
        assert got.page_bytes() == jprog.page_bytes()
    else:
        assert got.adapter_spec is None
    assert got.cache_bytes() == jprog.cache_bytes()
    assert got.retraced_buckets == [] and got.compile_count == 0
    for k, v in np_params.items():
        assert np.array_equal(got._params_host[k].numpy(), v), k
    reqs = _requests()
    assert _port_tokens(got, reqs) == _jax_tokens(jprog, reqs)


def test_jax_decode_artifact_sampled_tokens_equal_but_at_near_ties(
        weights, tmp_path):
    jmodel, _pm, np_params = weights
    jprog = jax_freeze_decode(jmodel, np_params, **LAYOUTS['paged'])
    art = jprog.save(str(tmp_path / 'jax.frozen'), include_programs=False)
    reqs = _requests(6, seed=7)
    want = _jax_tokens(jprog, reqs, temperature=TEMP, top_p=TOP_P)
    got = _port_tokens(load_decode(art, device='cpu'), reqs,
                       temperature=TEMP, top_p=TOP_P)
    near = total = compared = 0
    for seed, (prompt, g, w) in enumerate(zip(reqs, got, want)):
        margins = _perturbed_margins(jmodel, np_params, prompt, w, seed)
        near += int((margins <= MARGIN).sum())
        total += len(w)
        for t, (a, b) in enumerate(zip(g, w)):
            if a != b:
                assert margins[t] <= MARGIN, (seed, t, margins[t])
                break
            compared += 1
    assert near < 0.05 * total, (near, total)
    assert compared >= 0.9 * total, (compared, total)


def test_jax_program_table_keys_land_in_retraced_buckets(weights, tmp_path):
    """A JAX artifact's serialized executables do not deserialize in the
    port: every key of its ``programs`` table is listed, and warmup()
    builds the reference's set."""
    jmodel, _pm, np_params = weights
    jprog = jax_freeze_decode(jmodel, np_params, **LAYOUTS['slot'])
    art = jprog.save(str(tmp_path / 'jax.frozen'), include_programs=False)
    doc = _manifest(art)
    doc['programs'] = {'prefill:8': 'programs/prefill_8.bin',
                       'step': 'programs/step.bin'}
    with open(os.path.join(art, 'MANIFEST.json'), 'w') as f:
        json.dump(doc, f)
    got = load_decode(art, device='cpu')
    assert got.retraced_buckets == ['prefill:8', 'step']
    got.warmup()
    assert sorted(got.compile_seconds) == ['prefill:16', 'prefill:8', 'step']


# -- (2) a port-written artifact in the JAX package ----------------------------


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_port_decode_artifact_loads_in_jax(weights, tmp_path, layout):
    jmodel, pmodel, np_params = weights
    pprog = serving.freeze_decode(pmodel, np_params, device='cpu',
                                  **LAYOUTS[layout])
    jprog = jax_freeze_decode(jmodel, np_params, **LAYOUTS[layout])
    part = pprog.save(str(tmp_path / 'port.frozen'))
    jart = jprog.save(str(tmp_path / 'jax.frozen'), include_programs=False)
    assert sorted(os.listdir(part)) == ['MANIFEST.json', 'params.npz']
    pm, jm = _manifest(part), _manifest(jart)
    shared = (set(pm) & set(jm)) - PROVENANCE
    assert set(pm) - PROVENANCE == set(jm) - PROVENANCE
    assert {k: pm[k] for k in shared} == {k: jm[k] for k in shared}
    assert pm['programs'] == {} and pm['device'] == 'cpu'
    back = jax_load_decode(part)
    assert type(back).__name__ == type(jprog).__name__
    assert back.retraced_buckets == []
    reqs = _requests()
    assert _jax_tokens(back, reqs) == _port_tokens(pprog, reqs)


def test_port_decode_params_come_from_the_host_copy(weights, tmp_path):
    _jm, pmodel, np_params = weights
    prog = serving.freeze_decode(pmodel, np_params, device='cpu',
                                 **LAYOUTS['slot'])
    # the host copy is what is written, under the model's names, float32
    art = prog.save(str(tmp_path / 'a'), include_programs=False)
    with np.load(os.path.join(art, 'params.npz')) as z:
        assert sorted(z.files) == sorted(np_params)
        for k in z.files:
            assert z[k].dtype == np.float32
            assert np.array_equal(z[k], np_params[k]), k
    assert not any(n.endswith('.tmp.%d' % os.getpid())
                   for n in os.listdir(art))


# -- (3) a round trip in a fresh process ---------------------------------------

_CHILD = r'''
import json, sys
import torch
torch.set_num_threads(1)
from mxnet_tpu_torch.serving import load_frozen
from mxnet_tpu_torch.serving.decode import DecodeEngine
reqs = json.loads(sys.argv[2])
prog = load_frozen(sys.argv[1], device='cpu')
prog.warmup()
warm = sorted(prog.compile_seconds)
eng = DecodeEngine(prog, timeout_s=120)
outs = [eng.generate(p, max_new_tokens=%d, seed=s, temperature=t).result(120)
        for s, (p, t) in enumerate(reqs)]
eng.close()
print(json.dumps({'outs': outs, 'warm': warm,
                  'compiled': prog.compile_count,
                  'cls': type(prog).__name__,
                  'mods': sorted(m for m in sys.modules
                                 if m.split('.')[0] in ('jax',
                                                        'mxnet_tpu'))}))
''' % NEW


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_port_round_trip_in_a_fresh_process(weights, tmp_path, layout):
    _jm, pmodel, np_params = weights
    prog = serving.freeze_decode(pmodel, np_params, device='cpu',
                                 **LAYOUTS[layout])
    art = prog.save(str(tmp_path / 'port.frozen'))
    temps = [0.0, TEMP] if layout == 'paged' else [0.0, 0.0]
    reqs = [(p, temps[i % 2]) for i, p in enumerate(_requests())]
    eng = DecodeEngine(prog, timeout_s=WAIT)
    try:
        want = [eng.generate(p, max_new_tokens=NEW, seed=s,
                             temperature=t).result(WAIT)
                for s, (p, t) in enumerate(reqs)]
    finally:
        eng.close()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get('PYTHONPATH')) if p))
    env.pop('MXNET_TPU_FAULT', None)
    run = subprocess.run([sys.executable, '-c', _CHILD, art,
                          json.dumps(reqs)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(tmp_path))
    assert run.returncode == 0, run.stderr[-3000:]
    doc = json.loads(run.stdout.strip().splitlines()[-1])
    assert doc['outs'] == want
    paged = layout == 'paged'
    want_set = (['prefill:%d' % b for b in BUCKETS] + ['step']
                + (['copy', 'verify:3'] if paged else []))
    assert doc['warm'] == sorted(want_set)
    assert doc['compiled'] == len(want_set)
    assert doc['cls'] == type(prog).__name__
    assert doc['mods'] == []


# -- (4) rejection and dispatch -------------------------------------------------


def test_frozen_load_rejects_wrong_schema(tmp_path):
    art = tmp_path / 'bogus'
    art.mkdir()
    (art / 'MANIFEST.json').write_text('{"schema": "nope"}')
    with pytest.raises(ValueError):
        serving.load_frozen(str(art), device='cpu')
    with pytest.raises(ValueError):
        serving.FrozenProgram.load(str(art), device='cpu')


def test_frozen_decode_rejects_wrong_kind(tmp_path):
    art = str(tmp_path / 'bogus')
    os.makedirs(art)
    with open(os.path.join(art, 'MANIFEST.json'), 'w') as f:
        json.dump({'schema': serving.FROZEN_SCHEMA, 'kind': 'nope'}, f)
    with pytest.raises(ValueError):
        load_decode(art, device='cpu')


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_load_dispatches_slot_and_paged_artifacts(weights, tmp_path,
                                                  layout):
    _jm, pmodel, np_params = weights
    prog = serving.freeze_decode(pmodel, np_params, device='cpu',
                                 **LAYOUTS[layout])
    art = prog.save(str(tmp_path / 'p.frozen'))
    for loader in (load_decode, serving.load_frozen,
                   DecodeProgram.load, PagedDecodeProgram.load):
        again = loader(art, device='cpu')
        _same_program(again, prog)
    assert bool(_manifest(art).get('paged')) is (layout == 'paged')


def test_load_frozen_dispatches_adapter_artifacts(weights, tmp_path):
    _jm, pmodel, _np = weights
    ad = adapters.init_adapter(pmodel, rank=RANK, seed=4, name='dispatch')
    path = adapters.save_adapter(str(tmp_path / 'dispatch'), ad)
    back = serving.load_frozen(path, device='cpu')
    assert isinstance(back, adapters.Adapter)
    assert back.digest == ad.digest and back.name == 'dispatch'
    # a JAX-written adapter artifact dispatches the same way
    jmodel, _ = jax_init_lm(**CFG)
    jad = jax_adapters.init_adapter(jmodel, rank=RANK, seed=4,
                                    name='dispatch')
    jpath = jax_adapters.save_adapter(str(tmp_path / 'jax'), jad)
    assert serving.load_frozen(jpath, device='cpu').digest == jad.digest


def test_rnn_lm_artifact_raises_naming_a9(tmp_path):
    """A JAX-written ``rnn_lm`` artifact, refused until the RNN-LM family
    was ported, loads in the port as a slot program with the JAX model's
    config, builds the reference's program set at ``warmup()`` and serves
    the JAX program's greedy tokens; an unknown family stays refused."""
    model, params = jax_init_rnn(vocab=19, embed=8, hidden=12, layers=1,
                                 mode='lstm', max_len=32)
    jprog = JaxDecodeProgram(model, params, slots=2, prefill_buckets=(4,))
    art = jprog.save(str(tmp_path / 'rnn.frozen'), include_programs=False)
    prog = load_decode(art, device='cpu')
    assert type(prog) is DecodeProgram and not prog.paged
    assert prog.model.family == 'rnn_lm' and prog.model.config == model.config
    assert prog.warmup().compile_count == len(prog.prefill_buckets) + 1
    assert model_from_config('rnn_lm', model.config).config == model.config
    prompts = [[5, 3, 1], [2], [7, 1, 18, 4]]
    assert _port_tokens(prog, prompts) == _jax_tokens(jprog, prompts)
    with pytest.raises(ValueError, match='unknown decode family'):
        model_from_config('nope', {})


def _mlp():
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation='relu', in_units=8, device='cpu'),
            nn.Dense(4, in_units=16, device='cpu'))
    return net


def test_one_shot_block_without_stamp_refuses_save(tmp_path):
    frozen = serving.freeze(_mlp(), data_shapes=[('data', (8,))],
                            buckets=(1, 2))
    with pytest.raises(NotImplementedError, match='symbolic API'):
        frozen.save(str(tmp_path / 'mlp'))
    assert not os.path.exists(str(tmp_path / 'mlp' / 'MANIFEST.json'))


def test_jax_one_shot_artifact_raises_not_implemented(tmp_path):
    data = mx.sym.Variable('data')
    h = mx.sym.FullyConnected(data, num_hidden=4, name='fc1')
    rs = np.random.RandomState(0)
    args = {'fc1_weight': mx.nd.array(rs.randn(4, 8).astype('float32')),
            'fc1_bias': mx.nd.array(np.zeros(4, 'float32'))}
    frozen = jax_serving.freeze((h, args, {}), data_shapes=[('data', (8,))],
                                buckets=(1, 2))
    art = frozen.save(str(tmp_path / 'jax.frozen'), include_programs=False)
    assert os.path.exists(os.path.join(art, 'symbol.json'))
    with pytest.raises(NotImplementedError, match='symbol.json'):
        serving.load_frozen(art, device='cpu')


# -- (5) one-shot round trips ----------------------------------------------------

TINY_SSD = dict(base_channels=(8, 16), scale_channels=(16,))


def _seeded(net, seed=0):
    """``net``'s parameters from a numpy seed, moving statistics apart
    from 0 / 1 so that a swap would show."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in sorted(net.collect_params().tensors().items()):
            if name.endswith('running_var'):
                p.copy_(torch.from_numpy(
                    (0.5 + rs.rand(*p.shape)).astype('float32')))
            else:
                p.copy_(torch.from_numpy(
                    (0.1 * rs.randn(*p.shape)).astype('float32')))
    return net


def test_one_shot_ssd_round_trip_is_bitwise(tmp_path):
    net = _seeded(ssd.ssd_300(3, device='cpu', **TINY_SSD))
    frozen = serving.freeze(ssd.ssd_detector(net, nms_topk=50),
                            data_shapes=[('data', (3, 64, 64))],
                            buckets=(1, 2, 4), name='tiny-ssd')
    x = np.random.RandomState(1).uniform(-1, 1, (3, 3, 64, 64)) \
        .astype('float32')
    want = frozen.run([x])
    art = frozen.save(str(tmp_path / 'ssd.frozen'))
    doc = _manifest(art)
    assert doc['schema'] == serving.FROZEN_SCHEMA
    assert doc['buckets'] == [1, 2, 4] and doc['n_outputs'] == 1
    assert doc['data_descs'] == [['data', [3, 64, 64], 'float32']]
    assert doc['zoo']['name'] == 'ssd_detector'
    assert doc['zoo']['kwargs']['net']['block']['name'] == 'ssd_300'
    with np.load(os.path.join(art, 'params.npz')) as z:
        aux = sorted(k for k in z.files if k.startswith('aux:'))
        assert all(k.startswith(('arg:', 'aux:')) for k in z.files)
    stats = sorted('aux:' + k for k in net.collect_params()
                   if k.endswith(('running_mean', 'running_var')))
    assert aux == stats and len(aux) == 2 * 12     # 12 BatchNorms
    loaded = serving.load_frozen(art, device='cpu')
    assert isinstance(loaded, serving.FrozenProgram)
    assert loaded.name == 'tiny-ssd' and loaded.policy.buckets == (1, 2, 4)
    got = loaded.warmup().run([x])
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert loaded.compile_count == 3
    # the fallback's host copy is the loaded arrays, bitwise the same
    fb = loaded.run_fallback([x])
    assert all(np.array_equal(a, b) for a, b in zip(fb, want))
    assert loaded._host_block is loaded.block


def test_one_shot_resnet_and_bert_stamps_round_trip(tmp_path):
    rnet = _seeded(resnet.resnet18_v1(classes=5, device='cpu'), 2)
    frozen = serving.freeze(rnet, data_shapes=[('data', (3, 32, 32))],
                            buckets=(1, 2))
    x = np.random.RandomState(3).randn(2, 3, 32, 32).astype('float32')
    want = frozen.run([x])[0]
    loaded = serving.load_frozen(frozen.save(str(tmp_path / 'rn')),
                                 device='cpu')
    assert np.array_equal(loaded.run([x])[0], want)
    assert stamp.stamp_of(loaded.block) == stamp.stamp_of(rnet) == {
        'name': 'resnet18_v1', 'kwargs': {'classes': 5}}
    bnet = bert.get_bert(vocab_size=40, max_length=16, units=16,
                         hidden_size=32, num_layers=1, num_heads=2,
                         dropout=0.0, use_decoder=False, use_classifier=False,
                         device='cpu')
    bert.init_params(bnet, seed=5)
    frozen = serving.freeze(bnet, data_shapes=[('tokens', (16,), 'int32'),
                                               ('types', (16,), 'int32')],
                            buckets=(1, 2))
    toks = np.random.RandomState(4).randint(0, 40, (2, 16)).astype('int32')
    want = frozen.run([toks, np.zeros_like(toks)])
    loaded = serving.load_frozen(frozen.save(str(tmp_path / 'bert')),
                                 device='cpu')
    got = loaded.run([toks, np.zeros_like(toks)])
    assert len(got) == len(want) == 2
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_stamp_of_a_block_with_a_non_json_argument_is_none():
    net = resnet.get_resnet(1, 18, classes=3, device='cpu')
    assert stamp.stamp_of(net)['name'] == 'get_resnet'
    odd = ssd.ssd_detector(_mlp())        # an unstamped argument block
    assert stamp.stamp_of(odd) is None
    with pytest.raises(ValueError, match='unknown zoo constructor'):
        stamp.build({'name': 'nope', 'kwargs': {}}, 'cpu')


def test_loaded_decode_program_keeps_no_card_copy_on_cpu(weights, tmp_path):
    """On the CPU the program's parameters are its host copy: the loaded
    arrays, not a second copy."""
    _jm, pmodel, np_params = weights
    prog = serving.freeze_decode(pmodel, np_params, device='cpu',
                                 **LAYOUTS['slot'])
    again = load_decode(prog.save(str(tmp_path / 'p')), device='cpu')
    assert again._params_host is again.params
    for k in np_params:
        assert torch.equal(again.params[k], prog.params[k]), k

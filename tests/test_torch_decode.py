"""Port parity of the decode slice: the JAX ``TransformerLM`` and
``DecodeProgram`` against ``mxnet_tpu_torch``'s, on the same weights.

A small JAX model (vocab 19, units 16, 2 layers, 4 heads, max_len 32)
is built from a seed; ``params_from_jax`` carries its weights into the
port. Tolerances: logits atol 1e-4 / rtol 1e-5 (float32 matmuls
and layer norms summed in another order by each framework); greedy
tokens must be equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import config
from mxnet_tpu.serving.decode.model import \
    init_transformer_lm as jax_init_lm
from mxnet_tpu.serving.decode.program import DecodeProgram as JaxProgram
from mxnet_tpu_torch import resolve_device
from mxnet_tpu_torch.serving import decode as port
from mxnet_tpu_torch.serving.decode import cache as port_cache

torch.set_num_threads(1)

CFG = dict(vocab=19, units=16, hidden=24, layers=2, heads=4, max_len=32)
PROMPTS = ([7, 2, 9], [1, 5, 3, 3, 8, 0, 11], [4])


@pytest.fixture
def knob():
    """Restore the JAX package's pallas knob after the test."""
    yield
    config.unset('MXNET_TPU_PALLAS')


@pytest.fixture(scope='module')
def models():
    jmodel, np_params = jax_init_lm(**CFG)
    pmodel, _ = port.init_transformer_lm(**CFG)
    return jmodel, np_params, pmodel, port.params_from_jax(np_params,
                                                           'cpu')


def test_init_params_same_draws_as_jax(models):
    _jm, np_params, pmodel, _pp = models
    mine = pmodel.init_params(0)
    assert sorted(mine) == sorted(np_params)
    for k, v in np_params.items():
        assert np.array_equal(mine[k], v), k


@pytest.mark.parametrize('pallas', ['attention', '0'])
def test_full_forward_logits_match_jax(models, knob, pallas):
    jmodel, np_params, pmodel, pparams = models
    config.set('MXNET_TPU_PALLAS', pallas)
    rs = np.random.RandomState(1)
    tokens = rs.randint(0, CFG['vocab'], size=(2, 21)).astype('int32')
    want = np.asarray(jmodel.full_forward(
        {k: jnp.asarray(v) for k, v in np_params.items()},
        jnp.asarray(tokens)))
    got = pmodel.full_forward(pparams, torch.tensor(tokens).long()).numpy()
    assert got.shape == (2, 21, CFG['vocab'])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def _cached(prog, prompt, n, slot=1):
    """Prefill + greedy steps through a JAX or a port DecodeProgram."""
    cache = prog.new_cache()
    cache, tok, _ = prog.run_prefill(cache, prompt, slot)
    got, pos = [tok], len(prompt)
    while len(got) < n:
        tk = np.zeros(prog.slots, 'int32')
        ps = np.zeros(prog.slots, 'int32')
        tk[slot], ps[slot] = got[-1], pos
        cache, toks, _ = prog.run_step(cache, tk, ps)
        got.append(int(toks[slot]))
        pos += 1
    return got


@pytest.mark.parametrize('prompt', PROMPTS)
def test_greedy_tokens_equal_jax_decode_program(models, knob, prompt):
    jmodel, np_params, pmodel, _pp = models
    config.set('MXNET_TPU_PALLAS', 'attention')
    jprog = JaxProgram(jmodel, np_params, slots=2, prefill_buckets=(4, 8))
    pprog = port.freeze_decode(pmodel, np_params, slots=2,
                               prefill_buckets=(4, 8), paged=False,
                               device='cpu')
    assert _cached(pprog, prompt, 8) == _cached(jprog, prompt, 8)


@pytest.mark.parametrize('prompt', PROMPTS)
def test_cached_tokens_equal_full_forward_recompute(models, prompt):
    _jm, np_params, pmodel, pparams = models
    prog = port.DecodeProgram(pmodel, np_params, slots=2,
                              prefill_buckets=(4, 8), device='cpu')
    toks, ref = list(prompt), []
    for _ in range(8):
        logits = pmodel.full_forward(pparams, torch.tensor([toks]))
        ref.append(int(logits[0, -1].argmax()))
        toks.append(ref[-1])
    assert _cached(prog, prompt, 8, slot=0) == ref


def test_params_from_jax_checks_names_and_shapes(models):
    _jm, np_params, _pm, pparams = models
    assert sorted(pparams) == sorted(np_params)
    assert all(t.dtype == torch.float32 and t.device.type == 'cpu'
               for t in pparams.values())
    bad = dict(np_params)
    bad['l1_ffn2_w'] = bad['l1_ffn2_w'][:, :5]
    with pytest.raises(ValueError, match='l1_ffn2_w'):
        port.params_from_jax(bad, 'cpu')
    extra = dict(np_params, stray=np.zeros(3, 'float32'))
    with pytest.raises(ValueError, match='stray'):
        port.params_from_jax(extra, 'cpu')
    missing = {k: v for k, v in np_params.items() if k != 'l0_ln2_b'}
    with pytest.raises(ValueError, match='l0_ln2_b'):
        port.params_from_jax(missing, 'cpu')


@pytest.mark.parametrize('kwargs', [dict(adapter_rank=4),
                                    dict(sample_args=True),
                                    dict(logit_mask=True)])
def test_freeze_decode_refuses_unported_configurations(models, kwargs):
    """Adapters, sampling and the logit mask were refused until they were
    ported; now each builds the program the JAX package's freeze_decode
    builds (the other two read from their knobs), with the same extras."""
    from mxnet_tpu.serving.decode.program import \
        freeze_decode as jax_freeze_decode
    jmodel, np_params, pmodel, _pp = models
    args = dict(kwargs, prefill_buckets=(4, 8))
    jprog = jax_freeze_decode(jmodel, np_params, **args)
    pprog = port.freeze_decode(pmodel, np_params, device='cpu', **args)
    assert (pprog.sample_args, pprog.logit_mask) == \
        (jprog.sample_args, jprog.logit_mask)
    if jprog.adapter_spec is None:
        assert pprog.adapter_spec is None and pprog.apool is None
        return
    assert pprog.adapter_spec.to_manifest() == \
        jprog.adapter_spec.to_manifest()
    assert {k: (tuple(a.shape), tuple(b.shape))
            for k, (a, b) in pprog.apool.items()} == \
        {k: (a.shape, b.shape)
         for k, (a, b) in jprog.adapter_spec.zero_tree().items()}


@pytest.mark.parametrize('paged', [True, None, False])
def test_freeze_decode_pages_transformers_by_default(models, paged):
    """paged=None resolves as in the JAX package (MXNET_TPU_SERVE_PAGED,
    True): a transformer gets the paged program; paged=False keeps the
    slot cache."""
    _jm, np_params, pmodel, _pp = models
    prog = port.freeze_decode(pmodel, np_params, prefill_buckets=(4, 8),
                              device='cpu', paged=paged)
    if paged is False:
        assert type(prog) is port.DecodeProgram and not prog.paged
    else:
        assert isinstance(prog, port.PagedDecodeProgram) and prog.paged
        assert prog.page_size == 16
        assert prog.pages == prog.slots * prog.max_pages + 1


def test_freeze_decode_checks_model_and_max_len(models):
    _jm, np_params, pmodel, _pp = models
    with pytest.raises(TypeError):
        port.freeze_decode(object(), np_params, device='cpu')
    with pytest.raises(ValueError, match='max_len'):
        port.freeze_decode(pmodel, np_params, max_len=64, device='cpu')
    with pytest.raises(ValueError, match='top prefill bucket'):
        port.freeze_decode(pmodel, np_params, prefill_buckets=(8, 32),
                           device='cpu')


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device('cuda')
    model, params = port.init_transformer_lm(**CFG)
    with pytest.raises(RuntimeError, match='CUDA'):
        port.freeze_decode(model, params)
    with pytest.raises(RuntimeError, match='CUDA'):
        port.params_from_jax(params)
    assert resolve_device('cpu') == torch.device('cpu')


def test_cache_updates_in_place():
    spec = port_cache.CacheSpec({'k': ((6, 4), 'float32')})
    assert port_cache.cache_bytes(spec, 3) == 3 * 6 * 4 * 4
    cache = port_cache.init_cache(spec, 3, torch.device('cpu'))
    arr = cache['k']
    arr.fill_(7.0)
    out = port_cache.write_slot(arr, torch.ones(2, 4), 1)
    assert out is arr
    assert (arr[1, :2] == 1).all() and not arr[1, 2:].any()
    assert (arr[0] == 7).all() and (arr[2] == 7).all()
    rows = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    port_cache.write_position(arr, rows, torch.tensor([0, 3, 5]))
    assert torch.equal(arr[0, 0], rows[0])
    assert torch.equal(arr[1, 3], rows[1])
    assert torch.equal(arr[2, 5], rows[2])

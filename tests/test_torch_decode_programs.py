"""The decode programs of the port (``DecodeProgram`` / ``PagedDecodeProgram``
``compile_*``, ``warmup``, ``compile_count``, ``compile_seconds`` and the
capture-safe bodies behind ``run_*``) against the JAX package's compiled
programs, and the program layer's own contracts: the cache a program owns
(a rebuild zeroes the same storage), the launch counts of a captured
program (a recording added once a replay) and the engine's warm-up.

The model is ``test_torch_decode.py``'s kind (vocab 19, units 16, 2
layers, 4 heads, max_len 48), its weights from a numpy seed into both
packages. On the CPU the port's programs run their bodies uncaptured,
the plain version of the CUDA graphs a card captures; the JAX programs
run as the JAX package's own tests run them on the CPU, with the Pallas
knob off (its plain attention) for the program keys. Tolerances: greedy
tokens equal, pool contents and logits within 1e-5 absolute (the flash
kernels' reduction tier) and 1e-5 relative. The ``cuda``-marked test
holds the captured programs against the same bodies run eagerly on a
card, and counts their replays; it skips here.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.capture import Program
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.kernels import _launch
from mxnet_tpu_torch.serving import InferenceSession, freeze_decode
from mxnet_tpu_torch.serving.decode import DecodeEngine
from mxnet_tpu_torch.serving.decode.paged import pages_for

torch.set_num_threads(1)

CFG = dict(vocab=19, units=16, hidden=24, layers=2, heads=4, max_len=48)
BUCKETS = (4, 16)
TOL = 1e-5
KINDS = {'slot': dict(paged=False), 'paged': dict(paged=True, page_size=8),
         'spec': dict(paged=True, page_size=8, spec_k=2)}


@pytest.fixture(scope='module')
def weights():
    # the JAX package is imported where it is used, so that the cuda test
    # runs where only the port is installed
    from mxnet_tpu.serving.decode.model import init_transformer_lm
    jmodel, np_params = init_transformer_lm(**CFG)
    return jmodel, np_params


@pytest.fixture
def knob():
    """Set the JAX package's pallas knob off; restore it after."""
    from mxnet_tpu import config as jax_config
    jax_config.set('MXNET_TPU_PALLAS', '0')
    yield
    jax_config.unset('MXNET_TPU_PALLAS')


def _pair(weights, kind, **kw):
    """(JAX program, port program on the CPU) of ``kind``, the same
    weights, slots and ladder."""
    from mxnet_tpu.serving.decode.program import \
        freeze_decode as jax_freeze_decode
    jmodel, np_params = weights
    from mxnet_tpu_torch.serving.decode import init_transformer_lm
    pmodel, _ = init_transformer_lm(**CFG)
    args = dict(dict(KINDS[kind], slots=2, prefill_buckets=BUCKETS), **kw)
    return (jax_freeze_decode(jmodel, np_params, **args),
            freeze_decode(pmodel, np_params, device='cpu', **args))


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_warmup_builds_the_reference_program_set(weights, knob, kind):
    jprog, pprog = _pair(weights, kind)
    assert pprog.compile_count == 0 and pprog.compile_seconds == {}
    assert jprog.warmup() is jprog and pprog.warmup() is pprog
    want = ['prefill:%d' % b for b in BUCKETS] + ['step']
    if kind != 'slot':
        want.append('copy')
    if kind == 'spec':
        want.append('verify:3')
    assert sorted(pprog.compile_seconds) == sorted(jprog.compile_seconds) \
        == sorted(want)
    assert pprog.compile_count == jprog.compile_count == len(want)
    assert all(s >= 0 for s in pprog.compile_seconds.values())
    # building again, or running, builds nothing more
    pprog.warmup()
    pprog.compile_step()
    cache = pprog.new_cache()
    if kind == 'slot':
        pprog.run_prefill(cache, [1, 2, 3], 0)
        pprog.run_step(cache, [3, 0], [3, 0])
    else:
        pprog.run_prefill(cache, [1, 2, 3], [1])
        pprog.run_step(cache, [3, 0], [3, 0],
                       np.zeros((2, pprog.max_pages), 'int32'))
        pprog.run_copy_page(cache, 1, 2)
    assert pprog.compile_count == len(want)


def test_programs_refuse_what_the_reference_refuses(weights):
    _, slot = _pair(weights, 'slot')
    with pytest.raises(ValueError, match='not a prefill bucket'):
        slot.compile_prefill(8)
    _, paged = _pair(weights, 'paged')
    with pytest.raises(ValueError, match='spec_k > 0'):
        paged.compile_verify()
    with pytest.raises(ValueError, match='spec_k > 0'):
        paged.run_verify(paged.new_cache(), np.zeros((2, 1), 'int32'),
                         np.zeros(2, 'int32'),
                         np.zeros((2, paged.max_pages), 'int32'))
    assert paged.compile_count == 0


def _script(prog, paged, spec):
    """Prefill two prompts, three steps, a copy-on-write and a verify
    through ``prog`` (JAX or port): every call's tokens and logits, and
    the pool / cache after."""
    cache = prog.new_cache()
    rs = np.random.RandomState(3)
    out = []
    tables = np.zeros((2, getattr(prog, 'max_pages', 1)), 'int32')
    pos = np.zeros(2, 'int32')
    last = np.zeros(2, 'int32')
    for s, n in enumerate((3, 11)):
        prompt = rs.randint(0, CFG['vocab'], n)
        if paged:
            tables[s] = 1 + s * prog.max_pages + np.arange(prog.max_pages)
            ids = list(tables[s, :pages_for(n, prog.page_size)])
            cache, tok, logits = prog.run_prefill(cache, prompt, ids)
        else:
            cache, tok, logits = prog.run_prefill(cache, prompt, s)
        out.append(([tok], np.asarray(logits)))
        pos[s], last[s] = n, tok
    for _ in range(3):
        if paged:
            cache, toks, logits = prog.run_step(cache, last, pos, tables)
        else:
            cache, toks, logits = prog.run_step(cache, last, pos)
        out.append((list(toks), np.asarray(logits)))
        last, pos = np.asarray(toks, 'int32'), pos + 1
    if paged:
        cache = prog.run_copy_page(cache, int(tables[0, 0]),
                                   int(tables[1, 3]))
    if spec:
        chunk = rs.randint(0, CFG['vocab'], (2, 3)).astype('int32')
        cache, toks, logits = prog.run_verify(cache, chunk, pos, tables)
        out.append((np.asarray(toks).reshape(-1).tolist(),
                    np.asarray(logits)))
    return out, {k: np.asarray(v) for k, v in cache.items()}


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_capture_safe_bodies_equal_jax_programs(weights, knob, kind):
    """The bodies a card captures, run on the CPU, against the JAX
    programs: greedy prefill, step, copy_page and verify."""
    jprog, pprog = _pair(weights, kind)
    paged, spec = kind != 'slot', kind == 'spec'
    got, gcache = _script(pprog, paged, spec)
    want, wcache = _script(jprog, paged, spec)
    assert len(got) == len(want) == 5 + spec
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == list(np.asarray(wt).reshape(-1))
        np.testing.assert_allclose(gl, wl.reshape(gl.shape), atol=TOL,
                                   rtol=TOL)
    assert sorted(gcache) == sorted(wcache)
    for name in gcache:
        np.testing.assert_allclose(gcache[name], wcache[name], atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize('kind', ['slot', 'paged'])
def test_rebuilt_cache_is_the_same_storage_zeroed(weights, kind):
    _, prog = _pair(weights, kind)
    prog.warmup()
    cache = prog.new_cache()
    ptrs = {k: t.data_ptr() for k, t in cache.items()}
    if kind == 'slot':
        prog.run_prefill(cache, [1, 2, 3], 1)
    else:
        prog.run_prefill(cache, [1, 2, 3], [2])
    assert any(bool(t.any()) for t in cache.values())
    again = prog.new_cache()
    assert again is cache
    assert {k: t.data_ptr() for k, t in again.items()} == ptrs
    assert not any(bool(t.any()) for t in again.values())
    # a cache the program does not own is refused
    other = {k: t.clone() for k, t in cache.items()}
    with pytest.raises(ValueError, match='owns'):
        if kind == 'slot':
            prog.run_step(other, [0, 0], [0, 0])
        else:
            prog.run_copy_page(other, 1, 2)


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_every_program_input_starts_on_a_16_byte_boundary(weights, kind):
    """The kernels take their int32 inputs (positions, lengths, tables)
    16-byte aligned: each input of a program has a segment of its own,
    at 2 slots and an odd bucket too."""
    _, prog = _pair(weights, kind, prefill_buckets=(5, 16))
    prog.warmup()
    assert prog.compile_count == 3 + (kind != 'slot') + (kind == 'spec')
    for key, buf in prog._compiled.items():
        for i, n in enumerate(buf.sizes):
            seg = buf.arg(i)
            assert seg.numel() == n and seg.data_ptr() % 16 == 0, (key, i)
        assert buf.out[buf.at:].data_ptr() % 16 == 0, key


def test_a_replay_adds_its_recorded_counts():
    """What a capture launches goes to its recording, not the totals;
    each replay adds the recording (a CPU program runs its body)."""
    kernels.reset_launch_counts()
    with _launch.recording() as rec:
        _launch.count('flash_decode_fwd')
        _launch.count('multi_tensor_update', 'adamw')
        with pytest.raises(RuntimeError, match='open already'):
            with _launch.recording():
                pass
    assert not any(kernels.launch_counts().values())
    assert rec.launches == {'flash_decode_fwd': 1, 'multi_tensor_update': 1}
    for _ in range(3):
        _launch.add_counts(rec)
    counts = kernels.launch_counts()
    assert counts['flash_decode_fwd'] == counts['multi_tensor_update'] == 3
    assert kernels.instance_launches() == {('multi_tensor_update',
                                            'adamw'): 3}
    calls = []
    prog = Program('cpu', lambda: calls.append(1), torch.device('cpu'))
    assert prog.graph is None and prog.seconds >= 0
    prog.run()
    prog.run()
    assert calls == [1, 1]
    kernels.reset_launch_counts()


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_engine_warms_every_program_at_start(weights, kind):
    """The engine builds the target's (and the draft's) reference set as
    it starts; no request builds another."""
    _, prog = _pair(weights, kind)
    draft = None
    if kind == 'spec':
        _, draft = _pair(weights, 'slot')
    with InferenceSession(prog, timeout_s=60, max_new_tokens=5,
                          draft=draft) as sess:
        n = prog.compile_count
        assert n == len(BUCKETS) + 1 + (kind != 'slot') + (kind == 'spec')
        if draft is not None:
            assert draft.compile_count == len(BUCKETS) + 1
        outs = [sess.generate(p).result(60)
                for p in ([7, 2, 9], [1, 5, 3, 3, 8, 0, 11, 4, 6], [4])]
        assert prog.compile_count == n
    assert all(len(o) == 5 for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', sorted(KINDS))
def test_captured_programs_equal_eager_bodies_on_card(kind):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the programs are CUDA graphs over '
                    'kernels built for sm_90a')
    from mxnet_tpu_torch.serving.decode import init_transformer_lm
    # head dim 64, the serving slice's width (the kernels take 1-128)
    pmodel, np_params = init_transformer_lm(**dict(CFG, units=128, heads=2))
    args = dict(KINDS[kind], slots=2, prefill_buckets=BUCKETS)
    runs = {}
    for capture in (True, False):
        prog = freeze_decode(pmodel, np_params, **args)
        prog.capture = capture
        draft = None
        if kind == 'spec':
            draft = freeze_decode(pmodel, np_params, slots=2,
                                  prefill_buckets=BUCKETS, paged=False)
            draft.capture = capture
        eng = DecodeEngine(prog, timeout_s=60, draft=draft)
        try:
            kernels.reset_launch_counts()
            outs = [eng.generate(p, max_new_tokens=6).result(60)
                    for p in ([7, 2, 9], [1, 5, 3, 3, 8, 0, 11, 4, 6])]
            runs[capture] = (outs, kernels.launch_counts(),
                             eng.stats()['counts'])
        finally:
            eng.close()
        assert (prog.compile_count > 0) and all(
            (b.prog.graph is not None) == capture
            for b in prog._compiled.values())
    assert runs[True][0] == runs[False][0]
    # a replay counts what its eager body launches
    assert runs[True][1] == runs[False][1]
    c = runs[True][2]
    layers = CFG['layers']
    assert runs[True][1]['flash_attention_fwd'] == layers * (
        c['prefills'] + (c['prefills'] + c['prefix_hits']
                         if kind == 'spec' else 0))


@pytest.mark.cuda
def test_captured_sampling_and_adapters_equal_eager_on_card():
    """A paged program with sampling and an adapter pool: a mix of greedy
    and sampled requests on the base and on two adapters, captured and
    uncaptured, the same tokens and launches; the noise kernel's uniforms
    bitwise its plain version's."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the programs are CUDA graphs over '
                    'kernels built for sm_90a')
    from mxnet_tpu_torch.ops.kernels import sampling as noise
    from mxnet_tpu_torch.serving import adapters
    from mxnet_tpu_torch.serving.decode import init_transformer_lm
    keys = torch.arange(16, dtype=torch.int32, device='cuda').view(8, 2)
    assert torch.equal(noise.threefry_gumbel(keys, 30522, uniform=True),
                       noise.threefry_gumbel_reference(keys, 30522,
                                                       uniform=True))
    pmodel, np_params = init_transformer_lm(**dict(CFG, units=128, heads=2))
    runs = {}
    for capture in (True, False):
        prog = freeze_decode(pmodel, np_params, slots=2,
                             prefill_buckets=BUCKETS, page_size=8,
                             adapter_rank=4, adapter_slots=3)
        prog.capture = capture
        reg = adapters.AdapterRegistry(adapters.AdapterPool(
            prog.adapter_spec))
        for i in range(2):
            reg.register('ad%d' % i, adapters.init_adapter(
                pmodel, 4, seed=i, scale=50.0))
        with DecodeEngine(prog, timeout_s=60, adapters=reg) as eng:
            kernels.reset_launch_counts()
            outs = [eng.generate([7, 2, 9, 4], max_new_tokens=6,
                                 adapter=(None, 'ad0', 'ad1')[i % 3],
                                 temperature=0.8 * (i % 2), top_p=0.9,
                                 seed=i).result(60) for i in range(6)]
            runs[capture] = (outs, kernels.launch_counts())
    assert runs[True] == runs[False]
    assert runs[True][1]['threefry_gumbel'] > 0

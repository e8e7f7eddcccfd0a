"""Port parity of sampled decoding: ``mxnet_tpu_torch``'s sampler, its
noise and the engine's sampled streams against the JAX package's
(``mxnet_tpu/serving/decode/sampling.py`` and its engine).

Inputs are made from numpy seeds and go to both packages. What is held:

  * the threefry bits bitwise ``jax.random.bits``; the gumbel values within
    4 float32 ULPs of ``jax.random.gumbel``, an ULP of ``g = -log(t)``, ``t
    = -log(u)`` counted as ``ulp(g) + ulp(t) / t`` (the output's own ULP
    plus an ULP of the inner logarithm carried through the outer one: near
    ``g = 0`` the two packages' ``log`` of a ``t`` near 1 part by far more
    than ``ulp(g)``);
  * ``key_for`` and ``neutral_args`` equal to the JAX package's;
  * temperature 0 byte for byte the argmax, and a program with sampling
    byte for byte the program without it;
  * the nucleus keep set equal to JAX's but for tokens whose ``csum - p``
    lies within 1e-6 of top_p (the cumulative sums run in other orders);
  * the engine's sampled tokens equal to the JAX engine's at every position
    where the JAX run's top two perturbed scores differ by more than 1e-4,
    with fewer than 1 % of positions under that margin;
  * the first sampled token's law against the softmax of ``full_forward``
    (the chi-square test of ``tests/test_adapters.py``), sampled
    speculation equal to plain sampling for the same seeds, the logit mask.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.serving.decode import engine as jax_engine
from mxnet_tpu.serving.decode import sampling as jax_sampling
from mxnet_tpu.serving.decode.model import \
    init_transformer_lm as jax_init_lm
from mxnet_tpu.serving.decode.program import \
    freeze_decode as jax_freeze_decode
from mxnet_tpu_torch.ops.kernels import sampling as noise
from mxnet_tpu_torch.serving import freeze_decode
from mxnet_tpu_torch.serving.decode import DecodeEngine, init_transformer_lm
from mxnet_tpu_torch.serving.decode import sampling

torch.set_num_threads(1)

CFG = dict(vocab=97, units=16, hidden=24, layers=2, heads=4, max_len=64)
MARGIN = 1e-4              # a top-2 perturbed-score gap below it: a tie
NOISE_ULPS = 4


def _keys(seed, n):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2 ** 32, size=(n, 2), dtype=np.uint64) \
        .astype(np.uint32)


def _as_bits(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


# -- the noise -----------------------------------------------------------------


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('v', [1000, 30522])
def test_threefry_bits_are_jax_random_bits(v, seed):
    keys = _keys(seed, 3)
    got = noise.threefry_bits_reference(_as_bits(keys), v).numpy()
    assert got.min() >= 0 and got.max() < 2 ** 32
    for r in range(3):
        want = np.asarray(jax.random.bits(jnp.asarray(keys[r]), (v,)))
        assert np.array_equal(got[r].astype(np.uint32), want), r


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('v', [1000, 30522])
def test_gumbel_within_4_ulps_of_jax(v, seed):
    keys = _keys(seed, 3)
    g = noise.threefry_gumbel(_as_bits(keys), v).numpy()
    u = noise.threefry_gumbel(_as_bits(keys), v, uniform=True).numpy()
    tiny = np.finfo(np.float32).tiny
    for r in range(3):
        ju = np.asarray(jax.random.uniform(jnp.asarray(keys[r]), (v,),
                                           minval=tiny, maxval=1.0))
        assert np.array_equal(u[r], ju), r
        jg = np.asarray(jax.random.gumbel(jnp.asarray(keys[r]), (v,)))
        t = (-np.log(u[r].astype(np.float64))).astype(np.float32)
        ulp = np.spacing(np.abs(jg)) + np.spacing(t) / t
        assert np.all(np.abs(g[r] - jg) <= NOISE_ULPS * ulp), r


def test_noise_takes_int64_keys_and_refuses_bad_shapes():
    keys = _keys(5, 2)
    want = noise.threefry_gumbel(_as_bits(keys), 50)
    got = noise.threefry_gumbel(torch.from_numpy(keys.astype(np.int64)), 50)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match='rows, 2'):
        noise.threefry_gumbel(torch.zeros(4, dtype=torch.int32), 50)


# -- the host side -----------------------------------------------------------------


def test_key_for_and_neutral_args_equal_jax():
    for seed in (0, 7, 2 ** 31 + 5, -3):
        for pos in (0, 1, 11, 511, 10 ** 6):
            assert np.array_equal(sampling.key_for(seed, pos),
                                  jax_sampling.key_for(seed, pos))
    assert np.array_equal(sampling.keys_for(7, range(9)),
                          jax_sampling.keys_for(7, range(9)))
    for got, want in zip(sampling.neutral_args(5),
                         jax_sampling.neutral_args(5)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_temperature_zero_is_the_argmax_byte_for_byte():
    rs = np.random.RandomState(0)
    logits = rs.randn(12, 300).astype('float32')
    logits[3, 17] = logits[3, 40] = logits[3].max() + 1.0   # a tie
    temps, top_ps, keys = sampling.neutral_args(12)
    got = sampling.sample_tokens(torch.from_numpy(logits), temps,
                                 np.full(12, 0.3, 'float32'),
                                 _keys(1, 12))
    assert np.array_equal(got.numpy(), logits.argmax(-1))
    want = np.asarray(jax_sampling.sample_tokens(logits, temps, top_ps,
                                                 keys))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize('top_p', [0.05, 0.5, 0.9, 1.0])
def test_nucleus_keep_set_equals_jax(top_p):
    rs = np.random.RandomState(int(top_p * 100))
    logits = (rs.randn(16, 500) * rs.uniform(0.5, 4, (16, 1))) \
        .astype('float32')
    temps = rs.uniform(0.3, 1.5, 16).astype('float32')
    top_ps = np.full(16, top_p, 'float32')
    # the reference's expressions (sampling.py:105-117)
    logp = jax.nn.log_softmax(jnp.asarray(logits) / temps[:, None], axis=-1)
    probs = jnp.exp(logp)
    order = jnp.argsort(-probs, axis=-1)
    sorted_p = jnp.take_along_axis(probs, order, axis=-1)
    csum = jnp.cumsum(sorted_p, axis=-1)
    keep_sorted = (csum - sorted_p) < top_ps[:, None]
    rows = jnp.arange(16)[:, None]
    want = np.asarray(jnp.zeros(logits.shape, bool).at[rows, order]
                      .set(keep_sorted))
    edge = np.zeros(logits.shape, bool)
    edge[np.arange(16)[:, None], np.asarray(order)] = \
        np.abs(np.asarray(csum - sorted_p) - top_p) <= 1e-6
    x = torch.from_numpy(logits) / torch.from_numpy(temps)[:, None]
    got = sampling.nucleus(torch.exp(torch.log_softmax(x, dim=-1)),
                           torch.from_numpy(top_ps)).numpy()
    assert np.array_equal(got[~edge], want[~edge])
    assert got.any(axis=-1).all()


def test_sampled_rows_equal_jax_sampler():
    rs = np.random.RandomState(3)
    n = 64
    logits = (rs.randn(n, 1000) * 2).astype('float32')
    temps = rs.choice([0.0, 0.5, 0.8, 1.3], n).astype('float32')
    top_ps = rs.choice([1.0, 0.9, 0.5, 0.05], n).astype('float32')
    keys = sampling.keys_for(11, range(n))
    want = np.asarray(jax_sampling.sample_tokens(logits, temps, top_ps,
                                                 keys))
    got = sampling.sample_tokens(torch.from_numpy(logits), temps, top_ps,
                                 keys).numpy()
    assert np.array_equal(got, want)


# -- the programs and the engine -----------------------------------------------


@pytest.fixture(scope='module')
def weights():
    jmodel, np_params = jax_init_lm(**CFG)
    pmodel, _ = init_transformer_lm(**CFG)
    return jmodel, pmodel, np_params


def _script(prog, temps, seed):
    """A prefill and three steps on slot 1 of a paged program: (tokens,
    logits) of every call, the extras a row a slot."""
    pool = prog.new_cache()
    table = np.zeros((prog.slots, prog.max_pages), 'int32')
    table[1] = np.arange(1, prog.max_pages + 1)
    prompt = [5, 9, 2, 44, 7, 1]
    kw = {}
    if temps is not None:
        kw = dict(temps=[temps], top_ps=[0.9],
                  keys=sampling.key_for(seed, len(prompt) - 1)[None])
    pool, tok, logits = prog.run_prefill(pool, prompt, [1], **kw)
    out, pos = [(tok, logits)], len(prompt)
    for _ in range(3):
        tk = np.zeros(prog.slots, 'int32')
        ps = np.zeros(prog.slots, 'int32')
        tk[1], ps[1] = out[-1][0], pos
        if temps is not None:
            keys = np.zeros((prog.slots, 2), 'uint32')
            keys[1] = sampling.key_for(seed, pos)
            kw = dict(temps=[0.0, temps], top_ps=[1.0, 0.9], keys=keys)
        pool, toks, logits = prog.run_step(pool, tk, ps, table, **kw)
        out.append((int(toks[1]), logits[1]))
        pos += 1
    return out


def test_greedy_program_with_sampling_is_the_program_without(weights):
    """Temperature 0 in a program with sampling: the tokens and logits of
    the program without it, byte for byte (omitted extras and explicit
    zeros alike)."""
    _jm, pmodel, np_params = weights
    progs = {sa: freeze_decode(pmodel, np_params, slots=2,
                               prefill_buckets=(8,), page_size=8,
                               sample_args=sa, device='cpu')
             for sa in (False, True)}
    base = _script(progs[False], None, 0)
    for temps in (None, 0.0):
        got = _script(progs[True], temps, 3)
        assert [t for t, _ in got] == [t for t, _ in base]
        for (_, gl), (_, bl) in zip(got, base):
            assert np.array_equal(gl, bl)
    assert progs[True].compile_count == progs[False].compile_count == 2


def _perturbed_margins(jmodel, np_params, prompt, out, seed, temp, top_p):
    """The JAX run's top-2 perturbed-score gap at each served position
    (teacher-forced on ``out``; the reference's own expressions)."""
    dev = {k: jnp.asarray(v) for k, v in np_params.items()}
    toks = jnp.asarray([list(prompt) + out[:-1]], 'int32')
    logits = np.asarray(jmodel.full_forward(dev, toks))[0, len(prompt) - 1:]
    n = len(out)
    logp = jax.nn.log_softmax(jnp.asarray(logits) / temp, axis=-1)
    probs = jnp.exp(logp)
    order = jnp.argsort(-probs, axis=-1)
    sp = jnp.take_along_axis(probs, order, axis=-1)
    keep_sorted = (jnp.cumsum(sp, axis=-1) - sp) < top_p
    keep = jnp.zeros(logits.shape, bool).at[
        jnp.arange(n)[:, None], order].set(keep_sorted)
    keys = jax_sampling.keys_for(seed, range(len(prompt) - 1,
                                             len(prompt) - 1 + n))
    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (logits.shape[1],)))(
        jnp.asarray(keys))
    scores = np.asarray(jnp.where(keep, logp, -jnp.inf) + gumbel)
    top2 = np.sort(scores, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_engine_sampled_tokens_equal_jax_engine(weights):
    jmodel, pmodel, np_params = weights
    rs = np.random.RandomState(4)
    requests = [(rs.randint(0, CFG['vocab'], rs.randint(3, 15)).tolist(), s)
                for s in range(6)]
    temp, top_p, new = 0.8, 0.9, 12
    args = dict(slots=3, prefill_buckets=(16,), page_size=8)
    jeng = jax_engine.DecodeEngine(jax_freeze_decode(jmodel, np_params,
                                                     **args), timeout_s=120)
    try:
        want = [jeng.generate(p, max_new_tokens=new, temperature=temp,
                              top_p=top_p, seed=s).result(120)
                for p, s in requests]
    finally:
        jeng.close()
    eng = DecodeEngine(freeze_decode(pmodel, np_params, device='cpu',
                                     **args), timeout_s=60)
    try:
        got = [eng.generate(p, max_new_tokens=new, temperature=temp,
                            top_p=top_p, seed=s).result(60)
               for p, s in requests]
        assert eng.stats()['counts']['sampled_tokens'] == new * len(requests)
    finally:
        eng.close()
    # past a near-tie the two streams may part, and their contexts with
    # them: each stream is compared up to its first differing token
    near = total = compared = 0
    for (prompt, seed), g, w in zip(requests, got, want):
        margins = _perturbed_margins(jmodel, np_params, prompt, w, seed,
                                     temp, top_p)
        near += int((margins <= MARGIN).sum())
        total += len(w)
        for t, (a, b) in enumerate(zip(g, w)):
            if a != b:
                assert margins[t] <= MARGIN, (seed, t, margins[t])
                break
            compared += 1
    assert near < 0.01 * total, (near, total)
    assert compared >= 0.9 * total, (compared, total)


def chi2_threshold(df):
    """The chi-square 99.9 % quantile by Wilson-Hilferty (as
    ``tests/test_adapters.py`` computes it)."""
    z = 3.0902
    return df * (1 - 2.0 / (9 * df) + z * (2.0 / (9 * df)) ** 0.5) ** 3


def test_first_sampled_token_chi_square_against_softmax(weights):
    _jm, pmodel, np_params = weights
    prompt, temp, n_seeds = [3, 5, 7, 11, 13], 1.0, 240
    params = {k: torch.from_numpy(v) for k, v in np_params.items()}
    with torch.inference_mode():
        logits = pmodel.full_forward(params, torch.tensor([prompt]))[0, -1]
    logits = logits.double().numpy()
    probs = np.exp(logits / temp - np.logaddexp.reduce(logits / temp))
    counts = np.zeros(CFG['vocab'])
    prog = freeze_decode(pmodel, np_params, slots=4, prefill_buckets=(8,),
                         paged=False, sample_args=True, device='cpu')
    with DecodeEngine(prog, max_queue=n_seeds, timeout_s=120) as eng:
        streams = [eng.generate(prompt, max_new_tokens=1, temperature=temp,
                                top_p=1.0, seed=s) for s in range(n_seeds)]
        for s in streams:
            counts[s.result(120)[0]] += 1
    expected = probs * n_seeds
    keep = expected >= 1.0
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.maximum(np.append(expected[keep], expected[~keep].sum()), 1e-9)
    stat = float(((obs - exp) ** 2 / exp).sum())
    assert stat < chi2_threshold(len(obs) - 1), stat


def test_sampled_speculation_equals_plain_sampling(weights):
    """The same seeds through a speculative engine (a self-draft, 2
    proposals a tick, keys shared with the verify pass) and a plain one:
    the same streams, and the drafts' coupled proposals are accepted."""
    _jm, pmodel, np_params = weights
    rs = np.random.RandomState(5)
    requests = [rs.randint(0, CFG['vocab'], rs.randint(3, 15)).tolist()
                for _ in range(5)]
    args = dict(slots=3, prefill_buckets=(16,), page_size=8, device='cpu')
    outs, stats = {}, {}
    for spec in (False, True):
        prog = freeze_decode(pmodel, np_params, spec_k=2 if spec else 0,
                             **args)
        draft = freeze_decode(pmodel, np_params, slots=3,
                              prefill_buckets=(16,), paged=False,
                              device='cpu') if spec else None
        with DecodeEngine(prog, draft=draft, timeout_s=60) as eng:
            outs[spec] = [eng.generate(p, max_new_tokens=10, temperature=0.7,
                                       top_p=0.95, seed=i).result(60)
                          for i, p in enumerate(requests)]
            stats[spec] = eng.stats()
    assert outs[True] == outs[False]
    assert stats[True]['counts']['spec_rounds'] > 0
    assert stats[True]['spec']['acceptance_rate'] >= 0.9


def test_logit_mask_forbids_tokens_and_zero_mask_is_identity(weights):
    _jm, pmodel, np_params = weights
    with pytest.raises(ValueError, match='logit_mask requires sample_args'):
        freeze_decode(pmodel, np_params, sample_args=False, logit_mask=True,
                      device='cpu')
    masked = freeze_decode(pmodel, np_params, slots=2, prefill_buckets=(8,),
                           paged=False, logit_mask=True, device='cpu')
    plain = freeze_decode(pmodel, np_params, slots=2, prefill_buckets=(8,),
                          paged=False, device='cpu')
    assert masked.logit_mask and masked.sample_args
    V = CFG['vocab']
    odd = np.where(np.arange(V) % 2 == 1, -np.inf, 0.0).astype('float32')
    prompt = [4, 8, 15, 16, 23]
    for temp in (0.0, 0.9):
        kw = dict(temps=[temp], top_ps=[1.0],
                  keys=sampling.key_for(2, len(prompt) - 1)[None])
        cache = masked.new_cache()
        _, tok, logits = masked.run_prefill(cache, prompt, 0, masks=odd[None],
                                            **kw)
        assert tok % 2 == 0
        _, zero_tok, zero_logits = masked.run_prefill(cache, prompt, 0, **kw)
        _, want, want_logits = plain.run_prefill(plain.new_cache(), prompt, 0,
                                                 **kw)
        assert zero_tok == want and np.array_equal(zero_logits, want_logits)
        # the mask moves the token, not the logits the program returns
        assert np.array_equal(logits, want_logits)
        steps = []
        for _ in range(4):
            _, toks, _ = masked.run_step(
                cache, [tok, 0], [len(prompt) + len(steps), 0],
                temps=[temp, 0.0], top_ps=[1.0, 1.0],
                keys=sampling.keys_for(2, [len(prompt) + len(steps), 0]),
                masks=np.stack([odd, odd]))
            tok = int(toks[0])
            steps.append(tok)
        assert all(t % 2 == 0 for t in steps), steps


def test_engine_refuses_bad_sampling_laws(weights):
    _jm, pmodel, np_params = weights
    greedy = freeze_decode(pmodel, np_params, slots=2, prefill_buckets=(8,),
                           paged=False, sample_args=False, device='cpu')
    with DecodeEngine(greedy, timeout_s=30) as eng:
        with pytest.raises(ValueError, match='without sampling args'):
            eng.generate([1, 2], temperature=0.5)
        with pytest.raises(ValueError, match='temperature must be >= 0'):
            eng.generate([1, 2], temperature=-1.0)
        for top_p in (0.0, 1.5):
            with pytest.raises(ValueError, match='top_p'):
                eng.generate([1, 2], top_p=top_p)
        assert len(eng.generate([1, 2], max_new_tokens=3).result(30)) == 3

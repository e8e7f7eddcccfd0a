"""The port's adapter self-test (``python -m
mxnet_tpu_torch.serving.adapters``) on the CPU, against the JAX
package's (``mxnet_tpu/serving/adapters/__main__.py``).

``main(['--device', 'cpu', '--out', path])`` must pass its six legs,
write the reference's ``{ok, checks}`` verdict and return 0; each leg is
also run alone. The self-test's model (vocabulary 61, units 32, 4 heads:
head dim 8) is the reference's: its ``temp0_identity`` stream (the
program without sampling extras, greedy) must equal, token for token, the
JAX self-test model's stream on the same prompt.
"""
import importlib
import json

import numpy as np
import pytest

from mxnet_tpu import config as jax_config
from mxnet_tpu.serving.decode.engine import DecodeEngine as JaxEngine
from mxnet_tpu.serving.decode.program import freeze_decode as jax_freeze
from mxnet_tpu_torch.serving.decode import DecodeEngine, freeze_decode

port_selftest = importlib.import_module(
    'mxnet_tpu_torch.serving.adapters.__main__')
jax_selftest = importlib.import_module('mxnet_tpu.serving.adapters.__main__')

LEGS = ('artifact', 'pool', 'zero_retrace', 'temp0_identity', 'sampled_spec',
        'prefix_isolation')


def test_main_passes_every_leg_and_writes_the_verdict(tmp_path, capsys):
    out = tmp_path / 'ADAPTERS_SELFTEST.json'
    assert port_selftest.main(['--device', 'cpu', '--out', str(out)]) == 0
    verdict = json.loads(out.read_text())
    assert verdict == {'ok': True, 'checks': dict.fromkeys(LEGS, 'ok')}
    printed = capsys.readouterr().out
    assert all('adapters selftest %-16s ok' % leg in printed for leg in LEGS)


@pytest.mark.parametrize('leg', LEGS)
def test_each_leg_passes_alone(tmp_path, leg):
    fn = getattr(port_selftest, 'check_' + leg)
    args = {'artifact': (str(tmp_path),), 'pool': ('cpu',)}.get(
        leg, (str(tmp_path), 'cpu'))
    assert fn(*args) is None


def test_a_failing_leg_fails_the_verdict(tmp_path, monkeypatch):
    monkeypatch.setattr(port_selftest, 'check_pool',
                        lambda device: 'a planted problem')
    out = tmp_path / 'A.json'
    assert port_selftest.main(['--device', 'cpu', '--out', str(out)]) == 1
    verdict = json.loads(out.read_text())
    assert verdict['ok'] is False
    assert verdict['checks']['pool'] == 'a planted problem'
    assert all(verdict['checks'][leg] == 'ok' for leg in LEGS
               if leg != 'pool')


def test_the_model_is_the_reference_selftests():
    pmodel, pparams = port_selftest._model()
    jmodel, jparams = jax_selftest._model()
    assert pmodel.units // pmodel.heads == 8
    assert sorted(pparams) == sorted(jparams)
    for k, v in jparams.items():
        assert np.array_equal(pparams[k], np.asarray(v)), k
    assert (port_selftest.VOCAB, port_selftest.PROMPT) == (
        jax_selftest.VOCAB, jax_selftest.PROMPT)


def test_temp0_stream_equals_the_jax_selftests():
    """The temp0_identity leg's reference stream: the program without
    sampling extras, greedy, 10 tokens of PROMPT, in both packages."""
    pmodel, params = port_selftest._model()
    jmodel, jparams = jax_selftest._model()
    jax_config.set('MXNET_TPU_PALLAS', 'attention')
    try:
        jprog = jax_freeze(jmodel, jparams, slots=4,
                           prefill_buckets=(16, 32), paged=False,
                           sample_args=False)
        with JaxEngine(jprog, name='t0-jax') as eng:
            want = list(eng.generate(jax_selftest.PROMPT,
                                     max_new_tokens=10))
    finally:
        jax_config.unset('MXNET_TPU_PALLAS')
    prog = freeze_decode(pmodel, params, slots=4, prefill_buckets=(16, 32),
                         paged=False, sample_args=False, device='cpu')
    with DecodeEngine(prog, name='t0-port') as eng:
        got = list(eng.generate(port_selftest.PROMPT, max_new_tokens=10))
    assert len(got) == 10
    assert got == want

"""The degraded path's contract with the captured decode programs: a trip
builds no program. A lost device call completes the streams it carried on
the CPU fallback with the healthy tokens, the engine's cache rebuild
zeroes the program's own storage (``new_cache``), ``compile_count`` stays
what the engine's warm-up built, and the next request is served by the
same programs, not degraded.

The same check runs on the CPU here, where the programs run their bodies
uncaptured, and, marked ``cuda``, on a card, where they are CUDA graphs
(skipped here). The file imports nothing of JAX, so that the card test
runs where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_degraded_card.py``.
"""
import pytest
import torch

from mxnet_tpu_torch.resilience import policy
from mxnet_tpu_torch.serving import freeze_decode
from mxnet_tpu_torch.serving.decode import DecodeEngine, init_transformer_lm

torch.set_num_threads(1)

# head dim 64, the serving slice's width (the kernels take 1-128)
CFG = dict(vocab=23, units=128, hidden=256, layers=2, heads=2, max_len=48)
PROMPTS = ([3, 1, 4, 1, 5, 9, 2], [8, 8, 2], [2, 7, 1, 8, 2, 8], [6, 5])
WAIT = 120


def _arm(monkeypatch, spec):
    monkeypatch.setenv('MXNET_TPU_FAULT', '')
    policy.get_injector()          # a fresh injector for the new value
    if spec:
        monkeypatch.setenv('MXNET_TPU_FAULT', spec)


def _generate(eng, i, n=6):
    return eng.generate(PROMPTS[i], max_new_tokens=n,
                        temperature=0.8 if i % 2 else 0.0, top_p=0.9, seed=i)


def _trip(monkeypatch, device):
    model, params = init_transformer_lm(**CFG)
    prog = freeze_decode(model, params, slots=4, prefill_buckets=(4, 16),
                         page_size=8, device=device)
    _arm(monkeypatch, '')
    eng = DecodeEngine(prog, timeout_s=WAIT)
    built = prog.compile_count
    try:
        healthy = [_generate(eng, i).result(WAIT) for i in range(4)]
        # the fault two device calls into the next request: its first
        # step, after its prefill
        _arm(monkeypatch, 'device_loss@serving.decode.%d:1'
             % (eng._op_seq + 1))
        tripped = _generate(eng, 0)
        assert tripped.result(WAIT) == healthy[0] and tripped.degraded
        st = eng.stats()
        assert st['degraded'] and st['counts']['retired']['degraded'] == 1
        assert st['pages']['pages_used'] == 0
        _arm(monkeypatch, '')
        ok = _generate(eng, 1)
        assert ok.result(WAIT) == healthy[1] and not ok.degraded
        st = eng.stats()
        assert st['counts']['fallback_tokens'] == 5
        assert st['breaker'] == 'closed' and not st['degraded']
    finally:
        eng.close()
    assert built == len(prog.prefill_buckets) + 2      # ladder, step, copy
    assert prog.compile_count == built


def test_a_trip_builds_no_program_on_the_cpu(monkeypatch):
    _trip(monkeypatch, 'cpu')


@pytest.mark.cuda
def test_a_trip_on_the_card_builds_no_program(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the decode programs are CUDA graphs '
                    'of the sm_90a kernels')
    _trip(monkeypatch, None)

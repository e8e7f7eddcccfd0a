"""Port parity of the ``mxnet_tpu.seqstate.v1`` payload: the port's
``mxnet_tpu_torch/serving/decode/seqstate.py`` against the JAX package's
``mxnet_tpu/serving/decode/seqstate.py``.

The same inputs (arrays from a numpy seed) through both packages'
``build_payload`` give the same document, byte for byte in its canonical
JSON, and the same digest; each package's payload decodes in the other to
the same state, arrays bitwise; a torn, version-mismatched or
inconsistent payload is refused with each package's ``SeqStateError``.
Exact throughout: the payload is host data.
"""
import base64
import json

import numpy as np
import pytest

from mxnet_tpu.serving.decode import seqstate as jax_seqstate
from mxnet_tpu_torch.serving.decode import seqstate as port_seqstate

MODULES = {'jax': jax_seqstate, 'port': port_seqstate}


def _canonical(doc):
    return json.dumps(doc, sort_keys=True, separators=(',', ':'))


def _rows(pos, units=8, entries=2, seed=0):
    rs = np.random.RandomState(seed)
    return {'l%d_%s' % (i, kv): rs.randn(pos, units).astype('float32')
            for i in range(entries) for kv in ('k', 'v')}


CASES = {
    'paged': dict(kind='paged', prompt=[3, 5, 7, 11], emitted=[2, 9],
                  pos=5, last_token=9, max_new=16, eos_id=2,
                  request_id='r-1', page_size=8, entries=_rows(5)),
    'paged_sampled_adapter': dict(
        kind='paged', prompt=list(range(1, 20)), emitted=[4], pos=19,
        last_token=4, max_new=7, request_id=None, page_size=16,
        entries=_rows(19, seed=1), adapter_id='ad3',
        sampling={'temperature': 0.8, 'top_p': 0.9, 'seed': 12}),
    'extending': dict(kind='paged', prompt=list(range(10)), emitted=[],
                      pos=8, last_token=8, max_new=4, page_size=8,
                      entries=_rows(8, seed=2)),
    'slot': dict(kind='slot', prompt=[1, 2, 3], emitted=[5, 6], pos=4,
                 last_token=6, max_new=9,
                 entries={'h': np.arange(12, dtype='float32').reshape(3, 4),
                          'c': np.ones((3, 4), 'float32')}),
    'cold': dict(kind='cold', prompt=[8, 8, 1], emitted=[], pos=0,
                 last_token=None, max_new=3, eos_id=None, request_id='c',
                 sampling={'temperature': 1.0, 'top_p': 1.0, 'seed': 0}),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_build_payload_is_the_references_byte_for_byte(case):
    jdoc = jax_seqstate.build_payload(**CASES[case])
    pdoc = port_seqstate.build_payload(**CASES[case])
    assert _canonical(pdoc) == _canonical(jdoc)
    assert json.dumps(pdoc) == json.dumps(jdoc)      # key order too
    assert pdoc['digest'] == jdoc['digest']
    assert len(pdoc['digest']) == 32
    assert pdoc['schema'] == port_seqstate.SEQSTATE_SCHEMA == \
        jax_seqstate.SEQSTATE_SCHEMA


@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax')])
@pytest.mark.parametrize('case', sorted(CASES))
def test_each_packages_payload_decodes_in_the_other(case, writer, reader):
    doc = json.loads(json.dumps(MODULES[writer].build_payload(**CASES[case])))
    got = MODULES[reader].decode_payload(doc)
    same = MODULES[writer].decode_payload(doc)
    assert sorted(got) == sorted(same)
    for key in got:
        if key == 'arrays':
            assert sorted(got[key]) == sorted(same[key])
            for name, arr in got[key].items():
                assert arr.dtype == same[key][name].dtype
                assert np.array_equal(arr, same[key][name])
                assert np.array_equal(arr, CASES[case]['entries'][name])
        else:
            assert got[key] == same[key], key


def test_arrays_round_trip_bitwise_in_both_packages():
    rs = np.random.RandomState(3)
    for arr in (rs.randn(5, 7).astype('float32'),
                rs.randint(-9, 9, (2, 3, 4)).astype('int32'),
                np.zeros((0, 4), 'float32'),
                np.asfortranarray(rs.randn(3, 5).astype('float32'))):
        for m in MODULES.values():
            blk = m.encode_array(arr)
            assert blk == jax_seqstate.encode_array(arr)
            back = port_seqstate.decode_array(blk)
            assert back.dtype == arr.dtype and np.array_equal(back, arr)


def _reseal(doc):
    doc = dict(doc)
    doc['digest'] = jax_seqstate._digest(doc)
    return doc


def _flip_char(doc):
    """One base64 character of an entry changed (its digest left)."""
    doc = json.loads(json.dumps(doc))
    blk = doc['entries']['l0_k']
    data = blk['data']
    blk['data'] = ('B' if data[0] != 'B' else 'C') + data[1:]
    return doc


def _truncated(doc):
    doc = json.loads(json.dumps(doc))
    raw = base64.b64decode(doc['entries']['l0_v']['data'])
    doc['entries']['l0_v']['data'] = base64.b64encode(raw[:-4]).decode()
    return _reseal(doc)


def _few_rows(doc):
    doc = json.loads(json.dumps(doc))
    doc['entries']['l0_k'] = jax_seqstate.encode_array(
        np.zeros((doc['pos'] - 1, 8), 'float32'))
    return _reseal(doc)


BAD = {
    'torn': _flip_char,
    'field_changed': lambda d: dict(d, pos=d['pos'] + 1),
    'version': lambda d: _reseal(dict(d, schema='mxnet_tpu.seqstate.v2')),
    'no_digest': lambda d: {k: v for k, v in d.items() if k != 'digest'},
    'missing_field': lambda d: _reseal({k: v for k, v in d.items()
                                        if k != 'prompt'}),
    'empty_prompt': lambda d: _reseal(dict(d, prompt=[])),
    'pos_outside': lambda d: _reseal(dict(d, pos=99)),
    'no_last_token': lambda d: _reseal(dict(d, last_token=None)),
    'unknown_kind': lambda d: _reseal(dict(d, kind='warm')),
    'truncated_array': _truncated,
    'rows_not_pos': _few_rows,
    'bad_sampling': lambda d: _reseal(dict(d, sampling={'seed': 1})),
    'not_an_object': lambda d: [d],
}


@pytest.mark.parametrize('package', sorted(MODULES))
@pytest.mark.parametrize('bad', sorted(BAD))
def test_torn_mismatched_and_inconsistent_payloads_refused_typed(bad,
                                                                 package):
    doc = jax_seqstate.build_payload(**CASES['paged'])
    mod = MODULES[package]
    with pytest.raises(mod.SeqStateError):
        mod.decode_payload(BAD[bad](doc))
    assert issubclass(mod.SeqStateError, ValueError)


def test_build_payload_refuses_an_unknown_kind_in_both_packages():
    for m in MODULES.values():
        with pytest.raises(ValueError):
            m.build_payload('warm', [1], [], 0, None, 1)

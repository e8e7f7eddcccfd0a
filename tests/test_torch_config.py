"""Port parity: the port's knob parsing (``mxnet_tpu_torch/config.py``)
against the JAX package's (``mxnet_tpu/config.py`` ``Knob.parse`` and
``get``), for every knob the port lists, over a set variable that is
empty, padded, false-like or true-like, and an unset one. One case a knob
and a value: the two packages give the same value, or raise the same
exception type."""
import pytest

from mxnet_tpu import config as jax_config
from mxnet_tpu_torch import config as port_config

UNSET = None
VALUES = ('', ' 0', '0', 'false', '1', UNSET)


def _read(get, name):
    try:
        return 'value', get(name)
    except Exception as exc:  # the type is what is compared
        return 'raises', type(exc).__name__


@pytest.mark.parametrize('raw', VALUES, ids=repr)
@pytest.mark.parametrize('name', sorted(port_config.KNOBS))
def test_knob_parses_as_the_reference(monkeypatch, name, raw):
    if raw is UNSET:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    assert name not in jax_config._values, 'a set() override would win'
    assert _read(port_config.get, name) == _read(jax_config.get, name)


@pytest.mark.parametrize('name', sorted(port_config.KNOBS))
def test_knob_table_is_the_references(name):
    typ, default, doc = port_config.KNOBS[name]
    knob = jax_config.KNOBS[name]
    assert (typ, default) == (knob.typ, knob.default)
    if name == 'MXNET_TPU_AMP':
        assert doc == knob.doc


def test_empty_and_padded_bool_knobs(monkeypatch):
    """ROADMAP C1's table: '' is False, ' 0' is True."""
    for raw, want in (('', False), (' 0', True), ('0', False),
                      ('false', False)):
        monkeypatch.setenv('MXNET_TPU_SERVE_PAGED', raw)
        assert port_config.get('MXNET_TPU_SERVE_PAGED') is want
    monkeypatch.setenv('MXNET_TPU_SERVE_DECODE_SLOTS', '')
    with pytest.raises(ValueError):
        port_config.get('MXNET_TPU_SERVE_DECODE_SLOTS')


# the endpoint's and the draft's knobs: name -> values to parse, each the
# reference's way
ENDPOINT_KNOBS = {
    'MXNET_TPU_SERVE_HTTP_PORT': ('8080', '0', ' 7'),
    'MXNET_TPU_SERVE_MAX_CONCURRENT': ('4', '0', '-1'),
    'MXNET_TPU_SERVE_SPEC_DRAFT': ('/tmp/draft.frozen', ' x ', '0'),
}


@pytest.mark.parametrize('name', sorted(ENDPOINT_KNOBS))
def test_endpoint_and_draft_knobs_are_the_references(monkeypatch, name):
    """Default, type, help text and parsing of the HTTP port, the
    concurrency cap and the speculative draft's path."""
    typ, default, doc = port_config.KNOBS[name]
    knob = jax_config.KNOBS[name]
    assert (typ, default, doc) == (knob.typ, knob.default, knob.doc)
    monkeypatch.delenv(name, raising=False)
    assert port_config.get(name) == jax_config.get(name) == default
    for raw in ENDPOINT_KNOBS[name]:
        monkeypatch.setenv(name, raw)
        assert port_config.get(name) == jax_config.get(name) == typ(raw)


# the observability core's and the serving gateway's knobs
GATEWAY_KNOBS = ('MXNET_TPU_TELEMETRY', 'MXNET_TPU_TRACE',
                 'MXNET_TPU_TRACE_BUFFER') + tuple(
    n for n in sorted(jax_config.KNOBS) if n.startswith('MXNET_TPU_GATEWAY_'))


def test_gateway_and_observability_knob_set():
    """Every gateway knob of the reference is in the port, fifteen of
    them, beside the three observability knobs."""
    assert len(GATEWAY_KNOBS) == 18
    assert set(GATEWAY_KNOBS) <= set(port_config.KNOBS)


@pytest.mark.parametrize('name', GATEWAY_KNOBS)
def test_gateway_knobs_are_the_references(monkeypatch, name):
    """Name, type, default and help text of each new knob, and its
    unset value, are ``mxnet_tpu/config.py``'s."""
    typ, default, doc = port_config.KNOBS[name]
    knob = jax_config.KNOBS[name]
    assert (typ, default, doc) == (knob.typ, knob.default, knob.doc)
    monkeypatch.delenv(name, raising=False)
    assert port_config.get(name) == jax_config.get(name) == default

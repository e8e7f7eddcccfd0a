"""The portable in-flight decode state, the ``mxnet_tpu.seqstate.v1``
payload: the port's copy of ``mxnet_tpu/serving/decode/seqstate.py``.

One JSON document a live sequence carries what another engine needs to
continue it, token for token under greedy decoding:

  * the scheduling state: the prompt, the emitted tokens, ``pos`` (the
    KV rows consumed), ``last_token`` (the next feed), ``max_new`` and
    ``eos_id`` (the original budget), ``request_id`` (the fleet's
    idempotency key), the pinned ``adapter_id`` and the ``sampling`` law;
  * the device state gathered to host rows: a paged engine ships the
    ``pos`` valid K/V rows of each cache entry, free of the page
    geometry (the importer re-chunks them to its own page size); a slot
    engine ships each cache entry's row of the slot.

The arrays ride base64 inside the JSON, and the document is sealed with
a 16-byte blake2b over the canonical JSON of everything but the digest,
so a torn or corrupted handoff is refused typed (:class:`SeqStateError`)
instead of decoding garbage K/V. The encoding is the reference's byte for
byte, so a payload written by either package decodes in the other and a
gateway relays it untouched. numpy and the stdlib only.
"""
from __future__ import annotations

import base64
import hashlib
import json

import numpy as onp

__all__ = ['SEQSTATE_SCHEMA', 'SeqStateError', 'encode_array',
           'decode_array', 'build_payload', 'decode_payload']

SEQSTATE_SCHEMA = 'mxnet_tpu.seqstate.v1'

_KINDS = ('paged', 'slot', 'cold')


class SeqStateError(ValueError):
    """A seqstate payload refused: another schema version, torn content
    (a digest mismatch, a truncated array) or a layout the importing
    engine cannot hold."""


def encode_array(arr):
    """One host array as a JSON-able dict: shape, dtype and the base64 of
    its C-order bytes."""
    arr = onp.ascontiguousarray(arr)
    return {'shape': [int(d) for d in arr.shape],
            'dtype': str(arr.dtype),
            'data': base64.b64encode(arr.tobytes()).decode('ascii')}


def decode_array(obj):
    """The inverse of :func:`encode_array`; a truncated or padded byte
    stream is refused typed."""
    try:
        shape = tuple(int(d) for d in obj['shape'])
        dtype = onp.dtype(str(obj['dtype']))
        raw = base64.b64decode(obj['data'].encode('ascii'), validate=True)
    except (KeyError, TypeError, ValueError) as exc:
        raise SeqStateError('malformed array block: %s' % (exc,))
    want = dtype.itemsize
    for d in shape:
        want *= d
    if len(raw) != want:
        raise SeqStateError(
            'torn array payload: %d bytes for shape %r dtype %s (want %d)'
            % (len(raw), shape, dtype, want))
    return onp.frombuffer(raw, dtype=dtype).reshape(shape)


def _digest(doc):
    """The seal: blake2b (16 bytes) over the canonical JSON of every
    field but the digest itself."""
    body = {k: v for k, v in doc.items() if k != 'digest'}
    blob = json.dumps(body, sort_keys=True, separators=(',', ':')).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def build_payload(kind, prompt, emitted, pos, last_token, max_new,
                  eos_id=None, request_id=None, page_size=None,
                  entries=None, adapter_id=None, sampling=None):
    """One sealed ``mxnet_tpu.seqstate.v1`` document.

    ``entries`` maps a cache entry's name to a host array: for ``paged``
    the ``(pos, *row_shape)`` valid K/V rows, for ``slot`` the slot's
    state. A ``cold`` sequence (still queued) carries none and imports
    through the ordinary admission. ``adapter_id`` pins the adapter the
    importer must re-acquire; ``sampling`` is ``{'temperature', 'top_p',
    'seed'}`` (its keys come from (seed, position), so a continuation
    draws what the source would have)."""
    if kind not in _KINDS:
        raise ValueError('kind must be one of %r, got %r' % (_KINDS, kind))
    doc = {
        'schema': SEQSTATE_SCHEMA,
        'kind': kind,
        'request_id': request_id,
        'prompt': [int(t) for t in prompt],
        'emitted': [int(t) for t in emitted],
        'pos': int(pos),
        'last_token': None if last_token is None else int(last_token),
        'max_new': int(max_new),
        'eos_id': None if eos_id is None else int(eos_id),
        'entries': {str(k): encode_array(v)
                    for k, v in (entries or {}).items()},
    }
    if page_size is not None:
        doc['page_size'] = int(page_size)
    if adapter_id is not None:
        doc['adapter_id'] = str(adapter_id)
    if sampling is not None:
        doc['sampling'] = {
            'temperature': float(sampling.get('temperature', 0.0)),
            'top_p': float(sampling.get('top_p', 1.0)),
            'seed': int(sampling.get('seed', 0))}
    doc['digest'] = _digest(doc)
    return doc


def decode_payload(obj):
    """Validate and decode a payload into host state: ``{'kind',
    'request_id', 'prompt', 'emitted', 'pos', 'last_token', 'max_new',
    'eos_id', 'page_size', 'arrays', 'adapter_id', 'sampling'}``, the
    arrays decoded per cache entry (a payload without the adapter and
    sampling blocks decodes to the base adapter, greedy). Raises
    :class:`SeqStateError` on another schema, a digest mismatch or
    inconsistent content."""
    if not isinstance(obj, dict):
        raise SeqStateError('seqstate payload must be a JSON object, got %s'
                            % type(obj).__name__)
    schema = obj.get('schema')
    if schema != SEQSTATE_SCHEMA:
        raise SeqStateError('seqstate version mismatch: got %r, this engine '
                            'speaks %r' % (schema, SEQSTATE_SCHEMA))
    if obj.get('digest') != _digest(obj):
        raise SeqStateError('torn seqstate payload: digest mismatch '
                            '(content corrupted in transit)')
    kind = obj.get('kind')
    if kind not in _KINDS:
        raise SeqStateError('unknown seqstate kind %r' % (kind,))
    try:
        prompt = [int(t) for t in obj['prompt']]
        emitted = [int(t) for t in obj.get('emitted') or []]
        pos = int(obj['pos'])
        max_new = int(obj['max_new'])
    except (KeyError, TypeError, ValueError) as exc:
        raise SeqStateError('malformed seqstate payload: %s' % (exc,))
    if not prompt:
        raise SeqStateError('seqstate payload has an empty prompt')
    if pos < 0 or pos > len(prompt) + len(emitted):
        raise SeqStateError(
            'inconsistent seqstate: pos=%d outside prompt(%d)+emitted(%d)'
            % (pos, len(prompt), len(emitted)))
    last_token = obj.get('last_token')
    if kind != 'cold' and last_token is None:
        raise SeqStateError('live seqstate payload missing last_token')
    arrays = {name: decode_array(blk)
              for name, blk in (obj.get('entries') or {}).items()}
    if kind == 'paged':
        for name, arr in arrays.items():
            if arr.shape[0] != pos:
                raise SeqStateError('paged entry %r carries %d rows for '
                                    'pos=%d' % (name, arr.shape[0], pos))
    eos_id = obj.get('eos_id')
    sampling = obj.get('sampling')
    if sampling is not None:
        try:
            sampling = {'temperature': float(sampling['temperature']),
                        'top_p': float(sampling['top_p']),
                        'seed': int(sampling['seed'])}
        except (KeyError, TypeError, ValueError) as exc:
            raise SeqStateError('malformed sampling block: %s' % (exc,))
    adapter_id = obj.get('adapter_id')
    return {
        'kind': kind,
        'request_id': obj.get('request_id'),
        'prompt': prompt,
        'emitted': emitted,
        'pos': pos,
        'last_token': None if last_token is None else int(last_token),
        'max_new': max_new,
        'eos_id': None if eos_id is None else int(eos_id),
        'page_size': obj.get('page_size'),
        'arrays': arrays,
        'adapter_id': None if adapter_id is None else str(adapter_id),
        'sampling': sampling,
    }

"""Serving knobs of the port, the counterpart of ``mxnet_tpu/config.py``.

The port keeps its own copy of the ``MXNET_TPU_SERVE_*`` knobs its
serving paths read (the decode engine, and the one-shot freeze and
micro-batcher), with the JAX package's names and defaults
(read from the environment). Constructor arguments always win over a
knob. There is no kernel on/off knob: on a CUDA tensor the kernel runs.
"""
from __future__ import annotations

import os

__all__ = ['KNOBS', 'get']

# name -> (type, default, doc)
KNOBS = {
    'MXNET_TPU_SERVE_MAX_BATCH': (
        int, 64, 'Largest micro-batch; also the default top of the '
        'batch bucket ladder.'),
    'MXNET_TPU_SERVE_DEADLINE_MS': (
        float, 5.0, 'Micro-batch flush deadline: the oldest queued '
        'request waits at most this long for batch-mates.'),
    'MXNET_TPU_SERVE_BUCKETS': (
        str, None, 'Explicit batch bucket ladder as a comma list '
        '(e.g. "1,8,32,64"); unset derives powers of two up to '
        'MXNET_TPU_SERVE_MAX_BATCH.'),
    'MXNET_TPU_SERVE_QUEUE_DEPTH': (
        int, 256, 'Admission bound on pending requests; a submit against '
        'a full queue raises BackpressureError.'),
    'MXNET_TPU_SERVE_TIMEOUT_S': (
        float, 30.0, 'Per-request budget: older requests fail with '
        'RequestTimeout; 0 disables.'),
    'MXNET_TPU_SERVE_DECODE_SLOTS': (
        int, 8, 'In-flight sequence slots of the continuous decode '
        'batch; the slot KV cache is slots x max_len.'),
    'MXNET_TPU_SERVE_PREFILL_BUCKETS': (
        str, None, 'Explicit prompt-length bucket ladder as a comma '
        'list; unset derives powers of two up to '
        'MXNET_TPU_SERVE_MAX_PREFILL.'),
    'MXNET_TPU_SERVE_MAX_PREFILL': (
        int, 64, 'Default top of the prefill ladder: the longest '
        'admissible prompt.'),
    'MXNET_TPU_SERVE_MAX_NEW_TOKENS': (
        int, 64, 'Default generation budget per request.'),
    'MXNET_TPU_SERVE_PREFILL_INTERLEAVE': (
        int, 1, 'Prefills admitted between consecutive decode steps '
        'while sequences are in flight.'),
}


def get(name):
    """Typed value of knob ``name``: the environment's, else the
    default."""
    typ, default, _doc = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None or raw.strip() == '':
        return default
    return typ(raw)

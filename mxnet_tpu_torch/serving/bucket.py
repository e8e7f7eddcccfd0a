"""Shape bucketing, the port's copy of ``mxnet_tpu/serving/bucket.py``.

Requests pad up to a small fixed ladder of sizes (powers of two by
default): prompt lengths for the decode engine's prefills, batch sizes
(axis 0, zero rows) for a frozen one-shot program. So the set of shapes a
program ever runs is bounded by the ladder. Pure shape math on the host;
sequence-length buckets of one-shot inputs are not ported.
"""
from __future__ import annotations

import numpy as onp

__all__ = ['default_buckets', 'parse_buckets', 'bucket_for', 'pad_axis0',
           'unpad_axis0', 'BucketPolicy']


def default_buckets(max_batch):
    """Powers-of-two ladder 1, 2, 4, ... up to (and always including)
    ``max_batch``."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError('max_batch must be >= 1, got %d' % max_batch)
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def _validate_ladder(vals, spec):
    """Ascending, unique, every bucket >= 1."""
    vals = sorted({int(b) for b in vals})
    if not vals or vals[0] < 1:
        raise ValueError('bad bucket ladder %r (buckets must be >= 1)'
                         % (spec,))
    return tuple(vals)


def parse_buckets(spec):
    """Parse a bucket ladder from a comma list, sorted ascending,
    duplicates dropped."""
    return _validate_ladder(
        [tok for tok in str(spec).split(',') if tok.strip()], spec)


def bucket_for(n, buckets):
    """Smallest bucket >= ``n``; ValueError past the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError('batch %d exceeds the largest bucket %d'
                     % (n, buckets[-1]))


def pad_axis0(arr, target):
    """Zero-pad ``arr`` along axis 0 up to ``target`` rows (no copy when
    already there)."""
    arr = onp.asarray(arr)
    n = arr.shape[0]
    if n == target:
        return arr
    if n > target:
        raise ValueError('cannot pad %d rows down to %d' % (n, target))
    pad = onp.zeros((target - n,) + arr.shape[1:], dtype=arr.dtype)
    return onp.concatenate([arr, pad], axis=0)


def unpad_axis0(arr, n):
    """Strip bucket padding: the first ``n`` rows."""
    return onp.asarray(arr)[:n]


class BucketPolicy:
    """An ascending bucket ladder (a comma string or a sequence)."""

    __slots__ = ('buckets',)

    def __init__(self, buckets=None, max_batch=64):
        if buckets is None:
            buckets = default_buckets(max_batch)
        elif isinstance(buckets, str):
            buckets = parse_buckets(buckets)
        else:
            buckets = _validate_ladder(buckets, buckets)
        self.buckets = buckets

    @property
    def max_batch(self):
        return self.buckets[-1]

    def bucket_for(self, n):
        return bucket_for(n, self.buckets)

    def pad(self, arrays, n=None):
        """Zero-pad each stacked input array along axis 0 to the bucket of
        ``n`` rows (default: the first array's). Returns ``(padded, n)``,
        ``n`` for :func:`unpad_axis0` on the outputs."""
        arrays = [onp.asarray(a) for a in arrays]
        if n is None:
            n = arrays[0].shape[0]
        b = self.bucket_for(n)
        return [pad_axis0(a, b) for a in arrays], n

    def __repr__(self):
        return 'BucketPolicy(buckets=%r)' % (self.buckets,)

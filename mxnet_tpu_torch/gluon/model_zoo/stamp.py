"""The zoo stamp: how a saved one-shot program rebuilds its block.

The reference's frozen artifact stores the inference graph
(``symbol.json``); the port has no symbolic API, so its artifact names
the model-zoo constructor that built the block instead. Each constructor
wrapped by :func:`zoo_constructor` puts ``{'name': <constructor>,
'kwargs': {...}}`` on the block it returns (``block.zoo_stamp``): its
arguments as JSON, ``device`` left out, a block argument as that block's
own stamp. :func:`build` calls the constructor again on a device of the
caller's choosing. A block no constructor stamped has no stamp, and a
frozen program of it cannot be saved.
"""
from __future__ import annotations

import functools
import inspect

__all__ = ['zoo_constructor', 'stamp_of', 'build']

_CONSTRUCTORS = {}


def _encode(value):
    from ..block import Block
    if isinstance(value, Block):
        inner = stamp_of(value)
        if inner is None:
            raise TypeError('an argument block carries no zoo stamp')
        return {'block': inner}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    raise TypeError('argument %r is not JSON' % (value,))


def _decode(value, device):
    if isinstance(value, list):
        return tuple(_decode(v, device) for v in value)
    if isinstance(value, dict):
        return build(value['block'], device)
    return value


def zoo_constructor(fn):
    """Register ``fn`` as a zoo constructor: the block it returns carries
    its stamp (none when an argument is not JSON: such a block cannot be
    saved)."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def construct(*args, **kwargs):
        block = fn(*args, **kwargs)
        bound = sig.bind(*args, **kwargs)
        named = {}
        for key, value in bound.arguments.items():
            if sig.parameters[key].kind is inspect.Parameter.VAR_KEYWORD:
                named.update(value)
            else:
                named[key] = value
        named.pop('device', None)
        try:
            block.zoo_stamp = {'name': fn.__name__,
                               'kwargs': {k: _encode(v)
                                          for k, v in named.items()}}
        except TypeError:
            block.zoo_stamp = None
        return block

    _CONSTRUCTORS[fn.__name__] = construct
    return construct


def stamp_of(block):
    """``block``'s zoo stamp, or None."""
    return getattr(block, 'zoo_stamp', None)


def build(stamp, device=None):
    """The block ``stamp`` describes, built anew on ``device`` (default
    cuda), its parameters allocated, not set. Raises ValueError for an
    unknown constructor."""
    from . import bert, resnet, ssd  # noqa: F401  (they register)
    fn = _CONSTRUCTORS.get(stamp.get('name'))
    if fn is None:
        raise ValueError('unknown zoo constructor %r (have %s)'
                         % (stamp.get('name'), sorted(_CONSTRUCTORS)))
    kwargs = {k: _decode(v, device) for k, v in stamp['kwargs'].items()}
    return fn(device=device, **kwargs)

"""Device contexts, the port's counterpart of ``mxnet_tpu/context.py``.

The JAX package maps contexts onto XLA devices. The port has one rule:
work runs on the CUDA card unless the caller asks for the CPU by name.
A host without CUDA is an error, never a silent move to the CPU.

:class:`Context` is the imperative surface's device: ``gpu(i)`` is card
``i``, ``cpu()`` the host. ``with mx.cpu():`` makes the CPU the default
of everything made inside the scope (``current_context``), as the
reference's context scope does; outside any scope the default is
``gpu(0)``, which raises where there is no card. :func:`resolve_device`
maps a context, a ``torch.device``, a name or None (the scope's default)
onto a ``torch.device``.
"""
from __future__ import annotations

import threading

import torch

__all__ = ['Context', 'cpu', 'gpu', 'current_context', 'resolve_device']

_DEVTYPE_NAMES = {1: 'cpu', 2: 'gpu'}
_DEVTYPE_IDS = {v: k for k, v in _DEVTYPE_NAMES.items()}


class Context:
    """A device context: ``Context('gpu', 0)`` or ``Context('cpu')``; a
    ``with`` scope makes it the default."""

    _default_ctx = threading.local()
    devtype2str = _DEVTYPE_NAMES
    devstr2type = _DEVTYPE_IDS

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
            return
        if device_type not in _DEVTYPE_IDS:
            raise ValueError('unknown device type %r (the port has cpu and '
                             'gpu)' % (device_type,))
        self.device_typeid = _DEVTYPE_IDS[device_type]
        self.device_id = 0 if device_id is None else int(device_id)

    @property
    def device_type(self):
        return _DEVTYPE_NAMES[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return '%s(%d)' % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = current_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    def torch_device(self):
        """The ``torch.device`` of this context (raises for a card on a
        host without CUDA)."""
        if self.device_type == 'cpu':
            return torch.device('cpu')
        return resolve_device(torch.device('cuda', self.device_id))

    @staticmethod
    def of(device):
        """The context of a ``torch.device``."""
        device = torch.device(device)
        if device.type == 'cpu':
            return Context('cpu', 0)
        return Context('gpu', device.index or 0)


def cpu(device_id=0):
    """The host."""
    return Context('cpu', device_id)


def gpu(device_id=0):
    """CUDA card ``device_id``."""
    return Context('gpu', device_id)


def current_context():
    """The innermost ``with ctx:`` scope's context; ``gpu(0)`` outside
    any."""
    return getattr(Context._default_ctx, 'value', None) or Context('gpu', 0)


def resolve_device(device=None):
    """Return the ``torch.device`` to run on.

    ``None`` means the current context (``cuda`` outside a ``with
    mx.cpu():`` scope); a :class:`Context` its device. A CUDA device
    raises ``RuntimeError`` when ``torch.cuda.is_available()`` is false;
    ``'cpu'`` is honoured as given (the tests pass it to run the plain
    PyTorch versions).
    """
    if device is None:
        device = getattr(Context._default_ctx, 'value', None) or 'cuda'
    if isinstance(device, Context):
        device = 'cpu' if device.device_type == 'cpu' \
            else torch.device('cuda', device.device_id)
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'mxnet_tpu_torch runs on a CUDA device by default, but '
                'torch.cuda.is_available() is False on this host; pass '
                "device='cpu' (or use `with mx.cpu():`) to run the plain "
                'PyTorch versions')
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError('unsupported device %r (cuda or cpu)' % (device,))
    return dev

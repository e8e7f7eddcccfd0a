"""Weight initializers, the counterpart of ``mxnet_tpu/initializer.py``.

The same classes, registry and name-suffix dispatch (``weight``,
``bias``, ``gamma``, ``beta``, the moving / running statistics) as the
JAX package. Each random initializer draws on the host from an explicit
``torch.Generator``: the one given as ``generator=``, else the port's
host generator (:func:`mxnet_tpu_torch.random.host_generator`, reset by
``mx.random.seed``). The JAX package draws from numpy's global RNG: the
port's draws have the same bounds and moments, not the same bits. The
array an initializer fills is an ``NDArray`` (``arr[:] = value``), on the
host when a gluon ``Parameter`` initializes, which then moves it once to
its device.
"""
from __future__ import annotations

import json
import logging
import re

import numpy as onp
import torch

from . import random as _random
from .base import string_types
from .ndarray import NDArray

_INITIALIZER_REGISTRY = {}

__all__ = ['InitDesc', 'Initializer', 'register', 'create', 'Zero', 'One',
           'Constant', 'Uniform', 'Normal', 'Orthogonal', 'Xavier',
           'MSRAPrelu', 'Bilinear', 'LSTMBias', 'Load', 'Mixed', 'FusedRNN']


class InitDesc(str):
    """Parameter name + attrs handed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        desc = super().__new__(cls, name)
        desc.attrs = attrs or {}
        desc.global_init = global_init
        return desc


def register(klass):
    """Register an initializer class under its lowercase name."""
    _INITIALIZER_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(initializer, **kwargs):
    if isinstance(initializer, Initializer):
        return initializer
    if isinstance(initializer, string_types):
        return _INITIALIZER_REGISTRY[initializer.lower()](**kwargs)
    if callable(initializer):
        return initializer
    raise ValueError('cannot create initializer from %r' % (initializer,))


def _shape(arr):
    return tuple(arr.shape)


class Initializer:
    """Base initializer with MXNet's name-suffix dispatch."""

    _DISPATCH = (
        ('weight_quantize', '_init_quantized_weight', None),
        ('weight', '_init_weight', 'weight'),
        ('bias', '_init_bias', 'bias'),
        ('gamma', '_init_gamma', 'gamma'),
        ('beta', '_init_beta', 'beta'),
        ('min', '_init_zero', None),
        ('max', '_init_one', None),
        ('moving_mean', '_init_zero', None),
        ('moving_var', '_init_one', None),
        ('moving_inv_var', '_init_zero', None),
        ('moving_avg', '_init_zero', None),
        ('running_mean', '_init_zero', None),
        ('running_var', '_init_one', None),
    )

    def __init__(self, generator=None, **kwargs):
        self._kwargs = kwargs
        self._generator = generator
        self._verbose, self._print_func = False, None

    @property
    def generator(self):
        """The ``torch.Generator`` the draws come from (a CPU one)."""
        return self._generator if self._generator is not None \
            else _random.host_generator()

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose = verbose
        self._print_func = print_func or (lambda x: float(
            onp.linalg.norm(x.asnumpy()) / onp.sqrt(x.size)))
        return self

    def dumps(self):
        """JSON [name, kwargs] form, re-creatable via ``create``."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def _verbose_print(self, desc, init, arr):
        if self._verbose and self._print_func:
            logging.info('Initialized %s as %s: %s', desc, init,
                         self._print_func(arr))

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        if desc.global_init is None:
            desc.global_init = self
        spec = desc.attrs.get('__init__', '')
        if spec:
            kind, kwargs = json.loads(spec)
            create(kind, **kwargs)._init_weight(desc, arr)
            self._verbose_print(desc, spec, arr)
            return
        for suffix, handler, label in self._DISPATCH:
            if desc.endswith(suffix):
                getattr(self, handler)(desc, arr)
                if label:
                    self._verbose_print(desc, label, arr)
                return
        self._init_default(desc, arr)

    # -- draws -------------------------------------------------------------

    def _uniform(self, low, high, shape):
        u = torch.rand(shape, generator=self.generator, dtype=torch.float64)
        return (low + (high - low) * u).to(torch.float32)

    def _normal(self, loc, scale, shape):
        z = torch.randn(shape, generator=self.generator, dtype=torch.float64)
        return (loc + scale * z).to(torch.float32)

    # -- typed initializers ------------------------------------------------

    @staticmethod
    def _set(arr, value):
        if isinstance(value, torch.Tensor):
            value = value.to(arr._data.dtype if isinstance(arr, NDArray)
                             else arr.dtype)
        arr[:] = value

    def _init_bilinear(self, _, arr):
        shape = _shape(arr)
        f = onp.ceil(shape[3] / 2.)
        c = (2 * f - 1 - f % 2) / (2. * f)
        xs = onp.arange(shape[3], dtype='float32')
        ys = onp.arange(shape[2], dtype='float32')
        ky = 1 - onp.abs(ys / f - c)
        kx = 1 - onp.abs(xs / f - c)
        kernel = onp.outer(ky, kx).astype('float32')
        self._set(arr, onp.broadcast_to(kernel, shape).copy())

    def _init_loc_bias(self, _, arr):
        if _shape(arr)[0] != 6:
            raise AssertionError('loc bias expects 6 elements')
        self._set(arr, onp.array([1.0, 0, 0, 0, 1.0, 0], dtype='float32'))

    def _init_zero(self, _, arr):
        self._set(arr, 0.0)

    def _init_one(self, _, arr):
        self._set(arr, 1.0)

    def _init_bias(self, _, arr):
        self._set(arr, 0.0)

    def _init_gamma(self, _, arr):
        self._set(arr, 1.0)

    def _init_beta(self, _, arr):
        self._set(arr, 0.0)

    def _init_quantized_weight(self, _, arr):
        codes = torch.randint(-127, 127, _shape(arr),
                              generator=self.generator)
        self._set(arr, codes.to(torch.int8))

    def _init_weight(self, name, arr):
        raise NotImplementedError('Must override it')

    def _init_default(self, name, arr):
        raise ValueError(
            'Unknown initialization pattern for %s. Default initialization '
            'is now limited to "weight", "bias", "gamma" (1.0), and "beta" '
            '(0.0). Please use mx.sym.Variable(init=mx.init.*) to set '
            'initialization pattern' % name)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._set(arr, 0.0)


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        self._set(arr, 1.0)


_INITIALIZER_REGISTRY['zeros'] = Zero
_INITIALIZER_REGISTRY['ones'] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        v = self.value
        if isinstance(v, NDArray):
            v = v.asnumpy()
        elif isinstance(v, (list, tuple)):
            v = onp.asarray(v, dtype=onp.float32)
        self._set(arr, v)


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator=generator, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._set(arr, self._uniform(-self.scale, self.scale, _shape(arr)))


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator=generator, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._set(arr, self._normal(0.0, self.sigma, _shape(arr)))


@register
class Orthogonal(Initializer):
    """Orthonormal rows or columns from the SVD of a random matrix."""

    def __init__(self, scale=1.414, rand_type='uniform', generator=None):
        super().__init__(generator=generator, scale=scale,
                         rand_type=rand_type)
        self.scale, self.rand_type = scale, rand_type

    def _init_weight(self, _, arr):
        shape = _shape(arr)
        rows = shape[0]
        cols = int(onp.prod(shape[1:]))
        seed = (self._uniform(-1.0, 1.0, (rows, cols))
                if self.rand_type == 'uniform'
                else self._normal(0.0, 1.0, (rows, cols))).double().numpy()
        u, _, vt = onp.linalg.svd(seed, full_matrices=False)
        basis = u if u.shape == seed.shape else vt
        self._set(arr, (self.scale * basis).reshape(shape).astype(
            'float32'))


@register
class Xavier(Initializer):
    """Glorot scaling from fan-in / fan-out."""

    _FACTORS = {'avg': lambda fi, fo: (fi + fo) / 2.0,
                'in': lambda fi, fo: fi,
                'out': lambda fi, fo: fo}

    def __init__(self, rnd_type='uniform', factor_type='avg', magnitude=3,
                 generator=None):
        super().__init__(generator=generator, rnd_type=rnd_type,
                         factor_type=factor_type, magnitude=magnitude)
        self.rnd_type, self.factor_type = rnd_type, factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = _shape(arr)
        if len(shape) < 2:
            raise ValueError(
                'Xavier initializer cannot be applied to vector %s. It '
                'requires at least 2D.' % name)
        receptive = onp.prod(shape[2:]) if len(shape) > 2 else 1.
        fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
        try:
            factor = self._FACTORS[self.factor_type](fan_in, fan_out)
        except KeyError:
            raise ValueError('Incorrect factor type')
        scale = float(onp.sqrt(self.magnitude / factor))
        if self.rnd_type == 'uniform':
            draw = self._uniform(-scale, scale, shape)
        elif self.rnd_type == 'gaussian':
            draw = self._normal(0.0, scale, shape)
        else:
            raise ValueError('Unknown random type')
        self._set(arr, draw)


@register
class MSRAPrelu(Xavier):
    """He init adjusted for the PReLU slope."""

    def __init__(self, factor_type='avg', slope=0.25, generator=None):
        super().__init__('gaussian', factor_type, 2. / (1 + slope ** 2),
                         generator=generator)
        self._kwargs = {'factor_type': factor_type, 'slope': slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernels (for a deconvolution)."""

    def _init_weight(self, name, arr):
        self._init_bilinear(name, arr)


@register
class LSTMBias(Initializer):
    """Zero bias with the forget gate's quarter set to ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        gates = onp.zeros(_shape(arr), dtype='float32')
        width = int(_shape(arr)[0] / 4)
        gates[width:2 * width] = self.forget_bias
        self._set(arr, gates)


@register
class Load:
    """Init from a dict (or a .params file) of arrays, falling back to
    ``default_init`` for absent names."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray.ndarray import load_numpy
            param = load_numpy(param)
        self.param = {
            (name[4:] if name.startswith(('arg:', 'aux:')) else name): arr
            for name, arr in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def _note(self, name, how):
        if self.verbose:
            logging.info('Initialized %s by %s', name, how)

    def __call__(self, name, arr):
        src = self.param.get(name)
        if src is not None:
            if tuple(arr.shape) != tuple(src.shape):
                raise AssertionError(
                    'Parameter %s cannot be initialized from loading. '
                    'Shape mismatch, target %s vs loaded %s'
                    % (name, arr.shape, src.shape))
            arr[:] = src.asnumpy() if isinstance(src, NDArray) else src
            self._note(name, 'loading')
        else:
            if self.default_init is None:
                raise AssertionError(
                    'Cannot Initialize %s. Not found in loaded param and '
                    'no default Initializer is provided.' % name)
            self.default_init(name, arr)
            self._note(name, 'default')


@register
class Mixed:
    """First-match regex dispatch over parameter names."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise AssertionError('need one initializer per pattern')
        self.map = [(re.compile(p), init)
                    for p, init in zip(patterns, initializers)]

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(
            'Parameter name %s did not match any pattern. Consider adding '
            'a ".*" pattern at the and with default Initializer.' % name)


@register
class FusedRNN(Initializer):
    """Initialize a fused RNN parameter blob with the wrapped init."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            kind, kwargs = json.loads(init)
            init = _INITIALIZER_REGISTRY[kind.lower()](**kwargs)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden, self._num_layers = num_hidden, num_layers
        self._mode = mode
        self._bidirectional, self._forget_bias = bidirectional, forget_bias

    def _init_weight(self, desc, arr):
        if self._init is not None:
            self._init._init_weight(desc, arr)

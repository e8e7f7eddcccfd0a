"""Learning-rate schedulers, the counterpart of
``mxnet_tpu/lr_scheduler.py`` (a copy: the schedulers are plain Python).

Factor, MultiFactor, Poly and Cosine schedules with a linear or constant
warm-up, each a pure function of the update count (every call recomputes
the lr), so a resumed run continues the schedule. The port's
``Optimizer`` reads one through ``lr_scheduler=``: its ``base_lr`` is the
optimizer's learning rate, and each update's lr is the schedule at the
optimizer's ``num_update``.
"""
from __future__ import annotations

import bisect
import math

__all__ = ['LRScheduler', 'FactorScheduler', 'MultiFactorScheduler',
           'PolyScheduler', 'CosineScheduler']


class LRScheduler:
    """Base: lr = f(num_update) with an optional warmup phase.

    warmup_mode 'linear' ramps from warmup_begin_lr to base_lr over
    warmup_steps; 'constant' holds warmup_begin_lr until warmup ends.
    """

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode='linear'):
        if not isinstance(warmup_steps, int) or warmup_steps < 0:
            raise ValueError('Warmup steps has to be positive or 0')
        if warmup_begin_lr > base_lr:
            raise ValueError('Base lr has to be higher than '
                             'warmup_begin_lr')
        if warmup_mode not in ('linear', 'constant'):
            raise ValueError('Supports only linear and constant modes '
                             'of warmup')
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == 'constant':
            return self.warmup_begin_lr
        frac = num_update / float(self.warmup_steps)
        return self.warmup_begin_lr + \
            frac * (self.warmup_final_lr - self.warmup_begin_lr)

    def _decayed(self, steps_after_warmup):
        """Post-warmup schedule; subclasses implement this."""
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._decayed(num_update)


class FactorScheduler(LRScheduler):
    """lr = base_lr * factor^(floor updates/step), floored at
    stop_factor_lr."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode='linear'):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr,
                         warmup_mode)
        if step < 1:
            raise ValueError('Schedule step must be greater or equal '
                             'than 1 round')
        if factor > 1.0:
            raise ValueError('Factor must be no more than 1 to make lr '
                             'reduce')
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self._base_lr0 = base_lr

    def _decayed(self, num_update):
        # reference semantics: decay count = number of *completed* windows
        # strictly before num_update (boundary update keeps the old lr)
        n = max(0, (num_update - 1) // self.step)
        lr = self._base_lr0 * (self.factor ** n)
        self.base_lr = max(lr, self.stop_factor_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor after each milestone in `step` (strictly
    increasing)."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode='linear'):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr,
                         warmup_mode)
        if not isinstance(step, list) or not step:
            raise ValueError('step must be a non-empty list')
        if any(s < 1 for s in step):
            raise ValueError('Schedule step must be greater or equal '
                             'than 1 round')
        if any(b >= a for a, b in zip(step[1:], step[:-1])):
            raise ValueError('Schedule step must be an increasing '
                             'integer list')
        if factor > 1.0:
            raise ValueError('Factor must be no more than 1 to make lr '
                             'reduce')
        self.step = step
        self.factor = factor
        self._base_lr0 = base_lr

    def _decayed(self, num_update):
        # milestones passed = count of step values < num_update
        n = bisect.bisect_left(self.step, num_update)
        self.base_lr = self._base_lr0 * (self.factor ** n)
        return self.base_lr


class _SpanScheduler(LRScheduler):
    """Shared shape for poly/cosine: interpolate base_lr -> final_lr over
    [warmup_steps, max_update]."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode='linear'):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr,
                         warmup_mode)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError('maximum number of updates must be strictly '
                             'positive')
        self.max_update = max_update
        self.final_lr = final_lr
        self.base_lr_orig = base_lr
        self.max_steps = max_update - warmup_steps

    def _shape(self, t):
        """t in [0, 1] -> decay multiplier in [1, 0]."""
        raise NotImplementedError

    def _decayed(self, num_update):
        if num_update <= self.max_update:
            t = (num_update - self.warmup_steps) / float(self.max_steps)
            self.base_lr = self.final_lr + \
                (self.base_lr_orig - self.final_lr) * self._shape(t)
        return self.base_lr


class PolyScheduler(_SpanScheduler):
    """Polynomial decay (1 - t)^pwr down to final_lr."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode='linear'):
        super().__init__(max_update, base_lr, final_lr, warmup_steps,
                         warmup_begin_lr, warmup_mode)
        self.power = pwr

    def _shape(self, t):
        return (1.0 - t) ** self.power


class CosineScheduler(_SpanScheduler):
    """Half-cosine decay down to final_lr."""

    def _shape(self, t):
        return (1.0 + math.cos(math.pi * t)) / 2.0

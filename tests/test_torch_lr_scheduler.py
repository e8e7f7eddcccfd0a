"""The port's learning-rate schedulers (``mxnet_tpu_torch/lr_scheduler.py``)
against the JAX package's: every scheduler, with and without warm-up,
over 60 updates, equal to the last bit (both are plain Python floats);
and the port's optimizer reading one through ``lr_scheduler=``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx

CASES = {
    'factor': lambda m: m.FactorScheduler(step=7, factor=0.5,
                                          stop_factor_lr=1e-4, base_lr=0.1),
    'factor_warmup': lambda m: m.FactorScheduler(
        step=5, factor=0.9, base_lr=0.2, warmup_steps=10,
        warmup_begin_lr=0.01),
    'multifactor': lambda m: m.MultiFactorScheduler(step=[10, 25, 40],
                                                    factor=0.3, base_lr=0.5),
    'multifactor_warmup_constant': lambda m: m.MultiFactorScheduler(
        step=[20, 30], factor=0.5, base_lr=0.4, warmup_steps=8,
        warmup_begin_lr=0.05, warmup_mode='constant'),
    'poly': lambda m: m.PolyScheduler(max_update=50, base_lr=0.3, pwr=2,
                                      final_lr=0.01),
    'poly_warmup': lambda m: m.PolyScheduler(max_update=50, base_lr=0.3,
                                             pwr=1, warmup_steps=5),
    'cosine': lambda m: m.CosineScheduler(max_update=45, base_lr=0.25,
                                          final_lr=0.001),
    'cosine_warmup': lambda m: m.CosineScheduler(
        max_update=45, base_lr=0.25, warmup_steps=6, warmup_begin_lr=0.0),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_schedule_matches_jax(name):
    j = CASES[name](jmx.lr_scheduler)
    p = CASES[name](pmx.lr_scheduler)
    want = [j(t) for t in range(60)]
    got = [p(t) for t in range(60)]
    assert got == want
    # a recomputed schedule is the same (resume-safe)
    assert [p(t) for t in (59, 3, 30)] == [want[59], want[3], want[30]]


@pytest.mark.parametrize('bad', [
    dict(step=0), dict(step=2, factor=1.5)])
def test_factor_arguments_are_checked(bad):
    for m in (jmx.lr_scheduler, pmx.lr_scheduler):
        with pytest.raises(ValueError):
            m.FactorScheduler(**bad)


def test_optimizer_reads_the_schedule():
    """The optimizer's lr at each update is the schedule's at its update
    count, times the parameter's lr_mult."""
    from mxnet_tpu_torch.optimizer import optimizer as popt
    sched = pmx.lr_scheduler.FactorScheduler(step=2, factor=0.5,
                                             base_lr=0.4)
    opt = popt.create('sgd', learning_rate=0.4, lr_scheduler=sched)
    opt.set_lr_mult({0: 2.0})
    lrs = []
    for _ in range(6):
        lrs.append(opt._begin(0)[0])
    want = [2.0 * pmx.lr_scheduler.FactorScheduler(
        step=2, factor=0.5, base_lr=0.4)(t) for t in range(1, 7)]
    np.testing.assert_allclose(lrs, want, rtol=0, atol=0)
    assert opt.learning_rate == sched(opt.num_update)

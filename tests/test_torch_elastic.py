"""Port parity of the trainer's resilience hooks and the elastic resume
(``mxnet_tpu_torch/parallel/train_step.py``,
``mxnet_tpu_torch/resilience/elastic.py``, ``resilience/__main__.py``)
against the JAX package's, on the CPU.

  * the reference's ``shrink_plan`` tests (``tests/test_elastic.py:
    166-200``), ``host_loss_plan`` and ``available_devices`` beside the
    JAX package's;
  * the reference's trainer tests (:244-308) on the port: a resume from a
    checkpoint bit-identical to the uninterrupted run, a scripted preempt
    at step 4 with checkpoints every 2 steps (``Preempted`` carrying
    ``path_for(4)``), ``step_accum`` against one full-batch step;
  * the refusal with ``MXNET_TPU_ELASTIC=0`` (:343) of a JAX ``dp=2``
    trainer's checkpoint, and its elastic resume with accumulation;
  * across the packages, both ways, for SGD with momentum and AdamW: a
    trainer checkpoints at step 3 and the other package's resumes it; the
    next 3 losses agree within 1e-5 and the parameters within rtol 1e-5,
    atol 1e-6 (the reference's ``step_accum`` tier). The optimizer state
    crosses in the reference's ``leaves`` order, which the port's
    ``_state_tensors`` order is pinned to here; after ``cast('bfloat16')``
    the file holds the bf16 state widened to float32, narrowed back bit
    for bit on restore;
  * the self-test: ``python -m mxnet_tpu.resilience --train --devices 2``
    preempted at step 9, then ``python -m mxnet_tpu_torch.resilience
    --train --device cpu`` resuming its checkpoint with accumulation 2,
    the losses tracking the JAX package's uninterrupted 2-device run at
    rtol 1e-4, atol 1e-5 (``tests/test_elastic.py:340``); and the port's
    own preempt / restart / watchdog legs.

The nets are the reference's test MLPs (Dense(16, relu) -> Dense(3) over 6
features), their Xavier weights drawn by the JAX package from numpy seed 5
and carried into the port by name.
"""
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu.resilience import elastic as jax_elastic
from mxnet_tpu_torch import observability as port_obs
from mxnet_tpu_torch import parallel as port_parallel
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon import nn as port_nn
from mxnet_tpu_torch.gluon.block import params_from_jax
from mxnet_tpu_torch.resilience import (
    CheckpointManager, ElasticPlan, FaultInjector, MeshShrinkError,
    Preempted, PreemptionHandler, available_devices, host_loss_plan,
    load_state, mesh_meta, shrink_plan)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURES, HIDDEN, CLASSES = 6, 16, 3
OPTS = {'sgd': {'learning_rate': 0.1, 'momentum': 0.9},
        'adamw': {'learning_rate': 0.01, 'wd': 0.01}}
LOSS_TOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6


def _bat(step, batch=8):
    rs = np.random.RandomState(100 + step)
    return (rs.randn(batch, FEATURES).astype('float32'),
            rs.randint(0, CLASSES, (batch,)).astype('float32'))


# -- planning ---------------------------------------------------------------

def test_shrink_plan_halves_dp_with_accumulation():
    plan = shrink_plan({'axes': {'dp': 8}, 'device_count': 8}, 4)
    assert isinstance(plan, ElasticPlan)
    assert plan.new_axes == {'dp': 4} and plan.accum_steps == 2
    assert plan.changed
    d = plan.as_dict()
    assert d['old_axes'] == {'dp': 8} and d['accum_steps'] == 2
    assert d == jax_elastic.shrink_plan(
        {'axes': {'dp': 8}, 'device_count': 8}, 4).as_dict()


def test_shrink_plan_intact_mesh_is_identity():
    plan = shrink_plan({'axes': {'dp': 8}, 'device_count': 8}, 8)
    assert not plan.changed and plan.accum_steps == 1


def test_shrink_plan_preserves_model_parallel_axes():
    meta = {'axes': {'dp': 4, 'tp': 2}, 'device_count': 8}
    plan = shrink_plan(meta, 4)
    assert plan.new_axes == {'dp': 2, 'tp': 2}
    assert plan.accum_steps == 2
    with pytest.raises(MeshShrinkError):
        shrink_plan(meta, 1)
    with pytest.raises(MeshShrinkError):
        shrink_plan(meta, 6)


def test_shrink_plan_rejects_indivisible_shrink():
    with pytest.raises(MeshShrinkError, match='divide'):
        shrink_plan({'axes': {'dp': 8}, 'device_count': 8}, 3)
    with pytest.raises(MeshShrinkError, match='batch'):
        shrink_plan({'axes': {'dp': 8}, 'device_count': 8}, 4,
                    global_batch=12)


@pytest.mark.parametrize('meta,surviving', [
    ({'axes': {'dp': 8}, 'device_count': 8, 'process_count': 2}, 1),
    ({'axes': {'dp': 4, 'tp': 2}, 'device_count': 8, 'process_count': 4},
     2)])
def test_host_loss_plan_is_the_references(meta, surviving):
    port_obs.set_enabled(True)
    port_obs.get_recorder().clear()
    try:
        got = host_loss_plan(meta, surviving).as_dict()
    finally:
        port_obs.set_enabled(None)
    assert got == jax_elastic.host_loss_plan(meta, surviving).as_dict()
    assert got['note'].startswith('host loss:')
    ev = [e for e in port_obs.get_recorder().events()
          if e['kind'] == 'host_lost']
    assert ev and ev[-1]['accum_steps'] == got['accum_steps']


def test_mesh_meta_of_the_port_is_one_device():
    want = {'axes': {'dp': 1}, 'device_count': 1, 'process_count': 1}
    assert mesh_meta(None) == mesh_meta({'dp': 1}) == want
    assert mesh_meta(['cpu', 'cpu']) == {'axes': {'dp': 2},
                                         'device_count': 2,
                                         'process_count': 1}
    assert shrink_plan(['a', 'b'], 1).accum_steps == 2


def test_available_devices_honors_device_loss(caplog):
    inj = FaultInjector('device_loss@elastic.restart:1')
    with caplog.at_level(logging.WARNING):
        devs = available_devices(injector=inj, platform='cpu')
    assert devs == [torch.device('cpu')]
    assert 'restart sees 1 device(s)' in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert available_devices(injector=inj, platform='cpu') == devs
    assert 'restart sees' not in caplog.text      # consumed


# -- the trainers -----------------------------------------------------------

@pytest.fixture(scope='module')
def weights():
    """The reference's test MLP's Xavier weights (numpy seed 5), by
    name."""
    import mxnet_tpu as mx
    from mxnet_tpu import nd
    from mxnet_tpu.gluon import nn
    np.random.seed(5)
    mx.random.seed(5)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(HIDDEN, activation='relu'), nn.Dense(CLASSES))
    net.initialize(mx.init.Xavier())
    net(nd.zeros((1, FEATURES)))
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _port_pt(weights, opt='sgd'):
    net = port_nn.HybridSequential()
    net.add(port_nn.Dense(HIDDEN, activation='relu', in_units=FEATURES,
                          prefix='dense0_', device='cpu'),
            port_nn.Dense(CLASSES, in_units=HIDDEN, prefix='dense1_',
                          device='cpu'))
    params_from_jax(weights, net)
    pt = port_parallel.ParallelTrainer(
        net, port_loss.SoftmaxCrossEntropyLoss(), opt, dict(OPTS[opt]))
    return net, pt


def _jax_pt(weights, opt='sgd', dp=1):
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu import gluon, nd, parallel
    from mxnet_tpu.gluon import nn
    mx.random.seed(5)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(HIDDEN, activation='relu'), nn.Dense(CLASSES))
    net.initialize(mx.init.Xavier())
    net(nd.zeros((1, FEATURES)))
    for p, w in zip(net.collect_params().values(), weights.values()):
        p.set_data(nd.array(w))
    mesh = parallel.create_mesh({'dp': dp}, devices=jax.devices()[:dp])
    pt = parallel.ParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                  opt, dict(OPTS[opt]), mesh)
    return net, pt


def _t(batch):
    return torch.tensor(batch[0]), torch.tensor(batch[1])


def _nd(batch):
    from mxnet_tpu import nd
    return nd.array(batch[0]), nd.array(batch[1])


def _port_params(net):
    return [p.detach().numpy().copy() for p in net.collect_params().tensors().values()]


def _jax_params(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def test_parallel_trainer_checkpoint_resume_bit_identical(weights, tmp_path):
    net_a, pt_a = _port_pt(weights)
    pt_a.build(*_t(_bat(0)))
    for s in range(6):
        pt_a.step(*_t(_bat(s)))

    net_b, pt_b = _port_pt(weights)
    pt_b.build(*_t(_bat(0)))
    mgr = CheckpointManager(str(tmp_path), prefix='pt')
    for s in range(3):
        pt_b.step(*_t(_bat(s)))
    pt_b.save_checkpoint(mgr)
    state = mgr.latest()[1]
    assert state['mesh'] == mesh_meta(None)
    assert state['generator'].dtype == np.uint8

    net_c, pt_c = _port_pt(weights)
    pt_c.build(*_t(_bat(0)))
    step, plan = pt_c.resume(mgr)
    assert step == 3 and plan is None and pt_c.num_update == 3
    for s in range(3, 6):
        pt_c.step(*_t(_bat(s)))
    for a, c in zip(_port_params(net_a), _port_params(net_c)):
        assert np.array_equal(a, c)


def test_parallel_trainer_attached_checkpoint_and_preempt(weights,
                                                          tmp_path):
    mgr = CheckpointManager(str(tmp_path), prefix='pt')
    inj = FaultInjector('preempt@train.step.4:1')
    net, pt = _port_pt(weights)
    pt.build(*_t(_bat(0)))
    pt.attach_preemption(PreemptionHandler(injector=inj))
    pt.attach_checkpointing(mgr, every_n=2)
    with pytest.raises(SystemExit) as ei:
        for s in range(8):
            pt.step(*_t(_bat(s)))
    exc = ei.value
    assert isinstance(exc, Preempted) and exc.step == 4
    assert exc.code == 75
    # periodic checkpoints at 2 and 4 (the step-4 one is the drain's)
    assert exc.checkpoint == mgr.path_for(4)
    assert mgr.latest()[0] == 4 and mgr._steps() == [2, 4]


def test_step_accum_matches_single_step_to_fp_tolerance(weights):
    net, pt = _port_pt(weights)
    x, y = _t(_bat(1))
    pt.build(x, y)
    snap = pt.snapshot()
    loss_one = float(pt.step(x, y))
    params_one = _port_params(net)
    pt.restore(snap)
    loss_acc = float(pt.step_accum(x, y, 2))
    assert abs(loss_one - loss_acc) < 1e-5
    for a, b in zip(params_one, _port_params(net)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert pt.num_update == 1


@pytest.fixture(scope='module')
def dp2_checkpoint(weights, tmp_path_factory):
    """A JAX dp=2 trainer after 3 steps of batch 8, its checkpoint, and
    the 3 losses it goes on to."""
    from mxnet_tpu.resilience import CheckpointManager as JaxManager
    root = str(tmp_path_factory.mktemp('dp2'))
    net, pt = _jax_pt(weights, dp=2)
    pt.build(*_nd(_bat(0)))
    for s in range(3):
        pt.step(*_nd(_bat(s)))
    pt.save_checkpoint(JaxManager(root, prefix='pt'))
    ref = [float(pt.step(*_nd(_bat(s))).asnumpy()) for s in range(3, 6)]
    return root, ref


def test_resume_refuses_shrink_when_elastic_disabled(weights, dp2_checkpoint,
                                                     monkeypatch):
    root, _ = dp2_checkpoint
    net, pt = _port_pt(weights)
    pt.build(*_t(_bat(0, batch=4)))
    monkeypatch.setenv('MXNET_TPU_ELASTIC', '0')
    with pytest.raises(MeshShrinkError, match='disabled'):
        pt.resume(CheckpointManager(root, prefix='pt'))
    with pytest.raises(MeshShrinkError, match='disabled'):
        pt.resume(CheckpointManager(root, prefix='pt'), elastic=False)
    assert pt.num_update == 0


def test_elastic_resume_of_a_dp2_checkpoint_tracks_it(weights,
                                                      dp2_checkpoint,
                                                      monkeypatch):
    root, ref = dp2_checkpoint
    net, pt = _port_pt(weights)
    pt.build(*_t(_bat(0, batch=4)))        # microbatch shapes
    monkeypatch.setenv('MXNET_TPU_ELASTIC', '1')
    step, plan = pt.resume(CheckpointManager(root, prefix='pt'))
    assert step == 3 and plan.accum_steps == 2
    assert plan.new_axes == {'dp': 1}
    got = [float(pt.step_accum(*_t(_bat(s)), 2)) for s in range(3, 6)]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('opt', sorted(OPTS))
def test_leaves_cross_in_the_references_order(weights, opt, tmp_path):
    """The JAX trainer's ``leaves`` and the port's optimizer-state tensors
    after the same 3 steps, position by position (SGD: one momentum a
    parameter; AdamW: mean then variance)."""
    from mxnet_tpu.resilience import CheckpointManager as JaxManager
    jnet, jpt = _jax_pt(weights, opt)
    pnet, ppt = _port_pt(weights, opt)
    for s in range(3):
        jpt.step(*_nd(_bat(s)))
        ppt.step(*_t(_bat(s)))
    jstate = load_state(jpt.save_checkpoint(
        JaxManager(str(tmp_path / 'j'), prefix='pt')))
    pstate = load_state(ppt.save_checkpoint(
        CheckpointManager(str(tmp_path / 'p'), prefix='pt')))
    assert sorted(set(jstate) - {'base_key', 'rng'}) == sorted(
        set(pstate) - {'base_key', 'rng', 'generator'})
    per = {'sgd': 1, 'adamw': 2}[opt]
    assert len(pstate['leaves']) == len(jstate['leaves']) == 4 * per
    shapes = [w.shape for w in weights.values()]
    assert [a.shape for a in pstate['leaves']] == [
        s for s in shapes for _ in range(per)]
    for got, want in zip(pstate['leaves'], jstate['leaves']):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    for got, want in zip(pstate['params'], jstate['params']):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert pstate['update_counts'] == jstate['update_counts']
    assert (pstate['num_update'], pstate['opt_num_update'], pstate['amp'],
            pstate['zero']) == (jstate['num_update'], jstate['opt_num_update'],
                                jstate['amp'], jstate['zero'])


@pytest.mark.parametrize('opt', sorted(OPTS))
@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_a_checkpoint_crosses_the_packages(weights, opt, writer, tmp_path):
    """One package's trainer checkpoints at step 3, the other's resumes;
    the next 3 losses and the parameters after them hold the reference's
    step_accum tier against the writer's own uninterrupted run."""
    from mxnet_tpu.resilience import CheckpointManager as JaxManager
    root = str(tmp_path)
    if writer == 'jax':
        wnet, wpt = _jax_pt(weights, opt)
        for s in range(3):
            wpt.step(*_nd(_bat(s)))
        wpt.save_checkpoint(JaxManager(root, prefix='pt'))
        want = [float(wpt.step(*_nd(_bat(s))).asnumpy())
                for s in range(3, 6)]
        want_params = _jax_params(wnet)
        rnet, rpt = _port_pt(weights, opt)
        rpt.build(*_t(_bat(0)))
        step, plan = rpt.resume(CheckpointManager(root, prefix='pt'))
        got = [float(rpt.step(*_t(_bat(s)))) for s in range(3, 6)]
        got_params = _port_params(rnet)
    else:
        wnet, wpt = _port_pt(weights, opt)
        for s in range(3):
            wpt.step(*_t(_bat(s)))
        wpt.save_checkpoint(CheckpointManager(root, prefix='pt'))
        want = [float(wpt.step(*_t(_bat(s)))) for s in range(3, 6)]
        want_params = _port_params(wnet)
        rnet, rpt = _jax_pt(weights, opt)
        rpt.build(*_nd(_bat(0)))
        step, plan = rpt.resume(JaxManager(root, prefix='pt'))
        got = [float(rpt.step(*_nd(_bat(s))).asnumpy())
               for s in range(3, 6)]
        got_params = _jax_params(rnet)
    assert step == 3 and plan is None and rpt.num_update == 6
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    for g, w in zip(got_params, want_params):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


# -- the self-tests in child processes --------------------------------------

def _child(args, tmp, fault=None, jax=False, devices=None):
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               MXNET_TPU_FLIGHT_PATH=os.path.join(tmp, 'F.jsonl'))
    env.pop('MXNET_TPU_FAULT', None)
    if fault:
        env['MXNET_TPU_FAULT'] = fault
    if devices:
        env['XLA_FLAGS'] = '--xla_force_host_platform_device_count=%d' \
            % devices
    mod = 'mxnet_tpu.resilience' if jax else 'mxnet_tpu_torch.resilience'
    run = subprocess.run([sys.executable, '-m', mod] + args, cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    return run


def _train_args(tmp, ckpt, out, tag):
    return ['--train', '--ckpt-dir', os.path.join(tmp, ckpt), '--out',
            os.path.join(tmp, out), '--flight-artifact',
            os.path.join(tmp, 'f%s.jsonl' % tag), '--stall-artifact',
            os.path.join(tmp, 's%s.json' % tag)]


def test_port_resumes_the_jax_selftests_dp2_checkpoint(tmp_path):
    tmp = str(tmp_path)
    ref = _child(_train_args(tmp, 'ref', 'ref.json', 0) + ['--devices', '2'],
                 tmp, jax=True, devices=2)
    assert ref.returncode == 0, ref.stderr[-2000:]
    pre = _child(_train_args(tmp, 'd', 'a.json', 1) + ['--devices', '2'],
                 tmp, fault='preempt@train.step.9:1', jax=True, devices=2)
    assert pre.returncode == 75, pre.stderr[-2000:]
    assert os.path.exists(os.path.join(tmp, 'd', 'pt-00000009.ckpt'))
    res = _child(_train_args(tmp, 'd', 'b.json', 2) + ['--device', 'cpu'],
                 tmp)
    assert res.returncode == 0, res.stderr[-2000:]
    with open(os.path.join(tmp, 'ref.json')) as f:
        want = json.load(f)
    with open(os.path.join(tmp, 'b.json')) as f:
        got = json.load(f)
    assert (got['start_step'], got['accum'], got['mesh']) == (
        9, 2, {'dp': 1})
    assert want['mesh'] == {'dp': 2}
    np.testing.assert_allclose(got['losses'], want['losses'][9:],
                               rtol=1e-4, atol=1e-5)
    assert 'no generator state' in res.stderr


def test_port_selftest_preempt_restart_and_watchdog(tmp_path):
    tmp = str(tmp_path)
    ref = _child(_train_args(tmp, 'd0', 'ref.json', 0) + ['--device', 'cpu'],
                 tmp)
    assert ref.returncode == 0, ref.stderr[-2000:]
    pre = _child(_train_args(tmp, 'd1', 'a.json', 1) + ['--device', 'cpu'],
                 tmp, fault='preempt@train.step.9:1')
    assert pre.returncode == 75, pre.stderr[-2000:]
    assert not os.path.exists(os.path.join(tmp, 'a.json'))
    res = _child(_train_args(tmp, 'd1', 'b.json', 2) + ['--device', 'cpu'],
                 tmp)
    assert res.returncode == 0, res.stderr[-2000:]
    with open(os.path.join(tmp, 'ref.json')) as f:
        want = json.load(f)
    with open(os.path.join(tmp, 'b.json')) as f:
        got = json.load(f)
    assert got['start_step'] == 9 and got['accum'] == 1
    assert got['param_hash'] == want['param_hash']
    assert got['losses'] == want['losses'][9:]
    # the preempted run's flight dump: the reference's preempt events
    from mxnet_tpu_torch.observability import read_flight
    header, events = read_flight(os.path.join(tmp, 'f1.jsonl'))
    assert header['reason'] == 'preempt'
    assert [e['kind'] for e in events if e['kind'].startswith('preempt')] \
        == ['preempt', 'preempt_exit']
    stall = os.path.join(tmp, 'STALL.json')
    wd = _child(['--watchdog-smoke', '--device', 'cpu', '--stall-artifact',
                 stall, '--out', os.path.join(tmp, 'w.json'),
                 '--flight-artifact', os.path.join(tmp, 'fw.jsonl')], tmp,
                fault='hang@train.step.3:1')
    assert wd.returncode == 0, wd.stderr[-2000:]
    with open(os.path.join(tmp, 'w.json')) as f:
        verdict = json.load(f)
    assert verdict['detected'] and verdict['detail']['step'] == 3
    assert verdict['schema'] == 'mxnet_tpu.stall.v1'
    assert verdict['phase'] == 'step'
    header, events = read_flight(os.path.join(tmp, 'fw.jsonl'))
    assert header['reason'] == 'stall' and events[-1]['kind'] == 'stall'


@pytest.mark.parametrize('multi_precision', [False, True])
def test_bf16_state_is_widened_in_the_file_and_narrowed_back(
        weights, multi_precision, tmp_path):
    """After ``cast('bfloat16')`` the checkpoint holds the bf16 weights and
    state widened to float32 (exact), and a fresh trainer restores them
    narrowed back, bit for bit; the next steps agree bitwise too."""
    import warnings

    def make():
        net, _ = _port_pt(weights)
        net.cast('bfloat16')
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')     # bf16 state without master
            pt = port_parallel.ParallelTrainer(
                net, port_loss.SoftmaxCrossEntropyLoss(), 'adamw',
                dict(OPTS['adamw'], multi_precision=multi_precision))
        return net, pt

    def batch(s):
        x, y = _t(_bat(s))
        return x.to(torch.bfloat16), y

    net_a, pt_a = make()
    for s in range(3):
        pt_a.step(*batch(s))
    mgr = CheckpointManager(str(tmp_path), prefix='pt')
    state = load_state(pt_a.save_checkpoint(mgr))
    assert {a.dtype for a in state['params']} == {np.dtype('float32')}
    assert {a.dtype for a in state['leaves']} == {np.dtype('float32')}
    assert len(state['leaves']) == 4 * (3 if multi_precision else 2)
    for a, p in zip(state['params'], net_a.parameters()):
        assert np.array_equal(a, p.detach().float().numpy())
    net_b, pt_b = make()
    pt_b.build(*batch(0))
    assert pt_b.resume(mgr) == (3, None)
    assert all(p.dtype == torch.bfloat16 for p in net_b.parameters())
    for a, b in zip(net_a.parameters(), net_b.parameters()):
        assert torch.equal(a, b)
    la = [pt_a.step(*batch(s)) for s in range(3, 5)]
    lb = [pt_b.step(*batch(s)) for s in range(3, 5)]
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for a, b in zip(net_a.parameters(), net_b.parameters()):
        assert torch.equal(a, b)

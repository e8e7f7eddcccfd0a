"""Port parity of the trainer's telemetry: the ``mxnet_tpu_*`` training
series and the flight events the port's ``ParallelTrainer``
(``mxnet_tpu_torch/parallel/train_step.py``) emits, against the JAX
package's one-device trainer, on the CPU.

One scenario runs through both trainers from the same numpy weights (the
reference's self-test MLP: Dense(16, relu) -> Dense(4) over 8 features,
SGD with momentum) and batches, each package recording into its own
registry and recorder, with a watchdog and step-granular checkpoints
attached: two ``step`` calls (the first builds), ``step_accum(2)``,
``step_n`` over 3 batches, one more ``step``, an explicit
``save_checkpoint``. What is held: the training series' deltas are equal
(counters and the global-step gauge exactly, histograms by count: step
and compile seconds, the ``compile`` and ``checkpoint`` phases), and the
flight events are equal in order, kind and every field but the seconds a
timer read (``compile`` with ``program='fused_step'``, ``step`` with
``n``, ``checkpoint``, ``watchdog_heartbeat`` with its phase). On the CPU
the port captures nothing, so its series are the JAX trainer's call for
call; the card's extra ``compile`` a captured signature is held by the
self-test's train leg and chip_smoke's phase 4t.

Also: telemetry on and off train the port's MLP to bit-identical
parameters, and ``python -m mxnet_tpu_torch.observability --device cpu``
passes its eight legs in a child process.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu import observability as jax_obs
from mxnet_tpu_torch import observability as port_obs
from mxnet_tpu_torch import parallel as port_parallel
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon import nn as port_nn
from mxnet_tpu_torch.gluon.block import params_from_jax
from mxnet_tpu_torch.resilience import CheckpointManager as PortManager
from mxnet_tpu_torch.resilience import Watchdog as PortWatchdog

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURES, HIDDEN, CLASSES, BATCH = 8, 16, 4, 8
HYPER = {'learning_rate': 0.1, 'momentum': 0.9}
SERIES = ('mxnet_tpu_steps_total', 'mxnet_tpu_examples_total',
          'mxnet_tpu_step_seconds', 'mxnet_tpu_compile_seconds',
          'mxnet_tpu_global_step', 'mxnet_tpu_checkpoints_total',
          'mxnet_tpu_phase_seconds')
KINDS = ('compile', 'step', 'checkpoint', 'watchdog_heartbeat')
TIMED = ('ts', 'mono', 'seconds')
PKGS = {'jax': jax_obs, 'port': port_obs}


@pytest.fixture(autouse=True)
def _telemetry(tmp_path):
    """Both packages' telemetry on and their recorders empty, dumping into
    this test's directory; both as they were, after."""
    saved = []
    for name, obs in PKGS.items():
        obs.set_enabled(True)
        rec = obs.get_recorder()
        saved.append((obs, rec, rec.path, rec._enabled))
        rec.clear()
        obs.configure_flight(path=str(tmp_path / ('%s.jsonl' % name)),
                             enabled=True)
    yield
    for obs, rec, path, enabled in saved:
        obs.set_enabled(None)
        rec.path, rec._enabled = path, enabled


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, BATCH, FEATURES).astype('float32')
    y = rs.randint(0, CLASSES, (n, BATCH)).astype('float32')
    return x, y


@pytest.fixture(scope='module')
def weights():
    """The JAX MLP's Xavier draw from numpy seed 7, by name."""
    import mxnet_tpu as mx
    from mxnet_tpu import nd
    from mxnet_tpu.gluon import nn
    np.random.seed(7)
    mx.random.seed(7)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(HIDDEN, activation='relu'), nn.Dense(CLASSES))
    net.initialize(mx.init.Xavier())
    net(nd.zeros((1, FEATURES)))
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _jax_trainer(weights):
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu import gluon, nd, parallel
    from mxnet_tpu.gluon import nn
    mx.random.seed(7)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(HIDDEN, activation='relu'), nn.Dense(CLASSES))
    net.initialize(mx.init.Xavier())
    net(nd.zeros((1, FEATURES)))
    for (n, p), w in zip(net.collect_params().items(), weights.values()):
        p.set_data(nd.array(w))
    mesh = parallel.create_mesh({'dp': 1}, devices=jax.devices()[:1])
    pt = parallel.ParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                  'sgd', dict(HYPER), mesh)
    return net, pt, nd.array


def _port_trainer(weights):
    net = port_nn.HybridSequential()
    net.add(port_nn.Dense(HIDDEN, activation='relu', in_units=FEATURES,
                          prefix='dense0_', device='cpu'),
            port_nn.Dense(CLASSES, in_units=HIDDEN, prefix='dense1_',
                          device='cpu'))
    params_from_jax(weights, net)
    pt = port_parallel.ParallelTrainer(
        net, port_loss.SoftmaxCrossEntropyLoss(), 'sgd', dict(HYPER))
    return net, pt, torch.tensor


def _series(obs):
    """{(name, labels): (type, value or count)} of the training series."""
    out = {}
    for name, fam in obs.snapshot().items():
        if name not in SERIES:
            continue
        for s in fam['series']:
            key = (name, tuple(sorted(s['labels'].items())))
            out[key] = (fam['type'], s['count'] if fam['type'] ==
                        'histogram' else s['value'])
    return out


def _delta(before, after):
    """Counters and histogram counts as deltas (those that moved), gauges
    as they end."""
    out = {}
    for key, (typ, v) in after.items():
        if typ == 'gauge':
            out[key] = v
        elif v != before.get(key, (typ, 0))[1]:
            out[key] = v - before.get(key, (typ, 0))[1]
    return out


def _events(obs, root):
    out = []
    for ev in obs.get_recorder().events():
        if ev['kind'] not in KINDS:
            continue
        ev = {k: v for k, v in ev.items() if k not in TIMED}
        if 'path' in ev:
            ev['path'] = os.path.relpath(ev['path'], root)
        out.append(ev)
    return out


def _scenario(name, weights, root):
    """The scripted run of one package; returns (series deltas, events,
    losses, parameters)."""
    obs = PKGS[name]
    if name == 'jax':
        from mxnet_tpu.resilience import CheckpointManager, Watchdog
        net, pt, put = _jax_trainer(weights)
    else:
        CheckpointManager, Watchdog = PortManager, PortWatchdog
        net, pt, put = _port_trainer(weights)
    ckpt = os.path.join(root, name)
    pt.attach_watchdog(Watchdog(artifact_path=os.path.join(ckpt,
                                                           'STALL.json')))
    pt.attach_checkpointing(CheckpointManager(ckpt, prefix='pt', keep=2),
                            every_n=3)
    x, y = _batches(7)
    before = _series(obs)
    losses = []
    for k in range(2):
        losses.append(pt.step(put(x[k]), put(y[k])))
    losses.append(pt.step_accum(put(x[2]), put(y[2]), 2))
    losses.extend(pt.step_n(put(x[3:6]), put(y[3:6])))
    losses.append(pt.step(put(x[6]), put(y[6])))
    pt.save_checkpoint()
    if name == 'jax':
        losses = [float(l.asnumpy()) for l in losses]
        params = [p.data().asnumpy() for p in net.collect_params().values()]
    else:
        losses = [float(l) for l in losses]
        params = [p.detach().numpy() for p in net.collect_params().tensors().values()]
    return (_delta(before, _series(obs)), _events(obs, ckpt), losses,
            params, pt.num_update)


def test_train_series_and_events_equal_the_jax_trainers(weights, tmp_path):
    runs = {name: _scenario(name, weights, str(tmp_path))
            for name in ('jax', 'port')}
    (jseries, jevents, jlosses, jparams, jn), \
        (pseries, pevents, plosses, pparams, pn) = runs['jax'], runs['port']
    assert pn == jn == 7
    assert pseries == jseries
    assert pevents == jevents
    # what the scenario moved: 5 calls for 7 updates, one build
    assert pseries[('mxnet_tpu_steps_total', ())] == 7
    assert pseries[('mxnet_tpu_examples_total', ())] == 7 * BATCH
    assert pseries[('mxnet_tpu_compile_seconds', ())] == 1
    assert pseries[('mxnet_tpu_step_seconds', ())] == 4
    assert pseries[('mxnet_tpu_global_step', ())] == 7
    assert pseries[('mxnet_tpu_checkpoints_total', ())] == 3
    assert pseries[('mxnet_tpu_phase_seconds',
                    (('phase', 'compile'),))] == 1
    assert pseries[('mxnet_tpu_phase_seconds',
                    (('phase', 'checkpoint'),))] == 3
    kinds = [e['kind'] for e in pevents]
    assert kinds.count('compile') == 1 and kinds.count('step') == 5
    assert [e['n'] for e in pevents if e['kind'] == 'step'] == [1, 1, 1, 3,
                                                                 1]
    assert [e['phase'] for e in pevents
            if e['kind'] == 'watchdog_heartbeat'] == ['compile'] + \
        ['step'] * 4
    compile_ev = next(e for e in pevents if e['kind'] == 'compile')
    assert compile_ev['program'] == 'fused_step' and compile_ev['step'] == 0
    # the same training, too: the reference's step_accum tier
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5, atol=1e-6)
    for got, want in zip(pparams, jparams):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_telemetry_on_and_off_train_bitwise(weights):
    x, y = _batches(4, seed=3)
    out = {}
    for on in (True, False):
        port_obs.set_enabled(on)
        try:
            net, pt, _ = _port_trainer(weights)
            pt.step(torch.tensor(x[0]), torch.tensor(y[0]))
            pt.step_accum(torch.tensor(x[1]), torch.tensor(y[1]), 2)
            pt.step_n(torch.tensor(x[2:]), torch.tensor(y[2:]))
            out[on] = [p.detach().clone() for p in net.parameters()]
        finally:
            port_obs.set_enabled(True)
    assert all(torch.equal(a, b) for a, b in zip(out[True], out[False]))


def test_selftest_legs_five_to_seven_in_a_child(tmp_path):
    out = str(tmp_path / 'OBS.json')
    env = dict(os.environ, MXNET_TPU_FLIGHT_PATH=str(tmp_path / 'F.jsonl'))
    run = subprocess.run(
        [sys.executable, '-m', 'mxnet_tpu_torch.observability', '--device',
         'cpu', '--out', out], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    with open(out) as f:
        verdict = json.load(f)
    assert verdict['ok'] is True and len(verdict['checks']) == 8
    for leg in ('spans', 'train', 'bit_identical'):
        assert verdict['checks'][leg] == 'ok'
    assert 'skipped' not in run.stdout

"""Port parity: the resilience layer (``mxnet_tpu_torch/resilience``)
against the JAX package's (``mxnet_tpu/resilience``), with fake clocks and
scripted faults, and the port's own rule that a kernel's build or launch
failure is never transient.

Each parity case drives both packages' objects through the same script
and compares what they do: which calls raise, with which class name and
message, which states a breaker passes through, which delays a retry
draws. No case waits on the wall clock for an ordering: the one monitor
test waits for events its fake clock counts.
"""
import json
import math
import os
import random
import sys
import threading

import pytest

from mxnet_tpu.resilience import policy as jax_policy
from mxnet_tpu.resilience import watchdog as jax_watchdog
from mxnet_tpu_torch import config as port_config
from mxnet_tpu_torch import resilience
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.kernels import _build, _launch
from mxnet_tpu_torch.ops.kernels.errors import (KernelBuildFailure,
                                                KernelError,
                                                KernelLaunchFailure)
from mxnet_tpu_torch.resilience import policy as port_policy
from mxnet_tpu_torch.resilience import watchdog as port_watchdog
from mxnet_tpu_torch.resilience.checkpoint import atomic_write_bytes

PACKAGES = {'jax': (jax_policy, jax_watchdog),
            'port': (port_policy, port_watchdog)}


class FakeClock:
    """A clock that moves only when told to, and counts its reads."""

    def __init__(self):
        self.t = 0.0
        self.reads = 0
        self.read = threading.Condition()

    def __call__(self):
        with self.read:
            self.reads += 1
            self.read.notify_all()
        return self.t

    def sleep(self, s):
        self.t += s


@pytest.fixture
def no_fault(monkeypatch):
    monkeypatch.delenv('MXNET_TPU_FAULT', raising=False)


# -- the fault injector ------------------------------------------------------

DECODE_KINDS = ('device_loss', 'device_unavailable', 'tunnel_stall',
                'worker_crash', 'preempt')
# one script of calls: (site, kinds, step); steps None are unqualified
CALLS = ([('serving.decode', DECODE_KINDS, op) for op in range(7)]
         + [('serving.decode', ('hang',), op) for op in range(4)]
         + [('serving', DECODE_KINDS, b) for b in range(4)]
         + [('serving.infer', ('hang',), b) for b in range(3)]
         + [('train.step', ('preempt', 'hang'), s) for s in (11, 12, 12)]
         + [('dataloader.worker', ('worker_crash',), None)] * 2
         + [('device', ('device_unavailable', 'tunnel_stall'), None)] * 3
         + [('checkpoint.commit', ('worker_crash',), None)])

SPECS = ('', 'device_unavailable', 'device_unavailable:2',
         'device_loss@serving.decode.3:1',
         'device_loss@serving.decode:3',
         'worker_crash@serving.decode.2:1,preempt@serving.decode.5:1',
         'hang@serving.decode.2:1,device_loss@serving.decode:2',
         'device_loss@serving:1,worker_crash@serving.2:1',
         'hang@serving.infer.1:1',
         'preempt@train.step.12:1,hang@train.step:1',
         'tunnel_stall:1,device_unavailable@device',
         'worker_crash@dataloader.worker:1, device_loss:0',
         'worker_crash@checkpoint.commit:1',
         'nan@grads:2,inf@loss:1,device_unavailable@serving.decode.1')


def _script(pkg, spec):
    """What each call of CALLS does under ``spec``: None, or the fault's
    (class name, message, kind, site); then three ``poison`` reads."""
    inj = pkg.FaultInjector(spec)
    out = []
    for site, kinds, step in CALLS:
        pending = inj.pending(site, kinds, step=step)
        try:
            inj.fire(site, kinds, step=step)
            out.append((pending, None))
        except pkg.InjectedFault as exc:
            out.append((pending, (type(exc).__name__, str(exc), exc.kind,
                                  exc.site, exc.no_backoff)))
    for site in ('grads', 'grads', 'loss', 'grads', 'loss'):
        v = inj.poison(site)
        out.append(('poison', 'nan' if math.isnan(v) else v))
    return bool(inj), out


@pytest.mark.parametrize('spec', SPECS)
def test_injector_fires_as_the_reference(spec):
    assert _script(port_policy, spec) == _script(jax_policy, spec)


@pytest.mark.parametrize('spec', ['no_such_kind', 'device_loss:x',
                                  'device_loss@serving:1.5', 'hang:',
                                  'nan@grads:2,bogus@x:1'])
def test_injector_rejects_bad_specs_as_the_reference(spec):
    msgs = []
    for pkg in (jax_policy, port_policy):
        with pytest.raises(ValueError) as ei:
            pkg.FaultInjector(spec)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_get_injector_reads_the_knob_and_reparses_on_change(monkeypatch):
    monkeypatch.setenv('MXNET_TPU_FAULT', 'device_loss@serving:1')
    inj = port_policy.get_injector()
    assert inj.spec == port_config.get('MXNET_TPU_FAULT')
    with pytest.raises(port_policy.DeviceLossError):
        port_policy.inject('serving', ('device_loss',))
    # the same value keeps the same injector and its spent count
    assert port_policy.get_injector() is inj
    port_policy.inject('serving', ('device_loss',))
    monkeypatch.setenv('MXNET_TPU_FAULT', 'device_loss@serving:1 ')
    assert port_policy.get_injector() is not inj
    with pytest.raises(port_policy.DeviceLossError):
        port_policy.inject('serving', ('device_loss',))
    monkeypatch.delenv('MXNET_TPU_FAULT')
    assert not port_policy.get_injector()
    assert port_policy.poison('grads') == 0.0


# -- breaker, retry, deadline ------------------------------------------------


def _breaker_script(pkg, threshold, reset):
    clock = FakeClock()
    cb = pkg.CircuitBreaker(failure_threshold=threshold,
                            reset_timeout=reset, clock=clock)

    def boom():
        raise ConnectionError('down')

    out = []
    # (advance, fails): the call raises ConnectionError when ``fails``
    for advance, fails in ((0, 1), (0, 1), (1, 1), (0, 0), (0, 1), (0, 1),
                           (0, 1), (5, 0), (10, 0), (25, 1), (31, 1),
                           (0, 0), (40, 0), (0, 1), (0, 0)):
        clock.sleep(advance)
        before = cb.state
        try:
            cb.call(boom if fails else (lambda: 'ok'))
            got = 'ok'
        except ConnectionError:
            got = 'failed'
        except pkg.CircuitOpenError as exc:
            got = 'refused: %s' % exc
        out.append((before, got, cb.state))
    cb.record_failure()
    out.append(cb.state)
    cb.record_success()
    out.append(cb.state)
    return out


@pytest.mark.parametrize('threshold,reset', [(3, 30.0), (1, 0.2), (2, 10.0)])
def test_breaker_states_as_the_reference(threshold, reset):
    got = _breaker_script(port_policy, threshold, reset)
    assert got == _breaker_script(jax_policy, threshold, reset)
    assert {'closed', 'open', 'half-open'} <= {s for row in got[:-2]
                                               for s in row[::2]}


@pytest.mark.parametrize('kw', [
    dict(base_delay=1.0, multiplier=2.0, max_delay=60.0, jitter=0.1),
    dict(base_delay=1.0, multiplier=2.0, max_delay=8.0, jitter=0.25),
    dict(base_delay=0.5, multiplier=3.0, max_delay=100.0, jitter=0.0)])
def test_retry_delays_as_the_reference(kw):
    delays = [[pkg.Retry(rng=random.Random(7), **kw).delay(a)
               for a in range(1, 12)] for pkg in (jax_policy, port_policy)]
    assert delays[0] == delays[1]


def _retry_script(pkg, deadline):
    clock = FakeClock()
    sleeps, retries = [], []

    def sleep(s):
        sleeps.append(s)
        clock.sleep(s)

    state = {'n': 0}

    def flaky():
        state['n'] += 1
        if state['n'] == 2:
            pkg.FaultInjector('device_unavailable:1').fire(
                'device', ('device_unavailable',))
        raise ConnectionError('down %d' % state['n'])

    r = pkg.Retry(max_attempts=6, base_delay=2.0, jitter=0.2,
                  deadline=deadline, sleep=sleep, clock=clock,
                  rng=random.Random(3),
                  on_retry=lambda a, e, p: retries.append((a, str(e), p)))
    with pytest.raises(pkg.RetryExhausted) as ei:
        r.call(flaky)
    bug = pkg.Retry(max_attempts=3, sleep=sleep)
    with pytest.raises(ValueError):
        bug.call(lambda: (_ for _ in ()).throw(ValueError('bug')))
    return (sleeps, retries, str(ei.value), ei.value.attempts,
            str(ei.value.last_error), state['n'])


@pytest.mark.parametrize('deadline', [None, 9.0])
def test_retry_calls_as_the_reference(deadline):
    assert _retry_script(port_policy, deadline) == \
        _retry_script(jax_policy, deadline)


def test_deadline_and_timeout_as_the_reference():
    out = []
    for pkg in (jax_policy, port_policy):
        clock = FakeClock()
        d = pkg.Deadline(5.0, clock=clock)
        row = [d.remaining(), d.expired()]
        clock.sleep(4.0)
        d.check('still fine')
        clock.sleep(2.0)
        with pytest.raises(pkg.TimeoutExpired) as ei:
            d.check('epoch 3')
        row += [d.expired(), str(ei.value)]
        t = pkg.Timeout(5.0)
        row.append(t.run(lambda: 42))
        with pytest.raises(ZeroDivisionError):
            t.run(lambda: 1 // 0)
        out.append(row)
    assert out[0] == out[1]


# -- is_transient ------------------------------------------------------------

TRANSIENT_CASES = [
    RuntimeError("Unable to initialize backend 'tpu': UNAVAILABLE"),
    RuntimeError('DEADLINE_EXCEEDED: rpc'), RuntimeError('INTERNAL: xla'),
    RuntimeError('remote_compile failed'), OSError('Connection reset'),
    RuntimeError('Socket closed'), RuntimeError('failed to connect to x'),
    RuntimeError('tunnel down'), ConnectionError('x'), TimeoutError('t'),
    ValueError('shape mismatch'), RuntimeError('device lost'),
    KeyError('UNAVAILABLE'), RuntimeError(''),
    RuntimeError('CUDA error: an illegal memory access was encountered'),
]


@pytest.mark.parametrize('i', range(len(TRANSIENT_CASES)))
def test_is_transient_as_the_reference(i):
    exc = TRANSIENT_CASES[i]
    assert port_policy.is_transient(exc) == jax_policy.is_transient(exc)


@pytest.mark.parametrize('kind', sorted(jax_policy._FAULT_CLASSES))
def test_injected_faults_are_transient_in_both(kind):
    got = []
    for pkg in (jax_policy, port_policy):
        with pytest.raises(pkg.InjectedFault) as ei:
            pkg.FaultInjector(kind).fire('s', (kind,))
        got.append((pkg.is_transient(ei.value), type(ei.value).__name__))
        got.append((pkg.is_transient(pkg.TimeoutExpired('x')), 'timeout'))
    assert got[:2] == got[2:] and got[0][0] is True


def test_launch_failure_is_never_transient():
    """A kernel's launch failure: a KernelLaunchFailure (still a
    RuntimeError), not transient even with the reference's markers in its
    message."""
    with pytest.raises(KernelLaunchFailure) as ei:
        _launch.raise_on('flash_decode_fwd', 700)
    exc = ei.value
    assert isinstance(exc, RuntimeError) and isinstance(exc, KernelError)
    assert str(exc) == 'flash_decode_fwd launch failed: cudaError_t 700'
    assert not port_policy.is_transient(exc)
    for msg in ('x launch failed: cudaError_t 1 INTERNAL',
                'CUBLAS_STATUS_INTERNAL_ERROR UNAVAILABLE tunnel'):
        assert jax_policy.is_transient(RuntimeError(msg))
        assert not port_policy.is_transient(KernelLaunchFailure(msg))
    _launch.raise_on('flash_decode_fwd', 0)     # success raises nothing


def test_build_failure_is_never_transient(monkeypatch, tmp_path):
    """nvcc failing with ``INTERNAL`` in its stderr: build() raises a
    KernelBuildFailure (still a RuntimeError) that is not transient, and
    build_all joins the failures into one; no library is left behind."""
    script = ('import sys; sys.stderr.write("error: INTERNAL compiler '
              'error: UNAVAILABLE\\n"); sys.exit(3)')
    monkeypatch.setattr(_build, '_BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(_build, 'library_path',
                        lambda name: str(tmp_path / (name + '.so')))
    monkeypatch.setattr(_build, '_command',
                        lambda name, out: [sys.executable, '-c', script])
    with pytest.raises(KernelBuildFailure) as ei:
        _build.build('sampling')
    exc = ei.value
    assert isinstance(exc, RuntimeError)
    assert 'nvcc failed building sampling (rc 3)' in str(exc)
    assert 'INTERNAL' in str(exc)
    assert jax_policy.is_transient(RuntimeError(str(exc)))
    assert not port_policy.is_transient(exc)
    with pytest.raises(KernelBuildFailure) as ei:
        _build.build_all()
    assert not port_policy.is_transient(ei.value)
    assert str(ei.value).count('nvcc failed building') == \
        len(_build.SOURCES)
    assert not list(tmp_path.glob('*.so'))
    assert kernels.KernelBuildFailure is KernelBuildFailure


# -- the watchdog ------------------------------------------------------------


def test_stall_record_has_the_references_keys():
    got = port_watchdog.stall_record('decode', 7, 301.25, 300.0, name='s')
    want = jax_watchdog.stall_record('decode', 7, 301.25, 300.0, name='s')
    assert port_watchdog.STALL_SCHEMA == jax_watchdog.STALL_SCHEMA \
        == 'mxnet_tpu.stall.v1'
    assert sorted(got) == sorted(want)
    for key in ('schema', 'name', 'phase', 'step', 'waited_s', 'budget_s',
                'pid'):
        assert got[key] == want[key], key
    assert 'MainThread' in got['thread_stacks']


@pytest.mark.parametrize('env,budgets', [
    ({}, None),
    ({'MXNET_TPU_WATCHDOG_STEP_S': '12.5',
      'MXNET_TPU_WATCHDOG_COMPILE_S': '99'}, {'decode': 7.0})])
def test_watchdog_budgets_from_the_knobs_as_the_reference(monkeypatch, env,
                                                          budgets):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = port_watchdog.Watchdog(budgets=budgets)
    want = jax_watchdog.Watchdog(budgets=budgets)
    assert got.budgets == want.budgets
    assert got.budget_for('decode') == want.budget_for('decode')
    assert got.budget_for('other') == want.budget_for('other')


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_scripted_hang_raises_and_writes_the_artifact(monkeypatch, tmp_path,
                                                      pkg):
    """``hang@train.step.3:1``: the beat at step 3 ages the heartbeat, and
    the check after it raises TunnelStallError and writes the artifact;
    the same in both packages (the message but for the path)."""
    monkeypatch.setenv('MXNET_TPU_FAULT', 'hang@train.step.3:1')
    results = {}
    for name, (pol, wdm) in PACKAGES.items():
        clock = FakeClock()
        path = str(tmp_path / ('%s.json' % name))
        wd = wdm.Watchdog(budgets={'step': 10.0}, artifact_path=path,
                          clock=clock, injector=pol.FaultInjector(
                              os.environ['MXNET_TPU_FAULT']))
        raised = []
        for step in range(5):
            wd.beat(step, phase='step')
            clock.sleep(1.0)
            try:
                wd.check()
            except pol.TunnelStallError as exc:
                raised.append((step, str(exc).replace(path, '<path>'),
                               pol.is_transient(exc)))
        with open(path) as f:
            art = json.load(f)
        results[name] = (raised, {k: art[k] for k in (
            'schema', 'name', 'phase', 'step', 'waited_s', 'budget_s')},
            sorted(art))
    assert results['port'] == results['jax']
    raised, art, keys = results[pkg]
    assert [r[0] for r in raised] == [3] and raised[0][2]
    assert art['schema'] == 'mxnet_tpu.stall.v1' and art['step'] == 3
    assert art['waited_s'] > art['budget_s'] == 10.0
    assert keys == sorted(port_watchdog.stall_record('step', 0, 0, 0))
    assert not list(tmp_path.glob('*.tmp.*'))


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_monitor_thread_calls_on_stall_once(tmp_path, pkg):
    """A beat that ages the heartbeat (a scripted hang): the monitor
    thread writes the artifact and calls ``on_stall`` once, however many
    more times it polls the same stall."""
    pol, wdm = PACKAGES[pkg]
    clock = FakeClock()
    fired, first = [], threading.Event()

    def on_stall(rec):
        fired.append(rec)
        first.set()

    path = str(tmp_path / 's.json')
    wd = wdm.Watchdog(budgets={'decode': 5.0}, artifact_path=path,
                      clock=clock, site='serving.decode',
                      injector=pol.FaultInjector('hang@serving.decode.2:1'),
                      on_stall=on_stall, poll_s=0.002)
    with wd:
        wd.beat(1, phase='decode')
        wd.beat(2)
        assert first.wait(30)
        with clock.read:
            seen = clock.reads
            assert clock.read.wait_for(lambda: clock.reads >= seen + 10, 30)
        wd.beat(3)             # a fresh beat re-arms it: no new stall
        with clock.read:
            seen = clock.reads
            assert clock.read.wait_for(lambda: clock.reads >= seen + 10, 30)
    assert len(fired) == 1
    assert fired[0]['step'] == 2 and fired[0]['phase'] == 'decode'
    assert fired[0]['schema'] == 'mxnet_tpu.stall.v1'
    with open(path) as f:
        assert json.load(f)['step'] == 2


def test_idle_disarms_the_heartbeat_until_the_next_beat():
    """The port's ``idle()``: after a call returns nothing is in flight,
    so no age of the last beat is a stall; the next beat re-arms it."""
    clock = FakeClock()
    wd = port_watchdog.Watchdog(budgets={'decode': 5.0}, clock=clock,
                                injector=port_policy.FaultInjector(''))
    wd.beat(1, phase='decode')
    clock.sleep(6.0)
    assert wd.stalled() is not None
    wd.idle()
    clock.sleep(60.0)
    assert wd.stalled() is None
    wd.check()
    wd.beat(2)
    clock.sleep(6.0)
    assert wd.stalled()[3] == 2


def test_no_artifact_file_without_a_path(monkeypatch, tmp_path):
    """Without ``artifact_path`` the stall record stays in ``last_record``
    and the log: nothing is written into the working directory."""
    monkeypatch.chdir(tmp_path)
    clock = FakeClock()
    wd = port_watchdog.Watchdog(
        budgets={'step': 10.0}, clock=clock,
        injector=port_policy.FaultInjector('hang@train.step.0:1'))
    wd.beat(0, phase='step')
    with pytest.raises(port_policy.TunnelStallError):
        wd.check()
    assert wd.last_record['step'] == 0
    assert wd.last_record['schema'] == port_watchdog.STALL_SCHEMA
    assert list(tmp_path.iterdir()) == []


def test_atomic_write_and_scripted_crash_between_fsync_and_rename(
        monkeypatch, tmp_path):
    path = tmp_path / 'STALL.json'
    atomic_write_bytes(str(path), b'one')
    assert path.read_bytes() == b'one'
    monkeypatch.setenv('MXNET_TPU_FAULT', 'worker_crash@checkpoint.commit:1')
    with pytest.raises(resilience.WorkerCrashError):
        atomic_write_bytes(str(path), b'two')
    assert path.read_bytes() == b'one'       # the old file, whole
    assert sorted(p.name for p in tmp_path.iterdir()) == ['STALL.json']
    atomic_write_bytes(str(path), b'three')  # the count is spent
    assert path.read_bytes() == b'three'


def test_the_package_exports_what_it_ports(no_fault):
    for name in resilience.__all__:
        assert getattr(resilience, name) is not None
    assert resilience.is_transient is port_policy.is_transient
    assert not hasattr(resilience, 'acquire_backend')

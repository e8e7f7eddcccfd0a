"""Port parity of the profiler (``mxnet_tpu_torch/profiler.py``) against
the JAX package's (``mxnet_tpu/profiler.py``), on the CPU.

The reference's profiler tests (``tests/test_observability.py:213,
403-497``, ``tests/test_frontend_misc.py:269``) run through both packages,
one case a package: the counter's thread safety, ``dump(finished=)``
semantics, ``dumps``' sort orders and JSON form, the chrome trace of a
``Task``. One scripted run of scopes, counters and a marker goes through
both under one fake clock and writes the same chrome trace, event for
event (names, categories, phases, stamps, durations, values), and the
same ``dumps`` tables in every sort order; under the fake clock the sort
test no longer races the wall clock. Then the port's own contract: a
phase span opens a ``phase:`` scope while the profiler runs, ``'run'``
starts ``torch.profiler`` and ``'stop'`` / ``dump()`` write its trace
(``<stem>_torch.json``) naming the scopes, ``op_span`` fences only while
the profiler runs and a failed fence propagates (the reference swallows
it), a trainer step records the reference's ``fused_train_step``
operator span, and ``MXNET_PROFILER_AUTOSTART`` starts the profiler when
the package is imported.
"""
import json
import threading

import numpy as np
import pytest
import torch

from mxnet_tpu import profiler as jax_profiler
from mxnet_tpu_torch import profiler as port_profiler
from mxnet_tpu_torch.observability import spans as port_spans

PKGS = {'jax': jax_profiler, 'port': port_profiler}
BOTH = pytest.mark.parametrize('pkg', sorted(PKGS))


class _Clock:
    """``time`` for a profiler module: ``perf_counter`` steps by the
    durations the script asks for."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def advance(self, s):
        self.t += s


@pytest.fixture
def clean():
    """Both profilers stopped and their buffers empty, before and after."""
    for prof in PKGS.values():
        prof.set_state('stop')
        prof.aggregate_stats(reset=True)
    yield
    for prof in PKGS.values():
        prof.set_state('stop')
        prof.aggregate_stats(reset=True)
        prof.set_config(filename='profile.json')


@BOTH
def test_profiler_counter_thread_safe(pkg, clean):
    prof = PKGS[pkg]
    c = prof.Counter(None, 'hot_path', 0)

    def worker():
        for _ in range(2000):
            c.increment(1)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert c._value == 16000
    c2 = prof.Counter(None, 'iadd', 1)
    c2 += 5
    assert isinstance(c2, prof.Counter) and c2._value == 6


@BOTH
def test_profiler_dump_finished_ends_collection(pkg, clean, tmp_path):
    prof = PKGS[pkg]
    f = str(tmp_path / 'prof.json')
    prof.set_config(filename=f)
    prof.set_state('run')
    with prof.scope('finished_scope'):
        pass
    prof.dump(finished=True)
    with open(f) as fh:
        names = [e['name'] for e in json.load(fh)['traceEvents']]
    assert 'finished_scope' in names
    # finished=True ended collection: profiling stopped and the buffer
    # cleared, so a later dump does not emit this run's events again
    assert not prof.is_running()
    prof.dump(finished=False)
    with open(f) as fh:
        assert all(e['name'] != 'finished_scope'
                   for e in json.load(fh)['traceEvents'])


@BOTH
def test_profiler_dump_unfinished_keeps_collecting(pkg, clean, tmp_path):
    prof = PKGS[pkg]
    f = str(tmp_path / 'prof2.json')
    prof.set_config(filename=f)
    prof.set_state('run')
    with prof.scope('s1'):
        pass
    prof.dump(finished=False)
    assert prof.is_running()
    with prof.scope('s2'):
        pass
    prof.dump(finished=False)
    with open(f) as fh:
        names = [e['name'] for e in json.load(fh)['traceEvents']]
    assert 's1' in names and 's2' in names


def _script(prof, clock):
    """The scripted run: scopes of every kind, a counter, a marker, the
    slow / fast ops of the reference's sort test (one 4 ms, three 1 ms)
    and an operator span."""
    with prof.Task(name='work'):
        clock.advance(0.002)
    with prof.Frame(name='frame0'):
        clock.advance(0.0005)
    ev = prof.Event('event0')
    ev.start()
    clock.advance(0.003)
    ev.stop()
    c = prof.Counter(None, 'queue', 1)
    c += 2
    c -= 1
    prof.Marker(None, 'here').mark()
    for name, dur, reps in (('slow_op', 0.004, 1), ('fast_op', 0.001, 3)):
        for _ in range(reps):
            with prof.scope(name):
                clock.advance(dur)
    with prof.op_span('fused_train_step'):
        clock.advance(0.006)


def _run_script(pkg, tmp_path, monkeypatch):
    prof = PKGS[pkg]
    clock = _Clock()
    monkeypatch.setattr(prof, 'time', clock)
    prof.set_config(filename=str(tmp_path / ('%s.json' % pkg)))
    prof.set_state('run')
    try:
        _script(prof, clock)
    finally:
        prof.set_state('stop')
    tables = {(s, a): prof.dumps(sort_by=s, ascending=a)
              for s in ('total', 'avg', 'min', 'max', 'count')
              for a in (False, True)}
    tables['json'] = json.loads(prof.dumps(format='json'))
    with pytest.raises(ValueError):
        prof.dumps(sort_by='bogus')
    path = prof.dump()
    with open(path) as f:
        trace = json.load(f)
    events = [{k: v for k, v in e.items() if k not in ('pid', 'tid')}
              for e in trace['traceEvents']]
    return events, tables, trace['displayTimeUnit']


def test_scripted_run_writes_the_references_trace_and_tables(
        clean, tmp_path, monkeypatch):
    runs = {pkg: _run_script(pkg, tmp_path, monkeypatch) for pkg in PKGS}
    assert runs['port'] == runs['jax']
    events, tables, unit = runs['port']
    assert unit == 'ms'
    assert [(e['name'], e['cat'], e['ph']) for e in events[:3]] == [
        ('work', 'task', 'X'), ('frame0', 'frame', 'X'),
        ('event0', 'event', 'X')]
    assert [e['args']['value'] for e in events
            if e['ph'] == 'C' and e['name'] == 'queue'] == [1, 3, 2]

    def order(sort_by, ascending=False):
        rows = tables[(sort_by, ascending)].splitlines()[1:]
        return [r.split()[0] for r in rows if r.split()[0] in
                ('slow_op', 'fast_op')]

    assert order('count') == ['fast_op', 'slow_op']
    assert order('count', ascending=True) == ['slow_op', 'fast_op']
    assert order('max') == ['slow_op', 'fast_op']
    assert order('avg') == ['slow_op', 'fast_op']
    assert order('min', ascending=True) == ['fast_op', 'slow_op']
    assert tables['json']['fast_op']['count'] == 3
    assert tables['json']['fused_train_step']['category'] == 'operator'
    # the dump drained the buffer
    assert port_profiler.aggregate_stats() == {}


@BOTH
def test_profiler_chrome_trace(pkg, clean, tmp_path):
    """set_config / set_state / dump write a chrome trace, and dumps()
    tables the task (``tests/test_frontend_misc.py:269``)."""
    prof = PKGS[pkg]
    f = tmp_path / 'trace.json'
    prof.set_config(filename=str(f))
    prof.set_state('run')
    with prof.Task(name='work'):
        np.ones((4, 4)).sum()
    prof.set_state('stop')
    assert 'work' in prof.dumps()
    prof.dump()
    events = json.loads(f.read_text())
    events = events.get('traceEvents', events)
    assert any(e.get('name') == 'work' for e in events)


# -- the port's own contract ------------------------------------------------


def test_span_opens_a_phase_scope_while_the_profiler_runs(clean, tmp_path):
    port_profiler.set_config(filename=str(tmp_path / 'p.json'),
                             aggregate_stats=True)
    with port_spans.span('sync'):       # idle: no scope
        pass
    assert port_profiler.aggregate_stats() == {}
    port_profiler.set_state('run')
    try:
        with port_spans.span('sync'):
            pass
        table = port_profiler.aggregate_stats(reset=True)
    finally:
        port_profiler.set_state('stop')
    assert 'phase:sync' in table and table['phase:sync']['count'] == 1
    # the scope also named itself in the torch trace written at the stop
    with open(port_profiler.torch_trace_path()) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'phase:sync' in names


def test_run_starts_torch_profiler_and_dump_writes_its_trace(clean,
                                                             tmp_path):
    port_profiler.set_config(filename=str(tmp_path / 'run.json'))
    port_profiler.set_state('run')
    assert port_profiler.torch_session() is not None
    port_profiler.set_state('run')              # idempotent
    with port_profiler.scope('matmul_scope'):
        torch.ones(8, 8) @ torch.ones(8, 8)
    port_profiler.dump(finished=True)
    assert port_profiler.torch_session() is None
    assert not port_profiler.is_running()
    assert port_profiler.torch_trace_path() == str(tmp_path /
                                                   'run_torch.json')
    with open(port_profiler.torch_trace_path()) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'matmul_scope' in names and 'aten::mm' in names


def test_op_span_fences_only_while_running_and_a_failed_fence_raises(
        clean, tmp_path):
    fences = []
    with port_profiler.op_span('idle', lambda: fences.append(1)):
        pass
    assert fences == [] and port_profiler.aggregate_stats() == {}

    def broken():
        raise RuntimeError('CUDA error: an illegal memory access')

    port_profiler.set_config(filename=str(tmp_path / 'f.json'))
    port_profiler.set_state('run')
    try:
        with port_profiler.op_span('fenced', lambda: fences.append(1)):
            pass
        with pytest.raises(RuntimeError, match='illegal memory access'):
            with port_profiler.op_span('broken', broken):
                pass
        # the reference swallows the same failure
        jax_profiler.set_config(filename=str(tmp_path / 'j.json'))
        jax_profiler.set_state('run')
        with jax_profiler.op_span('broken', broken):
            pass
    finally:
        port_profiler.set_state('stop')
        jax_profiler.set_state('stop')
    assert fences == [1]
    assert port_profiler.aggregate_stats()['fenced']['count'] == 1


def test_trainer_step_records_the_fused_train_step_span(clean, tmp_path):
    """A profiled port step records the reference's operator span, once
    a step."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss, nn
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=6, prefix='dense0_', device='cpu'))
    with torch.no_grad():
        net.collect_params().tensors()['dense0_weight'].copy_(torch.ones(4, 6))
    pt = parallel.ParallelTrainer(net, loss.SoftmaxCrossEntropyLoss(), 'sgd',
                                  {'learning_rate': 0.1})
    x, y = torch.ones(3, 6), torch.zeros(3)
    pt.step(x, y)                       # idle: nothing recorded
    port_profiler.set_config(filename=str(tmp_path / 't.json'))
    port_profiler.set_state('run')
    try:
        for _ in range(3):
            pt.step(x, y)
    finally:
        port_profiler.set_state('stop')
    table = port_profiler.aggregate_stats(reset=True)
    assert table['fused_train_step']['count'] == 3
    assert table['fused_train_step']['category'] == 'operator'


@pytest.mark.parametrize('value,running', [('1', True), ('0', False)])
def test_autostart_knob_starts_the_profiler_at_import(value, running,
                                                      tmp_path):
    """``MXNET_PROFILER_AUTOSTART`` starts the profiler (and its torch
    session) when the package is imported, as the reference's knob does;
    off, importing starts nothing."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ('import sys; sys.path.insert(0, %r)\n'
            'import mxnet_tpu_torch\n'
            'from mxnet_tpu_torch import profiler\n'
            'print(profiler.is_running(), profiler.torch_session() is not '
            'None)\n'
            'profiler.set_config(filename=%r)\n'
            'profiler.set_state("stop")' % (root, str(tmp_path / 'a.json')))
    env = dict(os.environ, MXNET_PROFILER_AUTOSTART=value)
    run = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.split()[-2:] == [str(running)] * 2
    assert os.path.exists(str(tmp_path / 'a_torch.json')) is running

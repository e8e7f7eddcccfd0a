"""Port parity of the checkpoint layer (``mxnet_tpu_torch/resilience/
checkpoint.py``) against the JAX package's
(``mxnet_tpu/resilience/checkpoint.py``), on the CPU.

The reference's checkpoint tests (``tests/test_resilience.py:266-383``)
run on the port: the round trip and the magic check, a kill between the
fsync and the rename (``worker_crash@checkpoint.commit:1``) keeping the
last good file, the CRC catching a flipped byte and a truncation,
v1 files still loading, ``keep`` pruning and the dead-writer sweep. Then
across the packages: ``save_state`` of either writes the same bytes for
the same state, and a file either writes loads in the other; both
managers count the write and record the same ``checkpoint`` event. The
port's own contract: ``load_state`` resolves builtins and numpy only, so
a pickle naming anything else is refused as foreign before its module
is imported (checked in a fresh process, where the JAX package is not
loaded), and a manager built without ``keep`` reads
``MXNET_TPU_CKPT_KEEP``.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from mxnet_tpu import observability as jax_obs
from mxnet_tpu.resilience import checkpoint as jax_ckpt
from mxnet_tpu_torch import observability as port_obs
from mxnet_tpu_torch.resilience import (CheckpointManager, WorkerCrashError,
                                        load_state, save_state)
from mxnet_tpu_torch.resilience import checkpoint as port_ckpt
from mxnet_tpu_torch.resilience import policy as port_policy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {'jax': jax_ckpt, 'port': port_ckpt}
STATES = {
    'scalars': {'epoch': 3, 'name': 'run', 'ok': True, 'none': None},
    'arrays': {'w': np.arange(4.0), 'b': np.ones((2, 3), 'float32'),
               'i': np.arange(5, dtype='int64'),
               'u8': np.arange(16, dtype='uint8')},
    'trainer': {'params': [np.arange(6, dtype='float32').reshape(2, 3)],
                'leaves': [np.zeros(3, 'float32')], 'num_update': 3,
                'update_counts': {0: 3, 1: 3}, 'opt_num_update': 3,
                'base_key': None, 'mesh': {'axes': {'dp': 2},
                                           'device_count': 2,
                                           'process_count': 1},
                'zero': False, 'amp': 'off', 'rng': np.arange(2, dtype=
                                                             'uint32'),
                'process_count': 1, 'step': 3, 'scale': np.float32(2.0)},
}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, np.generic)):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b and type(a) is type(b)


def test_checkpoint_state_roundtrip_and_magic(tmp_path):
    path = str(tmp_path / 's.ckpt')
    save_state(path, {'epoch': 3, 'w': np.arange(4.0)})
    state = load_state(path)
    assert state['epoch'] == 3
    np.testing.assert_array_equal(state['w'], np.arange(4.0))
    with open(str(tmp_path / 'junk.ckpt'), 'wb') as f:
        f.write(b'not a checkpoint')
    with pytest.raises(ValueError):
        load_state(str(tmp_path / 'junk.ckpt'))
    with pytest.raises(TypeError):
        save_state(path, [1, 2])


def test_checkpoint_kill_between_write_keeps_last_good(tmp_path,
                                                       monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(0, {'epoch': 0, 'v': 'good'})
    monkeypatch.setenv('MXNET_TPU_FAULT',
                       'worker_crash@checkpoint.commit:1')
    with pytest.raises(WorkerCrashError):
        mgr.save(1, {'epoch': 1, 'v': 'torn'})
    monkeypatch.setenv('MXNET_TPU_FAULT', '')
    port_policy.get_injector()
    step, state = mgr.latest()
    assert step == 0 and state['v'] == 'good'
    assert not [n for n in os.listdir(str(tmp_path)) if '.tmp.' in n]
    # a torn newer file on disk is skipped with a warning, not fatal
    with open(mgr.path_for(2), 'wb') as f:
        f.write(b'MXTPUCKPT1\ngarbage-after-magic')
    with pytest.warns(UserWarning):
        step, state = mgr.latest()
    assert step == 0 and state['v'] == 'good'


def test_checkpoint_crc_catches_silent_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(0, {'epoch': 0, 'w': np.arange(64.0)})
    path1 = mgr.save(1, {'epoch': 1, 'w': np.arange(64.0) * 2})
    with open(path1, 'rb') as f:
        raw = bytearray(f.read())
    raw[-13] ^= 0xFF          # a byte inside the numpy payload
    with open(path1, 'wb') as f:
        f.write(raw)
    with pytest.raises(ValueError, match='CRC32 mismatch'):
        load_state(path1)
    with pytest.warns(UserWarning, match='skipping unreadable'):
        step, state = mgr.latest()
    assert step == 0 and state['epoch'] == 0
    path2 = mgr.save(2, {'epoch': 2, 'w': np.arange(64.0)})
    with open(path2, 'r+b') as f:
        f.truncate(os.path.getsize(path2) - 40)
    with pytest.raises(ValueError):
        load_state(path2)


def test_checkpoint_v1_legacy_files_still_load(tmp_path):
    path = str(tmp_path / 'old.ckpt')
    with open(path, 'wb') as f:
        f.write(b'MXTPUCKPT1\n' + pickle.dumps({'epoch': 7}))
    assert load_state(path)['epoch'] == 7


def test_checkpoint_manager_prunes_and_sweeps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    # a dead writer's leftover (a pid past pid_max is never alive) is
    # swept; a live process's temporary in flight is not
    dead = str(tmp_path / 'ckpt-00000009.ckpt.tmp.4100100')
    live = str(tmp_path / ('ckpt-00000008.ckpt.tmp.%d' % os.getpid()))
    for p in (dead, live):
        with open(p, 'wb') as f:
            f.write(b'writer leftovers')
    for step in range(4):
        mgr.save(step, {'epoch': step})
    assert mgr._steps() == [2, 3]
    assert not os.path.exists(dead)
    assert os.path.exists(live)
    assert mgr.latest()[0] == 3
    os.unlink(live)


def test_manager_keep_defaults_to_the_knob(tmp_path, monkeypatch):
    assert CheckpointManager(str(tmp_path / 'a')).keep == 2
    monkeypatch.setenv('MXNET_TPU_CKPT_KEEP', '3')
    mgr = CheckpointManager(str(tmp_path / 'b'))
    for step in range(5):
        mgr.save(step, {'epoch': step})
    assert mgr._steps() == [2, 3, 4]
    assert CheckpointManager(str(tmp_path / 'c'), keep=1).keep == 1


# -- across the packages ------------------------------------------------------


@pytest.mark.parametrize('state', sorted(STATES))
def test_save_state_writes_the_references_bytes(state, tmp_path):
    paths = {}
    for name, mod in PKGS.items():
        paths[name] = str(tmp_path / ('%s.ckpt' % name))
        mod.save_state(paths[name], STATES[state])
    with open(paths['jax'], 'rb') as f:
        want = f.read()
    with open(paths['port'], 'rb') as f:
        got = f.read()
    assert got == want
    assert got.startswith(b'MXTPUCKPT2\ncrc:')


@pytest.mark.parametrize('state', sorted(STATES))
@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax')])
def test_a_file_either_writes_loads_in_the_other(writer, reader, state,
                                                 tmp_path):
    path = str(tmp_path / 'x.ckpt')
    PKGS[writer].save_state(path, STATES[state])
    assert _equal(PKGS[reader].load_state(path), STATES[state])


def test_both_managers_count_and_record_the_same_checkpoint(tmp_path):
    events = {}
    for name, mod, obs in (('jax', jax_ckpt, jax_obs),
                           ('port', port_ckpt, port_obs)):
        obs.set_enabled(True)
        rec = obs.get_recorder()
        rec.clear()
        was = rec._enabled
        rec._enabled = True
        counter = obs.trainer_instruments().checkpoints
        before = counter.value
        root = str(tmp_path / name)
        try:
            mgr = mod.CheckpointManager(root, prefix='pt', keep=2)
            mgr.save(4, {'epoch': 0})
            mgr.save(6, {'epoch': 1})
        finally:
            obs.set_enabled(None)
            rec._enabled = was
        assert counter.value - before == 2
        events[name] = [dict({k: v for k, v in e.items()
                              if k not in ('ts', 'mono')},
                             path=os.path.relpath(e['path'], root))
                        for e in rec.events() if e['kind'] == 'checkpoint']
    assert events['port'] == events['jax']
    assert [e['step'] for e in events['port']] == [4, 6]


# -- the restricted unpickler ------------------------------------------------

_FOREIGN = '''
import sys, zlib
sys.path.insert(0, %(root)r)
from mxnet_tpu_torch.resilience import load_state

path, kind = sys.argv[1], sys.argv[2]
# {'w': <global>()}: the global by the GLOBAL opcode, then NEWOBJ
name = {'class': b'mxnet_tpu.ndarray.ndarray\\nNDArray',
        'callable': b'os\\nsystem'}[kind]
payload = b'\\x80\\x04}(\\x8c\\x01wc' + name + b'\\n)\\x81u.'
crc = b'crc:%%08x\\n' %% (zlib.crc32(payload) & 0xffffffff)
with open(path, 'wb') as f:
    f.write(b'MXTPUCKPT2\\n' + crc + payload)
try:
    load_state(path)
except ValueError as exc:
    print('refused:', exc)
print('imported:', sorted(m for m in sys.modules
                         if m.split('.')[0] in ('mxnet_tpu', 'jax')))
'''


@pytest.mark.parametrize('kind', ['class', 'callable'])
def test_a_pickle_naming_a_foreign_object_is_refused_unimported(kind,
                                                               tmp_path):
    run = subprocess.run(
        [sys.executable, '-c', _FOREIGN % {'root': ROOT},
         str(tmp_path / 'foreign.ckpt'), kind], cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    out = run.stdout
    assert 'refused:' in out and 'is foreign' in out, out
    assert "imported: []" in out, out


def test_a_jax_trainer_checkpoint_loads_without_the_jax_package(tmp_path):
    """A checkpoint of the JAX trainer names builtins and numpy only: the
    port loads it in a process that never imports the JAX package."""
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu import gluon, nd, parallel
    from mxnet_tpu.gluon import nn
    from mxnet_tpu.resilience import CheckpointManager as JaxManager
    mx.random.seed(3)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, activation='relu'), nn.Dense(3))
    net.initialize(mx.init.Xavier())
    x = nd.array(np.ones((4, 5), 'float32'))
    y = nd.array(np.zeros(4, 'float32'))
    pt = parallel.ParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), 'adamw',
        {'learning_rate': 0.01},
        parallel.create_mesh({'dp': 1}, devices=jax.devices()[:1]))
    pt.step(x, y)
    path = pt.save_checkpoint(JaxManager(str(tmp_path), prefix='pt'))
    code = ('import sys; sys.path.insert(0, %r)\n'
            'from mxnet_tpu_torch.resilience import load_state\n'
            's = load_state(%r)\n'
            'print(sorted(s), len(s["params"]), len(s["leaves"]))\n'
            'print([m for m in sys.modules if m.split(".")[0] in '
            '("mxnet_tpu", "jax")])' % (ROOT, path))
    run = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    keys, imported = run.stdout.strip().splitlines()
    assert keys == str(sorted(jax_ckpt.load_state(path))) + ' 4 8'
    assert imported == '[]'
    # the reference's keys, every one
    for k in ('params', 'leaves', 'num_update', 'update_counts',
              'opt_num_update', 'base_key', 'mesh', 'zero', 'amp', 'rng',
              'process_count', 'step'):
        assert k in keys

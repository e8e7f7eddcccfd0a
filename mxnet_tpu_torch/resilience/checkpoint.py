"""Atomic checkpoint save and resume of training state, the port of
``mxnet_tpu/resilience/checkpoint.py``.

Write protocol (crash-safe on POSIX): serialize to a temporary file in the
target directory, flush and fsync, ``os.replace`` it onto the final name,
fsync the directory. A kill at any point leaves the previous checkpoint
or the new one, never a torn file. The fault injector's
``checkpoint.commit`` site fires between the fsync and the rename, so a
test can script exactly that kill.

A state is a dict of python and numpy values, pickled (protocol 4) behind
the reference's framing, byte for byte: the ``MXTPUCKPT2`` magic line, a
``crc:%08x`` line (CRC32 of the pickle), the pickle. v1 files (the
``MXTPUCKPT1`` magic, no CRC) stay readable. So a file either package
writes loads in the other.

:func:`load_state` unpickles through a restricted ``Unpickler`` that
resolves only builtins and numpy's array, dtype and scalar constructors:
a pickle that names anything else (a class of ``mxnet_tpu``, of torch, any
callable) is refused with ``ValueError`` ("foreign") before its module is
imported, so loading a file never imports the JAX package or runs code.

:class:`CheckpointManager` keeps numbered checkpoints, prunes beyond
``keep``, sweeps the temporaries of dead writers, and resumes from the
newest file that validates, skipping a torn one with a warning. A save
counts ``mxnet_tpu_checkpoints_total`` and records the ``checkpoint``
flight event, as the reference's does.

The gluon ``Trainer`` wiring (``snapshot_gluon`` / ``restore_gluon``)
waits for the port's gluon ``Trainer`` (ROADMAP A10).
"""
from __future__ import annotations

import io
import os
import pickle
import warnings
import zlib

from .. import config as _config
from ..observability import emit as _emit
from ..observability import metrics as _metrics
from .policy import inject

__all__ = ['atomic_replace', 'atomic_write_bytes', 'save_state',
           'load_state', 'CheckpointManager']

_MAGIC = b'MXTPUCKPT1\n'
_MAGIC2 = b'MXTPUCKPT2\n'
_CRC_LEN = len(b'crc:00000000\n')

# what a checkpoint may name: builtins that build plain values, and
# numpy's constructors of arrays, dtypes and scalars (numpy 1 and 2 names)
_BUILTINS = frozenset(('dict', 'list', 'tuple', 'set', 'frozenset', 'int',
                       'float', 'complex', 'bool', 'str', 'bytes',
                       'bytearray', 'slice', 'range'))
_NUMPY = {
    'numpy': frozenset(('ndarray', 'dtype')),
    'numpy.core.multiarray': frozenset(('_reconstruct', 'scalar')),
    'numpy._core.multiarray': frozenset(('_reconstruct', 'scalar')),
    'numpy.core.numeric': frozenset(('_frombuffer',)),
    'numpy._core.numeric': frozenset(('_frombuffer',)),
}


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        pass  # EPERM and the like: the process exists, not ours
    return True


def atomic_replace(tmp_path, final_path):
    """fsync ``tmp_path``, rename it over ``final_path`` atomically, then
    fsync the directory entry."""
    fd = os.open(tmp_path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
    # honors only the process-crash kind: a kill between the fsync and
    # the rename is what 'worker_crash@checkpoint.commit:1' scripts
    inject('checkpoint.commit', ('worker_crash',))
    os.replace(tmp_path, final_path)
    dirfd = os.open(os.path.dirname(os.path.abspath(final_path)) or '.',
                    os.O_RDONLY)
    try:
        os.fsync(dirfd)
    except OSError:
        pass  # some filesystems refuse a directory fsync; the rename is done
    finally:
        os.close(dirfd)


def atomic_write_bytes(path, payload):
    """Write ``payload`` (bytes, or a sequence of bytes-like parts written
    one after another) to ``path`` by the write-temp + fsync + rename
    protocol."""
    path = os.path.abspath(path)
    tmp = '%s.tmp.%d' % (path, os.getpid())
    parts = (payload,) if isinstance(payload, (bytes, bytearray,
                                                memoryview)) else payload
    with open(tmp, 'wb') as f:
        for part in parts:
            f.write(part)
        f.flush()
        os.fsync(f.fileno())
    try:
        atomic_replace(tmp, path)
    except BaseException:
        # never leave the temporary behind on a failed or injected commit
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_state(path, state):
    """Persist a state dict (python and numpy values) atomically, with a
    CRC32 of the payload in the header."""
    if not isinstance(state, dict):
        raise TypeError('state must be a dict, got %s' % type(state))
    payload = pickle.dumps(state, protocol=4)
    crc = b'crc:%08x\n' % (zlib.crc32(payload) & 0xffffffff)
    atomic_write_bytes(path, (_MAGIC2, crc, payload))


class _Unpickler(pickle.Unpickler):
    """Resolves builtins and numpy's constructors only; any other global
    is refused before its module is imported."""

    def find_class(self, module, name):
        if (module == 'builtins' and name in _BUILTINS) or \
                name in _NUMPY.get(module, ()):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            'foreign object %s.%s: a checkpoint holds builtins and numpy '
            'values only' % (module, name))


def load_state(path):
    """Load a state dict; raises ``ValueError`` for a torn, foreign or
    corrupt file (bad magic, CRC mismatch, a payload that does not
    unpickle or names anything but builtins and numpy)."""
    with open(path, 'rb') as f:
        head = f.read(len(_MAGIC))
        if head == _MAGIC2:
            crc_line = f.read(_CRC_LEN)
            payload = f.read()
            if not (crc_line.startswith(b'crc:') and
                    crc_line.endswith(b'\n')):
                raise ValueError('%s is torn or corrupt: truncated CRC '
                                 'header' % path)
            want = int(crc_line[4:-1], 16)
            got = zlib.crc32(payload) & 0xffffffff
            if got != want:
                raise ValueError(
                    '%s is torn or corrupt: CRC32 mismatch '
                    '(header %08x, payload %08x)' % (path, want, got))
        elif head == _MAGIC:
            payload = f.read()  # v1 (pre-CRC) checkpoint
        else:
            raise ValueError('%s is not a mxnet_tpu checkpoint '
                             '(bad magic)' % path)
    try:
        return _Unpickler(io.BytesIO(payload)).load()
    except pickle.UnpicklingError as exc:
        if 'foreign object' in str(exc):
            raise ValueError('%s is foreign: %s' % (path, exc)) from None
        raise ValueError('%s is torn or corrupt: %s' % (path, exc)) from None
    except Exception as exc:
        raise ValueError('%s is torn or corrupt: %s' % (path, exc)) from None


class CheckpointManager:
    """Numbered atomic checkpoints with resume-from-latest.

    Files are ``<prefix>-<step:08d>.ckpt`` under ``directory``.
    :meth:`latest` walks newest first and returns the first checkpoint
    that validates, skipping (with a warning) a torn file from an
    interrupted save. :meth:`save` prunes beyond ``keep`` (None: the
    ``MXNET_TPU_CKPT_KEEP`` knob, 2) and sweeps the temporaries left by
    killed writers."""

    def __init__(self, directory, prefix='ckpt', keep=None):
        if keep is None:
            keep = _config.get('MXNET_TPU_CKPT_KEEP')
        self.directory = os.path.abspath(directory)
        self.prefix = prefix
        self.keep = max(1, int(keep))
        os.makedirs(self.directory, exist_ok=True)

    def path_for(self, step):
        return os.path.join(self.directory,
                            '%s-%08d.ckpt' % (self.prefix, int(step)))

    def _steps(self):
        steps = []
        want = self.prefix + '-'
        for name in os.listdir(self.directory):
            if name.startswith(want) and name.endswith('.ckpt'):
                num = name[len(want):-len('.ckpt')]
                if num.isdigit():
                    steps.append(int(num))
        return sorted(steps)

    def save(self, step, state):
        """Write checkpoint ``step`` atomically and prune old ones."""
        state = dict(state)
        state.setdefault('step', int(step))
        save_state(self.path_for(step), state)
        self.prune()
        if _metrics.enabled():
            try:
                from ..observability import trainer_instruments
                trainer_instruments().checkpoints.inc()
            except Exception:
                pass        # telemetry never fails a checkpoint
            _emit.event('checkpoint', step=int(step), prefix=self.prefix,
                        path=self.path_for(step))
        return self.path_for(step)

    def prune(self):
        for step in self._steps()[:-self.keep]:
            try:
                os.unlink(self.path_for(step))
            except OSError:
                pass
        # sweep killed writers' temporaries: this manager's prefix only,
        # and only when the writing pid is dead, so that a live saver's
        # file in flight is never removed
        for name in os.listdir(self.directory):
            if not (name.startswith(self.prefix + '-') and
                    '.ckpt.tmp.' in name):
                continue
            pid = name.rpartition('.')[2]
            if pid.isdigit() and _pid_alive(int(pid)):
                continue
            try:
                os.unlink(os.path.join(self.directory, name))
            except OSError:
                pass

    def latest(self):
        """(step, state) of the newest valid checkpoint, or None."""
        for step in reversed(self._steps()):
            path = self.path_for(step)
            try:
                return step, load_state(path)
            except (ValueError, OSError) as exc:
                warnings.warn('skipping unreadable checkpoint %s (%s); '
                              'resuming from the previous one'
                              % (path, exc))
        return None

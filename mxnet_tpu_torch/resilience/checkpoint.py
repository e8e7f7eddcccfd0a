"""Atomic file writes, the part of ``mxnet_tpu/resilience/checkpoint.py``
the stall watchdog writes its artifact with: write a temporary file,
fsync it, rename it over the target, fsync the directory. A reader sees
the old file or the new one, never a torn one.

The trainer's ``save_state`` / ``CheckpointManager`` wait for the port of
the trainer's checkpoint hooks (ROADMAP A11).
"""
from __future__ import annotations

import os

from .policy import inject

__all__ = ['atomic_replace', 'atomic_write_bytes']


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
    """Write ``payload`` to ``path`` by the write-temp + fsync + rename
    protocol."""
    path = os.path.abspath(path)
    tmp = '%s.tmp.%d' % (path, os.getpid())
    with open(tmp, 'wb') as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    try:
        atomic_replace(tmp, path)
    except BaseException:
        # never leave the temporary behind on a failed or injected commit
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise

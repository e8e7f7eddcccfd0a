"""Build the CUDA kernels on first use and load them with ``ctypes``.

The counterpart of ``mxnet_tpu/native/_build_util.py``. Each
``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -cudart shared -Xptxas -v \
         -o _build/<name>-<hash>.so csrc/<name>.cu

A source may add flags of its own (``SOURCE_FLAGS``). The file name
carries a hash of the source, the shared headers and the flags, so a
changed source rebuilds and a stale library is never
loaded. The write goes through a per-process temporary file and an
atomic rename, so concurrent builders cannot clobber each other. A
build failure raises :class:`~.errors.KernelBuildFailure` with nvcc's
stderr; nothing here falls back.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns the ``cudaError_t`` of its launch, which the
wrapper turns into an exception.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import subprocess
import threading

from .errors import KernelBuildFailure

__all__ = ['SOURCES', 'NVCC_FLAGS', 'library_path', 'source_text', 'build',
           'build_all', 'load']

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, 'csrc')
_BUILD_DIR = os.path.join(_HERE, '_build')

SOURCES = ('flash_attention_fwd', 'flash_attention_bwd',
           'flash_attention_fwd_bf16', 'flash_attention_dq_bf16',
           'flash_attention_dkv_bf16', 'flash_decode_fwd', 'softmax_xent',
           'epilogue', 'nms', 'matmul_sm90', 'multi_tensor_update',
           'sampling')
# the CUDA runtime is linked shared: the library then binds to the
# libcudart.so already loaded by torch, so one runtime serves the process
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills, which build_all hands back
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-cudart', 'shared',
              '-Xptxas', '-v')

# flags of one source beside NVCC_FLAGS. multi_tensor_update: at ptxas's
# default register-usage level three of its instances (NAG's and
# signsgd's with a float32 master, RMSProp's in float32) spill to stay
# at an occupancy's register count; level 10 spills none, the other
# instances at their registers
SOURCE_FLAGS = {'multi_tensor_update': ('-Xptxas',
                                        '--register-usage-level=10')}

_lock = threading.Lock()
_loaded = {}


def _cuda_home():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise KernelBuildFailure('no CUDA toolkit found (set CUDA_HOME): the '
                           'port builds its kernels with nvcc')
    return CUDA_HOME


def _digest(name):
    h = hashlib.sha256()
    h.update(' '.join(NVCC_FLAGS + SOURCE_FLAGS.get(name, ())).encode())
    paths = [os.path.join(_CSRC, name + '.cu')] + sorted(
        glob.glob(os.path.join(_CSRC, '*.cuh')))
    for p in paths:
        with open(p, 'rb') as f:
            h.update(os.path.basename(p).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name):
    """Where the library of kernel source ``name`` is (or will be)
    built."""
    if name not in SOURCES:
        raise KeyError('unknown kernel source %r (have %s)'
                       % (name, ', '.join(SOURCES)))
    return os.path.join(_BUILD_DIR, '%s-%s.so' % (name, _digest(name)))


def source_text(name):
    """The text of ``csrc/<name>.cu`` with each ``#include "<h>.cuh"`` of
    a header in ``csrc/`` replaced by the header's text, the headers'
    own includes too, each header once (its ``#pragma once`` dropped): a
    copy that compiles from any directory, for the probes'
    text-substituted variants."""
    with open(os.path.join(_CSRC, name + '.cu')) as f:
        text = f.read()
    seen = set()

    def header(match):
        if match.group(1) in seen:
            return ''
        seen.add(match.group(1))
        with open(os.path.join(_CSRC, match.group(1))) as f:
            return inline(f.read().replace('#pragma once\n', ''))

    def inline(src):
        return re.sub(r'^#include "(\w+\.cuh)"$', header, src, flags=re.M)
    return inline(text)


def _command(name, out):
    home = _cuda_home()
    return [os.path.join(home, 'bin', 'nvcc'), *NVCC_FLAGS,
            *SOURCE_FLAGS.get(name, ()), '-Xlinker', '-rpath=' + os.path.join(home, 'lib64'), '-o', out,
            os.path.join(_CSRC, name + '.cu')]


def _start(name):
    """Start nvcc for ``name`` unless its library is current. Returns
    (process, tmp path, final path) or None."""
    so = library_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = '%s.tmp.%d' % (so, os.getpid())
    proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    return proc, tmp, so


def _finish(name, started, timeout):
    proc, tmp, so = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise KernelBuildFailure('nvcc timed out after %ss building %s'
                           % (timeout, name))
    if proc.returncode != 0:
        raise KernelBuildFailure('nvcc failed building %s (rc %d):\n%s'
                           % (name, proc.returncode,
                              (err or out).decode('utf-8', 'replace')))
    os.replace(tmp, so)
    return (out + err).decode('utf-8', 'replace')


def build(name, timeout=600):
    """Build one kernel library if it is missing; returns its path."""
    started = _start(name)
    if started is not None:
        _finish(name, started, timeout)
    return library_path(name)


def build_all(timeout=600):
    """Build every kernel library, one nvcc per source, all started
    together. Returns {name: ptxas's resource lines} for the sources it
    built (a library already current is not rebuilt and not listed)."""
    started = {n: _start(n) for n in SOURCES}
    errors, reports = [], {}
    # reap every nvcc, even after one of them failed
    for n, s in started.items():
        if s is not None:
            try:
                log = _finish(n, s, timeout)
            except KernelBuildFailure as exc:
                errors.append(str(exc))
                continue
            reports[n] = [ln.strip() for ln in log.splitlines()
                          if 'Compiling entry' in ln or 'registers' in ln
                          or 'spill' in ln]
    if errors:
        raise KernelBuildFailure('\n'.join(errors))
    return reports


def load(name):
    """The loaded ``ctypes.CDLL`` of kernel source ``name`` (built on
    first use)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib

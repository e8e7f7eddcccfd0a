"""What every kernel wrapper shares: launch counts, input checks and the
ctypes plumbing of a launch.

Each wrapper adds one to its kernel's count where it launches the kernel
and nowhere else, so a run can show that its main path went through the
kernels (:func:`launch_counts`). A CPU tensor never counts: it runs the
plain PyTorch version. A kernel built for bf16 too counts its bf16
instance under its own name (``flash_attention_fwd.bf16``), so a run
tells the AMP launches from the float32 ones; the whole-model optimizer
update counts its instance with a float32 master as
``multi_tensor_update.mp``.

A launch made while a CUDA graph captures runs nowhere yet: inside
:class:`recording` the counts go to the capture's record instead (from
every thread, the autograd engine's among them), and each replay of the
graph adds that record (:func:`add_counts`), so a captured program counts
what it launches, once a replay.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .errors import KernelLaunchFailure

__all__ = ['KERNELS', 'BF16', 'launch_counts', 'instance_launches',
           'reset_launch_counts', 'count', 'recording', 'add_counts',
           'io_dtype', 'instance',
           'on_cpu', 'dense', 'ptr', 'stream', 'require', 'check_inputs',
           'raise_on']

# every hand-written kernel of the port, by the name its wrapper counts;
# the bf16 instances (AMP) by their kernel's name and BF16
BF16 = '.bf16'
KERNELS = ('flash_attention_fwd', 'flash_attention_fwd' + BF16,
           'flash_attention_dq', 'flash_attention_dq' + BF16,
           'flash_attention_dkv', 'flash_attention_dkv' + BF16,
           'flash_decode_fwd', 'flash_paged_decode_fwd', 'softmax_xent_fwd',
           'softmax_xent_fwd' + BF16, 'softmax_xent_bwd',
           'softmax_xent_bwd' + BF16, 'bn_act_fwd', 'bn_act_fwd' + BF16,
           'bn_act_bwd', 'bn_act_bwd' + BF16, 'act_fwd', 'act_fwd' + BF16,
           'act_bwd', 'act_bwd' + BF16, 'add_act_fwd', 'add_act_fwd' + BF16,
           'nms', 'matmul_cur', 'matmul_noacc', 'matmul_ws', 'matmul_ep',
           'multi_tensor_update', 'multi_tensor_update' + BF16,
           'multi_tensor_update.mp', 'threefry_gumbel')

_launches = dict.fromkeys(KERNELS, 0)
_instances = {}
_record = None                 # the open capture's record, if any
_record_lock = threading.Lock()


def launch_counts():
    """Kernel launches since the last reset, by kernel name."""
    return dict(_launches)


def instance_launches():
    """Launches since the last reset of the kernels with several
    instances, by (kernel name, instance)."""
    return dict(_instances)


def reset_launch_counts():
    for name in _launches:
        _launches[name] = 0
    _instances.clear()


def _bump(launches, instances, kernel, instance):
    launches[kernel] = launches.get(kernel, 0) + 1
    if instance is not None:
        instances[kernel, instance] = instances.get((kernel, instance),
                                                    0) + 1


def count(kernel, instance=None):
    if kernel not in _launches:
        raise KeyError(kernel)
    rec = _record
    if rec is not None:
        _bump(rec.launches, rec.instances, kernel, instance)
    else:
        _bump(_launches, _instances, kernel, instance)


class recording:
    """``with recording() as rec:`` sends every count to ``rec``
    (``rec.launches``, ``rec.instances``) instead of the totals: what a
    CUDA graph capture, or a warm-up whose work is undone, launches. One
    at a time."""

    def __init__(self):
        self.launches = {}
        self.instances = {}

    def __enter__(self):
        global _record
        with _record_lock:
            if _record is not None:
                raise RuntimeError('launch counts: a recording is open '
                                   'already')
            _record = self
        return self

    def __exit__(self, *exc):
        global _record
        with _record_lock:
            _record = None
        return False


def add_counts(rec):
    """Add a :class:`recording`'s counts to the totals (a replay of the
    captured program)."""
    for kernel, n in rec.launches.items():
        _launches[kernel] += n
    for key, n in rec.instances.items():
        _instances[key] = _instances.get(key, 0) + n


def io_dtype(kernel, named, allowed=(torch.float32, torch.bfloat16)):
    """The one dtype of the tensors ``named`` (label -> tensor), which
    must be one of ``allowed``: a kernel built for float32 and bf16 takes
    all its inputs in one of them. Mixed dtypes, and any other type (fp16
    among them), raise ``TypeError``."""
    dtypes = {t.dtype for t in named.values()}
    if len(dtypes) != 1:
        raise TypeError('%s: %s must share one dtype, got %s'
                        % (kernel, ', '.join(named), ', '.join(
                            '%s %s' % (k, t.dtype) for k, t in named.items())))
    dtype = dtypes.pop()
    if dtype not in allowed:
        raise TypeError('%s: %s is not built (have %s)'
                        % (kernel, dtype, ', '.join(map(str, allowed))))
    return dtype


def instance(kernel, entry, dtype):
    """(the name it counts under, its C entry) of the instance of
    ``kernel`` (C entry ``entry`` for float32) for ``dtype``."""
    if dtype == torch.bfloat16:
        return kernel + BF16, entry + '_bf16'
    return kernel, entry


def on_cpu(kernel, t, layout=None):
    """The wrapper rule: True when ``t`` lies on the CPU (the wrapper
    runs the plain version), False on a CUDA device (it launches the
    kernel); any other device, or a rank other than that of ``layout``
    (such as ``'(rows, V)'``; None takes any rank), raises."""
    if layout is not None and t.dim() != layout.count(',') + 1:
        raise ValueError('%s: expected %s, got %r'
                         % (kernel, layout, tuple(t.shape)))
    if t.device.type == 'cpu':
        return True
    if t.device.type != 'cuda':
        raise ValueError('%s: unsupported device %s' % (kernel, t.device))
    return False


def dense(t):
    """``t`` itself when it is contiguous and 16-byte aligned, else a
    dense copy (an expanded or strided view, an offset slice)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(cond, msg):
    if not cond:
        raise ValueError(msg)


def check_inputs(kernel, named, dtypes):
    """Same device for all; dtype, contiguity and 16-byte alignment of
    every tensor a kernel reads or writes."""
    device = next(iter(named.values())).device
    for label, t in named.items():
        require(t.device == device, '%s: %s is on %s, expected %s'
                % (kernel, label, t.device, device))
        require(t.dtype == dtypes[label], '%s: %s must be %s, got %s'
                % (kernel, label, dtypes[label], t.dtype))
        require(t.is_contiguous(), '%s: %s must be contiguous'
                % (kernel, label))
        require(t.data_ptr() % 16 == 0, '%s: %s must be 16-byte aligned'
                % (kernel, label))


def raise_on(kernel, err):
    if err != 0:
        raise KernelLaunchFailure('%s launch failed: cudaError_t %d'
                           % (kernel, err))

"""mxnet_tpu_torch: the PyTorch + CUDA port of ``mxnet_tpu``.

The JAX package ``mxnet_tpu`` stays the reference; this package mirrors
its module paths so each counterpart is easy to find, and never imports
``jax`` or anything of ``mxnet_tpu``. Every TPU (Pallas) kernel on a
ported path is a hand-written CUDA kernel for Hopper (``sm_90a``) under
``ops/kernels/csrc/``, built with ``nvcc`` on first use.

Ported so far: generation serving of the causal transformer LM through
the slot KV cache (``serving.freeze_decode`` -> ``DecodeProgram`` ->
``InferenceSession.generate`` -> ``DecodeEngine``), carried by the
flash-prefill and flash-decode attention kernels; BERT pretraining
(``gluon.model_zoo.bert`` + ``gluon.loss`` + AdamW through
``parallel.ParallelTrainer.step``), carried by the flash forward, the
flash dq / dkv backward and the softmax-xent forward / backward kernels;
ResNet v1 training (``gluon.model_zoo.resnet`` + SGD with momentum
through the same step), carried by the epilogue kernels (BatchNorm apply
forward / backward, activation forward / backward, add + relu) and the
softmax-xent head; SSD-300 detection served one-shot
(``gluon.model_zoo.ssd`` + ``ops.contrib.multibox_detection`` through
``serving.freeze`` -> ``FrozenProgram`` -> ``InferenceSession.infer`` and
the micro-batcher), carried by the greedy-NMS kernel and the BatchNorm
apply kernel; and the imperative gluon surface (``nd``, ``autograd``,
``gluon.Parameter`` / ``Block.initialize`` / ``hybridize``,
``gluon.Trainer`` over the whole-model update kernel, ``init``,
``lr_scheduler``, ``metric``, ``io.NDArrayIter``), which runs the
reference's own training loop.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``
(or works inside ``with mx.cpu():``); on a host without CUDA they raise
instead of falling back. ``MXNET_PROFILER_AUTOSTART`` starts
:mod:`~mxnet_tpu_torch.profiler` at import, as the reference's package
does. The imperative modules load on first use (``mx.nd``, ``mx.gluon``,
...).
"""
import importlib as _importlib

from . import config
from .context import Context, cpu, current_context, gpu, resolve_device

__all__ = ['resolve_device', 'Context', 'cpu', 'gpu', 'current_context',
           'nd', 'ndarray', 'autograd', 'init', 'initializer', 'metric',
           'lr_scheduler', 'gluon', 'io', 'random', 'optimizer']

_LAZY = {'nd': 'ndarray', 'ndarray': 'ndarray', 'autograd': 'autograd',
         'init': 'initializer', 'initializer': 'initializer',
         'metric': 'metric', 'lr_scheduler': 'lr_scheduler',
         'gluon': 'gluon', 'io': 'io', 'random': 'random',
         'optimizer': 'optimizer'}


def __getattr__(name):
    if name in _LAZY:
        mod = _importlib.import_module('.' + _LAZY[name], __name__)
        globals()[name] = mod
        return mod
    raise AttributeError('module %r has no attribute %r' % (__name__, name))


if config.get('MXNET_PROFILER_AUTOSTART'):
    from . import profiler as _profiler
    _profiler.set_state('run')

"""The kernel layer's failures, typed.

A kernel that does not build or does not launch is a fault of the port,
never transient infrastructure trouble: the resilience layer
(:func:`mxnet_tpu_torch.resilience.is_transient`) returns False for every
:class:`KernelError` before it reads a message, so such a failure fails
its requests loudly and is never completed on the CPU. Both classes stay
``RuntimeError``s, as the errors they name were before.

:class:`HeadDimError` is an input the kernels are not built for, a
``ValueError`` as the wrappers' other refusals are: a head dim past what
the float32 serving kernels take (1-128), or other than 64 for the
training and bf16 kernels. Its message names the ROADMAP item that would
build it (B1).
"""
from __future__ import annotations

__all__ = ['KernelError', 'KernelBuildFailure', 'KernelLaunchFailure',
           'HeadDimError']


class KernelError(RuntimeError):
    """Base of the kernel layer's own failures."""


class KernelBuildFailure(KernelError):
    """nvcc failed or timed out building a kernel source, or there is no
    CUDA toolkit to build it with."""


class KernelLaunchFailure(KernelError):
    """A kernel's C entry point returned a ``cudaError_t`` other than
    ``cudaSuccess``."""


class HeadDimError(ValueError):
    """A head dim no instance of the kernel is built for (ROADMAP B1)."""

"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``)."""
from .fused import FusedUpdate, FusedUpdateError
from .optimizer import (SGD, AdamW, Optimizer, create, opt_registry,
                        register)

__all__ = ['Optimizer', 'SGD', 'AdamW', 'create', 'register',
           'opt_registry', 'FusedUpdate', 'FusedUpdateError']

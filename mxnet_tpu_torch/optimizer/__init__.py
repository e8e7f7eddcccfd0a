"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``)."""
from .fused import FusedUpdate, FusedUpdateError
from .optimizer import (SGD, Adam, AdamW, Optimizer, Updater, create,
                        get_updater, opt_registry, register)

__all__ = ['Optimizer', 'SGD', 'Adam', 'AdamW', 'create', 'register',
           'opt_registry', 'FusedUpdate', 'FusedUpdateError', 'Updater',
           'get_updater']

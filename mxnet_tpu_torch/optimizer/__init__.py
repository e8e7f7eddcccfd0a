"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import AdamW, Optimizer, create, opt_registry, register

__all__ = ['Optimizer', 'AdamW', 'create', 'register', 'opt_registry']

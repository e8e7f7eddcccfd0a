"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``)."""
from .fused import FusedUpdate, FusedUpdateError
from .optimizer import (DCASGD, FTML, LBSGD, NAG, SGD, SGLD, AdaDelta,
                        AdaGrad, Adam, Adamax, AdamW, Ftrl, Nadam, Optimizer,
                        RMSProp, Signum, Test, Updater, ccSGD, create,
                        get_updater, opt_registry, register)

__all__ = ['Optimizer', 'SGD', 'Signum', 'FTML', 'DCASGD', 'NAG', 'SGLD',
           'ccSGD', 'Adam', 'AdamW', 'AdaGrad', 'RMSProp', 'AdaDelta', 'Ftrl',
           'Adamax', 'Nadam', 'LBSGD', 'Test', 'create', 'register',
           'opt_registry', 'FusedUpdate', 'FusedUpdateError', 'Updater',
           'get_updater']

"""The one-program training step of the port (counterpart of
``mxnet_tpu/parallel``), one device so far."""
from .train_step import ParallelTrainer

__all__ = ['ParallelTrainer']

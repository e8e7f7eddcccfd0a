"""Model zoo of the port (counterpart of ``mxnet_tpu/gluon/model_zoo``)."""
from . import bert, resnet, ssd, stamp, vision

__all__ = ['bert', 'resnet', 'ssd', 'stamp', 'vision']

"""``model_zoo.vision``: the vision constructors by their gluon names
(the counterpart of ``mxnet_tpu/gluon/model_zoo/vision``); the port has
ResNet v1 and SSD-300."""
from .resnet import (get_resnet, resnet18_v1, resnet34_v1, resnet50_v1,
                     resnet101_v1, resnet152_v1)
from .ssd import ssd_300  # noqa: F401

__all__ = ['get_resnet', 'resnet18_v1', 'resnet34_v1', 'resnet50_v1',
           'resnet101_v1', 'resnet152_v1', 'ssd_300']

"""Data iterators of the port (counterpart of ``mxnet_tpu/io``)."""
from .io import DataBatch, DataDesc, DataIter, NDArrayIter

__all__ = ['DataBatch', 'DataDesc', 'DataIter', 'NDArrayIter']

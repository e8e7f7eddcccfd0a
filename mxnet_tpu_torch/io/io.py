"""Data iterators of the gluon loop, the counterpart of the first part of
``mxnet_tpu/io/io.py``: ``DataDesc``, ``DataBatch``, ``DataIter`` and
``NDArrayIter`` (shuffle, and the ``pad`` / ``discard`` / ``roll_over``
tail), a copy with the port's NDArray. The batches are NDArrays on the
current context (``with mx.cpu():`` for the host). The prefetchers, the
staging layer and the record iterators are not ported yet (ROADMAP A10's
data item).
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ['DataDesc', 'DataBatch', 'DataIter', 'NDArrayIter']


class DataDesc(namedtuple('DataDesc', ['name', 'shape'])):
    """Data layout description ."""

    def __new__(cls, name, shape, dtype=np.float32, layout='NCHW'):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return 'DataDesc[%s,%s,%s,%s]' % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find('N')

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """A batch of data ."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), 'Data must be list of NDArrays'
        if label is not None:
            assert isinstance(label, (list, tuple)), 'Label must be list of NDArrays'
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return '{}: data shapes: {} label shapes: {}'.format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter:
    """Base data iterator ."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration()

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Convert data into the canonical [(name, NDArray)] form."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {('_%d_%s' % (i, default_name)): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError('Input must be NDArray, numpy.ndarray, a list of '
                        'them or dict with them as values')
    ret = []
    for k, v in data.items():
        if not isinstance(v, NDArray):
            try:
                v = nd.array(np.asarray(v))
            except Exception:
                raise TypeError('Invalid type \'%s\' for %s, should be '
                                'NDArray or numpy.ndarray' % (type(v), k))
        ret.append((k, v))
    return list(sorted(ret))


class NDArrayIter(DataIter):
    """Iterate over NDArray / numpy data.

    Supports shuffle, last_batch_handle pad/discard/roll_over.
    """

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle='pad', data_name='data',
                 label_name='softmax_label'):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self.num_data = self.idx.shape[0]
        self._cache_data = None
        self._cache_label = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        if self.shuffle:
            self._shuffle_data()
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None

    def reset(self):
        if self.shuffle:
            self._shuffle_data()
        # roll_over keeps the tail for the next epoch 
        if self.last_batch_handle == 'roll_over' and \
                0 < self.cursor < self.num_data:
            self.cursor = self.cursor - self.num_data - self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration()
        data = self.getdata()
        label = self.getlabel()
        # discard incomplete tail batch
        if data[0].shape[0] != self.batch_size and \
                self.last_batch_handle == 'discard':
            raise StopIteration()
        return DataBatch(data=data, label=label, pad=self.getpad(),
                         index=None)

    def _getdata(self, data_source, start=None, end=None):
        assert start is not None or end is not None
        if start is None:
            start = 0
        if end is None:
            end = data_source[0][1].shape[0] if data_source else 0
        s = slice(start, end)
        return [x[1][self.idx[s]] if self.shuffle else x[1][s]
                for x in data_source]

    def _concat(self, first_data, second_data):
        if not first_data:
            return []
        return [nd.concatenate([first_data[i], second_data[i]])
                for i in range(len(first_data))]

    def _batchify(self, data_source):
        assert self.cursor < self.num_data
        if self.last_batch_handle == 'roll_over' and \
                -self.batch_size < self.cursor < 0:
            assert self._cache_data is not None or self._cache_label is not None
            cache = self._cache_data if self._cache_data is not None \
                else self._cache_label
            second = self._getdata(data_source, end=self.cursor +
                                   self.batch_size)
            return self._concat(cache, second)
        if self.last_batch_handle == 'pad' and \
                self.cursor + self.batch_size > self.num_data:
            pad = self.batch_size - self.num_data + self.cursor
            first = self._getdata(data_source, start=self.cursor)
            second = self._getdata(data_source, end=pad)
            return self._concat(first, second)
        end = self.cursor + self.batch_size if self.cursor + self.batch_size \
            < self.num_data else self.num_data
        return self._getdata(data_source, self.cursor, end)

    def getdata(self):
        return self._batchify(self.data)

    def getlabel(self):
        return self._batchify(self.label)

    def getpad(self):
        if self.last_batch_handle == 'pad' and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        if self.last_batch_handle == 'roll_over' and \
                -self.batch_size < self.cursor < 0:
            return -self.cursor
        return 0

    def _shuffle_data(self):
        np.random.shuffle(self.idx)

    def _cache_tail(self):
        self._cache_data = self._getdata(self.data, start=self.cursor)
        self._cache_label = self._getdata(self.label, start=self.cursor)

"""Evaluation metrics, the counterpart of ``mxnet_tpu/metric.py`` (a copy
over the port's NDArray): every class, ``create`` and the aliases, each
computed on host numpy from ``asnumpy()``, as the reference computes
them.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy

from .base import string_types
from .ndarray import NDArray

__all__ = ['EvalMetric', 'CompositeEvalMetric', 'Accuracy', 'TopKAccuracy',
           'F1', 'MCC', 'Perplexity', 'MAE', 'MSE', 'RMSE', 'CrossEntropy',
           'NegativeLogLikelihood', 'PearsonCorrelation', 'PCC', 'Loss',
           'Torch', 'Caffe', 'CustomMetric', 'np', 'create', 'register']

_METRIC_REGISTRY = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _alias(*names):
    def _reg(klass):
        register(klass)
        for n in names:
            _METRIC_REGISTRY[n.lower()] = klass
        return klass
    return _reg


def create(metric, *args, **kwargs):
    """Create a metric from name / callable / list (reference: metric.py)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, CompositeEvalMetric):
        return metric
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite_metric = CompositeEvalMetric()
        for child_metric in metric:
            composite_metric.add(create(child_metric, *args, **kwargs))
        return composite_metric
    if isinstance(metric, string_types):
        return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
    raise TypeError('metric should be a string, callable or EvalMetric')


def check_label_shapes(labels, preds, wrap=False, shape=False):
    lhs = labels.shape if shape else len(labels)
    rhs = preds.shape if shape else len(preds)
    if lhs != rhs:
        raise ValueError('Shape of labels {} does not match shape of '
                         'predictions {}'.format(lhs, rhs))
    if wrap:
        labels = [labels] if isinstance(labels, NDArray) else labels
        preds = [preds] if isinstance(preds, NDArray) else preds
    return labels, preds


def _as_pairs(name, value):
    names = list(name) if isinstance(name, (list, tuple)) else [name]
    values = list(value) if isinstance(value, (list, tuple)) else [value]
    return list(zip(names, values))


class EvalMetric:
    """Base metric with local + global accumulators (reference: metric.py:68)."""

    def __init__(self, name, output_names=None, label_names=None,
                 has_global_stats=False, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._has_global_stats = has_global_stats
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return 'EvalMetric: {}'.format(dict(self.get_name_value()))

    def get_config(self):
        config = dict(self._kwargs,
                      metric=self.__class__.__name__, name=self.name,
                      output_names=self.output_names,
                      label_names=self.label_names)
        return config

    @staticmethod
    def _select(mapping, wanted):
        if wanted is None:
            return list(mapping.values())
        return [mapping[n] for n in wanted if n in mapping]

    def update_dict(self, label, pred):
        self.update(self._select(label, self.label_names),
                    self._select(pred, self.output_names))

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.reset_local()
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self._has_global_stats:
            if self.global_num_inst == 0:
                return (self.name, float('nan'))
            return (self.name, self.global_sum_metric / self.global_num_inst)
        return self.get()

    def _accumulate(self, total, count=1):
        """Add one observation to both the local window and the running
        (global) accumulators."""
        self.sum_metric += total
        self.global_sum_metric += total
        self.num_inst += count
        self.global_num_inst += count

    def get_name_value(self):
        return _as_pairs(*self.get())

    def get_global_name_value(self):
        if self._has_global_stats:
            return _as_pairs(*self.get_global())
        return self.get_name_value()


class CompositeEvalMetric(EvalMetric):
    """Manage multiple metrics as one (reference: metric.py:234)."""

    def __init__(self, metrics=None, name='composite', output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        if metrics is None:
            metrics = []
        self.metrics = [create(i) for i in metrics]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError('Metric index {} is out of range 0 and {}'.format(
                index, len(self.metrics)))

    @staticmethod
    def _filter(mapping, wanted):
        if wanted is None:
            return mapping
        return OrderedDict((k, v) for k, v in mapping.items()
                           if k in wanted)

    def update_dict(self, labels, preds):
        labels = self._filter(labels, self.label_names)
        preds = self._filter(preds, self.output_names)
        self._each(lambda m: m.update_dict(labels, preds))

    def update(self, labels, preds):
        self._each(lambda m: m.update(labels, preds))

    def _each(self, fn):
        for metric in getattr(self, 'metrics', []):
            fn(metric)

    def reset(self):
        self._each(lambda m: m.reset())

    def reset_local(self):
        self._each(lambda m: m.reset_local())

    def _collect(self, getter):
        names, values = [], []
        for metric in self.metrics:
            for n, v in _as_pairs(*getter(metric)):
                names.append(n)
                values.append(v)
        return names, values

    def get(self):
        return self._collect(lambda m: m.get())

    def get_global(self):
        return self._collect(lambda m: m.get_global())

    def get_config(self):
        config = super().get_config()
        config.update({'metrics': [i.get_config() for i in self.metrics]})
        return config


@_alias('acc')
class Accuracy(EvalMetric):
    """Classification accuracy (reference: metric.py:440)."""

    def __init__(self, axis=1, name='accuracy', output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            pred_np = pred_label.asnumpy() if isinstance(pred_label, NDArray) \
                else numpy.asarray(pred_label)
            label_np = label.asnumpy() if isinstance(label, NDArray) \
                else numpy.asarray(label)
            if pred_np.shape != label_np.shape:
                pred_np = numpy.argmax(pred_np, axis=self.axis)
            pred_np = pred_np.astype('int32')
            label_np = label_np.astype('int32')
            label_np, pred_np = check_label_shapes(label_np, pred_np)
            num_correct = (pred_np.flat == label_np.flat).sum()
            self.sum_metric += num_correct
            self.global_sum_metric += num_correct
            self.num_inst += len(pred_np.flat)
            self.global_num_inst += len(pred_np.flat)


@_alias('top_k_accuracy', 'top_k_acc')
class TopKAccuracy(EvalMetric):
    """Top-k accuracy (reference: metric.py TopKAccuracy)."""

    def __init__(self, top_k=1, name='top_k_accuracy', output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.top_k = top_k
        assert self.top_k > 1, 'Please use Accuracy if top_k is no more than 1'
        self.name += '_%d' % self.top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) <= 2, 'Predictions should be no more than 2 dims'
            pred_np = numpy.argpartition(
                pred_label.asnumpy().astype('float32'), -self.top_k)
            label_np = label.asnumpy().astype('int32')
            num_samples = pred_np.shape[0]
            num_dims = len(pred_np.shape)
            if num_dims == 1:
                num_correct = (pred_np.flat == label_np.flat).sum()
                self.sum_metric += num_correct
                self.global_sum_metric += num_correct
            elif num_dims == 2:
                num_classes = pred_np.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    num_correct = (pred_np[:, num_classes - 1 - j].flat ==
                                   label_np.flat).sum()
                    self.sum_metric += num_correct
                    self.global_sum_metric += num_correct
            self.num_inst += num_samples
            self.global_num_inst += num_samples


def _prf_from_confusion(cm):
    """(precision, recall, fscore) from a 2x2 confusion matrix
    cm[label, prediction]."""
    tp = cm[1, 1]
    predicted_pos = cm[:, 1].sum()
    actual_pos = cm[1, :].sum()
    precision = tp / predicted_pos if predicted_pos else 0.0
    recall = tp / actual_pos if actual_pos else 0.0
    fscore = 2 * precision * recall / (precision + recall) \
        if precision + recall else 0.0
    return precision, recall, fscore


def _mcc_from_confusion(cm):
    """Matthews correlation coefficient from a 2x2 confusion matrix;
    zero-marginal terms drop out of the denominator (reference
    convention)."""
    if not cm.sum():
        return 0.0
    tn, fp = cm[0]
    fn, tp = cm[1]
    num = tp * tn - fp * fn
    denom = 1.0
    for marginal in (tp + fp, tp + fn, tn + fp, tn + fn):
        if marginal:
            denom *= marginal
    return num / math.sqrt(denom)


class _BinaryClassificationMetrics:
    """Windowed + running 2x2 confusion matrices backing F1/MCC
    (reference analog: metric.py:580 _BinaryClassificationMetrics)."""

    def __init__(self):
        self._local = numpy.zeros((2, 2), numpy.float64)
        self._running = numpy.zeros((2, 2), numpy.float64)

    def update_binary_stats(self, label, pred):
        pred = pred.asnumpy() if isinstance(pred, NDArray) \
            else numpy.asarray(pred)
        label = label.asnumpy() if isinstance(label, NDArray) \
            else numpy.asarray(label)
        label = label.astype('int32').ravel()
        check_label_shapes(label, pred)
        if numpy.unique(label).size > 2:
            raise ValueError('%s currently only supports binary '
                             'classification.' % type(self).__name__)
        hard = (numpy.argmax(pred, axis=1) == 1).astype('int32')
        truth = (label == 1).astype('int32')
        batch = numpy.zeros((2, 2), numpy.float64)
        numpy.add.at(batch, (truth, hard), 1.0)
        self._local += batch
        self._running += batch

    precision = property(lambda self: _prf_from_confusion(self._local)[0])
    recall = property(lambda self: _prf_from_confusion(self._local)[1])
    fscore = property(lambda self: _prf_from_confusion(self._local)[2])
    global_precision = property(
        lambda self: _prf_from_confusion(self._running)[0])
    global_recall = property(
        lambda self: _prf_from_confusion(self._running)[1])
    global_fscore = property(
        lambda self: _prf_from_confusion(self._running)[2])

    def matthewscc(self, use_global=False):
        return _mcc_from_confusion(self._running if use_global
                                   else self._local)

    @property
    def total_examples(self):
        return int(self._local.sum())

    @property
    def global_total_examples(self):
        return int(self._running.sum())

    def reset_stats(self):
        self._local[:] = 0

    def reset(self):
        self._local[:] = 0
        self._running[:] = 0


class _BinaryScoreMetric(EvalMetric):
    """Shared machinery for confusion-matrix scores (F1, MCC): macro
    averages the per-window score, micro scores the running matrix."""

    def __init__(self, name, output_names=None, label_names=None,
                 average='macro'):
        self.average = average
        self._bin = _BinaryClassificationMetrics()
        EvalMetric.__init__(self, name=name, output_names=output_names,
                            label_names=label_names,
                            has_global_stats=True)

    def _score(self, use_global):
        raise NotImplementedError

    @property
    def metrics(self):
        """The underlying binary confusion stats (upstream API name:
        f1.metrics.precision/.recall/.fscore)."""
        return self._bin

    @property
    def _average(self):   # upstream MCC attribute name
        return self.average

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self._bin.update_binary_stats(label, pred)
        if self.average == 'macro':
            self._accumulate_macro()
        else:
            self.sum_metric = self._score(False) * self._bin.total_examples
            self.num_inst = self._bin.total_examples
            self.global_sum_metric = self._score(True) * \
                self._bin.global_total_examples
            self.global_num_inst = self._bin.global_total_examples

    def _accumulate_macro(self):
        self._accumulate_pair(self._score(False), self._score(True))
        self._bin.reset_stats()

    def _accumulate_pair(self, local, global_):
        self.sum_metric += local
        self.num_inst += 1
        self.global_sum_metric += global_
        self.global_num_inst += 1

    def reset(self):
        self.reset_local()
        self.global_sum_metric = 0.
        self.global_num_inst = 0.
        self._bin.reset()

    def reset_local(self):
        self.sum_metric = 0.
        self.num_inst = 0.
        self._bin.reset_stats()


@register
class F1(_BinaryScoreMetric):
    """Binary F1 (reference: metric.py F1)."""

    def __init__(self, name='f1', output_names=None, label_names=None,
                 average='macro'):
        super().__init__(name, output_names, label_names, average)

    def _score(self, use_global):
        return self._bin.global_fscore if use_global else self._bin.fscore


@register
class MCC(_BinaryScoreMetric):
    """Matthews correlation coefficient (reference: metric.py MCC)."""

    def __init__(self, name='mcc', output_names=None, label_names=None,
                 average='macro'):
        super().__init__(name, output_names, label_names, average)

    def _score(self, use_global):
        return self._bin.matthewscc(use_global)


@register
class Perplexity(EvalMetric):
    """Perplexity (reference: metric.py Perplexity)."""

    def __init__(self, ignore_label, axis=-1, name='perplexity',
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label,
                         output_names=output_names, label_names=label_names,
                         has_global_stats=True)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.
        num = 0
        for label, pred in zip(labels, preds):
            label_np = label.asnumpy() if isinstance(label, NDArray) \
                else numpy.asarray(label)
            pred_np = pred.asnumpy() if isinstance(pred, NDArray) \
                else numpy.asarray(pred)
            assert label_np.size == pred_np.size / pred_np.shape[-1], \
                'shape mismatch'
            label_np = label_np.reshape((label_np.size,)).astype('int32')
            probs = pred_np.reshape(-1, pred_np.shape[-1])[
                numpy.arange(label_np.size), label_np]
            if self.ignore_label is not None:
                ignore = (label_np == self.ignore_label).astype(probs.dtype)
                num -= numpy.sum(ignore)
                probs = probs * (1 - ignore) + ignore
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label_np.size
        self._accumulate(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, math.exp(self.sum_metric / self.num_inst))

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, math.exp(self.global_sum_metric / self.global_num_inst))


class _RegressionMetric(EvalMetric):
    """Per-batch mean of an elementwise error (MAE/MSE/RMSE)."""

    def _error(self, diff):
        raise NotImplementedError

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            l_ = label.asnumpy()
            p_ = pred.asnumpy()
            l_ = l_[:, None] if l_.ndim == 1 else l_
            p_ = p_[:, None] if p_.ndim == 1 else p_
            self._accumulate(self._error(l_ - p_))


@register
class MAE(_RegressionMetric):
    """Mean absolute error (reference: metric.py MAE)."""

    def __init__(self, name='mae', output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def _error(self, diff):
        return float(numpy.abs(diff).mean())


@register
class MSE(_RegressionMetric):
    """Mean squared error (reference: metric.py MSE)."""

    def __init__(self, name='mse', output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def _error(self, diff):
        return float((diff ** 2).mean())


@register
class RMSE(_RegressionMetric):
    """Root mean squared error (reference: metric.py RMSE)."""

    def __init__(self, name='rmse', output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def _error(self, diff):
        return float(numpy.sqrt((diff ** 2).mean()))


class _NegLogProbMetric(EvalMetric):
    """Sum of -log p(label) over examples (CrossEntropy / NLL)."""

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            idx = label.asnumpy().ravel().astype(numpy.int64)
            p_ = pred.asnumpy()
            assert idx.shape[0] == p_.shape[0]
            picked = p_[numpy.arange(idx.shape[0]), idx]
            self._accumulate(float(-numpy.log(picked + self.eps).sum()),
                             idx.shape[0])


@_alias('ce')
class CrossEntropy(_NegLogProbMetric):
    """Cross entropy against class probabilities (reference: metric.py)."""

    def __init__(self, eps=1e-12, name='cross-entropy', output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.eps = eps


@_alias('nll_loss')
class NegativeLogLikelihood(_NegLogProbMetric):
    """NLL (reference: metric.py NegativeLogLikelihood)."""

    def __init__(self, eps=1e-12, name='nll-loss', output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.eps = eps


@_alias('pearsonr')
class PearsonCorrelation(EvalMetric):
    """Pearson correlation (reference: metric.py PearsonCorrelation).

    average='macro' averages per-batch correlations; 'micro' keeps
    running sums so get() returns the correlation over ALL samples."""

    def __init__(self, name='pearsonr', output_names=None, label_names=None,
                 average='macro'):
        self.average = average
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def reset_micro(self):
        # shifted sums: n, sum x, sum y, sum x^2, sum y^2, sum xy, with
        # x/y shifted by the first batch's means — correlation is shift-
        # invariant and the shift avoids catastrophic cancellation in
        # n*sxx - sx^2 for large-mean data
        self._sums = numpy.zeros(6, numpy.float64)
        self._shift = None

    def reset(self):
        self.reset_local()
        self.global_num_inst = 0
        self.global_sum_metric = 0.0
        self._gsums = numpy.zeros(6, numpy.float64)
        self._gshift = None

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.reset_micro()

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, False, True)
            l_ = label.asnumpy().ravel().astype(numpy.float64)
            p_ = pred.asnumpy().ravel().astype(numpy.float64)
            if self.average == 'macro':
                self._accumulate(float(numpy.corrcoef(p_, l_)[0, 1]))
            else:
                self.num_inst += 1
                self.global_num_inst += 1
                if self._shift is None:
                    self._shift = (float(l_.mean()), float(p_.mean()))
                if self._gshift is None:
                    self._gshift = self._shift
                self._sums += self._moments(l_, p_, self._shift)
                self._gsums += self._moments(l_, p_, self._gshift)

    @staticmethod
    def _moments(l_, p_, shift):
        ls = l_ - shift[0]
        ps = p_ - shift[1]
        return numpy.array([ls.size, ls.sum(), ps.sum(),
                            (ls * ls).sum(), (ps * ps).sum(),
                            (ls * ps).sum()])

    @staticmethod
    def _corr_of(sums):
        n, sl, sp, sll, spp, slp = sums
        num = n * slp - sl * sp
        den = numpy.sqrt(max(n * sll - sl * sl, 0.0) *
                         max(n * spp - sp * sp, 0.0))
        return float(num / den) if den else float('nan')

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        if self.average == 'macro':
            return (self.name, self.sum_metric / self.num_inst)
        return (self.name, self._corr_of(self._sums))

    def get_global(self):
        if self.average == 'macro':
            return super().get_global()
        if self.global_num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, self._corr_of(self._gsums))


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation via confusion matrix
    (reference: metric.py PCC)."""

    def __init__(self, name='pcc', output_names=None, label_names=None):
        self.k = 2
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def _grow(self, inc):
        self.lcm = numpy.pad(self.lcm, ((0, inc), (0, inc)), 'constant')
        self.gcm = numpy.pad(self.gcm, ((0, inc), (0, inc)), 'constant')
        self.k += inc

    @staticmethod
    def _calc_mcc(cmat):
        # multiclass MCC from the confusion matrix: cov(pred, label) /
        # sqrt(cov(pred, pred) * cov(label, label)) over class marginals
        total = cmat.sum()
        pred_marginal = cmat.sum(axis=1)
        label_marginal = cmat.sum(axis=0)
        var_pred = float((pred_marginal * (total - pred_marginal)).sum())
        var_label = float((label_marginal *
                           (total - label_marginal)).sum())
        if not var_pred or not var_label:
            return float('nan')
        cov = float((cmat.diagonal() * total -
                     pred_marginal * label_marginal).sum())
        return cov / numpy.sqrt(var_pred * var_label)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = label.asnumpy().astype('int32', copy=False)
            pred = pred.asnumpy()
            if pred.shape != label.shape:
                pred = pred.argmax(axis=1).astype('int32', copy=False)
            else:
                pred = pred.astype('int32', copy=False)
            n = max(pred.max(), label.max())
            if n >= self.k:
                self._grow(n + 1 - self.k)
            bcm = numpy.zeros((self.k, self.k))
            numpy.add.at(bcm, (pred, label), 1)
            self.lcm += bcm
            self.gcm += bcm
        self.num_inst += 1
        self.global_num_inst += 1

    @property
    def sum_metric(self):
        return self._calc_mcc(self.lcm) * self.num_inst

    @property
    def global_sum_metric(self):
        return self._calc_mcc(self.gcm) * self.global_num_inst

    @sum_metric.setter
    def sum_metric(self, _):
        pass

    @global_sum_metric.setter
    def global_sum_metric(self, _):
        pass

    def reset(self):
        self.global_num_inst = 0.
        self.gcm = numpy.zeros((self.k, self.k))
        self.reset_local()

    def reset_local(self):
        self.num_inst = 0.
        self.lcm = numpy.zeros((self.k, self.k))


@register
class Loss(EvalMetric):
    """Dummy metric averaging a loss output (reference: metric.py Loss)."""

    def __init__(self, name='loss', output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            self._accumulate(float(pred.asnumpy().sum()), pred.size)


@register
class Torch(Loss):
    """Legacy alias (reference: metric.py Torch)."""

    def __init__(self, name='torch', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    """Legacy alias (reference: metric.py Caffe)."""

    def __init__(self, name='caffe', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """Metric from a feval function (reference: metric.py CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find('<') != -1:
                name = 'custom(%s)' % name
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names,
                         has_global_stats=True)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            result = self._feval(label.asnumpy(), pred.asnumpy())
            # feval may return a bare value (count 1) or (sum, count)
            total, count = result if isinstance(result, tuple) \
                else (result, 1)
            self._accumulate(total, count)

    def get_config(self):
        raise NotImplementedError('CustomMetric cannot be serialized')


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval as a CustomMetric factory (reference: metric.py np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


@register
@_alias('map')
class MApMetric(EvalMetric):
    """Mean average precision for detection (reference: the example-tier
    evaluate/eval_metric.py MApMetric; promoted to the core metric zoo so
    the SSD workload has an in-tree evaluation path).

    update() consumes (labels, preds) where
      preds[0]:  (B, N, 6) rows [class_id, score, x1, y1, x2, y2]
                 (MultiBoxDetection output; class_id < 0 = invalid)
      labels[0]: (B, M, 5+) rows [class_id, x1, y1, x2, y2, ...]
                 (class_id < 0 = padding)
    AP is the area under the interpolated precision-recall curve per
    class; get() reports the mean over classes seen in ground truth.
    """

    def __init__(self, iou_thresh=0.5, class_names=None, name='mAP',
                 output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.iou_thresh = iou_thresh
        self.class_names = class_names
        self.reset()

    def reset(self):
        # per class: list of (score, is_tp); gt counts
        self._records = {}
        self._gt_counts = {}
        self.num_inst = 1
        self.sum_metric = 0.0
        self.global_num_inst = 1
        self.global_sum_metric = 0.0

    @staticmethod
    def _iou(box, boxes):
        ix1 = numpy.maximum(box[0], boxes[:, 0])
        iy1 = numpy.maximum(box[1], boxes[:, 1])
        ix2 = numpy.minimum(box[2], boxes[:, 2])
        iy2 = numpy.minimum(box[3], boxes[:, 3])
        inter = numpy.maximum(ix2 - ix1, 0) * numpy.maximum(iy2 - iy1, 0)
        a1 = (box[2] - box[0]) * (box[3] - box[1])
        a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        return inter / numpy.maximum(a1 + a2 - inter, 1e-12)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = label.asnumpy() if hasattr(label, 'asnumpy') else label
            pred = pred.asnumpy() if hasattr(pred, 'asnumpy') else pred
            for b in range(pred.shape[0]):
                gts = label[b]
                gts = gts[gts[:, 0] >= 0]
                for cid in numpy.unique(gts[:, 0]).astype(int):
                    self._gt_counts[cid] = self._gt_counts.get(cid, 0) + \
                        int((gts[:, 0] == cid).sum())
                dets = pred[b]
                dets = dets[dets[:, 0] >= 0]
                order = numpy.argsort(-dets[:, 1])
                matched = numpy.zeros(len(gts), bool)
                for d in dets[order]:
                    cid = int(d[0])
                    rec = self._records.setdefault(cid, [])
                    cand = numpy.where((gts[:, 0] == cid) & ~matched)[0]
                    if len(cand):
                        ious = self._iou(d[2:6], gts[cand][:, 1:5])
                        j = int(numpy.argmax(ious))
                        if ious[j] >= self.iou_thresh:
                            matched[cand[j]] = True
                            rec.append((float(d[1]), 1))
                            continue
                    rec.append((float(d[1]), 0))

    def _average_precision(self, records, n_gt):
        if not records or n_gt == 0:
            return 0.0
        rec = sorted(records, key=lambda r: -r[0])
        tp = numpy.cumsum([r[1] for r in rec], dtype=numpy.float64)
        fp = numpy.cumsum([1 - r[1] for r in rec], dtype=numpy.float64)
        recall = tp / n_gt
        precision = tp / numpy.maximum(tp + fp, 1e-12)
        # integral AP with monotone-decreasing interpolated precision
        mrec = numpy.concatenate([[0.0], recall, [1.0]])
        mpre = numpy.concatenate([[0.0], precision, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        changed = numpy.where(mrec[1:] != mrec[:-1])[0]
        return float(((mrec[changed + 1] - mrec[changed]) *
                      mpre[changed + 1]).sum())

    def get(self):
        cids = sorted(self._gt_counts)
        if not cids:
            return self.name, float('nan')
        aps = [self._average_precision(self._records.get(c, []),
                                       self._gt_counts[c]) for c in cids]
        return self.name, float(numpy.mean(aps))

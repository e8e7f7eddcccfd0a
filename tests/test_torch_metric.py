"""The port's metrics (``mxnet_tpu_torch/metric.py``) against the JAX
package's: every class fed the same batches (as NDArrays of each
package), ``get()`` equal to float64 rounding (1e-12 relative: both
compute on host numpy from ``asnumpy()``); ``create`` and the aliases.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx

RS = np.random.RandomState(0)
LOGITS = [RS.rand(8, 5).astype('float32') for _ in range(3)]
LABELS = [RS.randint(0, 5, (8,)).astype('float32') for _ in range(3)]
BIN = [RS.rand(10, 2).astype('float32') for _ in range(2)]
BIN_LAB = [RS.randint(0, 2, (10,)).astype('float32') for _ in range(2)]
REG = [RS.randn(6, 3).astype('float32') for _ in range(2)]
REG_LAB = [RS.randn(6, 3).astype('float32') for _ in range(2)]
PROBS = [(p / p.sum(1, keepdims=True)) for p in LOGITS]

CASES = {
    'accuracy': (lambda m: m.Accuracy(), LOGITS, LABELS),
    'top_k_accuracy': (lambda m: m.TopKAccuracy(top_k=3), LOGITS, LABELS),
    'f1': (lambda m: m.F1(), BIN, BIN_LAB),
    'f1_macro': (lambda m: m.F1(average='macro'), BIN, BIN_LAB),
    'mcc': (lambda m: m.MCC(), BIN, BIN_LAB),
    'perplexity': (lambda m: m.Perplexity(ignore_label=None), PROBS,
                   LABELS),
    'mae': (lambda m: m.MAE(), REG, REG_LAB),
    'mse': (lambda m: m.MSE(), REG, REG_LAB),
    'rmse': (lambda m: m.RMSE(), REG, REG_LAB),
    'cross_entropy': (lambda m: m.CrossEntropy(), PROBS, LABELS),
    'nll': (lambda m: m.NegativeLogLikelihood(), PROBS, LABELS),
    'pearsonr': (lambda m: m.PearsonCorrelation(), REG, REG_LAB),
    'pcc': (lambda m: m.PCC(), LOGITS, LABELS),
    'loss': (lambda m: m.Loss(), REG, REG_LAB),
    'custom': (lambda m: m.CustomMetric(
        lambda label, pred: float(np.abs(label - pred.argmax(1)).mean()),
        name='gap'), LOGITS, LABELS),
    'np': (lambda m: m.np(lambda label, pred: float((pred ** 2).sum()),
                          name='sq'), REG, REG_LAB),
    'composite': (lambda m: m.CompositeEvalMetric(
        [m.Accuracy(), m.TopKAccuracy(top_k=2)]), LOGITS, LABELS),
}


def _run(mx, make, preds, labels, ctx=None):
    metric = make(mx.metric)
    for p, l in zip(preds, labels):
        metric.update([mx.nd.array(l, ctx=ctx)], [mx.nd.array(p, ctx=ctx)])
    out = metric.get()
    metric.reset()
    return out


@pytest.mark.parametrize('name', sorted(CASES))
def test_metric_matches_jax(name):
    make, preds, labels = CASES[name]
    want = _run(jmx, make, preds, labels)
    got = _run(pmx, make, preds, labels, ctx=pmx.cpu())
    assert _names(got) == _names(want)
    np.testing.assert_allclose(np.asarray(_values(got), np.float64),
                               np.asarray(_values(want), np.float64),
                               rtol=1e-12, atol=0)


def _names(out):
    n = out[0]
    return list(n) if isinstance(n, (list, tuple)) else [n]


def _values(out):
    v = out[1]
    return list(v) if isinstance(v, (list, tuple)) else [v]


@pytest.mark.parametrize('alias', ['acc', 'accuracy', 'top_k_accuracy',
                                   'f1', 'mae', 'mse', 'rmse', 'ce',
                                   'nll_loss', 'pearsonr', 'loss'])
def test_create_and_aliases_match(alias):
    kwargs = {'top_k': 2} if alias == 'top_k_accuracy' else {}
    assert type(pmx.metric.create(alias, **kwargs)).__name__ == \
        type(jmx.metric.create(alias, **kwargs)).__name__


def test_create_composite_from_a_list():
    m = pmx.metric.create(['acc', 'mse'])
    assert type(m).__name__ == 'CompositeEvalMetric'
    assert [type(c).__name__ for c in m.metrics] == ['Accuracy', 'MSE']

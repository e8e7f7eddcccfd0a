"""Op bodies of the BERT training path, the counterpart of the ops of the
same names in ``mxnet_tpu/ops/nn.py``.

Only the ops BERT reaches are here. Each keeps the JAX body's order of
operations, so the CPU parity tests compare like with like:

  * :func:`fully_connected` (nn.py:29): ``x @ W^T`` then ``+ b``, W (out,
    in);
  * :func:`activation` (nn.py:439): tanh and exact-erf gelu;
  * :func:`flash_attention_op` (nn.py:504): head-split (B*H, S, D)
    attention through the flash kernels; the mask is the (B,) lengths
    form only;
  * :func:`softmax_cross_entropy` / :func:`fused_softmax_xent`
    (nn.py:748-776): the fused softmax-xent kernels;
  * :func:`layer_norm` (nn.py:920-990): ``_ln_core``, float32 centred
    two-pass variance and ``rsqrt``, with its hand-written backward;
  * :func:`dropout` (nn.py:1059) on a caller's ``torch.Generator``;
  * :func:`embedding` (nn.py:1077).

The attention and loss ops always go through ``ops/kernels``: the kernels
on a CUDA tensor, their plain versions on a CPU tensor. There is no knob.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .kernels import flash_attention, fused_softmax_xent_rows

__all__ = ['fully_connected', 'activation', 'flash_attention_op',
           'softmax_cross_entropy', 'fused_softmax_xent', 'layer_norm',
           'LayerNormFunction', 'dropout', 'embedding']


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight^T (+ bias)``; ``flatten`` folds all non-batch axes
    of ``data`` into one first."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    if bias is not None:
        out = out + bias
    return out


# the activations BERT reaches: the pooler's tanh and the exact-erf GELU
# of the FFN and the MLM transform
_ACTIVATIONS = {
    'tanh': torch.tanh,
    'gelu': lambda x: F.gelu(x, approximate='none'),
}


def activation(data, act_type='relu'):
    """Elementwise activation by name (``gelu`` is the exact-erf form)."""
    try:
        fn = _ACTIVATIONS[act_type]
    except KeyError:
        raise ValueError('unknown act_type %r (have %s)'
                         % (act_type, ', '.join(sorted(_ACTIVATIONS))))
    return fn(data)


def flash_attention_op(q, k, v, mask=None, *, num_heads, causal=False,
                       scale=None):
    """Multi-head attention core over head-split tensors: q (B*H, Sq, D),
    k/v (B*H, Sk, D), ``mask`` None or the (B,) valid key lengths (any
    numeric dtype; cast to int32). Returns (B*H, Sq, D).

    The JAX op also takes a dense (B, Sq, Sk) mask, which it runs on its
    unfused path; the port has no such path and raises instead."""
    h = int(num_heads)
    bh, sq, d = q.shape
    b = bh // h
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lengths = None
    if mask is not None:
        if mask.dim() != 1:
            raise NotImplementedError(
                'flash_attention_op: only the (B,) lengths mask is ported; '
                'a dense %r mask is not' % (tuple(mask.shape),))
        if mask.shape[0] != b:
            raise ValueError('flash_attention_op: lengths batch %d != B=%d'
                             % (mask.shape[0], b))
        lengths = mask.to(torch.int32)
    out = flash_attention(q.reshape(b, h, sq, d), k.reshape(b, h, sk, d),
                          v.reshape(b, h, sk, d), lengths=lengths,
                          causal=bool(causal), scale=float(scale))
    return out.reshape(bh, sq, d)


def softmax_cross_entropy(data, label):
    """Sum over rows of the softmax cross-entropy of (rows, V) logits."""
    return fused_softmax_xent_rows(data, label).sum()


def fused_softmax_xent(pred, label):
    """Per-row softmax cross-entropy head: (..., V) logits and (...)
    labels -> (..., 1) nll in the logits' dtype."""
    v = pred.shape[-1]
    lead = pred.shape[:-1]
    nll = fused_softmax_xent_rows(pred.reshape(-1, v), label.reshape(-1))
    return nll.reshape(lead + (1,)).to(pred.dtype)


class LayerNormFunction(torch.autograd.Function):
    """``_ln_core`` (nn.py:920-978): float32 row statistics with a centred
    two-pass variance, and the hand-written backward whose row reductions
    mean(dxhat) and mean(dxhat * xhat) use the saved (data, mean, inv)."""

    @staticmethod
    def forward(ctx, data, gamma, beta, eps, ax):
        out, mean, inv = _ln_forward(data, gamma, beta, eps, ax)
        ctx.save_for_backward(data, gamma, mean, inv)
        ctx.ax, ctx.beta_dtype = ax, beta.dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        data, gamma, mean, inv = ctx.saved_tensors
        ax = ctx.ax
        shape = [1] * data.dim()
        shape[ax] = data.shape[ax]
        xhat = (data.float() - mean) * inv
        dyf = dout.float()
        dxhat = dyf * gamma.float().reshape(shape)
        m1 = torch.mean(dxhat, dim=ax, keepdim=True)
        m2 = torch.mean(dxhat * xhat, dim=ax, keepdim=True)
        dx = inv * (dxhat - m1 - xhat * m2)
        red = tuple(i for i in range(data.dim()) if i != ax)
        dgamma = torch.sum(dyf * xhat, dim=red)
        dbeta = torch.sum(dyf, dim=red)
        return (dx.to(data.dtype), dgamma.to(gamma.dtype),
                dbeta.to(ctx.beta_dtype), None, None)


def _ln_forward(data, gamma, beta, eps, ax):
    xf = data.float()
    mean = torch.mean(xf, dim=ax, keepdim=True)
    cen = xf - mean
    var = torch.mean(cen * cen, dim=ax, keepdim=True)
    inv = torch.rsqrt(var + eps)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    out = cen * inv * gamma.float().reshape(shape) \
        + beta.float().reshape(shape)
    return out.to(data.dtype), mean, inv


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm over ``axis`` with affine ``gamma`` / ``beta``."""
    ax = int(axis) % data.dim()
    return LayerNormFunction.apply(data, gamma, beta, float(eps), ax)


def dropout(data, p=0.5, generator=None, training=True):
    """Inverted dropout: ``data * mask / keep`` with a Bernoulli(keep)
    mask drawn from ``generator`` (which must live on ``data``'s device).
    Identity when not training or ``p <= 0``. The JAX package draws the
    mask from a threefry key, which no PyTorch generator reproduces."""
    if not training or p <= 0:
        return data
    if generator is None:
        raise RuntimeError('dropout: training with p=%g needs a '
                           'torch.Generator (the port draws no mask from '
                           'the global RNG)' % p)
    keep = 1.0 - p
    mask = (torch.rand(data.shape, generator=generator, device=data.device)
            < keep).to(data.dtype)
    return data * mask / keep


def embedding(data, weight):
    """Rows of ``weight`` at the indices ``data`` (any numeric dtype,
    cast to integers as ``astype(int32)`` does)."""
    return weight[data.to(torch.int64)]

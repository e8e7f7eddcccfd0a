"""Op bodies of the ported training paths, the counterpart of the ops of
the same names in ``mxnet_tpu/ops/nn.py``.

The ops of the ported paths are functions here, each in the JAX body's
order of operations, so the CPU parity tests compare like with like:

  * :func:`fully_connected` (nn.py:29): ``x @ W^T`` then ``+ b``, W (out,
    in);
  * :func:`convolution` (nn.py:100): 1-, 2- or 3-D convolution over
    NC(D)(H)W as one ``F.conv{1,2,3}d`` (the JAX op is one XLA
    convolution, outside any Pallas kernel); :func:`deconvolution`
    (nn.py:138), the transposed convolution with the (in, out / groups,
    *kernel) weight and the output padding ``adj``, as one
    ``F.conv_transpose{1,2,3}d``;
  * :func:`pooling` (nn.py:261): 1-, 2- or 3-D max pooling with
    ``_max_pool_core``'s equality-mask backward (:class:`MaxPoolFunction`),
    sum and average windows (``count_include_pad`` either way), the
    ``full`` convention's right extension, and global max, sum and
    average pooling;
  * :func:`activation` (nn.py:439) and :func:`leaky_relu` (nn.py:454):
    the kernel-covered activations go through the epilogue kernels'
    save-output core, as the JAX ops do with the ``epilogue`` family on;
    elu and selu through the same save-output backward in plain torch
    (:class:`OutputActFunction`, ``_act_core``), as the JAX op with
    ``MXNET_TPU_VJP_RESCHEDULE`` on (its default); prelu and gelu plain;
  * :func:`add_relu` (nn.py:490): the ResNet v1 block join through the
    add+act kernel;
  * :func:`batch_norm` (nn.py:785-917): training mode through
    :class:`BatchNormTrainFunction` (``_bn_train_core``: one-pass float32
    statistics, the ``bn_act_fwd`` kernel, the plain ``_bn_train_bwd``
    backward); inference mode and ``use_global_stats`` through the BN
    apply kernels;
  * :func:`flash_attention_op` (nn.py:504): head-split (B*H, S, D)
    attention through the flash kernels; the mask is the (B,) lengths
    form only;
  * :func:`softmax_cross_entropy` / :func:`fused_softmax_xent`
    (nn.py:748-776): the fused softmax-xent kernels;
  * :func:`layer_norm` (nn.py:920-990): ``_ln_core``, float32 centred
    two-pass variance and ``rsqrt``, with its hand-written backward;
  * :func:`dropout` (nn.py:1059) on a caller's ``torch.Generator``;
  * :func:`embedding` (nn.py:1077); :func:`flatten`;
  * :func:`softmax` (nn.py:568), plain, in ``jax.nn.softmax``'s order
    (SSD's detection head), and :func:`relu`, plain ``torch.relu`` as the
    JAX package's ``relu`` (math.py:41) is ``jax.nn.relu``, no kernel;
  * :func:`rnn` (nn.py:1151-1297), the fused multi-layer (bi)RNN in modes
    ``lstm`` / ``gru`` / ``rnn_relu`` / ``rnn_tanh`` over the flat cuDNN
    parameter layout (:func:`_rnn_unpack_params`): the input projection
    one product over all T, then a loop over the steps of
    :func:`_cell_step`, the gate math written out in the JAX op's order
    (no ``torch.nn.LSTM`` or cuDNN RNN: the gate order and the layout are
    the reference's by construction). The JAX package computes the cells
    with XLA, outside any Pallas kernel, and so does the port: plain
    products and pointwise ops. :func:`_rnn_param_concat`
    (tensor.py:197) flattens and joins the pieces of that layout.

The kernel ops always go through ``ops/kernels``: the kernels on a CUDA
tensor, their plain versions on a CPU tensor. There is no knob.

At the end of the module these ops, and the rest of the reference's nn
ops in plain torch (the output heads with their loss-gradient backward,
the normalizations, the sequence ops, ``Deconvolution``, ``CTCLoss``,
the spatial transformer, every kind of ``Pooling``), are registered under
their reference names and signatures (``ops/registry.py``:
``mx.nd.FullyConnected`` and the rest).

AMP: each op recasts its inputs at entry by the active policy's class
for the reference op name (``amp.cast_op_inputs``, as the JAX dispatch
does at ``mxnet_tpu/ndarray/ndarray.py:662``): ``FullyConnected``,
``Convolution`` and ``_contrib_flash_attention`` cast float32 down to
the compute dtype; ``_contrib_fused_softmax_xent``,
``softmax_cross_entropy`` and ``softmax`` widen low precision to float32;
the rest pass the dtype through (LayerNorm and BatchNorm keep float32
statistics and return their input's dtype). With no policy active the
casts are the identity.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from ..amp import cast_op_inputs as _amp
from .kernels import (bn_act_forward, flash_attention, fused_act,
                      fused_add_act, fused_bn_apply, fused_softmax_xent_rows)

__all__ = ['fully_connected', 'convolution', 'deconvolution', 'pooling',
           'MaxPoolFunction', 'OutputActFunction', 'activation',
           'leaky_relu', 'instance_norm', 'add_relu', 'batch_norm',
           'BatchNormTrainFunction', 'flash_attention_op',
           'softmax_cross_entropy', 'fused_softmax_xent', 'layer_norm',
           'LayerNormFunction', 'dropout', 'embedding', 'flatten',
           'softmax', 'relu', 'rnn', 'rnn_param_size']


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight^T (+ bias)``; ``flatten`` folds all non-batch axes
    of ``data`` into one first."""
    data, weight, bias = _amp('FullyConnected', data, weight, bias)
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    if bias is not None:
        out = out + bias
    return out


def _ntuple(v, n, what):
    """``v`` (an int, or ``n`` ints) as an ``n``-tuple of ints."""
    t = (int(v),) * n if isinstance(v, int) else tuple(int(a) for a in v)
    if len(t) != n:
        raise ValueError('%s must be an int or %d ints, got %r'
                         % (what, n, v))
    return t


def _spatial(data, what):
    nd_ = data.dim() - 2
    if nd_ not in (1, 2, 3):
        raise NotImplementedError('%s: 1-, 2- or 3-D data (N, C, ...) only, '
                                  'got %d-D' % (what, data.dim()))
    return nd_


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def convolution(data, weight, bias=None, stride=1, pad=0, dilate=1,
                num_group=1):
    """1-, 2- or 3-D convolution over NC(D)(H)W ``data`` with an (out, in
    // groups, *kernel) ``weight`` and an optional (out,) ``bias``."""
    nd_ = _spatial(data, 'convolution')
    data, weight, bias = _amp('Convolution', data, weight, bias)
    return _CONV[nd_](data, weight, bias,
                      stride=_ntuple(stride, nd_, 'stride'),
                      padding=_ntuple(pad, nd_, 'pad'),
                      dilation=_ntuple(dilate, nd_, 'dilate'),
                      groups=int(num_group))


def deconvolution(data, weight, bias=None, stride=1, pad=0, adj=0,
                  dilate=1, num_group=1):
    """1-, 2- or 3-D transposed convolution with an (in, out // groups,
    *kernel) ``weight``: ``pad`` cut from each side of the full output,
    ``adj`` added on the right (the reference's ``target_shape`` is not
    read, as the JAX op reads it not)."""
    nd_ = _spatial(data, 'deconvolution')
    data, weight, bias = _amp('Deconvolution', data, weight, bias)
    return _CONV_T[nd_](data, weight, bias,
                        stride=_ntuple(stride, nd_, 'stride'),
                        padding=_ntuple(pad, nd_, 'pad'),
                        output_padding=_ntuple(adj, nd_, 'adj'),
                        groups=int(num_group),
                        dilation=_ntuple(dilate, nd_, 'dilate'))


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _pad_list(pad, extra):
    """``F.pad``'s list (last axis first) for ``pad`` on each side of each
    spatial axis and ``extra`` more on its right."""
    flat = []
    for p, e in reversed(list(zip(pad, extra))):
        flat += [p, p + e]
    return flat


class MaxPoolFunction(torch.autograd.Function):
    """``_max_pool_core`` (nn.py:193-254): max pooling whose backward
    gives the cotangent of a window to EVERY position equal to the
    window's max (the reference's pool.h rule), where autograd of
    ``F.max_pool2d`` picks one winner. For each of the window offsets (in
    the JAX loop's order, the last axis fastest), one strided slice of the
    -inf-padded input is compared with the output and the masked
    cotangent is added back at that offset. 1-, 2- or 3-D; ``extra`` the
    ``full`` convention's right extension of each axis."""

    @staticmethod
    def forward(ctx, data, kernel, stride, pad, extra=None):
        nd_ = data.dim() - 2
        extra = tuple(extra) if extra is not None else (0,) * nd_
        if any(extra):
            out = _MAX_POOL[nd_](F.pad(data, _pad_list(pad, extra),
                                       value=-math.inf), kernel, stride, 0)
        else:
            out = _MAX_POOL[nd_](data, kernel, stride, pad)
        ctx.save_for_backward(data, out)
        ctx.kernel, ctx.stride, ctx.pad, ctx.extra = (kernel, stride, pad,
                                                      extra)
        return out

    @staticmethod
    def backward(ctx, g):
        data, out = ctx.saved_tensors
        k, s, p = ctx.kernel, ctx.stride, ctx.pad
        xp = F.pad(data, _pad_list(p, ctx.extra), value=-math.inf)
        osp = out.shape[2:]
        dxp = torch.zeros(xp.shape, dtype=g.dtype, device=g.device)
        both = (slice(None), slice(None))
        for off in itertools.product(*(range(kk) for kk in k)):
            at = both + tuple(slice(o, o + (n - 1) * st + 1, st)
                              for o, n, st in zip(off, osp, s))
            hit = (xp[at] == out).to(g.dtype)
            dxp[at] += g * hit
        dx = dxp[both + tuple(slice(pp, pp + n)
                              for pp, n in zip(p, data.shape[2:]))]
        return dx.to(data.dtype), None, None, None, None


def _window_sum(data, k, s, p, extra):
    """The sum over each pooling window of ``data`` padded with zeros
    (``p`` each side, ``extra`` more on the right)."""
    nd_ = data.dim() - 2
    if nd_ == 1:
        return _window_sum(data.unsqueeze(2), (1,) + k, (1,) + s,
                           (0,) + p, (0,) + extra).squeeze(2)
    pool = F.avg_pool2d if nd_ == 2 else F.avg_pool3d
    if any(extra):
        data, p = F.pad(data, _pad_list(p, extra)), (0,) * nd_
    return pool(data, k, s, p, count_include_pad=True, divisor_override=1)


def pooling(data, kernel=(1, 1), pool_type='max', global_pool=False,
            stride=None, pad=0, pooling_convention='valid',
            count_include_pad=True):
    """1-, 2- or 3-D pooling over NC(D)(H)W ``data`` (``pooling``,
    nn.py:261-322): ``global_pool`` reduces each plane (max, sum, avg);
    else windows of ``kernel`` at ``stride`` (the kernel by default) with
    ``pad``: max through :class:`MaxPoolFunction`, sum, or avg (the window
    sum over the window's size, or with ``count_include_pad`` False over
    the count of its unpadded positions). ``pooling_convention='full'``
    rounds the output size up, the windows past the end reading padding,
    as the reference's. The JAX op falls back to autodiff's one-winner
    backward above 64 window offsets; the port keeps the equality rule for
    every window."""
    nd_ = _spatial(data, 'pooling')
    if global_pool:
        axes = tuple(range(2, 2 + nd_))
        if pool_type == 'max':
            return torch.amax(data, dim=axes, keepdim=True)
        if pool_type == 'sum':
            return torch.sum(data, dim=axes, keepdim=True)
        if pool_type == 'avg':
            return torch.mean(data, dim=axes, keepdim=True)
    k = _ntuple(kernel, nd_, 'kernel')
    s = k if stride is None else _ntuple(stride, nd_, 'stride')
    p = _ntuple(pad, nd_, 'pad')
    if pooling_convention == 'full':
        extra = []
        for i in range(nd_):
            rem = (int(data.shape[2 + i]) + 2 * p[i] - k[i]) % s[i]
            extra.append((s[i] - rem) % s[i] if rem else 0)
        extra = tuple(extra)
    elif pooling_convention == 'valid':
        extra = (0,) * nd_
    else:
        raise NotImplementedError('pooling: pooling_convention=%r is not '
                                  'ported' % (pooling_convention,))
    if pool_type == 'max' and not global_pool:
        return MaxPoolFunction.apply(data, k, s, p,
                                     extra if any(extra) else None)
    if pool_type not in ('avg', 'sum') or global_pool:
        raise NotImplementedError('pooling: %s%s pooling is not ported'
                                  % ('global ' if global_pool else '',
                                     pool_type))
    ssum = _window_sum(data, k, s, p, extra)
    if pool_type == 'sum':
        return ssum
    if count_include_pad:
        return ssum / float(math.prod(k))
    return ssum / _window_sum(torch.ones_like(data), k, s, p, extra)


# the activations with an output-only derivative: the epilogue kernels'
# save-output core covers them (``_ACT_RESCHED``, nn.py:430)
_EPILOGUE_ACTS = frozenset(('relu', 'sigmoid', 'tanh', 'softrelu',
                            'softsign'))


def activation(data, act_type='relu'):
    """Elementwise activation by name: relu, sigmoid, tanh, softrelu and
    softsign through the act kernels; gelu (the exact-erf form) plain."""
    if act_type in _EPILOGUE_ACTS:
        return fused_act(data, act_type)
    if act_type == 'gelu':
        return F.gelu(data, approximate='none')
    raise ValueError('unknown act_type %r (have %s)'
                     % (act_type, ', '.join(sorted(_EPILOGUE_ACTS
                                                   | {'gelu'}))))


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805
_SQRT_HALF = math.sqrt(0.5)


class OutputActFunction(torch.autograd.Function):
    """elu / selu with the JAX op's save-output backward (``_act_core``,
    nn.py:375-437): the forward ``where(x >= 0, x, slope * expm1(x))``
    (selu: ``scale * where(x >= 0, x, alpha * expm1(x))``), the output
    saved, the derivative from it, ``where(out >= 0, 1, out + slope)``
    (selu: ``where(out >= 0, scale, out + scale * alpha)``). Plain torch:
    the JAX package computes them with XLA, outside any Pallas kernel."""

    @staticmethod
    def forward(ctx, data, act_type, slope):
        if act_type == 'elu':
            out = torch.where(data >= 0, data, slope * torch.expm1(data))
        else:
            out = _SELU_SCALE * torch.where(
                data >= 0, data, _SELU_ALPHA * torch.expm1(data))
        ctx.save_for_backward(out)
        ctx.act_type, ctx.slope = act_type, slope
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        one = torch.ones_like(out)
        if ctx.act_type == 'elu':
            d = torch.where(out >= 0, one, out + ctx.slope)
        else:
            d = torch.where(out >= 0, _SELU_SCALE * one,
                            out + _SELU_SCALE * _SELU_ALPHA)
        return (g * d).to(out.dtype), None, None


def leaky_relu(data, act_type='leaky', slope=0.25, gamma=None):
    """``LeakyReLU`` (nn.py:454-487): ``leaky`` (and ``rrelu``, which the
    JAX op computes as leaky) through the act kernels when ``slope > 0``
    -- the sign invariant the output-only backward needs -- and plainly
    otherwise; ``prelu`` ``where(x >= 0, x, gamma x)`` with the learned
    ``gamma`` (a (C,) one broadcast over axis 1); ``elu`` (``slope`` its
    alpha; :class:`OutputActFunction` when ``slope > 0``, else plain) and
    ``selu`` through :class:`OutputActFunction`; ``gelu`` plain, as
    ``jax.nn.gelu`` computes it, ``0.5 x erfc(-x sqrt(1/2))`` (exact in
    the negative tail, where ``1 + erf`` cancels)."""
    if act_type in ('leaky', 'rrelu'):
        if slope > 0:
            return fused_act(data, 'leaky', float(slope))
        return torch.where(data >= 0, data, slope * data)
    if act_type == 'prelu':
        if gamma.dim() == 1 and data.dim() > 1:
            gamma = gamma.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data >= 0, data, gamma * data)
    if act_type == 'elu':
        if slope > 0:
            return OutputActFunction.apply(data, 'elu', float(slope))
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == 'selu':
        return OutputActFunction.apply(data, 'selu', 0.0)
    if act_type == 'gelu':
        return 0.5 * data * torch.erfc(-data * _SQRT_HALF)
    raise ValueError('unknown act_type %s' % (act_type,))


def add_relu(data, residual):
    """``relu(data + residual)``, the ResNet v1 residual join: one add+act
    kernel with the save-output backward for same-shape operands; the
    plain spelling for broadcasting ones, as the JAX op does."""
    if data.shape == residual.shape:
        return fused_add_act(data, residual, 'relu')
    return torch.relu(data + residual)


def flatten(data):
    """Collapse all axes but the first."""
    return data.reshape(data.shape[0], -1)


def relu(data):
    """``max(x, 0)``, plain: the JAX op is ``jax.nn.relu``, outside the
    epilogue kernels."""
    return torch.relu(data)


def softmax(data, axis=-1, temperature=None):
    """Softmax over ``axis`` (of ``data / temperature``): ``exp(x -
    max)`` over its sum, as ``jax.nn.softmax`` computes it."""
    data, = _amp('softmax', data)
    x = data if temperature in (None, 1.0) else data / temperature
    ax = -1 if axis is None else int(axis)
    e = torch.exp(x - torch.amax(x, dim=ax, keepdim=True))
    return e / torch.sum(e, dim=ax, keepdim=True)


def flash_attention_op(q, k, v, mask=None, *, num_heads, causal=False,
                       scale=None):
    """Multi-head attention core over head-split tensors: q (B*H, Sq, D),
    k/v (B*H, Sk, D), ``mask`` None or the (B,) valid key lengths (any
    numeric dtype; cast to int32). Returns (B*H, Sq, D).

    The JAX op also takes a dense (B, Sq, Sk) mask, which it runs on its
    unfused path; the port has no such path and raises instead."""
    q, k, v, mask = _amp('_contrib_flash_attention', q, k, v, mask)
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
    data, label = _amp('softmax_cross_entropy', data, label)
    return fused_softmax_xent_rows(data, label).sum()


def fused_softmax_xent(pred, label):
    """Per-row softmax cross-entropy head: (..., V) logits and (...)
    labels -> (..., 1) nll in the logits' dtype."""
    pred, label = _amp('_contrib_fused_softmax_xent', pred, label)
    v = pred.shape[-1]
    lead = pred.shape[:-1]
    nll = fused_softmax_xent_rows(pred.reshape(-1, v), label.reshape(-1))
    return nll.reshape(lead + (1,)).to(pred.dtype)


class BatchNormTrainFunction(torch.autograd.Function):
    """``_bn_train_core`` (nn.py:785-874): the training-mode BatchNorm.

    Forward: one-pass float32 statistics ``mean = E[x]``, ``var =
    max(E[x^2] - E[x]^2, 0)`` (biased), ``inv = rsqrt(var + eps)``, then
    the ``bn_act_fwd`` kernel with ``scale = inv * g``. Returns (out,
    mean, var). Backward: the plain ``_bn_train_bwd`` math from the saved
    (data, g, mean, inv), with the mean / var cotangents' terms when they
    have any (the ``BatchNorm`` op's outputs under ``mx.nd``); the layer
    reads mean and var under ``no_grad`` for its moving averages, and
    unused outputs bring no cotangent (``set_materialize_grads(False)``),
    so its backward is the plain one."""

    @staticmethod
    def forward(ctx, data, g, beta, eps, ax):
        red = tuple(i for i in range(data.dim()) if i != ax)
        m_count = 1.0
        for i in red:
            m_count *= data.shape[i]
        xf = data.float()
        s1 = torch.sum(xf, dim=red)
        s2 = torch.sum(xf * xf, dim=red)
        mean = s1 / m_count
        var = torch.clamp_min(s2 / m_count - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        out = bn_act_forward(xf, inv * g.float(), mean, beta.float(),
                             axis=ax).to(data.dtype)
        ctx.save_for_backward(data, g, mean, inv)
        ctx.ax, ctx.m_count, ctx.beta_dtype = ax, m_count, beta.dtype
        ctx.set_materialize_grads(False)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, dmean, dvar):
        data, g, mean, inv = ctx.saved_tensors
        ax, m_count = ctx.ax, ctx.m_count
        red = tuple(i for i in range(data.dim()) if i != ax)
        shape = [1] * data.dim()
        shape[ax] = data.shape[ax]
        xf = data.float()
        dyf = torch.zeros_like(xf) if dout is None else dout.float()
        sum_dy = torch.sum(dyf, dim=red)
        sum_dy_x = torch.sum(dyf * xf, dim=red)
        sum_dy_xhat = (sum_dy_x - mean * sum_dy) * inv
        xhat = (xf - mean.reshape(shape)) * inv.reshape(shape)
        scale = (g.float() * inv).reshape(shape)
        dx = scale * (dyf - (sum_dy / m_count).reshape(shape)
                      - xhat * (sum_dy_xhat / m_count).reshape(shape))
        if dmean is not None or dvar is not None:
            dm = torch.zeros_like(mean) if dmean is None else dmean.float()
            dv = torch.zeros_like(mean) if dvar is None else dvar.float()
            dx = dx + (dm / m_count).reshape(shape) \
                + (2.0 / m_count) * dv.reshape(shape) \
                * (xf - mean.reshape(shape))
        return (dx.to(data.dtype), sum_dy_xhat.to(g.dtype),
                sum_dy.to(ctx.beta_dtype), None, None)


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               fix_gamma=True, use_global_stats=False, axis=1,
               training=True):
    """BatchNorm over ``axis``; returns (out, mean, var) as the JAX op
    does, and leaves the moving averages to the layer.

    Training (and not ``use_global_stats``): batch statistics through
    :class:`BatchNormTrainFunction`; mean and var come back in the moving
    stats' dtype. Otherwise the moving statistics fold into a per-channel
    ``scale = rsqrt(var + eps) * g`` and the BN apply kernels run
    (:func:`~mxnet_tpu_torch.ops.kernels.fused_bn_apply`), differentiable
    in the data, gamma and beta: frozen-BN fine-tuning takes the
    ``bn_act_bwd`` kernel. ``fix_gamma`` uses ones for gamma."""
    ax = int(axis) % data.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training and not use_global_stats:
        out, mean, var = BatchNormTrainFunction.apply(data, g, beta,
                                                      float(eps), ax)
        stat = moving_mean.dtype
        return out, mean.to(stat), var.to(stat)
    scale = torch.rsqrt(moving_var.float() + eps) * g.float()
    out = fused_bn_apply(data, scale, moving_mean.float(), beta.float(),
                         axis=ax)
    return out.to(data.dtype), moving_mean, moving_var


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
    mask from a threefry key, which no PyTorch generator reproduces. On
    bf16 data ``keep`` is a weak Python float there, so it divides by
    ``keep`` rounded to bf16 (0.9 -> 0.8984375); so does the port."""
    if not training or p <= 0:
        return data
    if generator is None:
        raise RuntimeError('dropout: training with p=%g needs a '
                           'torch.Generator (the port draws no mask from '
                           'the global RNG)' % p)
    keep = 1.0 - p
    mask = (torch.rand(data.shape, generator=generator, device=data.device)
            < keep).to(data.dtype)
    return data * mask / torch.tensor(keep, dtype=data.dtype).item()


def embedding(data, weight):
    """Rows of ``weight`` at the indices ``data`` (any numeric dtype,
    cast to integers as ``astype(int32)`` does)."""
    return weight[data.to(torch.int64)]


# -- the fused RNN op (nn.py:1151-1297) ---------------------------------------

_GATES = {'rnn_relu': 1, 'rnn_tanh': 1, 'lstm': 4, 'gru': 3}


def _gates(mode):
    if mode not in _GATES:
        raise ValueError('unsupported RNN mode %r (have %s)'
                         % (mode, sorted(_GATES)))
    return _GATES[mode]


def _rnn_unpack_params(params, mode, num_layers, input_size, state_size,
                       bidirectional):
    """Views of the flat cuDNN-layout vector ``params``: for each layer,
    for each direction, W_i2h (G*H, in) and W_h2h (G*H, H); then every
    bias in the same order, b_i2h (G*H,) and b_h2h (G*H,). Returns (Ws,
    Bs), each ``[layer][direction] = (i2h, h2h)``."""
    G = _gates(mode)
    D = 2 if bidirectional else 1
    H = state_size
    off = 0

    def take(*shape):
        nonlocal off
        n = math.prod(shape)
        piece = params[off:off + n].reshape(shape)
        off += n
        return piece

    Ws = [[(take(G * H, input_size if layer == 0 else H * D),
            take(G * H, H)) for _ in range(D)]
          for layer in range(num_layers)]
    Bs = [[(take(G * H), take(G * H)) for _ in range(D)]
          for _ in range(num_layers)]
    return Ws, Bs


def rnn_param_size(mode, num_layers, input_size, state_size, bidirectional):
    """Elements of the flat parameter vector :func:`rnn` takes."""
    G = _gates(mode)
    D = 2 if bidirectional else 1
    H = state_size
    return sum(D * (G * H * (input_size if layer == 0 else H * D)
                    + G * H * H + 2 * G * H)
               for layer in range(num_layers))


def _rnn_param_concat(*args):
    """The pieces of the layout flattened and joined, in order."""
    return torch.cat([a.reshape(-1) for a in args], dim=0)


def _cell_step(mode, carry, xw, w_h2h, b_h2h):
    """One step of every row; ``xw`` = x @ W_i2h^T + b_i2h, precomputed
    for all t. Returns (carry, output)."""
    if mode == 'lstm':
        h, c = carry
        gates = xw + torch.matmul(h, w_h2h.t()) + b_h2h
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
        return (h, c), h
    if mode == 'gru':
        h = carry[0]
        hw = torch.matmul(h, w_h2h.t()) + b_h2h
        xr, xz, xn = xw.chunk(3, dim=-1)
        hr, hz, hn = hw.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h
        return (h,), h
    act = torch.tanh if mode == 'rnn_tanh' else torch.relu
    h = act(xw + torch.matmul(carry[0], w_h2h.t()) + b_h2h)
    return (h,), h


def _run_direction(mode, x, h0, c0, w_i2h, w_h2h, b_i2h, b_h2h, reverse):
    """One direction of one layer over x (T, B, in): the input projection
    as one product, then the steps in order (``reverse``: T-1 down to 0,
    each output kept at its own t). Returns (carry, ys (T, B, H))."""
    xw = torch.matmul(x, w_i2h.t()) + b_i2h
    carry = (h0, c0) if mode == 'lstm' else (h0,)
    T = x.shape[0]
    ys = [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        carry, ys[t] = _cell_step(mode, carry, xw[t], w_h2h, b_h2h)
    return carry, torch.stack(ys, dim=0)


# the JAX op accepts these and ignores them (nn.py:1242-1297): the port
# refuses a value it would not honour
_RNN_UNPORTED = (('p', 0.0), ('projection_size', None),
                 ('lstm_state_clip_min', None),
                 ('lstm_state_clip_max', None),
                 ('lstm_state_clip_nan', False),
                 ('use_sequence_length', False))


def rnn(data, parameters, state, state_cell=None, *, state_size,
        num_layers=1, bidirectional=False, mode='lstm', p=0.0,
        state_outputs=True, projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False,
        use_sequence_length=False):
    """Fused multi-layer (bi)RNN: data (T, B, I), the flat parameters,
    state (L*D, B, H) and, for an LSTM, state_cell (L*D, B, H). Returns
    out (T, B, H*D), with ``state_outputs`` also the final state (and
    cell), as a tuple; out alone otherwise.

    ``p`` (dropout between layers), ``projection_size``, the
    ``lstm_state_clip_*`` bounds and ``use_sequence_length``, which the
    JAX op takes and ignores, raise NotImplementedError naming the
    argument when given a value other than their default."""
    given = dict(p=p, projection_size=projection_size,
                 lstm_state_clip_min=lstm_state_clip_min,
                 lstm_state_clip_max=lstm_state_clip_max,
                 lstm_state_clip_nan=lstm_state_clip_nan,
                 use_sequence_length=use_sequence_length)
    for name, default in _RNN_UNPORTED:
        if given[name] != default:
            raise NotImplementedError(
                'rnn: %s=%r is not ported (the JAX op ignores it); the port '
                'runs %s=%r only' % (name, given[name], name, default))
    if mode == 'lstm' and state_cell is None:
        raise ValueError('rnn: mode lstm needs state_cell')
    data, parameters, state, state_cell = _amp('RNN', data, parameters,
                                               state, state_cell)
    T, B, I = data.shape
    H, L = int(state_size), int(num_layers)
    D = 2 if bidirectional else 1
    Ws, Bs = _rnn_unpack_params(parameters, mode, L, I, H, bidirectional)
    x = data
    out_h, out_c = [], []
    for layer in range(L):
        ys = []
        for d in range(D):
            li = layer * D + d
            c0 = state_cell[li] if mode == 'lstm' else None
            carry, y = _run_direction(mode, x, state[li], c0,
                                      *Ws[layer][d], *Bs[layer][d],
                                      reverse=(d == 1))
            ys.append(y)
            out_h.append(carry[0])
            if mode == 'lstm':
                out_c.append(carry[1])
        x = torch.cat(ys, dim=-1) if D == 2 else ys[0]
    if not state_outputs:
        return x
    outputs = (x, torch.stack(out_h, dim=0))
    if mode == 'lstm':
        outputs += (torch.stack(out_c, dim=0),)
    return outputs


def log_softmax(data, axis=-1, temperature=None):
    """``x - max - log(sum(exp(x - max)))`` over ``axis``, as
    ``jax.nn.log_softmax`` computes it."""
    data, = _amp('log_softmax', data)
    x = data if temperature in (None, 1.0) else data / temperature
    ax = -1 if axis is None else int(axis)
    shifted = x - torch.amax(x, dim=ax, keepdim=True)
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=ax,
                                         keepdim=True))


# -- the ops above under their reference names, with the reference
# signatures (``mx.nd.FullyConnected`` and the other generated wrappers,
# ops/registry.py) -----------------------------------------------------------

from ..base import torch_dtype as _torch_dtype  # noqa: E402
from .registry import register as _register  # noqa: E402


@_register('FullyConnected', num_inputs=-1)
def _fully_connected_op(args, *, num_hidden=None, no_bias=False,
                        flatten=True):
    bias = None if no_bias or len(args) < 3 else args[2]
    return fully_connected(args[0], args[1], bias, flatten=flatten)


@_register('Convolution', num_inputs=-1)
def _convolution_op(args, *, kernel=None, stride=None, dilate=None, pad=None,
                    num_filter=None, num_group=1, workspace=1024,
                    no_bias=False, cudnn_tune=None, cudnn_off=False,
                    layout=None):
    bias = None if no_bias or len(args) < 3 else args[2]
    return convolution(args[0], args[1], bias,
                       stride=stride if stride else 1,
                       pad=pad if pad else 0,
                       dilate=dilate if dilate else 1, num_group=num_group)


@_register('Pooling', aliases=('Pooling_v1',))
def _pooling_op(data, *, kernel=None, pool_type='max', global_pool=False,
                cudnn_off=False, pooling_convention='valid', stride=None,
                pad=None, p_value=2, count_include_pad=True, layout=None):
    """The reference op: :func:`pooling`, its stride 1 by default, as the
    reference's."""
    nd_ = data.dim() - 2
    return pooling(data, kernel=kernel if kernel else (1,) * nd_,
                   pool_type=pool_type, global_pool=global_pool,
                   stride=stride if stride else 1, pad=pad if pad else 0,
                   pooling_convention=pooling_convention,
                   count_include_pad=count_include_pad)


@_register('Activation')
def _activation_op(data, *, act_type='relu'):
    return activation(data, act_type)


@_register('LeakyReLU', num_inputs=-1)
def _leaky_relu_op(args, *, act_type='leaky', slope=0.25, lower_bound=0.125,
                   upper_bound=0.334):
    return leaky_relu(args[0], act_type, slope,
                      args[1] if len(args) > 1 else None)


_register('_contrib_add_relu', num_inputs=2)(add_relu)


@_register('_contrib_flash_attention', num_inputs=-1)
def _flash_attention_op(args, *, num_heads, causal=False, scale=None):
    return flash_attention_op(*args, num_heads=num_heads, causal=causal,
                              scale=scale)


@_register('softmax')
def _softmax_op(data, *, axis=-1, temperature=None, dtype=None, length=None):
    return softmax(data, axis, temperature)


@_register('log_softmax')
def _log_softmax_op(data, *, axis=-1, temperature=None, dtype=None):
    return log_softmax(data, axis, temperature)


_register('softmax_cross_entropy', num_inputs=2)(softmax_cross_entropy)
_register('_contrib_fused_softmax_xent', num_inputs=2)(fused_softmax_xent)


@_register('BatchNorm', num_inputs=5, num_outputs=3,
           aliases=('BatchNorm_v1',))
def _batch_norm_op(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
                   momentum=0.9, fix_gamma=True, use_global_stats=False,
                   output_mean_var=False, axis=1, cudnn_off=False,
                   min_calib_range=None, max_calib_range=None,
                   training=True):
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                      fix_gamma=fix_gamma,
                      use_global_stats=use_global_stats, axis=axis,
                      training=training)


@_register('LayerNorm', num_inputs=3, num_outputs=-1)
def _layer_norm_op(data, gamma, beta, *, axis=-1, eps=1e-5,
                   output_mean_var=False):
    out = layer_norm(data, gamma, beta, axis=axis, eps=eps)
    if not output_mean_var:
        return out
    ax = int(axis) % data.dim()
    _, mean, inv = _ln_forward(data.detach(), gamma, beta, float(eps), ax)
    return out, torch.squeeze(mean, dim=ax), torch.squeeze(1.0 / inv, dim=ax)


@_register('Dropout', needs_rng=True)
def _dropout_op(gen, data, *, p=0.5, mode='training', axes=None,
                cudnn_off=False, training=True):
    if axes:
        raise NotImplementedError('Dropout: axes= (a broadcast mask) is not '
                                  'ported')
    return dropout(data, p, gen, training)


@_register('Embedding', num_inputs=2,
           aliases=('_contrib_SparseEmbedding',))
def _embedding_op(data, weight, *, input_dim=None, output_dim=None,
                  dtype='float32', sparse_grad=False):
    return embedding(data, weight)


@_register('RNN', num_inputs=-1)
def _rnn_op(args, *, state_size=None, num_layers=1, bidirectional=False,
            mode='lstm', p=0.0, state_outputs=True, projection_size=None,
            lstm_state_clip_min=None, lstm_state_clip_max=None,
            lstm_state_clip_nan=False, use_sequence_length=False):
    return rnn(*args, state_size=state_size, num_layers=num_layers,
               bidirectional=bidirectional, mode=mode, p=p,
               state_outputs=state_outputs,
               projection_size=projection_size,
               lstm_state_clip_min=lstm_state_clip_min,
               lstm_state_clip_max=lstm_state_clip_max,
               lstm_state_clip_nan=lstm_state_clip_nan,
               use_sequence_length=use_sequence_length)


# -- the rest of the reference's nn ops, plain torch (none is a Pallas
# kernel in the JAX package) ----------------------------------------------------

def _jax_softmax(x, axis):
    e = torch.exp(x - torch.amax(x, dim=axis, keepdim=True))
    return e / torch.sum(e, dim=axis, keepdim=True)


@_register('softmin')
def _softmin_op(data, *, axis=-1, temperature=None, dtype=None):
    x = -data if temperature in (None, 1.0) else -data / temperature
    out = _jax_softmax(x, -1 if axis is None else int(axis))
    return out if not dtype else out.to(_torch_dtype(dtype))


@_register('SoftmaxActivation')
def _softmax_activation_op(data, *, mode='instance'):
    if mode == 'channel':
        return _jax_softmax(data, 1)
    return _jax_softmax(data.reshape(data.shape[0], -1), -1).reshape(
        data.shape)


class _LossHead(torch.autograd.Function):
    """An output head whose backward is its loss's gradient, not the
    derivative of its forward (``SoftmaxOutput``, the regression outputs,
    ``SVMOutput``): ``forward`` returns ``out``, ``backward`` the
    precomputed ``grad`` for the data and zeros for the label."""

    @staticmethod
    def forward(ctx, data, label, out, grad):
        ctx.save_for_backward(grad)
        ctx.label_shape = (label.shape, label.dtype, label.device)
        return out

    @staticmethod
    def backward(ctx, g):
        grad, = ctx.saved_tensors
        shape, dtype, device = ctx.label_shape
        return grad, torch.zeros(shape, dtype=dtype, device=device), \
            None, None


def _onehot(lab, n, axis, dtype):
    oh = F.one_hot(lab.to(torch.int64), n).to(dtype)
    return torch.movedim(oh, -1, axis) if axis not in (-1, oh.dim() - 1) \
        else oh


@_register('SoftmaxOutput', num_inputs=2, aliases=('Softmax',))
def _softmax_output_op(data, label, *, grad_scale=1.0, ignore_label=-1.0,
                       multi_output=False, use_ignore=False,
                       preserve_shape=False, normalization='null',
                       out_grad=False, smooth_alpha=0.0):
    """Softmax forward; backward ``(softmax - onehot(label)) * scale``
    (``softmax_output.cc``), ignored labels masked, ``normalization``
    'valid' / 'batch' dividing the scale."""
    axis = 1 if multi_output else -1
    with torch.no_grad():
        out = _jax_softmax(data, axis)
        lab = label.to(torch.int32)
        grad = out - _onehot(torch.clamp(lab, min=0), out.shape[axis], axis,
                             out.dtype)
        valid = torch.ones(lab.shape, dtype=out.dtype, device=out.device)
        if use_ignore:
            valid = (lab != int(ignore_label)).to(out.dtype)
            grad = grad * (valid.unsqueeze(axis) if multi_output
                           else valid[..., None])
        scale = float(grad_scale)
        if normalization == 'valid':
            scale = scale / torch.clamp(valid.sum(), min=1.0)
        elif normalization == 'batch':
            scale = scale / lab.shape[0]
        grad = (grad * scale).to(out.dtype)
    return _LossHead.apply(data, label, out, grad)


def _regression(link, grad_fn, name):
    @_register(name, num_inputs=2)
    def _op(data, label, *, grad_scale=1.0):
        lab = label.reshape(data.shape)
        with torch.no_grad():
            out = link(data)
            num = 1
            for s in out.shape[1:]:
                num *= s
            grad = (grad_fn(out, lab) * (float(grad_scale) / num)).to(
                out.dtype)
        return _LossHead.apply(data, label, out, grad)
    return _op


_regression(lambda x: x, lambda o, l: o - l, 'LinearRegressionOutput')
_regression(lambda x: x, lambda o, l: torch.sign(o - l),
            'MAERegressionOutput')
_regression(torch.sigmoid, lambda o, l: o - l, 'LogisticRegressionOutput')


@_register('SVMOutput', num_inputs=2)
def _svm_output_op(data, label, *, margin=1.0, regularization_coefficient=1.0,
                   use_linear=False):
    with torch.no_grad():
        y = 2 * F.one_hot(label.to(torch.int64), data.shape[-1]).to(
            data.dtype) - 1
        viol = (margin - y * data) > 0
        if use_linear:
            grad = torch.where(viol, -y * regularization_coefficient,
                               torch.zeros_like(data))
        else:
            grad = torch.where(viol, -2 * (margin - y * data) * y
                               * regularization_coefficient,
                               torch.zeros_like(data))
    return _LossHead.apply(data, label, data.detach().clone(), grad)


@_register('InstanceNorm', num_inputs=3)
def instance_norm(data, gamma, beta, *, eps=1e-3):
    """``InstanceNorm`` (nn.py:994-1001): each (sample, channel) plane
    normalized by its mean and (biased) variance, then ``* gamma +
    beta`` per channel."""
    red = tuple(range(2, data.dim()))
    mean = torch.mean(data, dim=red, keepdim=True)
    var = torch.mean(torch.square(data - mean), dim=red, keepdim=True)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    out = (data - mean) * torch.rsqrt(var + eps)
    return out * gamma.reshape(shape) + beta.reshape(shape)


@_register('L2Normalization')
def _l2_normalization_op(data, *, eps=1e-10, mode='instance'):
    if mode == 'instance':
        red = tuple(range(1, data.dim()))
    elif mode == 'channel':
        red = (1,)
    else:
        red = tuple(range(2, data.dim()))
    nrm = torch.sqrt(torch.sum(torch.square(data), dim=red, keepdim=True)
                     + eps)
    return data / nrm


@_register('LRN')
def _lrn_op(data, *, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    sq = torch.square(data)
    half = int(nsize) // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    acc = padded[:, 0:data.shape[1]]
    for i in range(1, int(nsize)):
        acc = acc + padded[:, i:i + data.shape[1]]
    return data / torch.pow(knorm + alpha / nsize * acc, beta)


def _seq_mask(lengths, maxlen, dtype):
    t = torch.arange(maxlen, dtype=torch.float32,
                     device=lengths.device)[:, None]
    return (t < lengths.to(torch.float32)[None, :]).to(dtype)


@_register('SequenceMask', num_inputs=-1)
def _sequence_mask_op(args, *, use_sequence_length=False, value=0.0, axis=0):
    data = args[0]
    if not use_sequence_length:
        return data
    ax = int(axis)
    mask = _seq_mask(args[1], data.shape[ax], data.dtype)
    if ax == 1:
        mask = mask.t()
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    return data * mask + value * (1 - mask)


@_register('SequenceLast', num_inputs=-1)
def _sequence_last_op(args, *, use_sequence_length=False, axis=0):
    data = args[0]
    ax = int(axis)
    if not use_sequence_length:
        return torch.select(data, ax, data.shape[ax] - 1)
    idx = torch.clamp(args[1].to(torch.int64) - 1, 0, data.shape[ax] - 1)
    moved = torch.movedim(data, ax, 0)
    idx = idx.reshape((1, -1) + (1,) * (moved.dim() - 2)).expand(
        (1,) + tuple(moved.shape[1:]))
    return torch.gather(moved, 0, idx)[0]


@_register('SequenceReverse', num_inputs=-1)
def _sequence_reverse_op(args, *, use_sequence_length=False, axis=0):
    data = args[0]
    if not use_sequence_length:
        return torch.flip(data, dims=(0,))
    lens = args[1].to(torch.int64)[None, :]
    t = torch.arange(data.shape[0], device=data.device)[:, None]
    src = torch.where(t < lens, lens - 1 - t, t)
    src = src.reshape((data.shape[0], -1) + (1,) * (data.dim() - 2))
    return torch.gather(data, 0, src.expand(data.shape))


@_register('UpSampling', num_inputs=-1, key_var_num_args='num_args')
def _upsampling_op(args, *, scale=1, sample_type='nearest', num_args=1,
                   num_filter=0, multi_input_mode='concat', workspace=512):
    s = int(scale)
    outs = []
    for data in args:
        if sample_type == 'nearest':
            out = torch.repeat_interleave(
                torch.repeat_interleave(data, s, dim=2), s, dim=3)
        else:
            out = F.interpolate(data, scale_factor=s, mode='bilinear',
                                align_corners=False)
        outs.append(out)
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == 'sum':
        total = outs[0]
        for o in outs[1:]:
            total = total + o
        return total
    return torch.cat(outs, dim=1)


@_register('CTCLoss', num_inputs=-1, aliases=(
    'ctc_loss', '_contrib_CTCLoss', '_contrib_ctc_loss'))
def _ctc_loss_op(args, *, use_data_lengths=False, use_label_lengths=False,
                 blank_label='first'):
    """CTC negative log likelihood per batch row: data (T, B, C)
    unnormalized activations, label (B, L) padded with 0 (lengths from
    the non-zero labels unless given)."""
    data, label = args[0], args[1]
    t, b, c = data.shape
    i = 2
    if use_data_lengths:
        data_len = args[i].to(torch.int64)
        i += 1
    else:
        data_len = torch.full((b,), t, dtype=torch.int64)
    lab = label.to(torch.int64)
    label_len = args[i].to(torch.int64) if use_label_lengths \
        else torch.sum(lab != 0, dim=-1)
    logp = torch.log_softmax(data.float(), dim=-1)
    blank = 0 if blank_label == 'first' else c - 1
    return F.ctc_loss(logp, lab, data_len.cpu(), label_len.cpu(),
                      blank=blank, reduction='none').to(data.dtype)


@_register('_contrib_SyncBatchNorm', num_inputs=5, num_outputs=3)
def _sync_batch_norm_op(data, gamma, beta, moving_mean, moving_var, *,
                        eps=1e-3, momentum=0.9, fix_gamma=True,
                        use_global_stats=False, output_mean_var=False,
                        ndev=1, key=None, training=False, axis=1):
    """BatchNorm: on one device the batch is the global batch."""
    return _batch_norm_op(data, gamma, beta, moving_mean, moving_var,
                          eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                          use_global_stats=use_global_stats,
                          output_mean_var=output_mean_var, axis=axis,
                          training=training)


@_register('IdentityAttachKLSparseReg')
def _identity_attach_kl_sparse_reg_op(data, *, sparseness_target=0.1,
                                      penalty=0.001, momentum=0.9):
    return data


def _tup(v, n, default):
    if v is None or (isinstance(v, (tuple, list)) and len(v) == 0):
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(a) for a in v)


@_register('Deconvolution', num_inputs=-1)
def _deconvolution_op(args, *, kernel=None, stride=None, dilate=None,
                      pad=None, adj=None, target_shape=None, num_filter=None,
                      num_group=1, workspace=512, no_bias=True,
                      cudnn_tune=None, cudnn_off=False, layout=None):
    """:func:`deconvolution` with the reference's arguments."""
    data, weight = args[0], args[1]
    nd_ = len(kernel)
    bias = args[2] if not no_bias and len(args) > 2 else None
    return deconvolution(data, weight, bias, stride=_tup(stride, nd_, 1),
                         pad=_tup(pad, nd_, 0), adj=_tup(adj, nd_, 0),
                         dilate=_tup(dilate, nd_, 1), num_group=num_group)


@_register('GridGenerator')
def _grid_generator_op(data, *, transform_type='affine', target_shape=None):
    h, w = int(target_shape[0]), int(target_shape[1])
    if transform_type != 'affine':
        return data                    # warp: data is the flow field
    n = data.shape[0]
    theta = data.reshape(n, 2, 3)
    ys = torch.linspace(-1, 1, h, dtype=data.dtype, device=data.device)
    xs = torch.linspace(-1, 1, w, dtype=data.dtype, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)], dim=0)
    return torch.einsum('nij,jk->nik', theta, grid).reshape(n, 2, h, w)


@_register('BilinearSampler', num_inputs=2)
def _bilinear_sampler_op(data, grid, *, cudnn_off=False):
    """Bilinear sampling of ``data`` at the normalized (x, y) of ``grid``,
    zero outside the image."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1) * (w - 1) / 2
    gy = (grid[:, 1] + 1) * (h - 1) / 2
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    wx1 = gx - x0
    wx0 = 1 - wx1
    wy1 = gy - y0
    wy0 = 1 - wy1
    flat = data.reshape(n, c, h * w)

    def sample(xi, yi):
        xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
        got = torch.gather(flat, 2, idx).reshape((n, c) + tuple(gx.shape[1:]))
        return got * valid[:, None].to(data.dtype)

    out = (sample(x0, y0) * (wx0 * wy0)[:, None]
           + sample(x1, y0) * (wx1 * wy0)[:, None]
           + sample(x0, y1) * (wx0 * wy1)[:, None]
           + sample(x1, y1) * (wx1 * wy1)[:, None])
    return out.to(data.dtype)


@_register('SpatialTransformer', num_inputs=2)
def _spatial_transformer_op(data, loc, *, target_shape=None,
                            transform_type='affine', sampler_type='bilinear',
                            cudnn_off=False):
    grid = _grid_generator_op(loc, transform_type=transform_type,
                              target_shape=target_shape)
    return _bilinear_sampler_op(data, grid)

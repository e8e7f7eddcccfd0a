"""Optimizer update ops, the counterpart of ``mxnet_tpu/ops/optimizer_ops.py``.

Ported: AdamW (the BERT-pretraining optimizer) and SGD with and without
momentum (the ResNet one), and their float32-master forms for
low-precision weights (``mp_adamw_update``, ``mp_sgd_update``,
``mp_sgd_mom_update``), dense gradients only.
The JAX package computes them outside any Pallas kernel, as plain
elementwise XLA; here they are plain PyTorch. Unlike the JAX ops, which
return new arrays, the port updates the weight and its state in place:
the update then holds no second copy of the model and its optimizer
state. The expressions and their order are the JAX ops'.

The rest of the reference's update ops (``signsgd_update`` /
``signum_update``, ``adam_update``, ``ftml_update``, ``rmsprop_update`` /
``rmspropalex_update``, ``ftrl_update``, ``_sparse_adagrad_update``,
:160-247 there) are functional, as the JAX ones: they return the new
weight and states, which the optimizers of ``optimizer/optimizer.py``
copy into place. Their float32 form is the plain version of the
whole-model update kernel's rules, which is bitwise it; so a division by
a Python scalar (FTML's ``1 - beta2^t``, Ftrl's lr) divides by a 0-dim
float32 tensor of the divisor (:func:`_over`): PyTorch on a CUDA device
multiplies by the reciprocal of a Python scalar divisor, a true division
by a tensor everywhere, as the JAX op divides.

bf16 weights without a float32 master (``sgd_update`` / ``sgd_mom_update``
on bf16 tensors, as ``bench_resnet`` trains a ``cast('bfloat16')`` net):
the port computes what the JAX trainer's traced update computes
(train_step.py:576, optimizer/fused.py:119-147), which the tests hold
byte for byte. Its lr, wd and rescale_grad are float32 scalars, not weak
Python floats, so they promote the bf16 math to float32: the gradient
widens, ``momentum * mom`` multiplies the widened momentum by the
momentum rounded to bf16 (a weak Python float takes the array's dtype),
and XLA keeps that product in float32; the new weight and momentum round
to bf16 once, at the end.

AdamW on bf16 weights with bf16 state and no master (``adamw_update`` on
bf16 tensors, as ``bench_bert`` trains a ``cast('bfloat16')`` net): the
reference's ``AdamW.update`` (optimizer.py:474-483) hands the op its
``rescale_grad`` as ``nd.full((1,), rescale_grad, dtype=weight.dtype)``,
a bf16 array, ``eta`` and ``wd`` as float32 scalars and ``beta1``,
``beta2``, ``epsilon`` and ``lr=1.0`` as weak Python floats, which take
bf16. XLA on the CPU (read from its optimized HLO, and held byte for byte
over 2M elements) computes every bf16 op of the op in float32 and rounds
its result to bf16, with these exceptions: ``m / (sqrt(v) + eps)`` stays
float32 (its bf16 result meets a float32 term, and XLA drops the round
trip), and so do ``wd * w``, the sum and ``eta *`` it, which float32
operands promote; the new weight rounds once at the end. So: ``g`` =
``grad * rescale`` rounded, clipped to the clip rounded; ``m`` =
``beta1 * m`` rounded + ``(1 - beta1) * g`` rounded, rounded; ``v`` the
same over ``g * g`` rounded; the denominator ``sqrt(v)`` rounded +
``eps``, rounded; the weight ``w - eta * (m / den + wd * w)`` in float32,
rounded (each constant rounded to bf16 first).
"""
from __future__ import annotations

import torch

__all__ = ['adamw_update', 'mp_adamw_update', 'sgd_update', 'sgd_mom_update',
           'mp_sgd_update', 'mp_sgd_mom_update', 'low_scalar',
           'signsgd_update', 'signum_update', 'adam_update', 'ftml_update',
           'rmsprop_update', 'rmspropalex_update', 'ftrl_update',
           'adagrad_update']

_LOW = (torch.float16, torch.bfloat16)


def low_scalar(x, dtype):
    """The Python float ``x`` as a weak scalar of a ``dtype`` array takes
    it: rounded to ``dtype``, as a Python float."""
    return torch.tensor(x, dtype=dtype).item()


@torch.no_grad()
def adamw_update(weight, grad, mean, var, rescale_grad=1.0, *, lr=1.0,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 clip_gradient=None):
    """AdamW with decoupled weight decay (``_adamw_update``,
    optimizer_ops.py:139-152), in place::

        g = grad * rescale_grad, clipped to [-clip, clip] if clip > 0
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g^2
        w = w - eta * (lr * m / (sqrt(v) + epsilon) + wd * w)

    On bf16 weight, gradient and state it rounds as the reference's traced
    update does (see the module docstring). Returns (weight, mean, var),
    the tensors passed in.
    """
    if weight.dtype in _LOW:
        return _adamw_low(weight, grad, mean, var, rescale_grad, lr=lr,
                          beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wd,
                          eta=eta, clip_gradient=clip_gradient)
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    mean.mul_(beta1).add_((1 - beta1) * g)
    var.mul_(beta2).add_((1 - beta2) * torch.square(g))
    step = lr * mean / (torch.sqrt(var) + epsilon) + wd * weight
    weight.sub_(eta * step)
    return weight, mean, var


def _adamw_low(weight, grad, mean, var, rescale_grad, *, lr, beta1, beta2,
               epsilon, wd, eta, clip_gradient):
    """:func:`adamw_update` on low-precision weight, gradient and state
    without a master: float32 arithmetic, each bf16 op of the reference
    rounded where XLA rounds it (the module docstring)."""
    dt = weight.dtype

    def r(x):
        return x.to(dt).float()

    def s(x):
        return low_scalar(x, dt)
    g = r(grad.float() * s(rescale_grad))
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -s(clip_gradient), s(clip_gradient))
    m = r(r(mean.float() * s(beta1)) + r(g * s(1 - beta1)))
    v = r(r(var.float() * s(beta2)) + r(r(g * g) * s(1 - beta2)))
    den = r(r(torch.sqrt(v)) + s(epsilon))
    w = weight.float()
    weight.copy_(w - eta * (r(m * s(lr)) / den + wd * w))
    mean.copy_(m)
    var.copy_(v)
    return weight, mean, var


@torch.no_grad()
def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad=1.0, *,
                    lr=1.0, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                    eta=1.0, clip_gradient=None):
    """AdamW on a low-precision weight with a float32 master
    (``_mp_adamw_update``, optimizer_ops.py:155-168), in place: the
    widened gradient updates the float32 ``mean``, ``var`` and
    ``weight32`` as :func:`adamw_update` does, and ``weight`` becomes
    ``weight32`` rounded. Returns (weight, mean, var, weight32)."""
    adamw_update(weight32, grad.float(), mean, var, rescale_grad, lr=lr,
                 beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wd, eta=eta,
                 clip_gradient=clip_gradient)
    weight.copy_(weight32)
    return weight, mean, var, weight32


def _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight):
    """``clip(grad * rescale_grad) + wd * weight``, the SGD family's order
    (``_rescale_clip``, optimizer_ops.py:20-31): clip before the wd
    term."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if wd != 0:
        g = g + wd * weight
    return g


@torch.no_grad()
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=None):
    """Plain SGD (``sgd_update``, optimizer_ops.py:57), in place:
    ``w = w - lr * g``; a bf16 weight computes in float32 and rounds
    once (see the module docstring). Returns ``weight``."""
    if weight.dtype in _LOW:
        g = _rescale_clip(grad.float(), rescale_grad, clip_gradient, wd,
                          weight.float())
        return weight.copy_(weight.float() - lr * g)
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    return weight.sub_(lr * g)


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """SGD with momentum (``sgd_mom_update``, optimizer_ops.py:67), in
    place::

        mom = momentum * mom - lr * g
        w = w + mom

    bf16 weight and momentum compute in float32 and round once each (see
    the module docstring). Returns (weight, mom), the tensors passed
    in."""
    if weight.dtype in _LOW:
        g = _rescale_clip(grad.float(), rescale_grad, clip_gradient, wd,
                          weight.float())
        m = low_scalar(momentum, mom.dtype)
        new_mom = mom.float() * m - lr * g
        weight.copy_(weight.float() + new_mom)
        mom.copy_(new_mom)
        return weight, mom
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    mom.mul_(momentum).sub_(lr * g)
    weight.add_(mom)
    return weight, mom


@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=None):
    """SGD on a low-precision weight with a float32 master
    (``mp_sgd_update``, optimizer_ops.py:78-87), in place: the widened
    gradient updates ``weight32``, ``w32 = w32 - lr * g`` with g the
    float32 ``clip(grad * rescale_grad) + wd * w32``, and ``weight``
    becomes ``w32`` rounded. Returns (weight, weight32)."""
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient, wd,
                      weight32)
    weight32.sub_(lr * g)
    weight.copy_(weight32)
    return weight, weight32


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """SGD with momentum on a low-precision weight with a float32 master
    (``mp_sgd_mom_update``, optimizer_ops.py:90-105), in place, all in
    float32::

        mom = momentum * mom - lr * g
        w32 = w32 + mom
        weight = w32 (rounded)

    Returns (weight, mom, weight32)."""
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient, wd,
                      weight32)
    mom.mul_(momentum).sub_(lr * g)
    weight32.add_(mom)
    weight.copy_(weight32)
    return weight, mom, weight32


# -- under their reference names (``mx.nd.sgd_update`` ...,
# ops/registry.py): the eager frontend writes the outputs back into the
# inputs at ``mutate_idx``, which these in-place bodies already updated --

from .registry import register as _register  # noqa: E402


@_register('sgd_update', num_inputs=2, mutate_idx=(0,))
def _sgd_update_op(weight, grad, *, lr=None, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=False):
    return sgd_update(weight, grad, lr=lr, wd=wd, rescale_grad=rescale_grad,
                      clip_gradient=clip_gradient)


@_register('sgd_mom_update', num_inputs=3, num_outputs=2, mutate_idx=(0, 2))
def _sgd_mom_update_op(weight, grad, mom, *, lr=None, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=False):
    return sgd_mom_update(weight, grad, mom, lr=lr, momentum=momentum, wd=wd,
                          rescale_grad=rescale_grad,
                          clip_gradient=clip_gradient)


@_register('mp_sgd_update', num_inputs=3, num_outputs=2, mutate_idx=(0, 2))
def _mp_sgd_update_op(weight, grad, weight32, *, lr=None, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=False):
    return mp_sgd_update(weight, grad, weight32, lr=lr, wd=wd,
                         rescale_grad=rescale_grad,
                         clip_gradient=clip_gradient)


@_register('mp_sgd_mom_update', num_inputs=4, num_outputs=3,
           mutate_idx=(0, 2, 3))
def _mp_sgd_mom_update_op(weight, grad, mom, weight32, *, lr=None,
                          momentum=0.0, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0, lazy_update=False):
    return mp_sgd_mom_update(weight, grad, mom, weight32, lr=lr,
                             momentum=momentum, wd=wd,
                             rescale_grad=rescale_grad,
                             clip_gradient=clip_gradient)


@_register('_adamw_update', num_inputs=5, num_outputs=3, mutate_idx=(0, 2, 3),
           aliases=('_contrib_adamw_update',))
def _adamw_update_op(weight, grad, mean, var, rescale_grad_t, *, lr=None,
                     beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                     clip_gradient=-1.0):
    return adamw_update(weight, grad, mean, var, rescale_grad_t, lr=lr,
                        beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wd,
                        eta=eta, clip_gradient=clip_gradient)


@_register('_mp_adamw_update', num_inputs=6, num_outputs=4,
           mutate_idx=(0, 2, 3, 4), aliases=('_contrib_mp_adamw_update',))
def _mp_adamw_update_op(weight, grad, mean, var, weight32, rescale_grad_t, *,
                        lr=None, beta1=0.9, beta2=0.999, epsilon=1e-8,
                        wd=0.0, eta=1.0, clip_gradient=-1.0):
    return mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad_t,
                           lr=lr, beta1=beta1, beta2=beta2, epsilon=epsilon,
                           wd=wd, eta=eta, clip_gradient=clip_gradient)


# -- the reference's other update ops, functional as the JAX ones (the
# frontend writes each output back into its input at ``mutate_idx``; the
# optimizers copy them into place) ----------------------------------------

def _over(t, c):
    """``t / c`` for a Python number ``c``: a true division on every
    device (a float32 ``t`` divided by ``c`` as a 0-dim float32 tensor on
    its device; see the module docstring)."""
    if t.dtype == torch.float32:
        return t / torch.full((), c, dtype=torch.float32, device=t.device)
    return t / c


def _rescale_wd_clip(grad, rescale_grad, clip_gradient, wd, weight):
    """``clip(rescale * grad + wd * weight)``: the Adam family's order,
    wd folded in before the clip."""
    g = grad * rescale_grad
    if wd != 0.0 and weight is not None:
        g = g + wd * weight
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _clip_only(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@_register('signsgd_update', num_inputs=2, mutate_idx=(0,))
def _signsgd_update_op(weight, grad, *, lr=None, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    g = _clip_only(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@_register('signum_update', num_inputs=3, num_outputs=2, mutate_idx=(0, 2))
def _signum_update_op(weight, grad, mom, *, lr=None, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom - (1 - momentum) * g
    return (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom), new_mom


@_register('adam_update', num_inputs=4, num_outputs=3, mutate_idx=(0, 2, 3))
def _adam_update_op(weight, grad, mean, var, *, lr=None, beta1=0.9,
                    beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, lazy_update=False):
    g = _rescale_wd_clip(grad, rescale_grad, clip_gradient, wd, weight)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    return weight - lr * m / (torch.sqrt(v) + epsilon), m, v


@_register('ftml_update', num_inputs=5, num_outputs=4,
           mutate_idx=(0, 2, 3, 4))
def _ftml_update_op(weight, grad, d, v, z, *, lr=None, beta1=0.6,
                    beta2=0.999, epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                    clip_grad=-1.0):
    g = _rescale_wd_clip(grad, rescale_grad, clip_grad, wd, weight)
    v_t = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(_over(v_t, 1 - beta2 ** t))
                                   + epsilon)
    sigma_t = d_t - beta1 * d
    z_t = beta1 * z + (1 - beta1) * g - sigma_t * weight
    return -z_t / d_t, d_t, v_t, z_t


@_register('rmsprop_update', num_inputs=3, num_outputs=2, mutate_idx=(0, 2))
def _rmsprop_update_op(weight, grad, n, *, lr=None, gamma1=0.95,
                       epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    g = _rescale_wd_clip(grad, rescale_grad, clip_gradient, wd, weight)
    n_t = gamma1 * n + (1 - gamma1) * torch.square(g)
    w = weight - lr * g / torch.sqrt(n_t + epsilon)
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n_t


@_register('rmspropalex_update', num_inputs=5, num_outputs=4,
           mutate_idx=(0, 2, 3, 4))
def _rmspropalex_update_op(weight, grad, n, g_acc, delta, *, lr=None,
                           gamma1=0.95, gamma2=0.9, epsilon=1e-8, wd=0.0,
                           rescale_grad=1.0, clip_gradient=-1.0,
                           clip_weights=-1.0):
    g = _rescale_wd_clip(grad, rescale_grad, clip_gradient, wd, weight)
    n_t = gamma1 * n + (1 - gamma1) * torch.square(g)
    g_t = gamma1 * g_acc + (1 - gamma1) * g
    delta_t = gamma2 * delta - lr * g / torch.sqrt(n_t - torch.square(g_t)
                                                   + epsilon)
    w = weight + delta_t
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n_t, g_t, delta_t


@_register('ftrl_update', num_inputs=4, num_outputs=3, mutate_idx=(0, 2, 3))
def _ftrl_update_op(weight, grad, z, n, *, lr=None, lamda1=0.01, beta=1.0,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip_only(grad, rescale_grad, clip_gradient)
    n_t = n + torch.square(g)
    sigma = _over(torch.sqrt(n_t) - torch.sqrt(n), lr)
    z_t = z + g - sigma * weight
    w = torch.where(torch.abs(z_t) > lamda1,
                    -(z_t - torch.sign(z_t) * lamda1)
                    / (_over(beta + torch.sqrt(n_t), lr) + wd),
                    torch.zeros_like(z_t))
    return w, z_t, n_t


@_register('_sparse_adagrad_update', num_inputs=3, num_outputs=2,
           mutate_idx=(0, 2), aliases=('adagrad_update',))
def _adagrad_update_op(weight, grad, history, *, lr=None, epsilon=1e-7,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip_only(grad, rescale_grad, clip_gradient)
    h = history + torch.square(g)
    return weight - lr * (g / torch.sqrt(h + epsilon) + wd * weight), h


@_register('_contrib_group_adagrad_update', num_inputs=3, num_outputs=2,
           mutate_idx=(0, 2))
def _group_adagrad_update_op(weight, grad, history, *, lr=None, epsilon=1e-5,
                             rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip_only(grad, rescale_grad, clip_gradient)
    if g.dim() > 1:
        h = history + torch.mean(torch.square(g),
                                 dim=tuple(range(1, g.dim())), keepdim=True)
    else:
        h = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(h) + epsilon), h


signsgd_update = _signsgd_update_op
signum_update = _signum_update_op
adam_update = _adam_update_op
ftml_update = _ftml_update_op
rmsprop_update = _rmsprop_update_op
rmspropalex_update = _rmspropalex_update_op
ftrl_update = _ftrl_update_op
adagrad_update = _adagrad_update_op


def _multi(args, n, per, fn):
    outs = []
    for i in range(int(n)):
        res = fn(i, [a.clone() for a in args[i * per:(i + 1) * per]])
        outs.extend(res if isinstance(res, tuple) else (res,))
    return tuple(outs)


@_register('multi_sgd_update', num_inputs=-1, num_outputs=-1,
           key_var_num_args='num_weights')
def _multi_sgd_update_op(args, *, num_weights=None, lrs=None, wds=None,
                         rescale_grad=1.0, clip_gradient=-1.0):
    return _multi(args, num_weights, 2, lambda i, g: sgd_update(
        g[0], g[1], lr=lrs[i], wd=wds[i], rescale_grad=rescale_grad,
        clip_gradient=clip_gradient))


@_register('multi_sgd_mom_update', num_inputs=-1, num_outputs=-1,
           key_var_num_args='num_weights')
def _multi_sgd_mom_update_op(args, *, num_weights=None, lrs=None, wds=None,
                             momentum=0.0, rescale_grad=1.0,
                             clip_gradient=-1.0):
    return _multi(args, num_weights, 3, lambda i, g: sgd_mom_update(
        g[0], g[1], g[2], lr=lrs[i], wd=wds[i], momentum=momentum,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient))


@_register('multi_mp_sgd_update', num_inputs=-1, num_outputs=-1,
           key_var_num_args='num_weights')
def _multi_mp_sgd_update_op(args, *, num_weights=None, lrs=None, wds=None,
                            rescale_grad=1.0, clip_gradient=-1.0):
    return _multi(args, num_weights, 3, lambda i, g: mp_sgd_update(
        g[0], g[1], g[2], lr=lrs[i], wd=wds[i], rescale_grad=rescale_grad,
        clip_gradient=clip_gradient))


@_register('multi_mp_sgd_mom_update', num_inputs=-1, num_outputs=-1,
           key_var_num_args='num_weights')
def _multi_mp_sgd_mom_update_op(args, *, num_weights=None, lrs=None,
                                wds=None, momentum=0.0, rescale_grad=1.0,
                                clip_gradient=-1.0):
    return _multi(args, num_weights, 4, lambda i, g: mp_sgd_mom_update(
        g[0], g[1], g[2], g[3], lr=lrs[i], wd=wds[i], momentum=momentum,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient))

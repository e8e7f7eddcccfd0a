"""Sampling inside the decode programs, the port of
``mxnet_tpu/serving/decode/sampling.py``.

Every per-request sampling parameter rides a program as a fixed-shape
input beside its tokens, so that switching a slot between greedy and
sampled traffic, or changing its temperature, changes the values in the
program's static buffers, never the program:

  * ``temps``  (rows,)    float32: 0.0 takes the greedy branch;
  * ``top_ps`` (rows,)    float32: the nucleus mass, in (0, 1];
  * ``keys``   (rows, 2)  uint32: raw threefry keys (int32 bits in the
    programs' buffers);
  * ``masks``  (rows, V)  float32: an additive logit mask (0.0 allowed,
    -inf or -1e9 forbidden), in the programs only when they are built with
    ``logit_mask``.

The reference's three contracts hold. **Greedy stays byte for byte**: the
token is ``where(temp > 0, sampled, argmax(logits + mask))``, and with
``temp == 0`` and no mask the argmax input is the logits themselves.
**Sampling is a pure function of (seed, position, logits)**: the host
derives each row's key as :func:`key_for` (blake2b of the pair), where the
position is that of the logits row (``len(prompt) - 1`` at prefill,
``positions[slot]`` at a step, ``positions[slot] + c`` for verify chunk
``c``). **Speculation couples through shared keys**: the draft proposes
with the keys the verify pass uses at the same positions, so every
emitted token is a draw of the target's own sampler.

The noise is JAX's, bit for bit (``ops/kernels/sampling.py``, one kernel
launch a call on a card), so that sampled tokens equal the JAX package's
wherever the two top perturbed scores are not a near-tie.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as onp
import torch

from ...ops.kernels.sampling import threefry_gumbel

__all__ = ['key_for', 'keys_for', 'neutral_args', 'nucleus',
           'perturbed_scores', 'sample_tokens']


def key_for(seed, pos):
    """The raw (2,) uint32 key of the logits row at absolute position
    ``pos`` of stream ``seed``: blake2b of the pair, independent across
    positions and the same on every host."""
    digest = hashlib.blake2b(b'%d|%d' % (int(seed), int(pos)),
                             digest_size=8).digest()
    hi, lo = struct.unpack('>II', digest)
    return onp.array([hi, lo], dtype=onp.uint32)


def keys_for(seed, positions):
    """:func:`key_for` over ``positions`` -> (n, 2) uint32."""
    return onp.stack([key_for(seed, p) for p in positions])


def neutral_args(n):
    """(temps, top_ps, keys) taking the greedy branch for ``n`` rows: the
    values a program with sampling runs with when the caller passes
    none."""
    return (onp.zeros((n,), 'float32'),
            onp.ones((n,), 'float32'),
            onp.zeros((n, 2), 'uint32'))


def _rows(x, dtype, device):
    """``x`` (a tensor, or an array-like) as a tensor of ``dtype`` on
    ``device``; uint32 keys cross as their int32 bits."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    x = onp.asarray(x)
    if x.dtype == onp.uint32:
        x = x.view(onp.int32)
    return torch.as_tensor(x, device=device).to(dtype)


def nucleus(probs, top_ps):
    """The nucleus of each row of ``probs`` (n, V): the smallest prefix
    of the stable descending order whose mass reaches ``top_ps`` (n,),
    kept as ``(csum - p) < top_p`` (so the first token always stays).
    Returns the (n, V) bool keep mask."""
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_p = probs.gather(-1, order)
    csum = torch.cumsum(sorted_p, dim=-1)
    keep_sorted = (csum - sorted_p) < top_ps[:, None]
    return torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)


def perturbed_scores(logits, temps, top_ps, keys):
    """The scores whose argmax is each sampled row's token: the
    temperature-scaled log-softmax of ``logits`` (n, V) inside the
    nucleus, -inf outside, plus the row's gumbel noise. ``temps``,
    ``top_ps`` (n,) float32 and ``keys`` (n, 2) int32 tensors on the
    logits' device."""
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    x = logits / safe_t[:, None]
    # jax.nn.log_softmax's expressions
    shifted = x - x.amax(dim=-1, keepdim=True)
    logp = shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))
    keep = nucleus(torch.exp(logp), top_ps)
    filtered = torch.where(keep, logp, torch.full_like(logp, -float('inf')))
    return filtered + threefry_gumbel(keys, logits.shape[-1])


def sample_tokens(logits, temps, top_ps, keys, masks=None):
    """One token a row of ``logits`` (n, V), as the reference computes it:
    the mask added, the greedy argmax, then the argmax of
    :func:`perturbed_scores` (temperature-scaled log-softmax, the nucleus,
    the gumbel noise); rows with ``temps == 0`` take the greedy token.
    Runs inside the decode programs (no host sync) and eagerly. The
    extras may be tensors or arrays (uint32 keys). Returns (n,) int64."""
    dev = logits.device
    temps = _rows(temps, torch.float32, dev).reshape(-1)
    top_ps = _rows(top_ps, torch.float32, dev).reshape(-1)
    keys = _rows(keys, torch.int32, dev).reshape(-1, 2)
    if masks is not None:
        logits = logits + _rows(masks, torch.float32, dev)
    greedy = torch.argmax(logits, dim=-1)
    sampled = torch.argmax(perturbed_scores(logits, temps, top_ps, keys),
                           dim=-1)
    return torch.where(temps > 0, sampled, greedy)

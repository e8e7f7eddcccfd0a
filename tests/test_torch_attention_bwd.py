"""Port parity: the gradient of the port's ``flash_attention`` (the dq and
dkv kernels behind ``FlashAttentionFunction``) against ``jax.grad`` of the
JAX package's Pallas ``flash_attention``.

On the CPU the port's wrappers run their plain PyTorch versions and the
JAX kernels run through the Pallas interpreter, with
``MXNET_TPU_PALLAS=attention,xent`` set as the JAX package's own tests set
it. Inputs and the output cotangent come from a numpy seed and go to both.
Tolerance: 2e-5 absolute, the RED (blockwise-reduction) tier of
``tests/test_pallas.py``: the recomputed probabilities and the sums over
keys and queries round differently in the two frameworks.

The kernels themselves (CUDA, sm_90a) run only on the card: the test
marked ``cuda`` compares them with their plain versions there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import config
from mxnet_tpu.ops.pallas import attention as jax_attn
from mxnet_tpu_torch.ops import kernels

torch.set_num_threads(1)
RED = 2e-5


@pytest.fixture(scope='module', autouse=True)
def kernels_on():
    config.set('MXNET_TPU_PALLAS', 'attention,xent')
    yield
    config.unset('MXNET_TPU_PALLAS')


def _inputs(seed, b, h, s, d):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, s, d).astype('float32') for _ in range(4)]


def _jax_grads(q, k, v, g, lengths, causal):
    def f(q, k, v):
        out = jax_attn.flash_attention(q, k, v, lengths=lengths,
                                       causal=causal)
        return jnp.sum(out * g)
    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, g, lengths, causal, fn=kernels.flash_attention):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fn(qt, kt, vt, lengths=torch.tensor(lengths), causal=causal)
    if isinstance(out, tuple):
        out = out[0]
    return [x.numpy() for x in torch.autograd.grad(
        out, (qt, kt, vt), torch.tensor(g))]


@pytest.mark.parametrize('seq', [5, 37, 130])
@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_grad_matches_jax(seq, causal):
    q, k, v, g = _inputs(seq + 11 * causal, 3, 2, seq, 16)
    # batch 0 below S, batch 1 sees no key at all, batch 2 full
    lengths = np.array([max(1, seq - 4), 0, seq], 'int32')
    want = _jax_grads(q, k, v, g, lengths, causal)
    got = _port_grads(q, k, v, g, lengths, causal)
    for name, a, b in zip('qkv', got, want):
        assert np.isfinite(a).all(), 'd%s has a non-finite entry' % name
        np.testing.assert_allclose(a, b, rtol=0, atol=RED,
                                   err_msg='d%s' % name)
    # the length-0 batch: no gradient anywhere, no NaN
    assert not got[0][1].any() and not got[1][1].any() \
        and not got[2][1].any()
    # keys past a length get no gradient
    assert not got[1][0, :, lengths[0]:].any()


@pytest.mark.parametrize('causal', [False, True])
def test_plain_backward_matches_autograd_of_reference(causal):
    q, k, v, g = _inputs(4, 2, 3, 37, 16)
    lengths = np.array([30, 0], 'int32')
    auto = _port_grads(q, k, v, g, lengths, causal,
                       fn=kernels.flash_attention_reference)
    qt, kt, vt = map(torch.tensor, (q, k, v))
    lens = torch.tensor(lengths)
    out, lse = kernels.flash_attention_reference(qt, kt, vt, lens, causal)
    plain = kernels.flash_attention_backward_reference(
        qt, kt, vt, out, lse, torch.tensor(g), lens, causal)
    for name, a, b in zip('qkv', plain, auto):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=RED,
                                   err_msg='d%s' % name)


def test_backward_wrappers_split_as_the_reference():
    q, k, v, g = _inputs(9, 1, 2, 20, 16)
    qt, kt, vt, gt = map(torch.tensor, (q, k, v, g))
    out, lse = kernels.flash_attention_with_lse(qt, kt, vt, 13, True)
    dq = kernels.flash_attention_dq(qt, kt, vt, out, lse, gt, 13, True)
    dk, dv = kernels.flash_attention_dkv(qt, kt, vt, out, lse, gt, 13, True)
    ref = kernels.flash_attention_backward_reference(qt, kt, vt, out, lse,
                                                     gt, 13, True)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)


def test_no_gradient_reaches_lengths_and_cpu_counts_nothing():
    kernels.reset_launch_counts()
    q, k, v, g = _inputs(2, 1, 1, 9, 16)
    qt = torch.tensor(q, requires_grad=True)
    lens = torch.tensor([7], dtype=torch.float32, requires_grad=True)
    out = kernels.flash_attention(qt, torch.tensor(k), torch.tensor(v),
                                  lengths=lens)
    (out * torch.tensor(g)).sum().backward()
    assert qt.grad is not None and lens.grad is None
    assert not any(kernels.launch_counts().values())


def test_backward_rejects_other_devices():
    t = torch.zeros(1, 1, 4, 16, device='meta')
    lse = torch.zeros(1, 1, 4, device='meta')
    for fn in (kernels.flash_attention_dq, kernels.flash_attention_dkv):
        with pytest.raises(ValueError, match='unsupported device'):
            fn(t, t, t, t, lse, t)


@pytest.mark.cuda
def test_training_kernels_match_plain_versions_on_card():
    """The four kernels of the training slice (flash dq and dkv,
    softmax-xent forward and backward) against their plain versions on
    the card: 1e-5 absolute for the forward outputs, 1e-5 relative to
    each tensor's max abs for the gradients."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are CUDA C++ for '
                    'sm_90a and have no CPU mode')
    for seq, causal in ((128, False), (17, True), (200, True)):
        q, k, v, g = (torch.tensor(a, device='cuda')
                      for a in _inputs(seq, 2, 12, seq, 64))
        lens = torch.tensor([seq - 5, 0], dtype=torch.int32, device='cuda')
        out, lse = kernels.flash_attention_with_lse(q, k, v, lens, causal)
        got = kernels.flash_attention_backward(q, k, v, out, lse, g, lens,
                                               causal)
        want = kernels.flash_attention_backward_reference(
            q, k, v, out, lse, g, lens, causal)
        for a, b in zip(got, want):
            tol = 1e-5 * max(b.abs().max().item(), 1e-30)
            assert (a - b).abs().max().item() <= tol
    for rows, vocab in ((96, 2), (300, 30522)):
        rs = np.random.RandomState(rows)
        x = torch.tensor(rs.randn(rows, vocab).astype('float32') * 3,
                         device='cuda')
        lab = torch.tensor(rs.randint(-1, vocab + 1, rows).astype('int32'),
                           device='cuda')
        gr = torch.tensor(rs.randn(rows).astype('float32'), device='cuda')
        nll, logp = kernels.softmax_xent_forward(x, lab)
        nll_ref, logp_ref = kernels.softmax_xent_forward_reference(x, lab)
        assert (nll - nll_ref).abs().max().item() <= 1e-5
        assert (logp - logp_ref).abs().max().item() <= 1e-5
        dx = kernels.softmax_xent_backward(logp, lab, gr)
        dx_ref = kernels.softmax_xent_backward_reference(logp, lab, gr)
        tol = 1e-5 * dx_ref.abs().max().item()
        assert (dx - dx_ref).abs().max().item() <= tol

"""Port parity: the flash-attention and flash-decode wrappers of
``mxnet_tpu_torch.ops.kernels`` against the JAX package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions and the
JAX kernels run through the Pallas interpreter (as the JAX package's own
tests run them). Inputs come from a numpy seed and go to both.
Tolerance: atol 1e-5, the reduction tier of the flash kernels
(docs/PERFORMANCE.md), since the online-softmax tree rounds differently
from a two-pass softmax and the two frameworks sum in other orders.

The kernels themselves (CUDA, sm_90a) run only on the card: the test
marked ``cuda`` compares them with their plain versions there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas import attention as jax_attn
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.kernels import attention as port_attn

torch.set_num_threads(1)
ATOL = 1e-5


def _qkv(rs, b, h, s, d):
    return [rs.randn(b, h, s, d).astype('float32') for _ in range(3)]


@pytest.mark.parametrize('seq', [5, 37, 130])
@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_matches_jax(seq, causal):
    rs = np.random.RandomState(seq + 7 * causal)
    q, k, v = _qkv(rs, 2, 2, seq, 16)
    # batch 1 has no visible key at all: its rows must come out 0
    lengths = np.array([max(1, seq - 3), 0], 'int32')
    want = np.asarray(jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lengths=jnp.asarray(lengths), causal=causal))
    got = kernels.flash_attention(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v),
                                  lengths=torch.tensor(lengths),
                                  causal=causal).numpy()
    assert got.shape == (2, 2, seq, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert not got[1].any()


def test_flash_attention_default_lengths_and_lse():
    rs = np.random.RandomState(3)
    q, k, v = _qkv(rs, 2, 2, 37, 16)
    want = np.asarray(jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out, lse = kernels.flash_attention_with_lse(
        torch.tensor(q), torch.tensor(k), torch.tensor(v))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=ATOL)
    # lse against the direct two-pass log-sum-exp
    s = np.einsum('bhqd,bhkd->bhqk', q, k) / 4.0
    ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), ref, rtol=0, atol=ATOL)


def _einsum_decode(q, keys, values, positions, heads):
    """The JAX model's flash-off decode path (model.py:467-476)."""
    slots, u = q.shape
    L = keys.shape[1]
    d = u // heads
    qh = jnp.asarray(q).reshape(slots, heads, d) / np.sqrt(d)
    kh = jnp.asarray(keys).reshape(slots, L, heads, d)
    vh = jnp.asarray(values).reshape(slots, L, heads, d)
    bias = jnp.where(jnp.arange(L)[None, :] <= jnp.asarray(positions)[:, None],
                     0.0, -1e9)[:, None, :]
    scores = jnp.einsum('shd,slhd->shl', qh, kh) + bias
    att = jnp.exp(scores - scores.max(-1, keepdims=True))
    att = att / att.sum(-1, keepdims=True)
    return np.asarray(jnp.einsum('shl,slhd->shd', att, vh)
                      .reshape(slots, u))


@pytest.mark.parametrize('max_len', [40, 300])
def test_flash_decode_matches_jax_and_einsum(max_len):
    rs = np.random.RandomState(max_len)
    slots, heads, u = 3, 2, 32
    q = rs.randn(slots, u).astype('float32')
    keys = rs.randn(slots, max_len, u).astype('float32')
    values = rs.randn(slots, max_len, u).astype('float32')
    positions = np.array([0, max_len // 2, max_len - 1], 'int32')
    want = np.asarray(jax_attn.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(values),
        jnp.asarray(positions), heads))
    got = kernels.flash_decode_attention(
        torch.tensor(q), torch.tensor(keys), torch.tensor(values),
        torch.tensor(positions), heads).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    einsum = _einsum_decode(q, keys, values, positions, heads)
    np.testing.assert_allclose(got, einsum, rtol=0, atol=ATOL)
    np.testing.assert_allclose(want, einsum, rtol=0, atol=ATOL)


def test_online_softmax_block_matches_jax():
    rs = np.random.RandomState(11)
    s = rs.randn(2, 5, 8).astype('float32')
    s[0, 1] = -np.inf                      # a fully masked row
    s[1, :, 3] = -np.inf
    v = rs.randn(2, 8, 4).astype('float32')
    m = np.full((2, 5), -np.inf, 'float32')
    m[1] = rs.randn(5)
    l = np.abs(rs.randn(2, 5)).astype('float32')
    o = rs.randn(2, 5, 4).astype('float32')
    want = jax_attn.online_softmax_block(*map(jnp.asarray, (s, v, m, l, o)))
    got = port_attn.online_softmax_block(*map(torch.tensor, (s, v, m, l, o)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)


def test_cpu_tensors_never_count_a_launch():
    kernels.reset_launch_counts()
    rs = np.random.RandomState(0)
    q, k, v = (torch.tensor(a) for a in _qkv(rs, 1, 2, 9, 16))
    kernels.flash_attention(q, k, v, causal=True)
    kernels.flash_decode_attention(q[0, :, 0].reshape(1, 32),
                                   torch.zeros(1, 9, 32),
                                   torch.zeros(1, 9, 32),
                                   torch.tensor([4], dtype=torch.int32), 2)
    counts = kernels.launch_counts()
    assert set(counts) == set(kernels.KERNELS) and not any(counts.values())


def test_wrappers_reject_other_devices():
    q = torch.zeros(1, 1, 4, 16, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.flash_attention(q, q, q)
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.flash_decode_attention(torch.zeros(1, 32, device='meta'),
                                       torch.zeros(1, 4, 32, device='meta'),
                                       torch.zeros(1, 4, 32, device='meta'),
                                       torch.zeros(1, dtype=torch.int32),
                                       2)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are CUDA C++ for '
                    'sm_90a and have no CPU mode')
    rs = np.random.RandomState(5)
    for seq in (17, 200):
        q, k, v = (torch.tensor(a, device='cuda')
                   for a in _qkv(rs, 1, 12, seq, 64))
        lengths = torch.tensor([seq - 2], dtype=torch.int32, device='cuda')
        got, lse = kernels.flash_attention_with_lse(q, k, v, lengths,
                                                    causal=True)
        want, lse_ref = kernels.flash_attention_reference(
            q, k, v, lengths, causal=True)
        assert (got - want).abs().max().item() <= ATOL
        assert (lse - lse_ref).abs().max().item() <= ATOL
    keys = torch.tensor(rs.randn(8, 512, 768).astype('float32'),
                        device='cuda')
    values = torch.tensor(rs.randn(8, 512, 768).astype('float32'),
                          device='cuda')
    q = torch.tensor(rs.randn(8, 768).astype('float32'), device='cuda')
    pos = torch.tensor([0, 127, 128, 511, 5, 300, 64, 256],
                       dtype=torch.int32, device='cuda')
    got = kernels.flash_decode_attention(q, keys, values, pos, 12)
    want = kernels.flash_decode_attention_reference(q, keys, values, pos, 12)
    assert (got - want).abs().max().item() <= ATOL

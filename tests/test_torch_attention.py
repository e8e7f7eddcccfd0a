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

from chip_smoke import DECODE_CHECK_POSITIONS, decode_identity
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


# float32 primitives of csrc/online_softmax.cuh in numpy. The fma is the
# float64 product and sum rounded to float32 (not always the single
# rounding of __fmaf_rn, but deterministic): both schedules below use the
# same primitives, so what the test pins is the schedule.
def _fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _rescale(m, tile_max):
    m_new = np.fmax(m, tile_max)
    safe = np.float32(0) if m_new == -np.inf else m_new
    corr = np.float32(0) if m == -np.inf else np.exp(np.float32(m - safe))
    return m_new, safe, corr


def _scores(qs, k_tile, base, last):
    """tile_score: one fma chain over d from 0; keys past `last` -inf."""
    s = np.zeros(len(k_tile), np.float32)
    for d in range(qs.shape[0]):
        s = _fma(qs[d], k_tile[:, d], s)
    s[base + np.arange(len(k_tile)) > last] = -np.inf
    return s


def _weights(s, safe):
    with np.errstate(over='ignore'):
        return np.where(s == -np.inf, np.float32(0),
                        np.exp((s - safe).astype(np.float32)))


def _fold(p, v, corr, l, acc):
    psum = np.float32(0)
    for x in p:
        psum = np.float32(psum + x)
    l = _fma(l, corr, psum)
    acc = (acc * corr).astype(np.float32)
    for jj in range(len(p)):
        acc = _fma(p[jj], v[jj], acc)
    return l, acc


def _finish(l, acc):
    return (acc / np.maximum(l, np.float32(1e-20))).astype(np.float32)


def _tiles(qs, keys, pos):
    """The scores of every tile up to the one holding the last visible
    key (none when pos < 0 or the cache is empty)."""
    block = port_attn.K_BLOCK
    last = min(pos, len(keys) - 1)
    ntiles = 0 if last < 0 else last // block + 1
    return [_scores(qs, keys[j * block:(j + 1) * block], j * block, last)
            for j in range(ntiles)]


def _walk_decode(qs, keys, values, pos):
    """The sequential walk of the old kernel and of the forward's row."""
    block = port_attn.K_BLOCK
    m, l = np.float32(-np.inf), np.float32(0)
    acc = np.zeros(values.shape[1], np.float32)
    for j, s in enumerate(_tiles(qs, keys, pos)):
        m, safe, corr = _rescale(m, s.max())
        l, acc = _fold(_weights(s, safe), values[j * block:(j + 1) * block],
                       corr, l, acc)
    return _finish(l, acc)


def _cluster_decode(qs, keys, values, pos):
    """csrc/flash_decode_fwd.cu's schedule: C = min(8, ceil(max_len /
    128)) CTAs (one at max_len 0), CTA r holding tile g C + r in round g; every tile scored
    and its max taken at once; each tile's running max the carried max of
    the earlier rounds, then fmaxf over the earlier ranks of its round;
    rescale, weights and psum a tile apart; then only the fold in tile
    order."""
    block = port_attn.K_BLOCK
    max_len = len(keys)
    csize = max(1, min(8, -(-max_len // block)))
    tiles = _tiles(qs, keys, pos)
    maxima = [s.max() for s in tiles]
    rounds = -(-len(tiles) // csize)
    l, acc = np.float32(0), np.zeros(values.shape[1], np.float32)
    m_carry = np.float32(-np.inf)
    for g in range(rounds):
        live = range(g * csize, min(len(tiles), (g + 1) * csize))
        folded = []
        for j in live:
            m = m_carry
            for r in range(j - g * csize):
                m = np.fmax(m, maxima[g * csize + r])
            _, safe, corr = _rescale(m, maxima[j])
            folded.append((_weights(tiles[j], safe), corr))
        for j, (p, corr) in zip(live, folded):
            l, acc = _fold(p, values[j * block:(j + 1) * block], corr, l,
                           acc)
        if g + 1 < rounds:
            for j in live:
                m_carry = np.fmax(m_carry, maxima[j])
    return _finish(l, acc)


@pytest.mark.parametrize('max_len', [0, 40, 300, 512, 1100])
def test_decode_cluster_schedule_bitwise_equals_walk(max_len):
    """The decode kernel's schedule against the same primitives run as
    the sequential walk, bitwise, with positions on every tile edge, no
    visible key (-1), past the cache (max_len + 5), and slots whose later
    tiles are all masked; then the walk against the plain version. At
    max_len 0 every slot sees no key and writes zeros."""
    rs = np.random.RandomState(max_len)
    heads, d = 2, 64
    edges = (0, 127, 128, 255, 511, 1023, 1024)
    positions = [p for p in edges if p < max_len] + [max_len - 1, -1,
                                                     max_len + 5, 5]
    keys = rs.randn(len(positions), max_len, heads * d).astype('float32')
    values = rs.randn(len(positions), max_len, heads * d).astype('float32')
    q = rs.randn(len(positions), heads * d).astype('float32')
    scale = np.float32(1 / np.sqrt(d))
    walk = np.zeros_like(q)
    for i, pos in enumerate(positions):
        for h in range(heads):
            cols = slice(h * d, (h + 1) * d)
            qs = (q[i, cols] * scale).astype(np.float32)
            want = _walk_decode(qs, keys[i, :, cols], values[i, :, cols],
                                pos)
            got = _cluster_decode(qs, keys[i, :, cols], values[i, :, cols],
                                  pos)
            assert got.tobytes() == want.tobytes(), (max_len, pos, h)
            walk[i, cols] = want
    plain = kernels.flash_decode_attention_reference(
        torch.tensor(q), torch.tensor(keys), torch.tensor(values),
        torch.tensor(positions, dtype=torch.int32), heads).numpy()
    np.testing.assert_allclose(walk, plain, rtol=0, atol=ATOL)
    if max_len == 0:
        assert not walk.any() and not plain.any()


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


@pytest.mark.parametrize('batch,sq', [(1, 256), (96, 128), (1, 1),
                                      (1, 17), (1, 200), (1, 513),
                                      (4, 17), (2, 200)])
def test_fwd_geometry_covers_rows_and_fits(batch, sq):
    heads = 12
    bq, blocks, smem = kernels.fwd_geometry(batch, heads, sq)
    assert bq in kernels.FWD_BLOCK_Q
    tiles = -(-sq // bq)
    items = batch * heads * tiles
    # the query tiles of a batch*head cover its rows, none wholly past Sq
    assert tiles * bq >= sq > (tiles - 1) * bq
    # blocks walk items blockIdx, + blocks, ...: each item once, and every
    # block has one
    assert 0 < blocks <= min(items, port_attn.SMS)
    assert sorted(i for blk in range(blocks)
                  for i in range(blk, items, blocks)) == list(range(items))
    assert 0 < smem <= port_attn.SMEM_BLOCK_MAX
    if items < port_attn.SMS:
        assert bq == min(kernels.FWD_BLOCK_Q) and blocks == items
    else:
        # the largest block size whose items still fill every SM
        larger = [b for b in kernels.FWD_BLOCK_Q if b > bq]
        assert all(batch * heads * -(-sq // b) < port_attn.SMS
                   for b in larger)


def test_fwd_geometry_serving_and_training_shapes():
    # the serving prefill (1 x 12 x 256) runs at least 96 blocks
    bq, blocks, _ = kernels.fwd_geometry(1, 12, 256)
    assert blocks >= 96 and bq == 32
    # the BERT training forward: 1152 items of 128 rows on 132 blocks
    assert kernels.fwd_geometry(96, 12, 128)[:2] == (128, 132)
    # a block size asked for is kept; one not built raises
    assert kernels.fwd_geometry(1, 12, 256, 128)[:2] == (128, 24)
    with pytest.raises(ValueError, match='not built'):
        kernels.fwd_geometry(1, 12, 256, 16)


def test_fwd_geometry_shared_memory_layout():
    # the Q tile, two K and two V tiles (K_BLOCK x D), the K_BLOCK x
    # block_q P tile and corr, m, l a row: the kernel's Layout
    for bq in kernels.FWD_BLOCK_Q:
        floats = bq * 64 + 4 * 128 * 64 + 128 * bq + 3 * bq
        assert kernels.fwd_geometry(1, 1, 1, bq)[2] == 4 * floats
    assert [kernels.fwd_geometry(1, 1, 1, b)[2] for b in (128, 32)] == [
        230912, 156032]


def test_fwd_block_q_is_ignored_on_cpu():
    rs = np.random.RandomState(8)
    q, k, v = (torch.tensor(a) for a in _qkv(rs, 1, 2, 40, 16))
    ref = kernels.flash_attention_with_lse(q, k, v, causal=True)
    for bq in kernels.FWD_BLOCK_Q:
        got = kernels.flash_attention_with_lse(q, k, v, causal=True,
                                               block_q=bq)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
def test_forward_rows_bitwise_equal_decode_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are CUDA C++ for '
                    'sm_90a and have no CPU mode')
    rs = np.random.RandomState(9)
    q, k, v = (torch.tensor(a, device='cuda') for a in _qkv(rs, 1, 12, 512,
                                                           64))
    for bq in kernels.FWD_BLOCK_Q:
        equal, diff = decode_identity(torch, kernels, q, k, v,
                                      DECODE_CHECK_POSITIONS, bq)
        assert all(equal), (bq, equal, diff)


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
        want, lse_ref = kernels.flash_attention_reference(
            q, k, v, lengths, causal=True)
        for bq in kernels.FWD_BLOCK_Q:
            got, lse = kernels.flash_attention_with_lse(
                q, k, v, lengths, causal=True, block_q=bq)
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

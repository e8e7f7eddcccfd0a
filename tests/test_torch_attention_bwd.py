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


BF16 = torch.bfloat16


def _bf16_pair(a):
    """``a`` rounded to bf16 once (to nearest even), as a torch tensor and
    the same values as a JAX array."""
    t = torch.tensor(a).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def bf16_ulps(got, want, tier=0.0):
    """chip_smoke's count of bf16 ULPs beyond ``tier`` (the card's check),
    over a torch result and a JAX one."""
    import chip_smoke
    return chip_smoke.bf16_ulps(torch, got, torch.from_numpy(
        np.asarray(want, dtype=np.float32)), tier)


@pytest.mark.parametrize('causal', [False, True])
def test_bf16_plain_versions_match_jax(causal):
    """The bf16 plain versions of the forward, dq and dkv against the JAX
    kernels' own bf16 calls in the interpreter (``_fwd_call`` through
    ``_flash_fwd_impl``, ``_bwd_call``) on the same bf16 values, S 128
    (no padding on either side), lengths 128, 77 and 1: out within one
    bf16 ULP of each element, lse float32 within 1e-5; dq, dk and dv in
    bf16 within one bf16 ULP of each element beyond the float32 tier
    (RED): both sides sum in float32 in other orders, which moves an
    element near 0 by up to RED, many of its own bf16 ULPs (measured 510
    for dq without the tier). The backward is held on the JAX forward's
    own out and lse, so it compares one function."""
    from mxnet_tpu.ops.pallas import interpret_mode
    b, h, s, d = 3, 2, 128, 64
    scale = 1.0 / 8
    lengths = np.array([128, 77, 1], 'int32')
    (tq, jq), (tk, jk), (tv, jv), (tg, jg) = (
        _bf16_pair(a) for a in _inputs(31 + causal, b, h, s, d))
    bias = jnp.where(jnp.arange(s)[None, :] < jnp.asarray(lengths)[:, None],
                     0.0, -jnp.inf).astype(jnp.float32)
    jo, jlse = jax_attn._flash_fwd_impl(jq, jk, jv, bias, causal, scale,
                                        interpret_mode())
    jdq, jdk, jdv = jax_attn._bwd_call(
        *(t.reshape(b * h, s, d) for t in (jq, jk, jv)), bias,
        jo.reshape(b * h, s, d), jlse, jg.reshape(b * h, s, d), heads=h,
        causal=causal, scale=scale, interpret=interpret_mode())
    assert jo.dtype == jdq.dtype == jnp.bfloat16
    lens = torch.tensor(lengths)
    out, lse = kernels.flash_attention_with_lse(tq, tk, tv, lens, causal,
                                                scale)
    assert out.dtype == BF16 and lse.dtype == torch.float32
    assert bf16_ulps(out.float(), np.asarray(jo.astype(jnp.float32))) <= 1
    jl = np.asarray(jlse).reshape(b, h, s)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), np.isneginf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(lse.numpy()[fin], jl[fin], rtol=0, atol=1e-5)
    to = torch.from_numpy(np.asarray(jo.astype(jnp.float32))).to(BF16)
    tl = torch.from_numpy(jl)
    dq = kernels.flash_attention_dq(tq, tk, tv, to, tl, tg, lens, causal,
                                    scale)
    dk, dv = kernels.flash_attention_dkv(tq, tk, tv, to, tl, tg, lens,
                                         causal, scale)
    for name, got, want in (('dq', dq, jdq), ('dk', dk, jdk),
                            ('dv', dv, jdv)):
        assert got.dtype == BF16, name
        ulps = bf16_ulps(got.float(), np.asarray(
            want.astype(jnp.float32)).reshape(b, h, s, d), RED)
        assert ulps <= 1, (name, ulps)


def test_wrappers_refuse_mixed_and_other_dtypes():
    """All float32 or all bfloat16: mixed dtypes and fp16 raise TypeError
    on either device's path (the CPU's here)."""
    q = torch.zeros(1, 1, 4, 64)
    lse = torch.zeros(1, 1, 4)
    for bad in ((q, q.to(BF16), q), (q.half(), q.half(), q.half())):
        with pytest.raises(TypeError):
            kernels.flash_attention_with_lse(*bad)
        with pytest.raises(TypeError):
            kernels.flash_attention_dq(*bad, q, lse, q)
        with pytest.raises(TypeError):
            kernels.flash_attention_dkv(*bad, q, lse, q)
    qb = q.to(BF16)
    with pytest.raises(TypeError):      # out and do share q's dtype
        kernels.flash_attention_dq(qb, qb, qb, q, lse, qb)


@pytest.mark.cuda
def test_bf16_instances_are_the_float32_kernels_rounded_on_card():
    """The bf16 kernels of the forward, dq and dkv (AMP) at the training
    shape and two odd cases. All three run on the bf16 tensor cores and
    round p (and ds) to bf16 before their products, another function than
    the float32 kernels': each within two bf16 ULPs of its own plain
    version beyond the float32 tier and what a flip of p or ds near a bf16
    rounding midpoint can move (the plain versions' ``slack``), and within
    the reference's bf16 tier of the reference function (0.02 absolute for
    out, 2e-2 of the max abs for dq, dk and dv); lse within 1e-5 of the
    float32 kernel's."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are CUDA C++ for '
                    'sm_90a and have no CPU mode')
    for b, s, causal, lengths in ((96, 128, False, None),
                                  (2, 200, True, [200, 0]),
                                  (3, 17, False, [17, 9, 1])):
        q, k, v, g = (torch.tensor(a, device='cuda').to(BF16)
                      for a in _inputs(s, b, 12, s, 64))
        lens = torch.tensor(lengths or [s] * b, dtype=torch.int32,
                            device='cuda')
        out, lse = kernels.flash_attention_with_lse(q, k, v, lens, causal)
        w = [t.float() for t in (q, k, v, g)]
        _, lse32 = kernels.flash_attention_with_lse(*w[:3], lens, causal)
        fin = ~torch.isneginf(lse32)
        assert torch.equal(torch.isneginf(lse), ~fin)
        assert (lse[fin] - lse32[fin]).abs().max().item() <= 1e-5
        plain, _, flips = kernels.flash_attention_bf16_reference(
            q, k, v, lens, causal, slack=True)
        ref, _ = kernels.flash_attention_reference(q, k, v, lens, causal)
        assert bf16_ulps(out.float().cpu(), plain.float().cpu().numpy(),
                         1e-5 + flips.cpu()) <= 2, (s, causal)
        assert (out.float() - ref.float()).abs().max().item() <= 0.02
        got = (kernels.flash_attention_dq(q, k, v, out, lse, g, lens, causal),
               *kernels.flash_attention_dkv(q, k, v, out, lse, g, lens,
                                            causal))
        dq_want, dq_flips = kernels.flash_attention_dq_bf16_reference(
            q, k, v, out, lse, g, lens, causal, slack=True)
        *want, dk_flips, dv_flips = kernels.flash_attention_dkv_bf16_reference(
            q, k, v, out, lse, g, lens, causal, slack=True)
        refs = kernels.flash_attention_backward_reference(
            q, k, v, out, lse, g, lens, causal)
        for name, a, p, fl, r in zip(('dq', 'dk', 'dv'), got,
                                     [dq_want] + want,
                                     (dq_flips, dk_flips, dv_flips), refs):
            top = p.float().abs().max().item()
            assert bf16_ulps(a.float().cpu(), p.float().cpu().numpy(),
                             1e-5 * top + fl.cpu()) <= 2, (name, s, causal)
            assert ((a.float() - r.float()).abs().max().item()
                    <= 2e-2 * r.float().abs().max().item()), (name, s)


@pytest.mark.cuda
def test_training_kernels_match_plain_versions_on_card():
    """The four kernels of the training slice (flash dq and dkv,
    softmax-xent forward and backward) against their plain versions on
    the card: 1e-5 absolute for the forward outputs, 1e-5 relative to
    each tensor's max abs for the gradients; the xent forward at every
    instance it is built for."""
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
    # every instance of the xent forward: a warp a row, a cluster of CTAs
    # (rows on and off 16-byte boundaries), a block a row
    for rows, vocab in ((96, 2), (300, 30522), (128, 1000), (8, 30523),
                        (4, 600001)):
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


# ---------------------------------------------------------------------------
# the backward kernels' arithmetic (csrc/flash_attention_bwd.cu): dq's S =
# Q K^T, dP = dO V^T and dQ = dS K (namespace dqk), dk/dv's S^T = K Q^T,
# dP^T = V dO^T, dV = P^T dO and dK = dS^T Q (namespace dkvk), all on the
# tensor cores in 3xTF32
# ---------------------------------------------------------------------------


def tf32_split(x):
    """(big, small) as the kernel's ``split`` and the mma read them: big =
    tf32(x) rounded to nearest, ties away from zero, on the 10-bit mantissa
    (add half of the 13 dropped bits to the magnitude, then clear them);
    small = x - big as the mma reads a float32 register given as tf32, its
    13 low bits dropped (toward zero)."""
    def top19(t):
        return (t.contiguous().view(torch.int32) & -0x2000).view(
            torch.float32)
    bits = x.contiguous().view(torch.int32)
    big = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return big, top19(x - big)


def mm_3xtf32(a, b):
    """a @ b as the kernel's ``mma3`` sums it: small.big + big.small +
    big.big in float32, small.small dropped."""
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    return (torch.matmul(as_, bb) + torch.matmul(ab, bs)) + torch.matmul(
        ab, bb)


LOG2E = 1.4426950408889634


def _kernel_exp(s, scale, lse):
    """p as the kernel takes it from the unscaled float32 scores: 2^(s
    scale2 - lse2), scale2 = scale log2 e and lse2 = lse log2 e rounded to
    float32, the argument one fma (rounded once); exp2 stands in for
    ``ex2.approx``, whose own rounding is not mirrored."""
    scale2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    lse2 = lse * torch.tensor(LOG2E, dtype=torch.float32)
    arg = s.double() * scale2.double() - lse2.double()[..., None]
    return torch.exp2(arg.float())


def _mirror_p_ds(s, dp, lse, delta, lengths, causal, scale):
    """p and ds from the scores ``s`` and ``dp`` (B, H, Sq, Sk) as
    ``_p_block`` orders them (attention.py:195). In float32 p is taken the
    kernels' way (:func:`_kernel_exp`), in float64 as exp(s scale -
    lse)."""
    sq, sk = s.shape[-2:]
    kp = torch.arange(sk)
    valid = (kp[None, :] < lengths[:, None].long())[:, None, None, :]
    if causal:
        valid = valid & (torch.arange(sq)[:, None] >= kp[None, :])
    dead = ~valid | torch.isneginf(lse)[..., None]
    safe = torch.where(torch.isneginf(lse), 0.0, lse)
    ex = (_kernel_exp(s, scale, safe) if s.dtype == torch.float32
          else torch.exp(s * scale - safe[..., None]))
    p = torch.where(dead, 0.0, ex)
    return p, p * (dp - delta[..., None]) * scale


def dq_mirror(q, k, v, out, lse, do, lengths, causal, scale, mm):
    """dq as the dq kernel computes it, every product by ``mm``; (B, H,
    S, D) tensors of one dtype."""
    delta = torch.sum(do * out, dim=-1)
    _, ds = _mirror_p_ds(mm(q, k.transpose(-1, -2)),
                         mm(do, v.transpose(-1, -2)), lse, delta, lengths,
                         causal, scale)
    return mm(ds, k)


def dkv_mirror(q, k, v, out, lse, do, lengths, causal, scale, mm):
    """(dk, dv) as the dk/dv kernel computes them, every product by
    ``mm`` in the kernel's orientation (keys the rows): S^T = K Q^T and
    dP^T = V dO^T, then dV = P^T dO and dK = dS^T Q."""
    delta = torch.sum(do * out, dim=-1)
    st = mm(k, q.transpose(-1, -2))
    dpt = mm(v, do.transpose(-1, -2))
    p, ds = _mirror_p_ds(st.transpose(-1, -2), dpt.transpose(-1, -2), lse,
                         delta, lengths, causal, scale)
    return mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), do)


def test_tf32_split_rounds_to_nearest_on_the_mantissa():
    rs = np.random.RandomState(5)
    x = torch.tensor(np.concatenate([
        rs.randn(4096) * 10.0 ** rs.randint(-6, 6, 4096),
        [1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23,
         1 + 3 * 2 ** -11, 0.0]]).astype('float32'))
    big, small = tf32_split(x)
    for t in (big, small):
        assert not (t.view(torch.int32) & 0x1fff).any()
    x64, big64, small64 = x.double(), big.double(), small.double()
    # big within half a tf32 ulp, x - big exact in float32
    assert ((x64 - big64).abs() <= 2.0 ** -11 * x64.abs()).all()
    assert torch.equal((x - big).double(), x64 - big64)
    # the pair keeps x within 2^-21 of itself (small toward zero)
    assert ((x64 - big64 - small64).abs() <= 2.0 ** -21 * x64.abs()).all()
    # ties go away from zero; below half goes down
    assert big[-5].item() == 1 + 2 ** -10 and big[-4].item() == -(1 + 2 ** -10)
    assert big[-3].item() == 1.0 and big[-2].item() == 1 + 2 ** -9
    assert big[-1].item() == 0.0 and small[-1].item() == 0.0


def test_3xtf32_product_holds_float32_accuracy():
    """The three terms miss a b by at most 2 x 2^-21 + 2^-22 of |a| |b|
    (each small part, and small.small dropped), their float32 sums by
    (k + 2) 2^-24 more."""
    rs = np.random.RandomState(6)
    a, b = (torch.tensor(rs.randn(64, 64).astype('float32')) for _ in '12')
    got = mm_3xtf32(a, b).double()
    want = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    assert ((got - want).abs() <= (5 * 2.0 ** -22 + 66 * 2.0 ** -24)
            * scale).all()


@pytest.mark.parametrize('causal', [False, True])
def test_mirrors_in_float64_match_the_plain_versions(causal):
    """The mirrors' masks and orientation: in float64 with exact products
    they give the plain versions' dq, dk and dv (a row set of length 0,
    one below S, S 37 off every tile) to the RED tier: the plain versions
    compute in float32."""
    q, k, v, g = (torch.tensor(a).double() for a in _inputs(7, 3, 2, 37, 64))
    lens = torch.tensor([37, 0, 30], dtype=torch.int32)
    out, lse = kernels.flash_attention_reference(q, k, v, lens, causal)
    want = kernels.flash_attention_backward_reference(q, k, v, out, lse, g,
                                                      lens, causal)
    got = (dq_mirror(q, k, v, out, lse, g, lens, causal, 0.125,
                     torch.matmul),
           *dkv_mirror(q, k, v, out, lse, g, lens, causal, 0.125,
                       torch.matmul))
    for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=RED,
                                   err_msg=name)
        assert not a[1].any(), name


@pytest.fixture(scope='module')
def training_dq():
    """dq, dk and dv at the training shape (B 96, H 12, S 128, D 64,
    lengths 128 down to 36 as chip_smoke's case has them): the 3xTF32
    mirrors, float64 and ``jax.grad`` of the JAX package's Pallas flash
    attention in the interpreter, from one numpy seed; each a dict of
    name -> tensor."""
    b, h, s, d = 96, 12, 128, 64
    q, k, v, g = _inputs(96, b, h, s, d)
    lengths = np.array([max(1, s - (i % 5) * 23) for i in range(b)],
                       'int32')
    lens = torch.tensor(lengths)
    qt, kt, vt, gt = map(torch.tensor, (q, k, v, g))
    out, lse = kernels.flash_attention_reference(qt, kt, vt, lens)
    scale = 1.0 / 8
    mirror, exact = [], []
    for i in range(0, b, 24):
        part = slice(i, i + 24)
        args = (qt[part], kt[part], vt[part], out[part], lse[part],
                gt[part], lens[part])
        args64 = tuple(t.double() if t.is_floating_point() else t
                       for t in args)
        mirror.append((dq_mirror(*args, False, scale, mm_3xtf32),
                       *dkv_mirror(*args, False, scale, mm_3xtf32)))
        exact.append((dq_mirror(*args64, False, scale, torch.matmul),
                       *dkv_mirror(*args64, False, scale, torch.matmul)))
    names = ('dq', 'dk', 'dv')
    jax_g = _jax_grads(q, k, v, g, lengths, False)
    return tuple({n: torch.cat([part[i] for part in parts])
                  for i, n in enumerate(names)} for parts in (mirror, exact)
                 ) + ({n: torch.tensor(a) for n, a in zip(names, jax_g)},)


def test_dq_in_3xtf32_against_float64_at_training_shape(training_dq):
    """The kernel's arithmetic holds dq to 2e-6 of its max abs against
    float64 (the card's check allows 1e-5): 3xTF32 is float32-grade."""
    mirror, exact, _ = training_dq
    rel = ((mirror['dq'].double() - exact['dq']).abs().max()
           / exact['dq'].abs().max()).item()
    assert rel <= 2e-6, rel


def test_dq_in_3xtf32_against_jax_at_training_shape(training_dq):
    """... and to 1e-5 of its max abs against the JAX package's flash
    attention gradient (its own float32 forward and backward)."""
    mirror, _, jax_g = training_dq
    rel = ((mirror['dq'] - jax_g['dq']).abs().max()
           / jax_g['dq'].abs().max()).item()
    assert rel <= 1e-5, rel


@pytest.mark.parametrize('name', ['dk', 'dv'])
def test_dkv_in_3xtf32_against_float64_at_training_shape(training_dq, name):
    """The dk/dv kernel's arithmetic holds dk and dv to 2e-6 of their max
    abs against float64, as dq's does."""
    mirror, exact, _ = training_dq
    rel = ((mirror[name].double() - exact[name]).abs().max()
           / exact[name].abs().max()).item()
    assert rel <= 2e-6, rel


@pytest.mark.parametrize('name', ['dk', 'dv'])
def test_dkv_in_3xtf32_against_jax_at_training_shape(training_dq, name):
    """... and to 1e-5 of their max abs against the JAX package's flash
    attention gradient."""
    mirror, _, jax_g = training_dq
    rel = ((mirror[name] - jax_g[name]).abs().max()
           / jax_g[name].abs().max()).item()
    assert rel <= 1e-5, rel

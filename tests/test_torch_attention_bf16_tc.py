"""The bf16 tensor-core flash kernels' plain versions (rows 1b, 2b and
3b): ``flash_attention_bf16_reference``,
``flash_attention_dq_bf16_reference`` and
``flash_attention_dkv_bf16_reference`` compute what
``csrc/flash_attention_fwd_bf16.cu``, ``csrc/flash_attention_dq_bf16.cu``
and ``csrc/flash_attention_dkv_bf16.cu`` compute, p (and for dq and dk/dv
ds) rounded to bf16 before the products that take them.

They are held to the JAX package's own bf16 kernels in the Pallas
interpreter (``_fwd_call`` / ``_bwd_call`` on bf16 inputs, padded as
``flash_attention`` pads them) and to the port's plain versions of the
reference function, within the reference's bf16 tier
(``mxnet_tpu/ops/pallas/__main__.py:88-103``): out within 0.02 absolute,
lse within 1e-5, dq, dk and dv within 2e-2 of their max abs. The backward is
held on the JAX forward's own out and lse, so both sides compute one
function. The kernels themselves run only on the card (chip_smoke.py and
the ``cuda``-marked test of ``test_torch_attention_bwd.py``); here the
geometry the wrappers launch with is held to the sources' layout.
"""
import math
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import config
from mxnet_tpu.ops.pallas import attention as jax_attn
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.kernels import attention as attn

torch.set_num_threads(1)
BF16 = torch.bfloat16
OUT_TOL = 0.02      # the reference's bf16 output tier
LSE_TOL = 1e-5
GRAD_REL = 2e-2     # dq, dk, dv: of their max abs
HEADS = 2
D = 64
# (batch, S, causal, lengths): S 128 both ways, odd S with a row that
# sees no key, a short S with lengths down to 1
CASES = ((2, 128, False, [128, 77]), (2, 128, True, [128, 100]),
         (2, 200, True, [200, 0]), (3, 17, False, [17, 9, 1]))


@pytest.fixture(scope='module', autouse=True)
def kernels_on():
    config.set('MXNET_TPU_PALLAS', 'attention')
    yield
    config.unset('MXNET_TPU_PALLAS')


def _inputs(b, s, seed):
    """q, k, v, do as bf16 torch tensors from a numpy seed."""
    rs = np.random.RandomState(seed)
    return [torch.tensor(rs.randn(b, HEADS, s, D).astype('float32')).to(BF16)
            for _ in range(4)]


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _pad(x, axis, mult):
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, -(-n // mult) * mult - n)
    return jnp.pad(x, pad)


def _jax_bf16(q, k, v, do, lengths, causal, scale):
    """(out, lse, dq, dk, dv) of the JAX package's bf16 kernels in the
    interpreter, padded as ``flash_attention`` pads: keys to K_BLOCK,
    queries to its query block; do is zero past Sq, so padded queries add
    nothing to dk and dv (and padded keys, masked, nothing to dq). The
    backward runs on the forward's out and lse."""
    from mxnet_tpu.ops.pallas import interpret_mode
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bq = min(jax_attn._Q_BLOCK, max(8, -(-sq // 8) * 8))
    qp, dop = (_pad(_jax(t), 2, bq) for t in (q, do))
    kp, vp = (_pad(_jax(t), 2, jax_attn.K_BLOCK) for t in (k, v))
    sqp, skp = qp.shape[2], kp.shape[2]
    k_pos = jnp.arange(skp)
    valid = (k_pos[None, :] < jnp.asarray(lengths)[:, None]) & (
        k_pos[None, :] < sk)
    bias = jnp.where(valid, 0.0, -jnp.inf).astype(jnp.float32)
    out, lse = jax_attn._flash_fwd_impl(qp, kp, vp, bias, causal, scale,
                                        interpret_mode())
    dq, dk, dv = jax_attn._bwd_call(
        qp.reshape(b * h, sqp, d), kp.reshape(b * h, skp, d),
        vp.reshape(b * h, skp, d), bias, out.reshape(b * h, sqp, d), lse,
        dop.reshape(b * h, sqp, d), heads=h, causal=causal, scale=scale,
        interpret=interpret_mode())
    assert out.dtype == dq.dtype == dk.dtype == jnp.bfloat16

    def back(x, n):
        return torch.from_numpy(np.array(x.astype(jnp.float32)))[
            :, :, :n]
    return (back(out, sq), torch.from_numpy(np.array(lse)).reshape(
        b, h, sqp)[:, :, :sq], back(dq.reshape(b, h, sqp, d), sq),
        back(dk.reshape(b, h, skp, d), sk),
        back(dv.reshape(b, h, skp, d), sk))


def _lse_err(got, want):
    """Max |got - want| over finite entries; the -inf entries must match."""
    fin = torch.isfinite(want)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    return (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0


def _rel(got, want):
    return ((got.float() - want.float()).abs().max().item()
            / max(want.float().abs().max().item(), 1e-30))


@pytest.mark.parametrize('b, s, causal, lengths', CASES)
def test_tc_plain_versions_match_jax_bf16_kernels(b, s, causal, lengths):
    """The new plain versions against the JAX package's bf16 kernels on the
    same bf16 values. Measured over CASES (CPU): out 0.0039-0.0078
    absolute, lse within 4.8e-7, dq 0.0031-0.0051, dk 0.0033-0.0064 and
    dv 0.0013-0.0036 of their max abs; the limits are the reference's bf16
    tier."""
    scale = 1.0 / math.sqrt(D)
    q, k, v, do = _inputs(b, s, 40 + s + causal)
    jo, jl, jdq, jdk, jdv = _jax_bf16(q, k, v, do, lengths, causal, scale)
    lens = torch.tensor(lengths, dtype=torch.int32)
    out, lse = attn.flash_attention_bf16_reference(q, k, v, lens, causal,
                                                   scale)
    assert out.dtype == BF16 and lse.dtype == torch.float32
    assert (out.float() - jo).abs().max().item() <= OUT_TOL
    assert _lse_err(lse, jl) <= LSE_TOL
    jout = jo.to(BF16)
    dq = attn.flash_attention_dq_bf16_reference(
        q, k, v, jout, jl, do, lens, causal, scale)
    dk, dv = attn.flash_attention_dkv_bf16_reference(
        q, k, v, jout, jl, do, lens, causal, scale)
    assert dq.dtype == dk.dtype == dv.dtype == BF16
    assert _rel(dq, jdq) <= GRAD_REL
    assert _rel(dk, jdk) <= GRAD_REL
    assert _rel(dv, jdv) <= GRAD_REL


@pytest.mark.parametrize('b, s, causal, lengths', CASES)
def test_tc_plain_versions_match_todays_plain_versions(b, s, causal,
                                                       lengths):
    """The new plain versions against the port's plain versions of the
    reference function (``flash_attention_reference``,
    ``flash_attention_dq_reference``, ``flash_attention_dkv_reference``:
    no rounding of p or ds) at the same tiers. Measured over CASES (CPU):
    out 0.0039-0.0078 absolute, lse within 4.8e-7, dq 0.0034-0.0061, dk
    0.0028-0.0072 and dv 0.0007-0.0066 of their max abs."""
    scale = 1.0 / math.sqrt(D)
    q, k, v, do = _inputs(b, s, 70 + s + causal)
    lens = torch.tensor(lengths, dtype=torch.int32)
    out, lse = attn.flash_attention_bf16_reference(q, k, v, lens, causal,
                                                   scale)
    ref, lse_ref = kernels.flash_attention_reference(q, k, v, lens, causal,
                                                     scale)
    assert (out.float() - ref.float()).abs().max().item() <= OUT_TOL
    assert _lse_err(lse, lse_ref) <= LSE_TOL
    dk, dv = attn.flash_attention_dkv_bf16_reference(
        q, k, v, ref, lse_ref, do, lens, causal, scale)
    dk_ref, dv_ref = kernels.flash_attention_dkv_reference(
        q, k, v, ref, lse_ref, do, lens, causal, scale)
    assert _rel(dk, dk_ref) <= GRAD_REL
    assert _rel(dv, dv_ref) <= GRAD_REL
    dq = attn.flash_attention_dq_bf16_reference(
        q, k, v, ref, lse_ref, do, lens, causal, scale)
    dq_ref = kernels.flash_attention_dq_reference(
        q, k, v, ref, lse_ref, do, lens, causal, scale)
    assert _rel(dq, dq_ref) <= GRAD_REL


def test_tc_plain_versions_round_where_the_kernels_round():
    """Without the bf16 rounding of p the new forward is today's (the same
    online softmax in log2 units, within float32 reordering), and its
    rounding of p is what separates them: on bf16-exact weights (one
    visible key a row, p = 1) the two agree exactly. The dq plain version
    rounds ds, and only ds, right before dS K."""
    q, k, v, _ = _inputs(1, 17, 5)
    lens = torch.tensor([1], dtype=torch.int32)
    out, lse = attn.flash_attention_bf16_reference(q, k, v, lens)
    ref, lse_ref = kernels.flash_attention_reference(q, k, v, lens)
    assert torch.equal(out, ref)
    assert (out.float() - v[:, :, :1].float()).abs().max().item() == 0.0
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=LSE_TOL,
                               rtol=0)
    # dq: ds rounded to bf16 right before dS K and nowhere else. The
    # kernel's function written out step by step (each step rounded in
    # float32, no fused multiply-add) gives the plain version's bits, and
    # without that one rounding it is the reference function's dq to within
    # a bf16 rounding of the output
    q, k, v, do = _inputs(2, 40, 6)
    lens = torch.tensor([40, 23], dtype=torch.int32)
    out, lse = kernels.flash_attention_reference(q, k, v, lens, True)
    dq = attn.flash_attention_dq_bf16_reference(q, k, v, out, lse, do, lens,
                                                True)
    sc = torch.tensor(1.0 / 8)
    log2e = torch.tensor(attn.LOG2E, dtype=torch.float32)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    pos = torch.arange(40)
    vis = ((pos[None, :] < lens[:, None].long())[:, None, None, :]
           & (pos[:, None] >= pos[None, :]))
    p = torch.where(vis, torch.exp2(torch.matmul(qf, kf.transpose(-1, -2))
                                    * (sc * log2e)
                                    - (lse * log2e)[..., None]), 0.0)
    delta = (dof * out.float()).sum(-1)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None]) * sc
    assert torch.equal(dq, torch.matmul(ds.to(BF16).float(), kf).to(BF16))
    unrounded = torch.matmul(ds, kf)
    want = kernels.flash_attention_dq_reference(q, k, v, out, lse, do, lens,
                                                True).float()
    assert not torch.equal(dq.float(), unrounded.to(BF16).float())
    assert _rel(unrounded.to(BF16), want) <= 2 ** -7


def test_cpu_path_runs_the_reference_function():
    """A CPU tensor still runs today's plain versions for bf16 (the
    reference's function): the wrappers' results are theirs, bit for
    bit."""
    q, k, v, do = _inputs(2, 40, 9)
    lens = torch.tensor([40, 13], dtype=torch.int32)
    out, lse = kernels.flash_attention_with_lse(q, k, v, lens, True)
    ref, lse_ref = kernels.flash_attention_reference(q, k, v, lens, True)
    assert torch.equal(out, ref) and torch.equal(lse, lse_ref)
    got = kernels.flash_attention_dkv(q, k, v, out, lse, do, lens, True)
    want = kernels.flash_attention_dkv_reference(q, k, v, out, lse, do,
                                                 lens, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_bf16_flips_flags_every_value_that_can_round_the_other_way(seed):
    """``bf16_flips(x, FLIP_REL |x|)``: every float32 value within
    FLIP_REL / 2 (relative) of x that rounds to another bf16 than x lies
    beside a flagged x, and a flagged x is within its reach of a rounding
    midpoint; ``bf16_ulp`` is the spacing of bf16 at x."""
    rs = np.random.RandomState(seed)
    x = torch.tensor(np.exp(rs.uniform(-20, 5, 200000)).astype('float32'))
    x = x * torch.tensor(rs.choice([-1.0, 1.0], x.numel()).astype('float32'))
    flag = attn.bf16_flips(x, attn.FLIP_REL * x.abs())
    for rel in (attn.FLIP_REL / 2, -attn.FLIP_REL / 2):
        y = x * (1 + rel)
        moved = x.to(BF16) != y.to(BF16)
        assert moved.any() and not (moved & ~flag).any()
    rounded = x.to(BF16).float()
    nxt = (rounded.abs() + attn.bf16_ulp(rounded)) * torch.sign(x)
    assert torch.equal(nxt.to(BF16).float(), nxt)
    assert ((rounded - x).abs() <= attn.bf16_ulp(x) / 2).all()
    assert 0.0 < flag.float().mean().item() < 4 * attn.FLIP_REL * 2 ** 8


@pytest.mark.parametrize('seed', [0, 1])
def test_dq_slack_covers_every_ds_that_can_round_the_other_way(seed):
    """``flash_attention_dq_bf16_reference(slack=True)``: ds perturbed by
    up to FLIP_REL / 2 of itself, as the card's other summation order and
    ex2.approx can move it, and rounded to bf16 again moves dq by no more
    than the returned flip bound (plus the float32 tier of the product's
    own sums); and the perturbation does flip some ds, so the bound is
    exercised."""
    q, k, v, do = _inputs(2, 96, 90 + seed)
    lens = torch.tensor([96, 61], dtype=torch.int32)
    out, lse = kernels.flash_attention_reference(q, k, v, lens, False)
    dq, flips = attn.flash_attention_dq_bf16_reference(
        q, k, v, out, lse, do, lens, slack=True)
    _, ds, _, _, kf, _ = attn._bf16_tc_terms(q, k, v, out, lse, do, lens,
                                             False, 1.0 / 8, False)
    rs = np.random.RandomState(seed)
    moved = ds * (1 + torch.tensor(rs.uniform(
        -attn.FLIP_REL / 2, attn.FLIP_REL / 2, ds.shape).astype('float32')))
    assert (moved.to(BF16) != ds.to(BF16)).any()
    got = torch.matmul(moved.to(BF16).float(), kf)
    tier = 1e-5 * dq.float().abs().max().item()
    assert ((got - torch.matmul(ds.to(BF16).float(), kf)).abs()
            <= flips + tier).all()
    assert (flips >= 0).all() and flips.max().item() > 0


def _structs(name, w):
    """{struct: {constant: value}} of the ``template <int W> struct``s of
    csrc/<name> at W = ``w``, each constant evaluated over the ones
    before it (integer division as C's; the sources write them as
    arithmetic, a comparison counting 0 or 1)."""
    with open(os.path.join(os.path.dirname(attn.__file__), 'csrc',
                           name)) as f:
        text = f.read()
    out = {}
    for m in re.finditer(r'template <int W>\s*struct (\w+) \{(.*?)\n\};',
                         text, re.S):
        env = {'W': w}
        for c in re.finditer(r'static constexpr int (\w+) =\s*([^;]+);',
                             m.group(2)):
            env[c.group(1)] = eval(c.group(2).replace('/', '//'),
                                   {'__builtins__': {}}, dict(env))
        del env['W']
        out[m.group(1)] = env
    return out


def test_bf16_geometries_follow_the_kernel_sources():
    """``fwd_bf16_geometry`` and ``dkv_bf16_geometry`` give the block
    sizes and shared-memory bytes the kernels are built with (the
    wrappers hold them to the libraries' ``*_smem`` entries at first load
    on the card), and one block a work item."""
    fwd = _structs('flash_attention_fwd_bf16.cu', D)['Fwd']
    dkv = _structs('flash_attention_dkv_bf16.cu', D)['Dkv']
    assert _structs('mma_bf16.cuh', D)['Row']['BYTES'] == 2 * D
    assert fwd['BK'] == kernels.K_BLOCK
    for b, h, s in ((96, 12, 128), (1, 12, 256), (2, 3, 17), (3, 2, 300)):
        assert attn.fwd_bf16_geometry(b, h, s) == (
            fwd['BQ'], b * h * -(-s // fwd['BQ']), fwd['SMEM_BYTES'])
        assert attn.dkv_bf16_geometry(b, h, s) == (
            dkv['BK'], dkv['BQ'], b * h * -(-s // dkv['BK']),
            dkv['SMEM_BYTES'])
    # two blocks an SM, as the kernels' launch bounds ask
    assert fwd['MIN_BLOCKS'] == dkv['MIN_BLOCKS'] == 2
    assert 2 * fwd['SMEM_BYTES'] <= attn.SMEM_BLOCK_MAX
    assert 2 * dkv['SMEM_BYTES'] <= attn.SMEM_BLOCK_MAX


def test_dq_bf16_geometry_follows_the_kernel_source():
    """``dq_bf16_geometry`` gives the query rows a work item, the keys a
    tile and the shared-memory bytes the dq kernel is built with (the
    wrapper holds them to the library's ``*_block_q`` / ``*_block_k`` /
    ``*_smem`` entries at first load on the card), one block a work item,
    eight warps of 16 query rows, and whole 16-key k-steps a step."""
    dq = _structs('flash_attention_dq_bf16.cu', D)['Dq']
    assert _structs('mma_bf16.cuh', D)['Row']['BYTES'] == 2 * D
    assert dq['THREADS'] == 32 * dq['BQ'] // 16 and dq['MIN_BLOCKS'] == 2
    assert dq['BK'] % dq['KS'] == 0 and dq['KS'] % 16 == 0
    for b, h, s in ((96, 12, 128), (1, 12, 256), (2, 3, 17), (3, 2, 300)):
        assert attn.dq_bf16_geometry(b, h, s) == (
            dq['BQ'], dq['BK'], b * h * -(-s // dq['BQ']),
            dq['SMEM_BYTES'])
    assert (attn.DQ_BF16_BLOCK_Q, attn.DQ_BF16_BLOCK_K) == (dq['BQ'],
                                                            dq['BK'])
    assert 2 * dq['SMEM_BYTES'] <= attn.SMEM_BLOCK_MAX

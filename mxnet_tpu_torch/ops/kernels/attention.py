"""Flash attention for training, prefill and single-token decode: CUDA
kernels and their plain PyTorch versions.

The counterpart of ``mxnet_tpu/ops/pallas/attention.py``. Four kernels,
float32, the training ones (forward, dq, dkv) also bf16:

  * :func:`flash_attention_with_lse` -> ``csrc/flash_attention_fwd.cu``
    (bf16: ``csrc/flash_attention_fwd_bf16.cu``), which replaces
    ``mxnet_tpu_flash_attention_fwd`` (attention.py:111);
  * :func:`flash_attention_dq` and :func:`flash_attention_dkv` ->
    ``csrc/flash_attention_bwd.cu`` (in bf16:
    ``csrc/flash_attention_dq_bf16.cu``,
    ``csrc/flash_attention_dkv_bf16.cu``), which replace
    ``mxnet_tpu_flash_attention_dq`` (attention.py:208) and
    ``mxnet_tpu_flash_attention_dkv`` (attention.py:243);
  * :func:`flash_decode_attention` -> ``csrc/flash_decode_fwd.cu``,
    which replaces ``mxnet_tpu_flash_decode_fwd`` (attention.py:423);
    :func:`flash_paged_decode_attention` -> the same kernel's paged
    instance, which replaces ``flash_paged_decode_attention``
    (attention.py:508, a page-table gather and then that kernel): it
    reads each slot's rows through its page table in place.

:func:`flash_attention` is differentiable: :class:`FlashAttentionFunction`
(the counterpart of the ``jax.custom_vjp`` at attention.py:344-380) runs
the forward kernel, saves q, k, v, the lengths, out and the log-sum-exp,
and its backward runs the dq and dkv kernels, which recompute the
probabilities from the saved log-sum-exp.

Each public function has a plain PyTorch version beside it
(:func:`flash_attention_reference`, :func:`flash_attention_dq_reference`,
:func:`flash_attention_dkv_reference`,
:func:`flash_decode_attention_reference`,
:func:`flash_paged_decode_attention_reference`) with the TPU kernels' ``-inf``
masking and fully-masked-row guards. The wrapper rules:

  * a CPU tensor goes to the plain version;
  * a CUDA tensor launches the kernel or raises -- there is no fallback;
  * inputs are checked for dtype, shape, contiguity and device;
  * each launch adds one to the kernel's count (:func:`launch_counts`).

bf16 (AMP): the forward, dq and dkv take q, k, v, out and do all float32
or all bfloat16 and launch that dtype's instance (counted as
``flash_attention_fwd.bf16`` and so on); ``lse`` stays float32; mixed
dtypes, fp16 and other types raise ``TypeError``. The bf16 forward, dq
and dk/dv are kernels of their own on the bf16 tensor cores
(``csrc/flash_attention_fwd_bf16.cu``, ``csrc/flash_attention_dq_bf16.cu``,
``csrc/flash_attention_dkv_bf16.cu``): they round p (and, for dq and
dk/dv, ds) to bf16 before the products that take them, so they compute
another function, held by the reference's bf16 tier
(``mxnet_tpu/ops/pallas/__main__.py:88-103``: 0.02 absolute of the
float32 result on the same bf16 inputs) and, on the card, against their
own plain versions (:func:`flash_attention_bf16_reference`,
:func:`flash_attention_dq_bf16_reference`,
:func:`flash_attention_dkv_bf16_reference`), which round where the
kernels round. A CPU tensor runs the reference's function, as for
float32: the plain versions widen, compute in float32 and round to the
input dtype.

Decode bit-identity (the TPU kernels' contract, attention.py:18-26): both
forward kernels walk the key axis from 0 in fixed ``K_BLOCK`` steps with
the same score, rescale and accumulation expressions
(``csrc/online_softmax.cuh``), so prefill, the reference forward and the
cached step combine the same reduction tree over the real keys: a row of
the forward kernel is bitwise the decode kernel's output at that
position, for every block size :func:`fwd_geometry` can pick. What
bounds each kernel on the H100, and what its design does about it, is
noted at the top of its source.

Head dims: every kernel here (the forward, dq and dk/dv in float32 and
bf16, both decode instances) takes every head dim D from 1 to
:data:`HEAD_DIM_MAX` (128), through instances built at the padded widths
:data:`HEAD_WIDTHS` (:func:`head_width`, the one place the width is
chosen; each launch passes it to the kernel): columns past D are zeros in
shared memory, so every D keeps the decode bit-identity. A head dim no
instance takes raises :class:`~.errors.HeadDimError` on a CUDA tensor,
before any launch (the CPU's plain versions take any D). Each launch of
the training rows counts its width as its instance
(:func:`~._launch.instance_launches`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._launch import (check_inputs as _check_inputs, count as _count,
                      instance as _instance, io_dtype as _io_dtype,
                      on_cpu as _on_cpu, ptr as _ptr, raise_on as _raise_on,
                      require as _require, stream as _stream)
from .errors import HeadDimError

__all__ = ['K_BLOCK', 'FWD_BLOCK_Q', 'HEAD_DIM_MAX', 'HEAD_WIDTHS',
           'head_width', 'fwd_block_qs', 'fwd_geometry', 'fwd_bf16_geometry',
           'dq_geometry', 'dkv_geometry', 'dq_bf16_geometry',
           'dkv_bf16_geometry', 'online_softmax_block',
           'flash_attention_bf16_reference',
           'flash_attention_dq_bf16_reference',
           'flash_attention_dkv_bf16_reference',
           'flash_attention', 'FlashAttentionFunction',
           'flash_attention_reference', 'flash_attention_with_lse',
           'flash_attention_dq', 'flash_attention_dkv',
           'flash_attention_backward',
           'flash_attention_dq_reference', 'flash_attention_dkv_reference',
           'flash_attention_backward_reference', 'flash_decode_attention',
           'flash_decode_attention_reference', 'flash_paged_decode_attention',
           'flash_paged_decode_attention_reference']

# fixed key-axis block: part of the bit-identity contract
K_BLOCK = 128
# query rows a work item of the forward kernel, the instances built at
# padded widths up to 64, largest first (128 or 32; at width 128, where a
# block holds one K and one V buffer, 64 or 32: fwd_block_qs); each does
# a row's arithmetic alike, so all are bitwise equal
FWD_BLOCK_Q = (128, 32)
FWD_BLOCK_Q_WIDE = (64, 32)
SMS = 132                   # streaming multiprocessors of the H100 SXM
SMEM_BLOCK_MAX = 232448     # bytes of shared memory a block may take
# every kernel here: every head dim 1 .. HEAD_DIM_MAX, through instances
# built at these padded widths (head_width; each launch passes its width
# to the kernel)
HEAD_DIM_MAX = 128
HEAD_WIDTHS = (16, 32, 64, 128)
_NEG_INF = float('-inf')
_QKV = '(B, H, Sq, D)'
# the bf16 tensor-core kernels' exp2 constants, as float32 (mma_bf16.cuh)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# the bf16 forward's query rows a work item, dq's query rows a work item
# and keys a tile, and dk/dv's keys a block (64 at width 128) and queries
# a tile (csrc/flash_attention_{fwd,dq,dkv}_bf16.cu)
FWD_BF16_BLOCK_Q = 128
DQ_BF16_BLOCK_Q = 128
DQ_BF16_BLOCK_K = 128
DKV_BF16_BLOCK_K = 128
DKV_BF16_BLOCK_K_WIDE = 64
DKV_BF16_BLOCK_Q = 32
# the float32 dq's query rows a block and keys a tile, dk/dv's keys a
# block and queries a tile, at every width (csrc/flash_attention_bwd.cu)
DQ_BLOCK_Q = 128
DQ_BLOCK_K = 32
DKV_BLOCK_K = 128
DKV_BLOCK_Q = 32


def online_softmax_block(scores, v_blk, m, l, o):
    """One online-softmax accumulation step over a key block (the same
    expressions as the JAX ``online_softmax_block``).

    ``scores`` (..., q, k) float32 with masked entries at exactly -inf;
    ``v_blk`` (..., k, d); carries ``m`` (..., q), ``l`` (..., q),
    ``o`` (..., q, d). Fully-masked rows stay (m=-inf, l=0, o=0).
    """
    m_new = torch.maximum(m, scores.amax(dim=-1))
    safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(torch.where(torch.isneginf(scores), _NEG_INF,
                              scores - safe_m[..., None]))
    corr = torch.exp(torch.where(torch.isneginf(m), _NEG_INF, m - safe_m))
    corr = torch.where(torch.isneginf(m), 0.0, corr)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.matmul(p, v_blk)
    return m_new, l_new, o_new


def _finish(m, l, acc):
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    safe_m = torch.where(torch.isneginf(m), 0.0, m)
    lse = torch.where(l > 0, safe_m + torch.log(torch.clamp(l, min=1e-20)),
                      _NEG_INF)
    return out, lse


def _lengths_tensor(lengths, batch, sk, device):
    if lengths is None:
        return torch.full((batch,), sk, dtype=torch.int32, device=device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    return lengths.reshape(-1).expand(batch).contiguous()


def flash_attention_reference(q, k, v, lengths=None, causal=False,
                              scale=None):
    """Plain PyTorch version of the flash-attention forward: (out (B, H,
    Sq, D) in q's dtype, lse (B, H, Sq) float32), computed in float32."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lens = _lengths_tensor(lengths, b, sk, q.device).to(torch.int64)
    qs = q.float() * scale
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for j in range(0, sk, K_BLOCK):
        kb = k[:, :, j:j + K_BLOCK].float()
        vb = v[:, :, j:j + K_BLOCK].float()
        k_pos = torch.arange(j, j + kb.shape[2], device=q.device)
        s = torch.matmul(qs, kb.transpose(-1, -2))
        valid = (k_pos[None, :] < lens[:, None])[:, None, None, :]
        if causal:
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        s = torch.where(valid, s, _NEG_INF)
        m, l, acc = online_softmax_block(s, vb, m, l, acc)
    out, lse = _finish(m, l, acc)
    return out.to(q.dtype), lse


def head_width(d, kernel='flash_attention'):
    """The padded width of head dim ``d``: the smallest of
    :data:`HEAD_WIDTHS` at least ``d``, the instance of every kernel here
    that runs it. A head dim outside 1 .. :data:`HEAD_DIM_MAX` raises
    :class:`~.errors.HeadDimError`."""
    if not 1 <= d <= HEAD_DIM_MAX:
        raise HeadDimError(
            '%s: head dim %d not built: the attention kernels take 1-%d '
            '(other head dims: ROADMAP B1)' % (kernel, d, HEAD_DIM_MAX))
    return next(w for w in HEAD_WIDTHS if w >= d)


def fwd_block_qs(d=64):
    """The float32 forward's block sizes at head dim ``d``, largest first:
    :data:`FWD_BLOCK_Q` up to width 64, :data:`FWD_BLOCK_Q_WIDE` at 128."""
    return FWD_BLOCK_Q if head_width(d) <= 64 else FWD_BLOCK_Q_WIDE


def fwd_geometry(batch, heads, sq, block_q=None, d=64):
    """Launch geometry of the forward kernel at head dim ``d``: (block_q,
    blocks, shared memory bytes a block).

    The kernel's work items are (batch * head, query tile of ``block_q``
    rows), batch * heads * ceil(sq / block_q) of them. ``blocks``
    persistent blocks, at most one an SM, walk them in strides of
    ``blocks``, each staging the next item's tiles while it computes.
    ``block_q`` is the largest of :func:`fwd_block_qs` whose items fill
    the :data:`SMS` SMs, else the smallest (short sequences: 96 items at
    1 x 12 x 256); a ``block_q`` given is kept. The bytes follow the
    kernel's ``Layout`` (``csrc/flash_attention_fwd.cu``) at the padded
    width W = :func:`head_width` of ``d``: the Q tile, two K and two V
    tiles of K_BLOCK rows (one of each at W 128), the K_BLOCK x block_q P
    tile and three floats a row. A head dim past :data:`HEAD_DIM_MAX`
    raises :class:`~.errors.HeadDimError`."""
    width = head_width(d)
    built = fwd_block_qs(d)
    buffers = 1 if width > 64 else 2

    def items(bq):
        return batch * heads * -(-sq // bq)
    if block_q is None:
        block_q = next((bq for bq in built if items(bq) >= SMS), built[-1])
    if block_q not in built:
        raise ValueError('flash_attention: block_q %r not built (have %s)'
                         % (block_q, built))
    floats = (block_q * width + 2 * buffers * K_BLOCK * width
              + K_BLOCK * block_q + 3 * block_q)
    return block_q, min(items(block_q), SMS), 4 * floats


def _fwd_lib():
    from . import _build
    lib = _build.load('flash_attention_fwd')
    fn = lib.mx_flash_attention_fwd
    if fn.argtypes is None:
        smem = lib.mx_flash_attention_fwd_smem
        smem.restype = ctypes.c_int
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        # every width at every block size: the bytes of its instance, 0
        # where none is built
        for width in HEAD_WIDTHS:
            for bq in sorted(set(FWD_BLOCK_Q + FWD_BLOCK_Q_WIDE)):
                want = (fwd_geometry(1, 1, 1, bq, width)[2]
                        if bq in fwd_block_qs(width) else 0)
                built = smem(bq, width)
                _require(built == want,
                         'flash_attention: fwd_geometry gives %d bytes at '
                         'width %d block_q %d, the kernel takes %d'
                         % (want, width, bq, built))
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
    return fn


def _f32(x, device):
    """``x`` as a 0-d float32 tensor: the kernels' float32 constants."""
    return torch.tensor(x, dtype=torch.float32, device=device)


# A value within FLIP_REL of its bf16 rounding midpoint (relative to
# itself) may round the other way on the card: the kernels' float32 sums
# run in another order than the plain versions' and their exp2 is
# ex2.approx, which moves p by far less (about 2^-20 relative at the
# training shape)
FLIP_REL = 2.0 ** -14


def bf16_ulp(x):
    """One bf16 ULP of each element of float32 ``x`` (2^(e - 7) for |x| in
    [2^e, 2^(e + 1)); the smallest normal's for 0)."""
    return torch.exp2(torch.floor(torch.log2(torch.clamp(
        x.abs(), min=2.0 ** -126))) - 7)


def bf16_flips(x, reach):
    """Where float32 ``x`` lies within ``reach`` (elementwise) of a bf16
    rounding midpoint: where a value that close to ``x`` can round to the
    other neighbour. The midpoint above |x|'s bf16 truncation is exact in
    float32."""
    a = x.abs()
    lo = (a.view(torch.int32) & ~0xffff).view(torch.float32)
    return (a - (lo + bf16_ulp(a) / 2)).abs() <= reach


def flash_attention_bf16_reference(q, k, v, lengths=None, causal=False,
                                   scale=None, slack=False):
    """Plain PyTorch version of the bf16 tensor-core forward
    (``csrc/flash_attention_fwd_bf16.cu``): (out (B, H, Sq, D) in q's
    dtype, lse (B, H, Sq) float32). The reference's online softmax over
    the same K_BLOCK-key tiles, in log2 units (x = (q k^T)(scale log2 e),
    weights 2^(x - m)), with each weight rounded to bf16 before P.V as
    the kernel rounds it; l sums the float32 weights; out = acc (1 /
    max(l, 1e-20)), lse = m ln 2 + log l. Each step rounds in float32 as
    the kernel's does (no fused multiply-add); the kernel's exp2 is
    ex2.approx, so a weight near a bf16 rounding boundary can round the
    other way on the card. ``slack=True`` also returns, per element of out
    (float32), what such flips can move it by: the bf16 ULP of each weight
    within :data:`FLIP_REL` of a rounding midpoint, times |v|, carried
    through the rescales and divided by l."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = q.device
    scale2 = _f32(scale, dev) * _f32(LOG2E, dev)
    lens = _lengths_tensor(lengths, b, sk, dev).to(torch.int64)
    qf = q.float()
    q_pos = torch.arange(sq, device=dev)
    m = torch.full((b, h, sq), _NEG_INF, device=dev)
    l = torch.zeros((b, h, sq), device=dev)
    acc = torch.zeros((b, h, sq, d), device=dev)
    flips = torch.zeros((b, h, sq, d), device=dev) if slack else None
    for j in range(0, sk, K_BLOCK):
        kb = k[:, :, j:j + K_BLOCK].float()
        vb = v[:, :, j:j + K_BLOCK].float()
        k_pos = torch.arange(j, j + kb.shape[2], device=dev)
        x = torch.matmul(qf, kb.transpose(-1, -2)) * scale2
        valid = (k_pos[None, :] < lens[:, None])[:, None, None, :]
        if causal:
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        x = torch.where(valid, x, _NEG_INF)
        m_new = torch.maximum(m, x.amax(dim=-1))
        safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        corr = torch.exp2(m - safe)
        p = torch.exp2(x - safe[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(
            p.to(torch.bfloat16).float(), vb)
        if slack:
            flips = flips * corr[..., None] + torch.matmul(
                torch.where(bf16_flips(p, FLIP_REL * p), bf16_ulp(p), 0.0),
                vb.abs())
        m = m_new
    inv = 1.0 / torch.clamp(l, min=1e-20)
    out = acc * inv[..., None]
    lse = torch.where(l > 0, m * _f32(LN2, dev) + torch.log(l), _NEG_INF)
    if slack:
        return out.to(q.dtype), lse, flips * inv[..., None]
    return out.to(q.dtype), lse


def fwd_bf16_geometry(batch, heads, sq, d=64):
    """Launch geometry of the bf16 forward kernel at head dim ``d``:
    (block_q, blocks, shared memory bytes a block). One block a work item
    (batch * head, query tile of :data:`FWD_BF16_BLOCK_Q` rows), two
    resident an SM up to width 64 (one at 128); the bytes follow the
    kernel's layout at the padded width W = :func:`head_width` of ``d``:
    the Q tile and two K and two V tiles of K_BLOCK rows, bf16."""
    width = head_width(d, 'flash_attention (bf16)')
    bq = FWD_BF16_BLOCK_Q
    return bq, batch * heads * -(-sq // bq), 2 * width * (bq + 4 * K_BLOCK)


def dq_bf16_geometry(batch, heads, sq, d=64):
    """Launch geometry of the bf16 dq kernel at head dim ``d``: (block_q,
    block_k, blocks, shared memory bytes a block). One block a work item
    (batch * head, query tile of :data:`DQ_BF16_BLOCK_Q` rows), two
    resident an SM up to width 64 (one at 128); it walks key tiles of
    :data:`DQ_BF16_BLOCK_K` rows. The bytes follow the kernel's layout at
    the padded width W of ``d``: the Q and dO tiles and two K and two V
    tiles, bf16."""
    width = head_width(d, 'flash_attention_dq (bf16)')
    bq, bk = DQ_BF16_BLOCK_Q, DQ_BF16_BLOCK_K
    return (bq, bk, batch * heads * -(-sq // bq),
            2 * width * (2 * bq + 4 * bk))


def dkv_bf16_geometry(batch, heads, sk, d=64):
    """Launch geometry of the bf16 dk/dv kernel at head dim ``d``:
    (block_k, block_q, blocks, shared memory bytes a block). One block a
    (batch * head, key block) of :data:`DKV_BF16_BLOCK_K` keys
    (:data:`DKV_BF16_BLOCK_K_WIDE` at width 128, where a thread holds 128
    floats of dK and dV); it walks query tiles of :data:`DKV_BF16_BLOCK_Q`
    rows. The bytes follow the kernel's layout at the padded width W of
    ``d``: the K and V tiles, two buffers of the Q, dO and O tiles (bf16)
    and two lse and two delta rows (float32)."""
    width = head_width(d, 'flash_attention_dkv (bf16)')
    bk = DKV_BF16_BLOCK_K if width <= 64 else DKV_BF16_BLOCK_K_WIDE
    bq = DKV_BF16_BLOCK_Q
    return (bk, bq, batch * heads * -(-sk // bk),
            2 * width * (2 * bk + 6 * bq) + 4 * 4 * bq)


def _row_floats(width):
    """Floats a staged row of the float32 backward's tiles at ``width``:
    at least 32, the swizzle's four 8-float groups."""
    return max(width, 32)


def dq_geometry(batch, heads, sq, d=64):
    """Launch geometry of the float32 dq kernel at head dim ``d``:
    (block_q, block_k, blocks, shared memory bytes a block). One block a
    work item (batch * head, :data:`DQ_BLOCK_Q`-query tile), two resident
    an SM up to width 64 (one at 128); it walks key tiles of
    :data:`DQ_BLOCK_K` rows. The bytes follow the kernel's layout
    (``csrc/flash_attention_bwd.cu`` ``Shape``) at the padded width of
    ``d``: the Q and dO tiles and two K and two V tiles, float32 rows of
    :func:`_row_floats`."""
    rs = _row_floats(head_width(d, 'flash_attention_dq'))
    bq, bk = DQ_BLOCK_Q, DQ_BLOCK_K
    return bq, bk, batch * heads * -(-sq // bq), 4 * rs * (2 * bq + 4 * bk)


def dkv_geometry(batch, heads, sk, d=64):
    """Launch geometry of the float32 dk/dv kernel at head dim ``d``:
    (block_k, block_q, blocks, shared memory bytes a block). One block a
    (batch * head, :data:`DKV_BLOCK_K`-key block), two resident an SM
    (one at width 128 and for the D < 64 of width 64, whose warps own 16
    keys, not 32); it walks query tiles of :data:`DKV_BLOCK_Q` rows. The
    bytes follow the kernel's layout at the padded width of ``d``: the K
    and V tiles, two buffers of the Q, dO and O tiles, two lse and two
    delta rows, float32."""
    rs = _row_floats(head_width(d, 'flash_attention_dkv'))
    bk, bq = DKV_BLOCK_K, DKV_BLOCK_Q
    return (bk, bq, batch * heads * -(-sk // bk),
            4 * (rs * (2 * bk + 6 * bq) + 4 * bq))


def _held_lib(source, entry, argtypes, geometry, entries):
    """The ctypes entry ``entry`` of the library of ``source``, its
    geometry held at first load, at every width of :data:`HEAD_WIDTHS`,
    to what the library reports: each of ``entries`` (C functions of the
    width: block sizes, then shared memory bytes) against ``geometry`` at
    d = the width (its block sizes and bytes; the blocks, second to last,
    left out)."""
    from . import _build
    lib = _build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        for width in HEAD_WIDTHS:
            built = tuple(getattr(lib, e)(width) for e in entries)
            geo = geometry(1, 1, 1, d=width)
            want = geo[:-2] + geo[-1:]
            _require(built == want, '%s: the geometry gives %r at width '
                     '%d, the kernel is built for %r'
                     % (entry, want, width, built))
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _flash_attention_cuda(q, k, v, lengths, causal, scale, block_q=None):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _require(k.shape == (b, h, sk, d) and v.shape == k.shape,
             'flash_attention: k/v must be (B, H, Sk, D) = %r, got %r / %r'
             % ((b, h, sk, d), tuple(k.shape), tuple(v.shape)))
    dt = q.dtype
    bf16 = dt == torch.bfloat16
    width = head_width(d, 'flash_attention (bf16)' if bf16 else
                       'flash_attention')
    if bf16:
        _require(block_q in (None, FWD_BF16_BLOCK_Q), 'flash_attention: the '
                 'bf16 kernel is built for block_q %d, not %r'
                 % (FWD_BF16_BLOCK_Q, block_q))
    else:
        block_q, blocks, _ = fwd_geometry(b, h, sq, block_q, d)
    lens = _lengths_tensor(lengths, b, sk, q.device)
    _check_inputs('flash_attention', {'q': q, 'k': k, 'v': v,
                                      'lengths': lens},
                  {'q': dt, 'k': dt, 'v': dt, 'lengths': torch.int32})
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    name, entry = _instance('flash_attention_fwd', 'mx_flash_attention_fwd',
                            dt)
    with torch.cuda.device(q.device):
        if bf16:
            fn = _held_lib('flash_attention_fwd_bf16', entry,
                           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
                               ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
                           fwd_bf16_geometry,
                           ('mx_flash_attention_fwd_bf16_block_q',
                            'mx_flash_attention_fwd_bf16_smem'))
            err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(lens), _ptr(out),
                     _ptr(lse), b, h, sq, sk, d, width, float(scale),
                     int(bool(causal)), _stream(q.device))
        else:
            err = _fwd_lib()(
                _ptr(q), _ptr(k), _ptr(v), _ptr(lens), _ptr(out), _ptr(lse),
                b, h, sq, sk, d, width, float(scale), int(bool(causal)),
                block_q, blocks, _stream(q.device))
    _raise_on(name, err)
    _count(name, width)
    return out, lse


def flash_attention_with_lse(q, k, v, lengths=None, causal=False,
                             scale=None, block_q=None):
    """:func:`flash_attention` that also returns the log-sum-exp
    (B, H, Sq) float32 -- the forward half of the flash backward.
    ``block_q`` picks the float32 kernel's query rows a work item (one of
    :func:`fwd_block_qs`; None: :func:`fwd_geometry` picks); every
    instance gives the same bits. The bf16 kernel is built for
    :data:`FWD_BF16_BLOCK_Q` alone."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _io_dtype('flash_attention', {'q': q, 'k': k, 'v': v})
    if _on_cpu('flash_attention', q, _QKV):
        return flash_attention_reference(q, k, v, lengths, causal, scale)
    return _flash_attention_cuda(q, k, v, lengths, causal, scale, block_q)


def flash_attention(q, k, v, lengths=None, causal=False, scale=None):
    """Blockwise flash attention over (B, H, S, D) tensors, float32 or
    bfloat16 (all three alike; the output in their dtype).

    ``lengths`` (B,) or a scalar masks keys at positions >= length;
    ``causal`` adds the autoregressive mask (key <= query position).
    ``scale`` defaults to 1/sqrt(D). Returns (B, H, Sq, D); a row with
    no visible key is 0. Differentiable in q, k and v through
    :class:`FlashAttentionFunction`; no gradient flows to ``lengths``.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionFunction.apply(q, k, v, lengths, bool(causal),
                                        float(scale))


class FlashAttentionFunction(torch.autograd.Function):
    """Flash forward kernel, and the dq / dkv kernels as its backward
    (the ``_flash_core`` custom_vjp of attention.py:344-380). Saves q, k,
    v, the (B,) int32 lengths, out and the log-sum-exp; the probabilities
    are recomputed, never stored."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, scale):
        lens = _lengths_tensor(lengths, q.shape[0], k.shape[2], q.device)
        out, lse = flash_attention_with_lse(q, k, v, lens, causal, scale)
        ctx.save_for_backward(q, k, v, lens, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lens, out, lse = ctx.saved_tensors
        # the cotangent of a head merge is usually a permuted view
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.contiguous(), lens, ctx.causal,
            ctx.scale)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# backward: dq and dk/dv recomputed from the saved log-sum-exp
# ---------------------------------------------------------------------------


def _bwd_terms(q, k, v, out, lse, do, lengths, causal, scale):
    """p and ds of ``_p_block`` (attention.py:195-205) and the dq/dkv
    bodies: s = (q k^T) * scale with masked keys at -inf, p = exp(s - lse)
    with masked entries and rows whose lse is -inf at exactly 0,
    ds = p * (do v^T - rowsum(do * o)) * scale."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    lens = _lengths_tensor(lengths, b, sk, q.device).to(torch.int64)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof, of = do.float(), out.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    k_pos = torch.arange(sk, device=q.device)
    valid = (k_pos[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        q_pos = torch.arange(sq, device=q.device)
        valid = valid & (q_pos[:, None] >= k_pos[None, :])
    s = torch.where(valid, s, _NEG_INF)
    dead = torch.isneginf(s) | torch.isneginf(lse)[..., None]
    safe_lse = torch.where(torch.isneginf(lse), 0.0, lse)
    p = torch.where(dead, 0.0, torch.exp(s - safe_lse[..., None]))
    delta = torch.sum(dof * of, dim=-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, qf, kf, dof


def flash_attention_dq_reference(q, k, v, out, lse, do, lengths=None,
                                 causal=False, scale=None):
    """Plain PyTorch version of the dq kernel: dq = ds k, (B, H, Sq, D) in
    q's dtype, computed in float32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds, _, kf, _ = _bwd_terms(q, k, v, out, lse, do, lengths, causal,
                                 scale)
    return torch.matmul(ds, kf).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, out, lse, do, lengths=None,
                                  causal=False, scale=None):
    """Plain PyTorch version of the dkv kernel: dk = ds^T q and
    dv = p^T do, each (B, H, Sk, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds, qf, _, dof = _bwd_terms(q, k, v, out, lse, do, lengths, causal,
                                   scale)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def _bf16_tc_terms(q, k, v, out, lse, do, lengths, causal, scale, slack):
    """p, ds and the widened inputs as the bf16 tensor-core backward
    kernels compute them: p = 2^(s (scale log2 e) - lse log2 e), 0 where
    masked or lse == -inf; ds = (p (dp - delta)) scale, each step rounded
    in float32 (no fused multiply-add); and with ``slack`` ``near``, the
    reach of float32 sums of dp and delta in another order on ds:
    p scale 2^-16 (|do| |v|^T + rowsum |do o|) (else None)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dev = q.device
    sc = _f32(scale, dev)
    log2e = _f32(LOG2E, dev)
    lens = _lengths_tensor(lengths, b, sk, dev).to(torch.int64)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof, of = do.float(), out.float()
    s = torch.matmul(qf, kf.transpose(-1, -2))
    k_pos = torch.arange(sk, device=dev)
    valid = (k_pos[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        q_pos = torch.arange(sq, device=dev)
        valid = valid & (q_pos[:, None] >= k_pos[None, :])
    dead = ~valid | torch.isneginf(lse)[..., None]
    p = torch.where(dead, 0.0, torch.exp2(
        s * (sc * log2e) - (lse * log2e)[..., None]))
    delta = torch.sum(dof * of, dim=-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sc
    near = p * sc * 2.0 ** -16 * (
        torch.matmul(dof.abs(), vf.abs().transpose(-1, -2))
        + (dof * of).abs().sum(dim=-1)[..., None]) if slack else None
    return p, ds, near, qf, kf, dof


def _ds_flips(ds, near):
    """What a bf16 flip of each ds can move it by: its bf16 ULP where it
    lies within FLIP_REL of a rounding midpoint or within ``near`` of one,
    plus ``near``, which the sums' order can move it by itself."""
    return torch.where(bf16_flips(ds, FLIP_REL * ds.abs() + near),
                       bf16_ulp(ds), 0.0) + near


def flash_attention_dq_bf16_reference(q, k, v, out, lse, do, lengths=None,
                                      causal=False, scale=None,
                                      slack=False):
    """Plain PyTorch version of the bf16 tensor-core dq kernel
    (``csrc/flash_attention_dq_bf16.cu``): dq (B, H, Sq, D) in q's dtype.
    p = 2^(s (scale log2 e) - lse log2 e), 0 where masked or lse == -inf;
    ds = (p (dp - delta)) scale; dq = bf16(ds) k with float32 sums: ds
    rounded to bf16 where the kernel rounds it, each other step rounded
    in float32 as the kernel's (no fused multiply-add). The kernel's exp2
    is ex2.approx and its sums run in another order, so a ds near a bf16
    rounding boundary can round the other way on the card. ``slack=True``
    also returns, per element of dq (float32), what such flips can move
    it by: the bf16 ULP of each ds within :data:`FLIP_REL` of a rounding
    midpoint or within p scale E of one, E = 2^-16 (|do| |v|^T + rowsum
    |do o|), plus that reach itself, times |k| (the rule of
    :func:`flash_attention_dkv_bf16_reference` for dk, k in q's
    place)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds, near, _, kf, _ = _bf16_tc_terms(q, k, v, out, lse, do, lengths,
                                           causal, scale, slack)
    dq = torch.matmul(ds.to(torch.bfloat16).float(), kf)
    if not slack:
        return dq.to(q.dtype)
    return dq.to(q.dtype), torch.matmul(_ds_flips(ds, near), kf.abs())


def flash_attention_dkv_bf16_reference(q, k, v, out, lse, do, lengths=None,
                                       causal=False, scale=None,
                                       slack=False):
    """Plain PyTorch version of the bf16 tensor-core dk/dv kernel
    (``csrc/flash_attention_dkv_bf16.cu``): (dk, dv), each (B, H, Sk, D) in
    k's dtype. p = 2^(s (scale log2 e) - lse log2 e), 0 where masked or
    lse == -inf; ds = (p (dp - delta)) scale; dv = bf16(p)^T do and dk =
    bf16(ds)^T q with float32 sums: p and ds rounded to bf16 where the
    kernel rounds them, each other step rounded in float32 as the kernel's
    (no fused multiply-add). The kernel's exp2 is ex2.approx, so a p near
    a bf16 rounding boundary can round the other way on the card.
    ``slack=True`` also returns, per element of dk and dv (float32), what
    such flips can move it by: the bf16 ULP of each p within
    :data:`FLIP_REL` of a rounding midpoint times |do| for dv; for dk, of
    each ds within FLIP_REL of one or within p scale E, E = 2^-16 (|do|
    |v|^T + rowsum |do o|), the reach of float32 sums of dp and delta in
    another order (which can also move ds by E itself), times |q|."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds, near, qf, _, dof = _bf16_tc_terms(q, k, v, out, lse, do, lengths,
                                             causal, scale, slack)
    bf = torch.bfloat16
    dk = torch.matmul(ds.to(bf).float().transpose(-1, -2), qf)
    dv = torch.matmul(p.to(bf).float().transpose(-1, -2), dof)
    if not slack:
        return dk.to(k.dtype), dv.to(v.dtype)
    p_flips = torch.where(bf16_flips(p, FLIP_REL * p), bf16_ulp(p), 0.0)
    return (dk.to(k.dtype), dv.to(v.dtype),
            torch.matmul(_ds_flips(ds, near).transpose(-1, -2), qf.abs()),
            torch.matmul(p_flips.transpose(-1, -2), dof.abs()))


def flash_attention_backward_reference(q, k, v, out, lse, do, lengths=None,
                                       causal=False, scale=None):
    """Plain PyTorch version of the flash backward: (dq, dk, dv)."""
    dq = flash_attention_dq_reference(q, k, v, out, lse, do, lengths,
                                      causal, scale)
    dk, dv = flash_attention_dkv_reference(q, k, v, out, lse, do, lengths,
                                           causal, scale)
    return dq, dk, dv


def _bwd_lib(kernel, dtype):
    """The ctypes entry of the dq (``kernel`` 'dq') or dk/dv ('dkv')
    kernel of ``dtype``, its geometry held at first load
    (:func:`_held_lib`); returns (counted name, entry)."""
    name, entry = _instance('flash_attention_' + kernel,
                            'mx_flash_attention_' + kernel, dtype)
    bf16 = dtype == torch.bfloat16
    geometry = {('dq', False): dq_geometry, ('dkv', False): dkv_geometry,
                ('dq', True): dq_bf16_geometry,
                ('dkv', True): dkv_bf16_geometry}[kernel, bf16]
    blocks = ('block_q', 'block_k') if kernel == 'dq' else ('block_k',
                                                             'block_q')
    outs = 1 if kernel == 'dq' else 2
    fn = _held_lib(
        'flash_attention_%s_bf16' % kernel if bf16 else 'flash_attention_bwd',
        entry, [ctypes.c_void_p] * (7 + outs) + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p], geometry,
        tuple('%s_%s' % (entry, b) for b in blocks) + (entry + '_smem',))
    return name, fn


def _bwd_dtype(kernel, q, k, v, out, do):
    """The one dtype (float32 or bfloat16) of the backward's inputs."""
    return _io_dtype(kernel, {'q': q, 'k': k, 'v': v, 'out': out, 'do': do})


def _bwd_checked(kernel, q, k, v, out, lse, do, lengths):
    """Shape, dtype, head dim and layout checks shared by the two backward
    kernels; returns the (B,) int32 lengths and the padded width of the
    instance (:func:`head_width`)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _require(k.shape == (b, h, sk, d) and v.shape == k.shape,
             '%s: k/v must be (B, H, Sk, D) = %r, got %r / %r'
             % (kernel, (b, h, sk, d), tuple(k.shape), tuple(v.shape)))
    _require(out.shape == q.shape and do.shape == q.shape,
             '%s: out/do must be %r, got %r / %r'
             % (kernel, tuple(q.shape), tuple(out.shape), tuple(do.shape)))
    _require(tuple(lse.shape) == (b, h, sq),
             '%s: lse must be %r, got %r' % (kernel, (b, h, sq),
                                            tuple(lse.shape)))
    width = head_width(d, kernel)
    lens = _lengths_tensor(lengths, b, sk, q.device)
    dt = q.dtype
    _check_inputs(kernel, {'q': q, 'k': k, 'v': v, 'out': out, 'lse': lse,
                           'do': do, 'lengths': lens},
                  {'q': dt, 'k': dt, 'v': dt, 'out': dt,
                   'lse': torch.float32, 'do': dt, 'lengths': torch.int32})
    return lens, width


def flash_attention_dq(q, k, v, out, lse, do, lengths=None, causal=False,
                       scale=None):
    """dq of flash attention from the forward's ``out`` and ``lse`` and
    the output cotangent ``do``; (B, H, Sq, D) in q's dtype (float32 or
    bfloat16, as k, v, out and do)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dt = _bwd_dtype('flash_attention_dq', q, k, v, out, do)
    if _on_cpu('flash_attention_dq', q, _QKV):
        return flash_attention_dq_reference(q, k, v, out, lse, do, lengths,
                                            causal, scale)
    lens, width = _bwd_checked('flash_attention_dq', q, k, v, out, lse, do,
                               lengths)
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        name, fn = _bwd_lib('dq', dt)
        err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), _ptr(do),
                 _ptr(lens), _ptr(dq), b, h, sq, k.shape[2], d, width,
                 float(scale), int(bool(causal)), _stream(q.device))
    _raise_on(name, err)
    _count(name, width)
    return dq


def flash_attention_dkv(q, k, v, out, lse, do, lengths=None, causal=False,
                        scale=None):
    """(dk, dv) of flash attention, each (B, H, Sk, D) in k's dtype
    (float32 or bfloat16, as q, v, out and do)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dt = _bwd_dtype('flash_attention_dkv', q, k, v, out, do)
    if _on_cpu('flash_attention_dkv', q, _QKV):
        return flash_attention_dkv_reference(q, k, v, out, lse, do, lengths,
                                             causal, scale)
    lens, width = _bwd_checked('flash_attention_dkv', q, k, v, out, lse, do,
                               lengths)
    b, h, sq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        name, fn = _bwd_lib('dkv', dt)
        err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), _ptr(do),
                 _ptr(lens), _ptr(dk), _ptr(dv), b, h, sq, k.shape[2], d,
                 width, float(scale), int(bool(causal)), _stream(q.device))
    _raise_on(name, err)
    _count(name, width)
    return dk, dv


def flash_attention_backward(q, k, v, out, lse, do, lengths=None,
                             causal=False, scale=None):
    """(dq, dk, dv): the dq kernel, then the dkv kernel (their plain
    versions for CPU tensors)."""
    dq = flash_attention_dq(q, k, v, out, lse, do, lengths, causal, scale)
    dk, dv = flash_attention_dkv(q, k, v, out, lse, do, lengths, causal,
                                 scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# single-token decode over the slot cache
# ---------------------------------------------------------------------------


def flash_decode_attention_reference(q, keys, values, positions, heads,
                                     scale=None):
    """Plain PyTorch version of the decode kernel: ``q`` (slots, U)
    against ``keys``/``values`` (slots, max_len, U), each slot seeing
    keys ``<= positions[slot]``. Returns (slots, U)."""
    slots, u = q.shape
    max_len = keys.shape[1]
    d = u // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pos = positions.to(device=q.device, dtype=torch.int64)
    qs = (q.float() * scale).reshape(slots, heads, 1, d)
    kh = keys.float().reshape(slots, max_len, heads, d).transpose(1, 2)
    vh = values.float().reshape(slots, max_len, heads, d).transpose(1, 2)
    m = torch.full((slots, heads, 1), _NEG_INF, device=q.device)
    l = torch.zeros((slots, heads, 1), device=q.device)
    acc = torch.zeros((slots, heads, 1, d), device=q.device)
    for j in range(0, max_len, K_BLOCK):
        kb = kh[:, :, j:j + K_BLOCK]
        vb = vh[:, :, j:j + K_BLOCK]
        k_pos = torch.arange(j, j + kb.shape[2], device=q.device)
        s = torch.matmul(qs, kb.transpose(-1, -2))
        valid = (k_pos[None, :] <= pos[:, None])[:, None, None, :]
        s = torch.where(valid, s, _NEG_INF)
        m, l, acc = online_softmax_block(s, vb, m, l, acc)
    out, _ = _finish(m, l, acc)
    return out.reshape(slots, u).to(q.dtype)


def _decode_lib():
    from . import _build
    lib = _build.load('flash_decode_fwd')
    fn = lib.mx_flash_decode_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
    return fn


def flash_decode_attention(q, keys, values, positions, heads, scale=None):
    """Cached decode-step attention: ``q`` (slots, U) single-token
    queries against the slot cache ``keys``/``values`` (slots, max_len,
    U), read in place; slot s attends keys ``<= positions[s]``
    (``positions`` (slots,) int32). Returns (slots, U) float32."""
    cpu = _on_cpu('flash_decode_attention', q, '(slots, U)')
    slots, u = q.shape
    if u % heads:
        raise ValueError('flash_decode_attention: units %d not divisible '
                         'by heads %d' % (u, heads))
    d = u // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if cpu:
        return flash_decode_attention_reference(q, keys, values, positions,
                                                heads, scale)
    max_len = keys.shape[1]
    _require(keys.shape == (slots, max_len, u) and values.shape == keys.shape,
             'flash_decode_attention: cache must be (slots, max_len, U) = '
             '%r, got %r / %r' % ((slots, max_len, u), tuple(keys.shape),
                                  tuple(values.shape)))
    _require(tuple(positions.shape) == (slots,),
             'flash_decode_attention: positions must be (slots,)')
    width = head_width(d, 'flash_decode_attention')
    _check_inputs('flash_decode_attention',
                  {'q': q, 'keys': keys, 'values': values,
                   'positions': positions},
                  {'q': torch.float32, 'keys': torch.float32,
                   'values': torch.float32, 'positions': torch.int32})
    out = torch.empty_like(q)
    fn = _decode_lib()
    with torch.cuda.device(q.device):
        err = fn(_ptr(q), _ptr(keys), _ptr(values), _ptr(positions),
                 _ptr(out), slots, max_len, u, heads, width, float(scale),
                 _stream(q.device))
    _raise_on('flash_decode_fwd', err)
    _count('flash_decode_fwd')
    return out


# ---------------------------------------------------------------------------
# single-token decode over the paged cache
# ---------------------------------------------------------------------------


def flash_paged_decode_attention_reference(q, key_pool, value_pool, tables,
                                           positions, heads, scale=None):
    """Plain PyTorch version of the paged decode kernel, the JAX
    function's own structure: gather each slot's view of ``max_pages x
    page_size`` rows through its page table, then
    :func:`flash_decode_attention_reference` over it. Returns (slots,
    U)."""
    slots, u = q.shape
    view = key_pool[tables.long()].reshape(slots, -1, u)
    values = value_pool[tables.long()].reshape(slots, -1, u)
    return flash_decode_attention_reference(q, view, values, positions,
                                            heads, scale)


def _paged_decode_lib():
    from . import _build
    fn = _build.load('flash_decode_fwd').mx_flash_paged_decode_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
    return fn


def flash_paged_decode_attention(q, key_pool, value_pool, tables, positions,
                                 heads, scale=None):
    """Decode-step attention over the paged cache: ``q`` (slots, U)
    single-token queries against the pools ``key_pool`` / ``value_pool``
    (pages, page_size, U), read in place through ``tables`` (slots,
    max_pages) int32; slot s attends the keys ``<= positions[s]``
    (int32) of its view of ``max_pages x page_size`` rows. Keys past a
    slot's position get weight 0 whatever their page holds, so the
    result is bitwise :func:`flash_decode_attention` over the gathered
    view. Returns (slots, U) float32."""
    cpu = _on_cpu('flash_paged_decode_attention', q, '(slots, U)')
    slots, u = q.shape
    if u % heads:
        raise ValueError('flash_paged_decode_attention: units %d not '
                         'divisible by heads %d' % (u, heads))
    d = u // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if cpu:
        return flash_paged_decode_attention_reference(
            q, key_pool, value_pool, tables, positions, heads, scale)
    _require(key_pool.dim() == 3 and key_pool.shape[2] == u
             and value_pool.shape == key_pool.shape,
             'flash_paged_decode_attention: pools must be (pages, '
             'page_size, %d), got %r / %r' % (u, tuple(key_pool.shape),
                                              tuple(value_pool.shape)))
    pages, page_size, _ = key_pool.shape
    _require(page_size > 0 and page_size & (page_size - 1) == 0,
             'flash_paged_decode_attention: page_size %d is not a power of '
             'two' % page_size)
    _require(tables.dim() == 2 and tables.shape[0] == slots,
             'flash_paged_decode_attention: tables must be (slots, '
             'max_pages) with slots %d, got %r' % (slots,
                                                  tuple(tables.shape)))
    _require(tuple(positions.shape) == (slots,),
             'flash_paged_decode_attention: positions must be (slots,)')
    width = head_width(d, 'flash_paged_decode_attention')
    max_pages = tables.shape[1]
    _require(max_pages * page_size < 2 ** 31
             and pages * page_size * u < 2 ** 32,
             'flash_paged_decode_attention: a view of 2**31 rows or a pool '
             'of 2**32 floats or more')
    _check_inputs('flash_paged_decode_attention',
                  {'q': q, 'key_pool': key_pool, 'value_pool': value_pool,
                   'tables': tables, 'positions': positions},
                  {'q': torch.float32, 'key_pool': torch.float32,
                   'value_pool': torch.float32, 'tables': torch.int32,
                   'positions': torch.int32})
    out = torch.empty_like(q)
    fn = _paged_decode_lib()
    with torch.cuda.device(q.device):
        err = fn(_ptr(q), _ptr(key_pool), _ptr(value_pool), _ptr(tables),
                 _ptr(positions), _ptr(out), slots, max_pages, page_size,
                 pages, u, heads, width, float(scale), _stream(q.device))
    _raise_on('flash_paged_decode_fwd', err)
    _count('flash_paged_decode_fwd')
    return out

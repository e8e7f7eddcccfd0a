"""Check and time the softmax-xent forward's cluster instance at 1, 2, 4
and 8 CTAs a row on the card, at the MLM head's shape by default.

    python -m mxnet_tpu_torch.tools.probe_xent_clusters [rows] [V] [dtype]

``dtype`` is the logits' type, ``float32`` (the default) or ``bfloat16``.
Each size whose chunk fits a block's shared memory calls the kernel's C
entry point with the cluster instance's geometry at that size
(``xent._cluster_geometry``; the wrapper itself takes only the size
``xent_geometry`` picks) on the same logits and labels, 3 of them out of
range. It holds nll and logp to 1e-5 absolute of the plain version (nll
exactly 0 at the out-of-range labels), and bf16 logits bitwise to the
float32 instance at the same size on the widened logits, before it times
anything, then times the sizes in turns (1, 2, 4, 8, 8, 4, 2, 1) by the
probe's ``slope_ms`` over inputs rotated past twice the L2
(:func:`times_by_size`, which chip_smoke.py calls at the MLM head too). A
line a size gives its error, its device ms and whether ``xent_geometry``
picks it. Needs a card; raises without one.
"""
from __future__ import annotations

import sys

from mxnet_tpu_torch.tools.probe_matmul_pipeline import (card, cold_copies,
                                                          slope_ms)

TOL = 1e-5
SIZES = (1, 2, 4, 8)


def sizes_for(v):
    """The cluster sizes of :data:`SIZES` whose chunk fits a block and
    leaves no CTA without a column at width ``v``."""
    from mxnet_tpu_torch.ops.kernels import xent
    return [c for c in SIZES if xent._chunk(v, c) <= xent.XENT_CHUNK_MAX
            and (c - 1) * xent._chunk(v, c) < v]


def forward_at(x, lab, cluster):
    """(nll, logp) of the cluster instance at ``cluster`` CTAs a row on
    the card's ``x`` (float32 or bf16 logits), through the C entry point;
    launches made here do not count."""
    import torch
    from mxnet_tpu_torch.ops.kernels import xent
    from mxnet_tpu_torch.ops.kernels._launch import ptr, raise_on, stream
    rows, v = x.shape
    geom = xent._cluster_geometry(rows, v, cluster, x.element_size())
    entry = 'mx_softmax_xent_fwd' + ('_bf16' if x.dtype == torch.bfloat16
                                     else '')
    nll = torch.empty((rows,), dtype=torch.float32, device=x.device)
    logp = torch.empty((rows, v), dtype=torch.float32, device=x.device)
    raise_on('softmax_xent_fwd', xent._lib(entry)(
        ptr(x), ptr(lab), ptr(nll), ptr(logp), rows, v,
        xent.XENT_INSTANCES.index('cluster'), geom.cluster, geom.chunk,
        stream(x.device)))
    return nll, logp


def times_by_size(torch, x, lab):
    """{cluster size: [device ms, ...]} of :func:`forward_at` on ``x`` and
    ``lab``, each size timed in turns (the sizes, then reversed) by
    ``slope_ms`` over clones rotated past twice the L2."""
    nbytes = x.numel() * x.element_size() + lab.numel() * 4
    copies = [(x, lab)] + [(x.clone(), lab.clone())
                           for _ in range(cold_copies(nbytes) - 1)]
    sizes = sizes_for(x.shape[1])
    times = {size: [] for size in sizes}
    for size in sizes + sizes[::-1]:
        times[size].append(slope_ms(torch, lambda i, size=size: forward_at(
            *copies[i % len(copies)], size)))
    return times


def main(argv=None):
    import torch
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import xent
    argv = sys.argv[1:] if argv is None else argv
    args = argv + ['1920', '30522', 'float32'][len(argv):]
    rows, v = int(args[0]), int(args[1])
    dtype = getattr(torch, args[2])
    if not torch.cuda.is_available():
        raise RuntimeError('probe_xent_clusters: no CUDA device')
    print(card(), flush=True)
    dev = torch.device('cuda')
    gen = torch.Generator(device='cpu').manual_seed(4)
    x = (torch.randn(rows, v, generator=gen) * 3).to(dev, dtype)
    lab = torch.randint(0, v, (rows,), generator=gen,
                        dtype=torch.int32).to(dev)
    out = min(3, rows - 1)
    lab[:out] = torch.tensor([-1, v, v + 7][:out], dtype=torch.int32)
    nll_ref, logp_ref = kernels.softmax_xent_forward_reference(x, lab)
    picked = kernels.xent_geometry(rows, v, x.element_size())
    errs = {}
    for size in sizes_for(v):
        nll, logp = forward_at(x, lab, size)
        errs[size] = max((nll - nll_ref).abs().max().item(),
                         (logp - logp_ref).abs().max().item())
        bitwise = True
        if dtype == torch.bfloat16:
            n32, l32 = forward_at(x.float(), lab, size)
            bitwise = torch.equal(nll, n32) and torch.equal(logp, l32)
        if not errs[size] <= TOL or not bitwise or (
                out and nll[:out].abs().max().item() != 0.0):
            raise AssertionError('softmax_xent_fwd at %d CTAs a row: max '
                                 'abs error %.3g, bitwise the float32 '
                                 'instance %s, nll at out-of-range labels %s'
                                 % (size, errs[size], bitwise,
                                    nll[:out].tolist()))
    times = times_by_size(torch, x, lab)
    for size, ts in times.items():
        print('xent rows %d V %d %s, %d CTAs a row (chunk %d columns%s): '
              'max_abs_err %.3g, device ms %s'
              % (rows, v, args[2], size, xent._chunk(v, size),
                 ', picked' if picked[:2] == ('cluster', size) else '',
                 errs[size], ' / '.join('%.4f' % t for t in ts)),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

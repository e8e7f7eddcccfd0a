"""Check and time the softmax-xent forward's cluster instance at 1, 2, 4
and 8 CTAs a row on the card, at the MLM head's shape by default.

    python -m mxnet_tpu_torch.tools.probe_xent_clusters [rows] [V]

Each size whose chunk fits a block's shared memory calls the kernel's C
entry point with the cluster instance's geometry at that size
(``xent._cluster_geometry``; the wrapper itself takes only the size
``xent_geometry`` picks) on the same logits and labels, 3 of them out of
range. It holds nll and logp to 1e-5 absolute of the plain version (nll
exactly 0 at the out-of-range labels) before it times anything, then
times the sizes in turns (1, 2, 4, 8, 8, 4, 2, 1) by the probe's
``slope_ms`` over inputs rotated past twice the L2. A line a size gives
its error, its device ms and whether ``xent_geometry`` picks it. Needs a
card; raises without one.
"""
from __future__ import annotations

import sys

from mxnet_tpu_torch.tools.probe_matmul_pipeline import (card, cold_copies,
                                                          slope_ms)

TOL = 1e-5
SIZES = (1, 2, 4, 8)


def main(argv=None):
    import torch
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import xent
    from mxnet_tpu_torch.ops.kernels._launch import ptr, raise_on, stream
    argv = sys.argv[1:] if argv is None else argv
    rows, v = (int(a) for a in (argv + ['1920', '30522'][len(argv):])[:2])
    if not torch.cuda.is_available():
        raise RuntimeError('probe_xent_clusters: no CUDA device')
    print(card(), flush=True)
    dev = torch.device('cuda')
    gen = torch.Generator(device='cpu').manual_seed(4)
    x = (torch.randn(rows, v, generator=gen) * 3).to(dev)
    lab = torch.randint(0, v, (rows,), generator=gen,
                        dtype=torch.int32).to(dev)
    out = min(3, rows - 1)
    lab[:out] = torch.tensor([-1, v, v + 7][:out], dtype=torch.int32)
    nll_ref, logp_ref = kernels.softmax_xent_forward_reference(x, lab)
    entry = xent._lib('mx_softmax_xent_fwd')
    cluster = xent.XENT_INSTANCES.index('cluster')
    picked = kernels.xent_geometry(rows, v)
    sizes = [c for c in SIZES if xent._chunk(v, c) <= xent.XENT_CHUNK_MAX
             and (c - 1) * xent._chunk(v, c) < v]

    def run(size):
        geom = xent._cluster_geometry(rows, v, size)

        def launch(x, lab):
            nll = torch.empty((rows,), dtype=torch.float32, device=dev)
            logp = torch.empty_like(x)
            raise_on('softmax_xent_fwd', entry(
                ptr(x), ptr(lab), ptr(nll), ptr(logp), rows, v, cluster,
                geom.cluster, geom.chunk, stream(dev)))
            return nll, logp
        return launch

    errs = {}
    for size in sizes:
        nll, logp = run(size)(x, lab)
        errs[size] = max((nll - nll_ref).abs().max().item(),
                         (logp - logp_ref).abs().max().item())
        if not errs[size] <= TOL or (out and nll[:out].abs().max().item()
                                     != 0.0):
            raise AssertionError('softmax_xent_fwd at %d CTAs a row: max '
                                 'abs error %.3g, nll at out-of-range '
                                 'labels %s' % (size, errs[size],
                                                nll[:out].tolist()))
    nbytes = x.numel() * 4 + lab.numel() * 4
    copies = [(x, lab)] + [(x.clone(), lab.clone())
                           for _ in range(cold_copies(nbytes) - 1)]
    times = {size: [] for size in sizes}
    for size in sizes + sizes[::-1]:
        fn = run(size)
        times[size].append(slope_ms(
            torch, lambda i, fn=fn: fn(*copies[i % len(copies)])))
    for size in sizes:
        print('xent rows %d V %d, %d CTAs a row (chunk %d floats%s): '
              'max_abs_err %.3g, device ms %s'
              % (rows, v, size, xent._cluster_geometry(rows, v, size).chunk,
                 ', picked' if picked[:2] == ('cluster', size) else '',
                 errs[size],
                 ' / '.join('%.4f' % t for t in times[size])), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

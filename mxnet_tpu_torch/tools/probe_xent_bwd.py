"""Check and time the softmax-xent backward kernel on the card, beside the
block-a-row kernel it replaced, variants of its design and
``cross_entropy``'s backward, at the heads the training slices run: BERT's
MLM head (1920 x 30522), ResNet-50's (128 x 1000) and BERT's NSP head
(96 x 2).

    python -m mxnet_tpu_torch.tools.probe_xent_bwd [--against DIR]

Run it from the repository's root (it takes its check cases from
``chip_smoke.py``). Candidates, each a function of ``(logp, labels, g)``
that allocates ``dx`` as the wrapper does:

  * ``shipped``: the wrapper ``softmax_xent_backward``;
  * ``against`` (with ``--against DIR``): ``DIR/softmax_xent.cu`` built
    with ``-I DIR``, called by the block-a-row kernel's entry point
    ``mx_softmax_xent_bwd(logp, labels, g, dx, int rows, int v,
    stream)``, for example the csrc directory of commit 682f4dc unpacked
    by ``git archive``;
  * ``noevict``: the built library's entry point with normal stores where
    the shipped geometry stores evict-first (the MLM head);
  * ``u2``: two vectors a thread, one block a tile of 2048 floats, the
    rest and the tail in the block past them (:data:`_U2_SRC`, appended
    to the source as a kernel of its own);
  * ``library``: the backward alone of ``cross_entropy(x, labels,
    reduction='sum')`` scaled by 1 / rows, from a retained graph.

Before it times anything it holds ``shipped`` bitwise to ``against`` and
to every variant, with g per row and g a scalar, at the three heads and at
every case of ``chip_smoke.XENT_BWD_CASES`` (labels -1 and V among them),
and ``library`` within 1e-5 of the plain version's max abs at each head.
Then, head by head, the candidates are timed in turns (an order that
starts one candidate later at each head, never with ``shipped``, then in
reverse) by the probe's ``slope_ms`` over inputs rotated past twice the
L2 (at most :data:`MAX_COPIES` copies: the NSP head's 768 bytes stay in
the L2, and its times are launch costs), with g = 1 / rows and labels in
[0, V) (``cross_entropy`` refuses others). A line a head gives each
candidate's two device ms, its share of the bytes bound (logp read and dx
written, labels and g read, at 3.35 TB/s) and its ratio to the library;
then ptxas's registers and spills of each backward kernel built; last,
one JSON line with every number. Needs a card; raises without one.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

from mxnet_tpu_torch.tools.probe_matmul_pipeline import (PEAK_BYTES_S, card,
                                                          cold_copies,
                                                          slope_ms)

HEADS = (('MLM', 1920, 30522), ('ResNet', 128, 1000), ('NSP', 96, 2))
TOL = 1e-5
MAX_COPIES = 256
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# two vectors of logp a thread over tiles of 2 x TILE floats; the block
# past the whole tiles takes the rest, a vector a thread and turn, and the
# n % 4 scalars
_U2_SRC = r'''
namespace {
template <bool EVICT>
__global__ void __launch_bounds__(mx_stream::THREADS)
softmax_xent_bwd_u2_kernel(const float* __restrict__ logp,
                           const int* __restrict__ labels,
                           const float* __restrict__ g,
                           float* __restrict__ dx, Idx n, Idx tiles,
                           Divisor v, Idx lead) {
  const XentBwd<EVICT> op{logp, labels, g, dx, v, lead};
  constexpr Idx TILE = mx_stream::TILE, VEC = mx_stream::VEC;
  const Idx i = (Idx)blockIdx.x * 2 * TILE + threadIdx.x * VEC;
  if (blockIdx.x < tiles) {
    const auto a = op.load(i);
    const auto b = op.load(i + TILE);
    op.store(i, a);
    op.store(i + TILE, b);
    return;
  }
  const Idx whole = n & ~(VEC - 1);
  for (Idx j = i; j < whole; j += TILE) op.store(j, op.load(j));
  if (whole + threadIdx.x < n) op.scalar(whole + threadIdx.x);
}
}  // namespace

// the shipped entry's arguments; tiles = n / (2 TILE)
extern "C" int mx_softmax_xent_bwd_u2(const void* logp, const void* labels,
                                      const void* g, void* dx, long long n,
                                      long long v, unsigned v_mul,
                                      int v_shift, long long lead, int evict,
                                      long long tiles, void* stream) {
  if (n == 0) return cudaSuccess;
  Divisor vd;
  if (n < 0 || n > INT32_MAX || !mx_stream::divisor(v, v_mul, v_shift, vd) ||
      lead < 0 || lead >= 4 || lead >= v || tiles != n / (2 * mx_stream::TILE))
    return cudaErrorInvalidValue;
  const unsigned grid =
      (unsigned)(tiles + (n % (2 * mx_stream::TILE) != 0));
  auto st = static_cast<cudaStream_t>(stream);
  const auto* lp = static_cast<const float*>(logp);
  const auto* lab = static_cast<const int*>(labels);
  const auto* gp = static_cast<const float*>(g);
  auto* dp = static_cast<float*>(dx);
  if (evict)
    softmax_xent_bwd_u2_kernel<true><<<grid, mx_stream::THREADS, 0, st>>>(
        lp, lab, gp, dp, (Idx)n, (Idx)tiles, vd, (Idx)lead);
  else
    softmax_xent_bwd_u2_kernel<false><<<grid, mx_stream::THREADS, 0, st>>>(
        lp, lab, gp, dp, (Idx)n, (Idx)tiles, vd, (Idx)lead);
  return cudaGetLastError();
}
'''
_KERNEL = re.compile(r'(softmax_xent_bwd(?:_u2)?_kernel)(?:ILb(\d)E)?')


def _nvcc(build, name, text, include=None):
    out = os.path.join(build._BUILD_DIR, 'variants')
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, 'xent_bwd_%s.cu' % name)
    with open(cu, 'w') as f:
        f.write(text)
    so = cu[:-3] + '.so'
    home = build._cuda_home()
    cmd = [os.path.join(home, 'bin', 'nvcc'), *build.NVCC_FLAGS,
           *(['-I', include] if include else []), '-Xlinker',
           '-rpath=' + os.path.join(home, 'lib64'), '-o', so, cu]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE), so


def _reap(name, proc):
    out, err = proc.communicate(timeout=600)
    log = (out + err).decode('utf-8', 'replace')
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed on %s:\n%s' % (name, log))
    return log


def bwd_resources(log):
    """{'kernel<store kind>': (registers, spill bytes)} of the backward
    kernels in ptxas's ``-v`` lines ``log``."""
    found, key = {}, None
    for ln in log.splitlines():
        if 'Compiling entry function' in ln:
            m = _KERNEL.search(ln)
            key = m and '%s<%s>' % (m.group(1), {'1': 'evict', '0': 'st',
                                                 None: ''}[m.group(2)])
            if key:
                found[key] = [0, 0]
        elif key:
            found[key][1] += sum(int(n) for n in re.findall(
                r'(\d+) bytes spill (?:stores|loads)', ln))
            regs = re.search(r'Used (\d+) registers', ln)
            if regs:
                found[key][0] = int(regs.group(1))
    return {k: tuple(v) for k, v in found.items()}


def _candidates(torch, xent, libs):
    """name -> fn(logp, labels, g) -> dx, as ``shipped`` takes them."""
    from mxnet_tpu_torch.ops.kernels._launch import raise_on, stream
    from mxnet_tpu_torch.ops.kernels.epilogue import EPI_TILE
    i64, u32, i32, vp = (ctypes.c_longlong, ctypes.c_uint, ctypes.c_int,
                         ctypes.c_void_p)

    def entry(lib, name, types):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, types
        return fn

    stream_types = [vp] * 4 + [i64, i64, u32, i32, i64, i32, i64, vp]

    def streamed(fn, evict=None, unroll=1):
        tile = unroll * EPI_TILE
        def run(logp, lab, g):
            rows, v = logp.shape
            gr = xent._rows_g(g, rows, logp.device)
            (c,), div = xent.xent_bwd_geometry(rows, v)
            dx = torch.empty_like(logp)
            raise_on('softmax_xent_bwd', fn(
                xent._at(logp, 0), xent._at(lab, 0), xent._at(gr, 0),
                xent._at(dx, 0), c.n, v, div.mul, div.shift, 0,
                int(c.geom.evict if evict is None else evict),
                c.n // tile, stream(logp.device)))
            return dx
        return run

    fns = {'shipped': xent.softmax_xent_backward}
    if 'against' in libs:
        parent = entry(libs['against'], 'mx_softmax_xent_bwd',
                       [vp] * 4 + [i32, i32, vp])

        def against(logp, lab, g):
            rows, v = logp.shape
            gr = xent._rows_g(g, rows, logp.device)
            dx = torch.empty_like(logp)
            raise_on('softmax_xent_bwd', parent(
                xent._at(logp, 0), xent._at(lab, 0), xent._at(gr, 0),
                xent._at(dx, 0), rows, v, stream(logp.device)))
            return dx
        fns['against'] = against
    fns['noevict'] = streamed(xent._lib('mx_softmax_xent_bwd'), evict=False)
    fns['u2'] = streamed(entry(libs['u2'], 'mx_softmax_xent_bwd_u2',
                               stream_types), unroll=2)
    return fns


def _check(torch, kernels, fns, cases, gen, dev, inputs):
    """Every candidate bitwise equal to ``shipped`` on each case, g per
    row and g a scalar."""
    for rows, v in cases:
        logp, lab = inputs(torch, kernels, rows, v, gen, dev)
        for kind, g in (('row', torch.rand(rows, generator=gen).to(dev)),
                        ('scalar', 0.37)):
            want = fns['shipped'](logp, lab, g)
            for name, fn in fns.items():
                if name != 'shipped' and not torch.equal(fn(logp, lab, g),
                                                         want):
                    raise AssertionError(
                        'xent backward %s differs from shipped at rows %d '
                        'V %d, g %s' % (name, rows, v, kind))


def main(argv=None):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('probe_xent_bwd needs a CUDA card')
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import _build, xent
    argv = list(sys.argv[1:] if argv is None else argv)
    against = None
    if argv[:1] == ['--against'] and len(argv) == 2:
        against = os.path.abspath(argv[1])
    elif argv:
        raise SystemExit('usage: probe_xent_bwd [--against DIR]')
    sys.path.insert(0, _ROOT)
    import chip_smoke
    dev = torch.device('cuda')
    print(card(), flush=True)
    procs = {'u2': _nvcc(_build, 'u2', _build.source_text('softmax_xent')
                         + _U2_SRC)}
    if against:
        procs['against'] = _nvcc(
            _build, 'against',
            open(os.path.join(against, 'softmax_xent.cu')).read(), against)
    _build.build('softmax_xent')
    libs, resources = {}, {}
    for name, (proc, so) in procs.items():
        resources[name] = bwd_resources(_reap(name, proc))
        libs[name] = ctypes.CDLL(so)
    fns = _candidates(torch, xent, libs)
    gen = torch.Generator(device='cpu').manual_seed(6)
    _check(torch, kernels, fns,
           [(r, v) for _, r, v in HEADS] + list(chip_smoke.XENT_BWD_CASES),
           gen, dev, chip_smoke.xent_bwd_inputs)
    print('checked: %s bitwise equal to shipped at the heads and at %d '
          'chip_smoke cases, g per row and scalar'
          % (', '.join(n for n in fns if n != 'shipped'),
             len(chip_smoke.XENT_BWD_CASES)), flush=True)
    F = torch.nn.functional
    names = list(fns) + ['library']
    report = {'card': card(), 'heads': {}, 'resources': resources}
    for k, (head, rows, v) in enumerate(HEADS):
        x = (torch.randn(rows, v, generator=gen) * 3).to(dev)
        lab = torch.randint(0, v, (rows,), generator=gen,
                            dtype=torch.int32).to(dev)
        logp = kernels.softmax_xent_forward(x, lab)[1]
        g = torch.full((rows,), 1.0 / rows, device=dev)
        nbytes = 2 * logp.numel() * 4 + 2 * rows * 4
        copies = min(cold_copies(logp.numel() * 4), MAX_COPIES)
        sets = [(logp, lab, g)] + [(logp.clone(), lab.clone(), g.clone())
                                   for _ in range(copies - 1)]
        graphs = []
        for _ in range(copies):
            xs = x.detach().clone().requires_grad_(True)
            graphs.append((xs, F.cross_entropy(xs, lab.long(),
                                               reduction='sum') / rows))
        want = xent.softmax_xent_backward_reference(logp, lab, g)
        lib = torch.autograd.grad(graphs[0][1], graphs[0][0],
                                  retain_graph=True)[0]
        err = (lib - want).abs().max().item() / want.abs().max().item()
        if not err <= TOL:
            raise AssertionError('cross_entropy backward at %s: %.3g of '
                                 'the plain version' % (head, err))
        calls = {n: (lambda fn: lambda i: fn(*sets[i % copies]))(fns[n])
                 for n in fns}
        calls['library'] = lambda i: torch.autograd.grad(
            graphs[i % copies][1], graphs[i % copies][0], retain_graph=True)
        skip = 1 + k % (len(names) - 1)
        order = names[skip:] + names[:skip]
        times = {n: [] for n in names}
        for name in order + order[::-1]:
            times[name].append(slope_ms(torch, calls[name]))
        bound = nbytes / PEAK_BYTES_S * 1e3
        lib_ms = sum(times['library']) / 2
        report['heads'][head] = dict(rows=rows, v=v, bound_ms=bound,
                                     copies=copies, first=order[0],
                                     device_ms=times)
        print('xent_bwd %s rows %d V %d (bytes bound %.4f ms, %d copies, '
              '%s first): %s' % (head, rows, v, bound, copies, order[0],
                                 '; '.join(
            '%s %s ms (%.3f of bound, %.3fx library)'
            % (n, ' / '.join('%.4f' % t for t in times[n]),
               bound / (sum(times[n]) / 2), sum(times[n]) / 2 / lib_ms)
            for n in names)), flush=True)
        del sets, graphs, x, logp, lib, want
        torch.cuda.empty_cache()
    for name, found in resources.items():
        print('ptxas %s: %s' % (name, ', '.join(
            '%s %d registers, %d bytes spilled' % (k, r, s)
            for k, (r, s) in sorted(found.items()))), flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

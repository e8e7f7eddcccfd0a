"""Probe the port's four bf16 matmul kernels against cuBLAS on ResNet-50's
1x1-conv shapes, on the card.

    python -m mxnet_tpu_torch.tools.probe_matmul_pipeline [iters]

The counterpart of ``tools/probe_matmul_pipeline.py`` (``SHAPES`` :22-32,
``time_variant`` :142-186, ``main`` :189-210). For each shape (bf16,
batch 128, M = B*H*W) it first checks ``torch.matmul`` (cuBLAS, the
counterpart of ``lax_mm``: bf16 in, float32 sums, with reduced-precision
reductions off), the plain version and the kernels ``cur``, ``noacc``,
``ws`` and ``ep`` (``mxnet_tpu_torch.ops.kernels.matmul``) against the
float64 product of the same inputs (:func:`float64_bound`), and each kernel
against the plain version; then it times each by :func:`slope_ms` and
prints one line each: ms, GB/s, TFLOP/s and the share of the bound
(:func:`bound_ms`), under the card's name and power limit; last, one JSON
line with every number.

Inputs come from a seeded ``torch.Generator`` on the card; each check
writes into a NaN-filled output; each timed run rotates over enough
copies of the inputs that the set exceeds twice the 50 MB L2, so
every launch reads A and B cold, as a 1x1 conv that reads the previous
layer's output finds them. Without a card it raises: unlike the JAX
probe, it writes no "unavailable" artifact and turns no failure into a
printed line.
"""
from __future__ import annotations

import itertools
import json
import math
import statistics
import subprocess
import sys
import time

__all__ = ['SHAPES', 'PEAK_BYTES_S', 'PEAK_BF16_FLOP_S', 'L2_BYTES',
           'ITERS', 'work', 'bound_ms', 'float64_bound', 'bound_ratio',
           'cold_copies', 'slope_ms', 'card', 'run', 'main']

SHAPES = [
    # (M, K, N)  -- ResNet-50 bottleneck 1x1s at bs128
    (401408, 64, 256),
    (401408, 256, 64),
    (100352, 512, 128),
    (100352, 128, 512),
    (25088, 1024, 256),
    (25088, 256, 1024),
    (6272, 512, 2048),
    (6272, 2048, 512),
]
PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOP_S = 989e12    # H100 SXM bf16 tensor cores, dense
L2_BYTES = 50e6              # H100 L2
ITERS = 20                   # launches of the short timed run


def work(m, k, n):
    """(bytes, flops) of one product: A and B read once, Y written once,
    bf16; a multiply and an add per (m, k, n)."""
    return 2 * (m * k + k * n + m * n), 2 * m * k * n


def bound_ms(m, k, n):
    """The least time the card could take, and what bounds it:
    (max(bytes / 3.35 TB/s, flops / 989 TFLOP/s) in ms, 'bytes' or
    'operations')."""
    nbytes, flops = work(m, k, n)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def float64_bound(a, b):
    """(y64, allowed) for bf16 ``a`` (M, K), ``b`` (K, N): the float64
    product of the inputs, and how far a float32 sum of the (exact) bf16
    products, rounded once to bf16, may lie from it in each element:

        |y - y64| <= ulp_bf16(|y64|) + K * 2**-23 * (|a| @ |b|)

    a bf16 ulp (twice the rounding's half ulp, for a sum that crossed into
    the next binade) plus twice the first-order bound of any float32
    summation order. Two orders that both hold it may differ by twice it."""
    import torch
    a64, b64 = a.double(), b.double()
    y64 = a64 @ b64
    absprod = a64.abs() @ b64.abs()
    _, e = torch.frexp(y64)     # |y64| = f * 2**e, f in [0.5, 1)
    ulp = torch.where(y64 == 0, torch.zeros_like(y64),
                      torch.ldexp(torch.ones_like(y64), e - 8))
    return y64, ulp + a.shape[1] * 2.0 ** -23 * absprod


def bound_ratio(y, ref, allowed):
    """max |y - ref| / allowed over the elements (NaN if any is NaN; inf
    where allowed is 0 and y differs); <= 1 holds the bound."""
    import torch
    err = (y.double() - ref).abs()
    ratio = torch.where(allowed > 0, err / allowed.clamp_min(1e-300),
                        torch.where(err > 0, math.inf, 0.0))
    return ratio.max().item() if ratio.numel() else 0.0


def cold_copies(nbytes):
    """Copies of ``nbytes`` of inputs a timed run rotates over: enough
    that the set exceeds twice the L2, so no launch finds its inputs
    there."""
    return int(2 * L2_BYTES // nbytes) + 1


def _sleep_rate(torch):
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 6)
    end.record()
    end.synchronize()
    return 1e6 / start.elapsed_time(end)


def slope_ms(torch, launch, n=ITERS):
    """Device milliseconds of one ``launch(i)`` (i counts every launch,
    warm-up and runs alike, for rotating inputs), the wrapper's host cost
    left out.

    As the JAX probe does, it times n and 4n launches back to back and
    takes the slope, (t(4n) - t(n)) / 3n, so the fixed cost of a run
    cancels; the median of 3 slopes, after 3 warm-up launches. CUDA
    events bracket each run, and a ``torch.cuda._sleep`` before the first
    event gives the host a
    head start (twice its enqueue time of 4n calls, from the warm-up), so
    the card runs the launches back to back without waiting for Python.
    If the first event has fired before the host has queued the whole
    run, the head start grows fourfold and the run is repeated; the card
    then never idles inside the timed span."""
    calls = itertools.count()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        launch(next(calls))
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    rate = _sleep_rate(torch)
    head_ms = 2.0 * 4 * n * min(host) * 1e3 + 1.0

    def timed(count):
        nonlocal head_ms
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(head_ms * rate))
            start.record()
            for _ in range(count):
                launch(next(calls))
            end.record()
            ahead = not start.query()
            end.synchronize()
            if ahead:
                return start.elapsed_time(end)
            head_ms *= 4
        raise RuntimeError('slope_ms: the host fell behind the card with a '
                           '%.1f ms head start' % head_ms)

    slopes = []
    for _ in range(3):
        lo = timed(n)
        hi = timed(4 * n)
        slopes.append((hi - lo) / (3 * n))
    return statistics.median(slopes)


def card():
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _candidates(torch, kernels):
    """name -> fn(a, b, out=None): cuBLAS, the plain version (which
    allocates its own result), the four kernels."""
    fns = {'cublas': lambda a, b, out=None: torch.matmul(a, b, out=out),
           'plain': lambda a, b, out=None: kernels.matmul_reference(a, b)}
    for v in kernels.MATMUL_VARIANTS:
        fns[v] = (lambda v: lambda a, b, out=None: kernels.matmul(
            a, b, v, out=out))(v)
    return fns


def _probe_shape(torch, kernels, m, k, n, iters, seed, log, name):
    dev = torch.device('cuda')
    nbytes, flops = work(m, k, n)
    b_ms, b_by = bound_ms(m, k, n)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    copies = [(randn(m, k), randn(k, n))
              for _ in range(cold_copies(2 * (m * k + k * n)))]
    a, b = copies[0]
    y64, allowed = float64_bound(a, b)
    fns = _candidates(torch, kernels)
    plain = fns['plain'](a, b).double()
    log('shape M=%d K=%d N=%d: %.1f MB, %.2f GFLOP, bound %.4f ms (%s); %d '
        'cold copies [%s]' % (m, k, n, nbytes / 1e6, flops / 1e9, b_ms, b_by,
                              len(copies), name))
    rows = {}
    for name, fn in fns.items():
        # a NaN-filled output, so a row or tile left unwritten shows
        y = fn(a, b, torch.full((m, n), math.nan, dtype=torch.bfloat16,
                                device=dev))
        ratio = bound_ratio(y, y64, allowed)
        row = dict(ratio=ratio)
        if name in kernels.MATMUL_VARIANTS:
            row['max_abs_err'] = (y.double() - plain).abs().max().item()
            row['ratio_vs_plain'] = bound_ratio(y, plain, 2 * allowed)
        if not (ratio <= 1 and row.get('ratio_vs_plain', 0) <= 1):
            raise AssertionError(
                '%s at M=%d K=%d N=%d is outside the float64 bound: '
                '|y - y64| / bound %.3g, against the plain version %.3g'
                % (name, m, k, n, ratio, row.get('ratio_vs_plain', 0)))
        del y
        ms = slope_ms(torch, lambda i: fn(*copies[i % len(copies)]),
                      n=iters)
        row.update(ms=ms, gb_s=nbytes / ms / 1e6, tflop_s=flops / ms / 1e9,
                   share=b_ms / ms)
        rows[name] = row
        log('  %-7s %9.4f ms %8.1f GB/s %7.1f TFLOP/s  %.3f of bound;  '
            '|y - y64| <= %.3f of the float64 bound%s'
            % (name, ms, row['gb_s'], row['tflop_s'], row['share'], ratio,
               '' if 'max_abs_err' not in row else ', max |y - plain| %.4g'
               % row['max_abs_err']))
    return dict(M=m, K=k, N=n, bytes=nbytes, flops=flops, bound_ms=b_ms,
                bound_by=b_by, copies=len(copies), rows=rows)


def run(torch, iters=ITERS, log=print):
    """Check and time cuBLAS, the plain version and the four kernels at
    each of :data:`SHAPES` on the card (inputs from seed i at shape i);
    returns {'card', 'iters', 'shapes': one dict a shape}. Raises when
    any result leaves the float64 bound."""
    from mxnet_tpu_torch.ops import kernels
    name = card()
    back = torch.backends.cuda.matmul
    saved = back.allow_tf32, back.allow_bf16_reduced_precision_reduction
    # float32 sums everywhere: no TF32 in the plain version, no bf16
    # partial sums in cuBLAS (preferred_element_type=float32 in lax_mm)
    back.allow_tf32 = False
    back.allow_bf16_reduced_precision_reduction = False
    try:
        return dict(card=name, iters=iters, shapes=[
            _probe_shape(torch, kernels, m, k, n, iters, i, log, name)
            for i, (m, k, n) in enumerate(SHAPES)])
    finally:
        back.allow_tf32, back.allow_bf16_reduced_precision_reduction = saved


def main(argv=None):
    import torch
    argv = sys.argv[1:] if argv is None else argv
    iters = int(argv[0]) if argv else ITERS
    if not torch.cuda.is_available():
        raise RuntimeError('probe_matmul_pipeline: no CUDA card '
                           '(torch.cuda.is_available() is False)')
    print('torch %s cuda %s, %d launches a short run, slope of %d and %d'
          % (torch.__version__, torch.version.cuda, iters, iters, 4 * iters),
          flush=True)
    result = run(torch, iters, log=lambda *a: print(*a, flush=True))
    print(json.dumps(dict(probe='matmul_pipeline', **result)))
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Time the flash-attention dq kernel beside variants of its source on the
card, at the training shape (B 96, H 12, S 128, D 64, non-causal).

    python -m mxnet_tpu_torch.tools.probe_dq_variants

Each variant is ``csrc/flash_attention_bwd.cu`` with a few exact text
substitutions (each must occur once), built with the port's nvcc flags
into the ignored ``ops/kernels/_build/variants/`` and called through the
same C entry point as the built kernel on the same inputs. The kernels
run in turns (built, variants, variants reversed, built), each timed by
the probe's ``slope_ms`` over inputs rotated past twice the L2. A line a
variant gives its device ms, its max error relative to the max abs of
the plain version and of dq in float64 (the same expressions on the card
in float64), and its registers and spill bytes from ptxas; the variants
that compute something else (``no_split``, ``1xtf32``) measure a cost,
not a candidate, and ``expf`` measures what ``ex2.approx`` on pre-scaled
arguments adds to the error. Needs a card; raises without one.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

from mxnet_tpu_torch.tools.probe_matmul_pipeline import (card, cold_copies,
                                                          slope_ms)

CVT_SPLIT = ('  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n'
             '  small = __float_as_uint(x - __uint_as_float(big));')
# name -> (what it measures, [(text, replacement)])
VARIANTS = {
    'cvt_rna': ('both parts by cvt.rna.tf32.f32 (5 instructions a split '
                'in SASS against 3)', [(CVT_SPLIT, (
                    '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : '
                    '"f"(x));\n'
                    '  const float rest = x - __uint_as_float(big);\n'
                    '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(small) : '
                    '"f"(rest));'))]),
    'no_split': ('operands handed whole, the same mma count: the cost of '
                 'the splits', [(CVT_SPLIT, ('  big = __float_as_uint(x);\n'
                                             '  small = big;'))]),
    '1xtf32': ('the big.big product alone: a third of the mma', [
        ('for (int n = 0; n < N; ++n) mma(acc[m][n], as[m], bb[n]);',
         'for (int n = 0; n < N; ++n) (void)0;'),
        ('for (int n = 0; n < N; ++n) mma(acc[m][n], ab[m], bs[n]);',
         'for (int n = 0; n < N; ++n) (void)0;')]),
    'expf': ('p by expf(s * scale - lse) in place of ex2.approx of the '
             'pre-scaled scores', [(
                 'const float ex = exp2f_approx(s[m][n][e] * scale2 - '
                 'lse2[m][e >> 1]);',
                 'const float ex = expf(s[m][n][e] * scale - lse_i);')]),
}


def _build_variant(build, name, subs):
    src = os.path.join(build._CSRC, 'flash_attention_bwd.cu')
    text = open(src).read()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError('variant %s: %r occurs %d times'
                               % (name, old[:60], text.count(old)))
        text = text.replace(old, new)
    out = os.path.join(build._BUILD_DIR, 'variants')
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, 'dq_%s.cu' % name)
    with open(cu, 'w') as f:
        f.write(text)
    so = cu[:-3] + '.so'
    home = build._cuda_home()
    cmd = [os.path.join(home, 'bin', 'nvcc'), *build.NVCC_FLAGS,
           '-I', build._CSRC, '-Xlinker',
           '-rpath=' + os.path.join(home, 'lib64'), '-o', so, cu]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE), so


def _resources(log):
    """(registers, spill bytes) of the dq kernel in ptxas's lines."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if 'Compiling entry' in ln and 'flash_attention_dq_kernel' in ln:
            rest = ' '.join(lines[i + 1:i + 4])
            regs = re.search(r'Used (\d+) registers', rest)
            spill = sum(int(n) for n in re.findall(
                r'(\d+) bytes spill (?:stores|loads)', rest))
            return int(regs.group(1)) if regs else None, spill
    return None, None


def _entry(lib):
    fn = lib.mx_flash_attention_dq
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn


def _dq_float64(q, k, v, out, lse, do, scale):
    """dq as ``_p_block`` orders it, every length whole, in float64."""
    q, k, v, out, lse, do = (t.double() for t in (q, k, v, out, lse, do))
    p = (q @ k.transpose(-1, -2) * scale - lse[..., None]).exp()
    delta = (do * out).sum(-1)
    return (p * (do @ v.transpose(-1, -2) - delta[..., None]) * scale) @ k


def main():
    import torch
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import _build
    if not torch.cuda.is_available():
        raise RuntimeError('probe_dq_variants: no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    started = {n: _build_variant(_build, n, subs)
               for n, (_, subs) in VARIANTS.items()}
    _build.build('flash_attention_bwd')
    built = {}
    for name, (proc, so) in started.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed on variant %s:\n%s'
                               % (name, err.decode('utf-8', 'replace')))
        built[name] = (_entry(ctypes.CDLL(so)),
                       _resources((out + err).decode('utf-8', 'replace')))

    gen = torch.Generator(device='cpu').manual_seed(3)
    b, h, s, d = 96, 12, 128, 64
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen).cuda()
                   for _ in range(4))
    lens = torch.full((b,), s, dtype=torch.int32, device='cuda')
    out, lse = kernels.flash_attention_with_lse(q, k, v, lens)
    want = kernels.flash_attention_dq_reference(q, k, v, out, lse, do, lens)
    exact = _dq_float64(q, k, v, out, lse, do, 1.0 / 8)
    inputs = (q, k, v, out, lse, do, lens)

    def call(fn):
        def run(q, k, v, out, lse, do, lens):
            dq = torch.empty_like(q)
            p = [ctypes.c_void_p(t.data_ptr())
                 for t in (q, k, v, out, lse, do, lens, dq)]
            err = fn(*p, b, h, s, s, d, 1.0 / 8, 0, ctypes.c_void_p(
                torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError('dq variant launch failed: %d' % err)
            return dq
        return run

    fns = {'built': kernels.flash_attention_dq}
    fns.update((n, call(fn)) for n, (fn, _) in built.items())
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(cold_copies(nbytes) - 1)]
    times = {n: [] for n in fns}
    for name in list(fns) + list(fns)[::-1]:
        fn = fns[name]
        times[name].append(slope_ms(
            torch, lambda i, fn=fn: fn(*copies[i % len(copies)])))
    for name, fn in fns.items():
        dq = fn(*inputs)
        rel = ((dq - want).abs().max() / want.abs().max()).item()
        rel64 = ((dq.double() - exact).abs().max()
                 / exact.abs().max()).item()
        regs, spill = (None, None) if name == 'built' else built[name][1]
        what = 'the built kernel' if name == 'built' else VARIANTS[name][0]
        print('dq %-10s device ms %s, rel_err %.3g (float64 %.3g), '
              'registers %s, spill %s bytes: %s'
              % (name, ' / '.join('%.4f' % t for t in times[name]), rel,
                 rel64, regs, spill, what), flush=True)
    rel = ((want.double() - exact).abs().max() / exact.abs().max()).item()
    print('dq plain version: rel_err against float64 %.3g' % rel,
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

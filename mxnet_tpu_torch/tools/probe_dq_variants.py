"""Time the flash-attention backward kernels (dq, dk/dv) beside variants of
their source on the card, at the training shape (B 96, H 12, S 128, D 64,
non-causal).

    python -m mxnet_tpu_torch.tools.probe_dq_variants [dq|dkv]

Without an argument both families run, dq first. Each variant is
``csrc/flash_attention_bwd.cu`` with a few exact text substitutions (each
must occur once), built with the port's nvcc flags into the ignored
``ops/kernels/_build/variants/`` and called through the same C entry
point as the built kernel on the same inputs. The two kernels share
``split`` and ``mma3``, so ``cvt_rna``, ``no_split`` and ``1xtf32`` change
both; ``expf`` changes the family's own exponential line, and dk/dv's
tile candidates (``mt1``: one m16 tile a warp, 64 keys a block;
``bq16``, ``bq64``: 16 or 64 queries a tile) change its constants. The kernels run
in turns (built, variants, variants reversed, built), each timed by the
probe's ``slope_ms`` over inputs rotated past twice the L2. A line a
variant gives its device ms, its max error relative to the max abs of the
plain version and of the float64 gradient (the same expressions on the
card in float64), and the family kernel's registers and spill bytes from
ptxas; the variants that compute something else (``no_split``,
``1xtf32``) measure a cost, not a candidate: 1xTF32 runs a third of the
mma, so the time 3xTF32 adds to it is two thirds of the mma time, and
whether the mma time and the memory time add or overlap follows. ``expf``
measures what ``ex2.approx`` on pre-scaled arguments adds to the error.
Needs a card; raises without one.
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
# what both kernels share (split, mma3): name -> (what it measures,
# [(text, replacement)])
SHARED = {
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
}
EXPF = 'p by expf(s * scale - lse) in place of ex2.approx of the ' \
    'pre-scaled scores'
KV_MT = 'constexpr int MT = 2;  // m16 tiles (16 keys) a warp'
KV_BQ = 'constexpr int BQ = 32;               // queries a tile'
# family -> (kernel name, {variant: (what, [(text, replacement)])})
FAMILIES = {
    'dq': ('flash_attention_dq', dict(SHARED, expf=(EXPF, [(
        'const float ex = exp2f_approx(s[m][n][e] * scale2 - '
        'lse2[m][e >> 1]);',
        'const float ex = expf(s[m][n][e] * scale - lse_i);')]))),
    'dkv': ('flash_attention_dkv', dict(
        SHARED,
        expf=(EXPF, [(
            'const float ex = exp2f_approx(st[m][n][e] * scale2 - '
            'l2[n][e & 1]);',
            'const float ex = expf(st[m][n][e] * scale - lq[n][e & 1]);')]),
        mt1=('one m16 tile (16 keys) a warp, 64 keys a block',
             [(KV_MT, KV_MT.replace('= 2', '= 1'))]),
        bq16=('16-query tiles', [(KV_BQ, KV_BQ.replace('32', '16'))]),
        bq64=('64-query tiles', [(KV_BQ, KV_BQ.replace('32', '64'))]))),
}


def _build_variant(build, family, name, subs):
    src = os.path.join(build._CSRC, 'flash_attention_bwd.cu')
    text = open(src).read()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError('variant %s: %r occurs %d times'
                               % (name, old[:60], text.count(old)))
        text = text.replace(old, new)
    out = os.path.join(build._BUILD_DIR, 'variants')
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, '%s_%s.cu' % (family, name))
    with open(cu, 'w') as f:
        f.write(text)
    so = cu[:-3] + '.so'
    home = build._cuda_home()
    cmd = [os.path.join(home, 'bin', 'nvcc'), *build.NVCC_FLAGS,
           '-I', build._CSRC, '-Xlinker',
           '-rpath=' + os.path.join(home, 'lib64'), '-o', so, cu]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE), so


def _resources(log, kernel):
    """(registers, spill bytes) of ``kernel`` (float32, the one the
    probe times) in ptxas's lines."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if 'Compiling entry' in ln and re.search(kernel + '_kernelE', ln):
            rest = ' '.join(lines[i + 1:i + 4])
            regs = re.search(r'Used (\d+) registers', rest)
            spill = sum(int(n) for n in re.findall(
                r'(\d+) bytes spill (?:stores|loads)', rest))
            return int(regs.group(1)) if regs else None, spill
    return None, None


def _entry(lib, family):
    fn = getattr(lib, 'mx_flash_attention_' + family)
    outs = 1 if family == 'dq' else 2
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (7 + outs) + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn


def _float64(q, k, v, out, lse, do, scale):
    """(dq, dk, dv) as ``_p_block`` orders them, every length whole, in
    float64."""
    q, k, v, out, lse, do = (t.double() for t in (q, k, v, out, lse, do))
    p = (q @ k.transpose(-1, -2) * scale - lse[..., None]).exp()
    delta = (do * out).sum(-1)
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None]) * scale
    return ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


def main(argv=None):
    import torch
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import _build
    argv = sys.argv[1:] if argv is None else argv
    families = argv or list(FAMILIES)
    unknown = [f for f in families if f not in FAMILIES]
    if unknown:
        raise SystemExit('probe_dq_variants: unknown family %s (have %s)'
                         % (unknown, ' '.join(FAMILIES)))
    if not torch.cuda.is_available():
        raise RuntimeError('probe_dq_variants: no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    started = {(f, n): _build_variant(_build, f, n, subs)
               for f in families
               for n, (_, subs) in FAMILIES[f][1].items()}
    _build.build('flash_attention_bwd')
    built = {}
    for (family, name), (proc, so) in started.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed on variant %s %s:\n%s'
                               % (family, name,
                                  err.decode('utf-8', 'replace')))
        built[family, name] = (
            _entry(ctypes.CDLL(so), family),
            _resources((out + err).decode('utf-8', 'replace'),
                       FAMILIES[family][0]))

    gen = torch.Generator(device='cpu').manual_seed(3)
    b, h, s, d = 96, 12, 128, 64
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen).cuda()
                   for _ in range(4))
    lens = torch.full((b,), s, dtype=torch.int32, device='cuda')
    out, lse = kernels.flash_attention_with_lse(q, k, v, lens)
    inputs = (q, k, v, out, lse, do, lens)
    plain = kernels.flash_attention_backward_reference(*inputs)
    exact = _float64(q, k, v, out, lse, do, 1.0 / 8)
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(cold_copies(nbytes) - 1)]
    for family in families:
        kernel, variants = FAMILIES[family]
        grads = slice(0, 1) if family == 'dq' else slice(1, 3)

        def call(fn):
            def run(q, k, v, out, lse, do, lens):
                res = [torch.empty_like(t)
                       for t in ((q,) if family == 'dq' else (k, v))]
                p = [ctypes.c_void_p(t.data_ptr())
                     for t in (q, k, v, out, lse, do, lens, *res)]
                err = fn(*p, b, h, s, s, d, 1.0 / 8, 0, ctypes.c_void_p(
                    torch.cuda.current_stream().cuda_stream))
                if err:
                    raise RuntimeError('%s variant launch failed: %d'
                                       % (family, err))
                return res[0] if family == 'dq' else tuple(res)
            return run

        fns = {'built': getattr(kernels, kernel)}
        fns.update((n, call(built[family, n][0])) for n in variants)
        times = {n: [] for n in fns}
        for name in list(fns) + list(fns)[::-1]:
            fn = fns[name]
            times[name].append(slope_ms(
                torch, lambda i, fn=fn: fn(*copies[i % len(copies)])))
        for name, fn in fns.items():
            got = fn(*inputs)
            got = [got] if family == 'dq' else list(got)
            rel = max(((a - w).abs().max() / w.abs().max()).item()
                      for a, w in zip(got, plain[grads]))
            rel64 = max(((a.double() - w).abs().max()
                         / w.abs().max()).item()
                        for a, w in zip(got, exact[grads]))
            regs, spill = ((None, None) if name == 'built'
                           else built[family, name][1])
            what = 'the built kernel' if name == 'built' else \
                variants[name][0]
            print('%s %-10s device ms %s, rel_err %.3g (float64 %.3g), '
                  'registers %s, spill %s bytes: %s'
                  % (family, name, ' / '.join('%.4f' % t
                                             for t in times[name]),
                     rel, rel64, regs, spill, what), flush=True)
        rel = max(((w.double() - x).abs().max() / x.abs().max()).item()
                  for w, x in zip(plain[grads], exact[grads]))
        print('%s plain version: rel_err against float64 %.3g'
              % (family, rel), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

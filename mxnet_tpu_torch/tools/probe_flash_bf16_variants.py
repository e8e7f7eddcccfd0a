"""Time the bf16 tensor-core flash kernels (the forward, dq, dk/dv) beside
variants of their sources on the card, at AMP's training shape (B 96, H
12, S 128, D 64, non-causal, bf16).

    python -m mxnet_tpu_torch.tools.probe_flash_bf16_variants [fwd|dq|dkv]

Without an argument every family runs, the forward first. Each variant is
``csrc/flash_attention_{fwd,dq,dkv}_bf16.cu`` (``_build.source_text``: the
headers inlined) with exact text substitutions (each must occur once),
built with the port's nvcc flags into the ignored
``ops/kernels/_build/variants/`` and called through the same C entry
point as the built kernel on the same inputs. ``lb1`` asks for one block
an SM (``__launch_bounds__(THREADS, 1)``): no register limit of 128, so
no spill, against the built two blocks an SM that spill a little.
``vlate`` (the forward) commits the first V tile as a cp.async group of
its own and waits for it only before P.V, so its copy runs under S and
the softmax: whether the first tile's load latency is what the forward
waits on. dq's ``ks64`` takes 64 keys a step (S, dP and dQ in 32 + 32 +
32 floats a thread, fewer ldmatrix of Q and dO), ``bk64`` 64-key tiles
(64 KB of shared memory a block, two tiles at S 128, the second loading
while the first is computed). The
kernels run in turns (built, variants, variants reversed, built), each
timed by the probe's ``slope_ms`` over inputs rotated past twice the L2
(the library's time at this shape is chip_smoke.py's). A line a variant
gives its device ms, whether its outputs are bitwise the built kernel's
(the same arithmetic), and its registers and spill bytes (stores +
loads) from ptxas; the built kernel's only where this call built its
library. Needs a card; raises without one.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

from mxnet_tpu_torch.tools.probe_matmul_pipeline import (card, cold_copies,
                                                          slope_ms)

LB = '__launch_bounds__(THREADS, 2)'
# the forward's first K/V copies, and its wait before a tile
FWD_KV0 = ('    stage_rows<BK, THREADS>(kv0 + TILE, vb, 0, sk, t);\n'
           '    cp_async_commit();')
FWD_WAIT = '    cp_async_wait_all();  // K(j), V(j) and (j == 0) Q have landed'
FWD_PV = '    product_pv<BK / 16>(o, s, kt + TILE, lane);'
# dq's keys a step and keys a tile
DQ_KS = 'constexpr int KS = 32;   // keys a step'
DQ_BK = 'constexpr int BK = 128;  // keys a tile'
# family -> (source, {variant: (what, [(text, replacement)])})
FAMILIES = {
    'fwd': ('flash_attention_fwd_bf16', {
        'lb1': ('one block an SM, no register limit of 128',
                [(LB, LB.replace('2)', '1)'))]),
        'vlate': ('the first V tile in a cp.async group of its own, waited '
                  'for after the softmax: its copy runs under S', [
                      (FWD_KV0, '    cp_async_commit();\n' + FWD_KV0),
                      (FWD_WAIT, '    if (j == 0)\n'
                       '      asm volatile("cp.async.wait_group 1;\\n" ::: '
                       '"memory");\n    else\n  ' + FWD_WAIT),
                      (FWD_PV, '    if (j == 0) {\n'
                       '      if (ntiles > 1)\n'
                       '        asm volatile("cp.async.wait_group 1;\\n" ::: '
                       '"memory");\n'
                       '      else\n        cp_async_wait_all();\n'
                       '      __syncthreads();\n    }\n' + FWD_PV)])}),
    'dq': ('flash_attention_dq_bf16', {
        'lb1': ('one block an SM, no register limit of 128',
                [(LB, LB.replace('2)', '1)'))]),
        'ks64': ('64 keys a step: one step a tile',
                 [(DQ_KS, DQ_KS.replace('32', '64'))]),
        'bk64': ('64-key tiles, 64 KB a block',
                 [(DQ_BK, DQ_BK.replace('128', '64 '))])}),
    'dkv': ('flash_attention_dkv_bf16', {
        'lb1': ('one block an SM, no register limit of 128',
                [(LB, LB.replace('2)', '1)'))])}),
}


def _build_variant(build, source, name, subs):
    text = build.source_text(source)
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError('variant %s: %r occurs %d times'
                               % (name, old[:60], text.count(old)))
        text = text.replace(old, new)
    out = os.path.join(build._BUILD_DIR, 'variants')
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, '%s_%s.cu' % (source, name))
    with open(cu, 'w') as f:
        f.write(text)
    so = cu[:-3] + '.so'
    home = build._cuda_home()
    cmd = [os.path.join(home, 'bin', 'nvcc'), *build.NVCC_FLAGS, '-Xlinker',
           '-rpath=' + os.path.join(home, 'lib64'), '-o', so, cu]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE), so


def _resources(log):
    """(registers, spill bytes: stores + loads) of the one kernel in
    ptxas's lines."""
    regs = re.search(r'Used (\d+) registers', log)
    spill = sum(int(n) for n in re.findall(
        r'(\d+) bytes spill (?:stores|loads)', log))
    return int(regs.group(1)) if regs else None, spill


# pointers of each family's entry: fwd q, k, v, lengths, out, lse; dq q,
# k, v, out, lse, do, lengths, dq; dkv the same with dk, dv
POINTERS = {'fwd': 6, 'dq': 8, 'dkv': 9}


def _entry(lib, family):
    fn = getattr(lib, 'mx_flash_attention_%s_bf16' % family)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * POINTERS[family] + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn


def main(argv=None):
    import torch
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import _build
    argv = sys.argv[1:] if argv is None else argv
    families = argv or list(FAMILIES)
    unknown = [f for f in families if f not in FAMILIES]
    if unknown:
        raise SystemExit('probe_flash_bf16_variants: unknown family %s '
                         '(have %s)' % (unknown, ' '.join(FAMILIES)))
    if not torch.cuda.is_available():
        raise RuntimeError('probe_flash_bf16_variants: no CUDA device')
    print(card(), flush=True)
    started = {(f, n): _build_variant(_build, FAMILIES[f][0], n, subs)
               for f in families
               for n, (_, subs) in FAMILIES[f][1].items()}
    shipped = _build.build_all()
    built = {}
    for (family, name), (proc, so) in started.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed on variant %s %s:\n%s'
                               % (family, name,
                                  err.decode('utf-8', 'replace')))
        built[family, name] = (_entry(ctypes.CDLL(so), family), _resources(
            (out + err).decode('utf-8', 'replace')))

    bf = torch.bfloat16
    gen = torch.Generator(device='cpu').manual_seed(3)
    b, h, s, d = 96, 12, 128, 64
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to('cuda', bf)
                   for _ in range(4))
    lens = torch.full((b,), s, dtype=torch.int32, device='cuda')
    out, lse = kernels.flash_attention_with_lse(q, k, v, lens)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for family in families:
        source, variants = FAMILIES[family]
        inputs = ((q, k, v, lens) if family == 'fwd'
                  else (q, k, v, out, lse, do, lens))
        nbytes = sum(t.numel() * t.element_size() for t in inputs)
        copies = [inputs] + [tuple(t.clone() for t in inputs)
                             for _ in range(cold_copies(nbytes) - 1)]

        def call(fn, family=family):
            def run(*t):
                res = {'fwd': [torch.empty_like(t[0]), torch.empty(
                    t[0].shape[:3], device='cuda')],
                    'dq': [torch.empty_like(t[0])],
                    'dkv': [torch.empty_like(t[1]), torch.empty_like(t[2])]
                }[family]
                p = [ctypes.c_void_p(x.data_ptr()) for x in (*t, *res)]
                err = fn(*p, b, h, s, s, d, 1.0 / 8, 0, stream)
                if err:
                    raise RuntimeError('%s variant launch failed: %d'
                                       % (family, err))
                return tuple(res)
            return run

        fns = {'built': {'fwd': kernels.flash_attention_with_lse,
                         'dq': lambda *t: (kernels.flash_attention_dq(*t),),
                         'dkv': kernels.flash_attention_dkv}[family]}
        fns.update((n, call(built[family, n][0])) for n in variants)
        times = {n: [] for n in fns}
        for name in list(fns) + list(fns)[::-1]:
            fn = fns[name]
            times[name].append(slope_ms(
                torch, lambda i, fn=fn: fn(*copies[i % len(copies)])))
        want = fns['built'](*inputs)
        regs = (_resources(' '.join(shipped[source])) if source in shipped
                else ('not reported (the library was current)', None))
        for name, fn in fns.items():
            got = fn(*inputs)
            same = all(torch.equal(a, w) for a, w in zip(got, want))
            r, spill = regs if name == 'built' else built[family, name][1]
            what = ('the built kernel' if name == 'built'
                    else variants[name][0])
            print('%s %-6s device ms %s, bitwise the built kernel %s, '
                  'registers %s, spill %s bytes: %s'
                  % (family, name, ' / '.join('%.4f' % t
                                             for t in times[name]),
                     same, r, spill, what), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

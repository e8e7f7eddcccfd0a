"""Time the flash decode kernel stopped after each of its stages, on the
card, at the serving slice's decode widths (8 slots, 12 heads, D 64).

    python -m mxnet_tpu_torch.tools.probe_decode_stages [--against DIR]

Each variant is ``csrc/flash_decode_fwd.cu`` with one exact text
substitution (it must occur once), built with the port's nvcc flags into
the ignored ``ops/kernels/_build/variants/`` and called through the same
C entry point on the same inputs. Every CTA of a
variant that stops early stops at the same point, after the cluster
barriers before it, so none waits at a barrier for a CTA that left and
none reads the shared memory of one that left:

  * ``launch``: every CTA returns once it has read its slot's position;
  * ``scored``: every CTA returns just before the first cluster barrier:
    the K and V tile staged, the keys scored, the tile max taken;
  * ``weighted``: every CTA returns after one more cluster barrier that
    follows the weights: the running max over distributed shared memory,
    rescale, the weights and their sum;
  * ``no_wait``: the whole kernel without the hand-off's wait: each CTA
    folds from whatever its accumulators hold (the output is wrong; the
    time the chain's waits leave out);
  * ``built``: the kernel as built;
  * ``against`` (with ``--against DIR``): ``DIR/flash_decode_fwd.cu`` as
    it stands, built with ``-I DIR``, for example the csrc directory of an
    earlier commit unpacked by ``git archive``; its entry point must take
    the same arguments. The SASS of its slot-cache kernel (``cuobjdump
    -sass``, addresses and encodings dropped) is first compared with the
    built slot instance's, line by line.

Configurations, each slot at one position: max_len 128 (a cluster of one
CTA) and 512 (of four) at position 127 (one tile, no chain), 255 and 383
(two and three tiles), and 512 at 511 (four tiles, a chain of four); then
the decode kernel's timed case in ``chip_smoke.py`` (0, 127, 128, 511, 5,
300, 64, 256); then the positions of ``chip_smoke.py``'s serving run
(phase 3: 16 prompts of 8-256 tokens drawn with seed 0, 8 slots, max_len
512, 32 new tokens), each wave of eight prompts 16 tokens into its new
ones. Each kernel is timed by the probe's ``slope_ms`` over inputs
rotated past twice the L2, in turns (built, the variants, the variants
reversed, built); a line a configuration gives each one's two times and
the bytes bound (K and V rows read once at 3.35 TB/s). Needs a card;
raises without one.
"""
from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess
import sys

from mxnet_tpu_torch.tools.probe_matmul_pipeline import (card, cold_copies,
                                                          slope_ms)

HEADS, D, SLOTS = 12, 64, 8
SERVING_POSITIONS = (0, 127, 128, 511, 5, 300, 64, 256)
# chip_smoke.py phase 3's prompt lengths
# (numpy RandomState(0).randint(8, 257, 16)), 16 tokens on
PHASE3_PROMPTS = (180, 55, 125, 200, 75, 203, 111, 17,
                  219, 29, 250, 44, 95, 78, 224, 96)
PHASE3_WAVES = tuple(tuple(n + 16 for n in PHASE3_PROMPTS[w:w + SLOTS])
                     for w in (0, SLOTS))
CONFIGS = ((128, (127,) * SLOTS), (512, (127,) * SLOTS),
           (512, (255,) * SLOTS), (512, (383,) * SLOTS),
           (512, (511,) * SLOTS), (512, SERVING_POSITIONS),
           *((512, wave) for wave in PHASE3_WAVES))
PEAK_BYTES_S = 3.35e12
QS_LINE = ('  if (t < DP)\n'
           '    sm.qs[t] = t < d ? __fmul_rn(q[(size_t)slot * units + h * d '
           '+ t], scale)\n'
           '                     : 0.f;\n')
TMAX_SYNC = ('    if (!alone) cluster_sync();  // every tile max of the round '
             'is written\n')
CARRY = '    if (t == 0 && g + 1 < rounds) {\n'
WAIT = ('        mbar_wait_cluster(smem_u32(&sm.bar), waits & 1u);\n'
        '        if (t == 0) mbar_expect_tx(smem_u32(&sm.bar), '
        'HANDOFF_BYTES);\n')
VARIANTS = {
    'launch': [(QS_LINE, QS_LINE + '  if (pos > -2) return;\n')],
    'scored': [(TMAX_SYNC, '    cp_async_wait<0>();\n    return;\n'
                + TMAX_SYNC)],
    'weighted': [(CARRY, '    if (!alone) cluster_sync();\n    return;\n'
                  + CARRY)],
    'no_wait': [(WAIT, '')],
}


def _build_variant(build, name, subs, csrc=None):
    csrc = csrc or build._CSRC
    src = os.path.join(csrc, 'flash_decode_fwd.cu')
    text = open(src).read()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError('variant %s: %r occurs %d times'
                               % (name, old[:60], text.count(old)))
        text = text.replace(old, new)
    out = os.path.join(build._BUILD_DIR, 'variants')
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, 'decode_%s.cu' % name)
    with open(cu, 'w') as f:
        f.write(text)
    so = cu[:-3] + '.so'
    home = build._cuda_home()
    cmd = [os.path.join(home, 'bin', 'nvcc'), *build.NVCC_FLAGS,
           '-I', csrc, '-Xlinker',
           '-rpath=' + os.path.join(home, 'lib64'), '-o', so, cu]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE), so


def _slot_sass(build, so):
    """The SASS instructions of the slot-cache decode kernel in library
    ``so`` (the one ``flash_decode_fwd_kernel`` that is not the paged
    instance), addresses and encodings dropped."""
    tool = os.path.join(build._cuda_home(), 'bin', 'cuobjdump')
    text = subprocess.run([tool, '-sass', so], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    fns, fn = {}, None
    for line in text.splitlines():
        head = re.search(r'Function : (\S+)', line)
        if head:
            fn = head.group(1)
            fns[fn] = []
        else:
            ins = re.match(r'\s*/\*[0-9a-f]+\*/\s*(.*?)\s*;', line)
            if fn and ins:
                fns[fn].append(ins.group(1))
    slot = [f for f in fns
            if 'flash_decode_fwd_kernel' in f and 'PagedRows' not in f]
    if len(slot) != 1:
        raise RuntimeError('%s: no single slot decode kernel in %s'
                           % (so, sorted(fns)))
    return fns[slot[0]]


def _entry(lib):
    fn = lib.mx_flash_decode_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    return fn


def main(argv=None):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('probe_decode_stages needs a CUDA card')
    from mxnet_tpu_torch.ops.kernels import _build
    argv = list(sys.argv[1:] if argv is None else argv)
    against = None
    if argv[:1] == ['--against'] and len(argv) == 2:
        against = os.path.abspath(argv[1])
    elif argv:
        raise SystemExit('usage: probe_decode_stages [--against DIR]')
    dev = torch.device('cuda')
    print(card(), flush=True)
    procs = {name: _build_variant(_build, name, subs)
             for name, subs in VARIANTS.items()}
    if against:
        procs['against'] = _build_variant(_build, 'against', [], against)
    fns = {'built': _entry(ctypes.CDLL(_build.build('flash_decode_fwd')))}
    for name, (proc, so) in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed on variant %s:\n%s'
                               % (name, err.decode('utf-8', 'replace')))
        fns[name] = _entry(ctypes.CDLL(so))
    if against:
        built = _slot_sass(_build, _build.library_path('flash_decode_fwd'))
        other = _slot_sass(_build, procs['against'][1])
        differ = sum(a != b for a, b in zip(built, other)) + abs(
            len(built) - len(other))
        print('slot decode kernel SASS: built %d instructions, against %d, '
              '%d lines differ' % (len(built), len(other), differ),
              flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device='cpu').manual_seed(0)
    units = HEADS * D
    scale = 1.0 / math.sqrt(D)
    names = list(procs)
    order = ['built'] + names + names[::-1] + ['built']
    for max_len, positions in CONFIGS:
        q = torch.randn(SLOTS, units, generator=gen).to(dev)
        keys, values = (torch.randn(SLOTS, max_len, units,
                                    generator=gen).to(dev)
                        for _ in range(2))
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        nbytes = keys.numel() * 4 * 2
        copies = [(keys, values)] + [(keys.clone(), values.clone())
                                     for _ in range(cold_copies(nbytes) - 1)]

        def launch(fn):
            def run(i):
                k, v = copies[i % len(copies)]
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         pos.data_ptr(), out.data_ptr(), SLOTS, max_len,
                         units, HEADS, D, scale, stream)
                if err:
                    raise RuntimeError('decode launch failed: %d' % err)
            return run

        times = {}
        for name in order:
            times.setdefault(name, []).append(
                slope_ms(torch, launch(fns[name])))
        live = sum(min(p, max_len - 1) + 1 for p in positions)
        bound = 2 * live * units * 4 / PEAK_BYTES_S * 1e3
        print('decode stages max_len %d positions %s (bytes bound %.4f '
              'ms): %s' % (max_len, list(positions), bound, ', '.join(
                  '%s %s' % (n, ' / '.join('%.4f' % t for t in times[n]))
                  for n in ['built'] + names)), flush=True)
        del copies
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

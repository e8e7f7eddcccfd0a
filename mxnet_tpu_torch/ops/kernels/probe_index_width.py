"""Probe on one card: the epilogue kernels with 32-bit against 64-bit
element indices, at ResNet-50's stem shape (batch 128).

    python3 -m mxnet_tpu_torch.ops.kernels.probe_index_width

``csrc/epilogue.cu`` indexes in 32 bits (``using Idx = uint32_t`` in the
``csrc/stream.cuh`` it includes). This
builds it twice more into the git-ignored ``_build/`` directory, once
with that line as it is and once with ``uint64_t``, calls each C entry
point directly, and prints for each kernel the median of 30 CUDA-event
timings after 5 warm-up calls, in four rounds that alternate which build
runs first. Beside them it times the 32-bit kernels through their Python
wrappers (the package's path, one event pair around each call as
``chip_smoke.py`` times them), and tries ``aten._add_relu``, the one
PyTorch call that computes ``relu(x + y)``, on the card.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess

import torch

from . import _build, epilogue

_IDX = 'using Idx = uint32_t;'
STEM, JOIN = (128, 64, 112, 112), (128, 256, 56, 56)


def _time_ms(fn, iters=30, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _build_variants():
    """{'32': CDLL, '64': CDLL} of csrc/epilogue.cu with either index."""
    src = _build.source_text('epilogue')
    if _IDX not in src:
        raise RuntimeError('csrc/stream.cuh no longer declares %r' % _IDX)
    home = _build._cuda_home()
    os.makedirs(_build._BUILD_DIR, exist_ok=True)
    procs = {}
    for bits, idx in (('32', 'uint32_t'), ('64', 'uint64_t')):
        stem = os.path.join(_build._BUILD_DIR, 'probe_epilogue_idx%s' % bits)
        with open(stem + '.cu', 'w') as f:
            f.write(src.replace(_IDX, 'using Idx = %s;' % idx))
        cmd = [os.path.join(home, 'bin', 'nvcc'), *_build.NVCC_FLAGS,
               '-Xlinker', '-rpath=' + os.path.join(home, 'lib64'),
               '-o', stem + '.so', stem + '.cu']
        procs[bits] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE), stem)
    libs = {}
    for bits, (proc, stem) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed (%s-bit):\n%s'
                               % (bits, err.decode('utf-8', 'replace')))
        libs[bits] = ctypes.CDLL(stem + '.so')
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit('probe_index_width: needs a CUDA card')
    libs = _build_variants()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(5)
    x, g = (torch.randn(STEM, generator=gen, device=dev) for _ in range(2))
    c, inner, n = STEM[1], STEM[2] * STEM[3], x.numel()
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    mean, beta = (torch.randn(c, generator=gen, device=dev)
                  for _ in range(2))
    xj, yj = (torch.randn(JOIN, generator=gen, device=dev) for _ in range(2))
    out, outj = torch.empty_like(x), torch.empty_like(xj)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    s = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    big, nj, zero = ctypes.c_longlong, ctypes.c_longlong(xj.numel()), \
        ctypes.c_float(0.0)
    geom = epilogue.epilogue_geometry(n)
    stream_args = (int(geom.evict), big(geom.tiles))
    bn = epilogue.bn_geometry(n, c, inner)
    # identity (code 0) for the BN apply, relu (code 1) for the acts
    bn_args = (big(n), big(c), big(inner), ctypes.c_uint(bn.inner.mul),
               bn.inner.shift, ctypes.c_uint(bn.c.mul), bn.c.shift, 0, zero,
               *stream_args)
    direct = {
        'bn_act_fwd': lambda lib: lib.mx_bn_act_fwd(
            p(x), p(scale), p(mean), p(beta), p(out), *bn_args, s()),
        'bn_act_bwd': lambda lib: lib.mx_bn_act_bwd(
            p(g), p(x), p(scale), p(out), *bn_args, s()),
        'act_fwd': lambda lib: lib.mx_act_fwd(p(x), p(out), big(n), 1, zero,
                                              *stream_args, s()),
        'act_bwd': lambda lib: lib.mx_act_bwd(p(g), p(x), p(out), big(n), 1,
                                              zero, *stream_args, s()),
        'add_act_fwd': lambda lib: lib.mx_add_act_fwd(
            p(xj), p(yj), p(outj), nj, 1, zero, s()),
    }
    wrapped = {
        'bn_act_fwd': lambda: epilogue.bn_act_forward(x, scale, mean, beta),
        'bn_act_bwd': lambda: epilogue.bn_act_backward(g, x, scale),
        'act_fwd': lambda: epilogue.act_forward(x, 'relu'),
        'act_bwd': lambda: epilogue.act_backward(g, x, 'relu'),
        'add_act_fwd': lambda: epilogue.add_act_forward(xj, yj, 'relu'),
    }
    times = {k: {'32': [], '64': []} for k in direct}
    for order in (('32', '64'), ('64', '32')) * 2:
        for bits in order:
            for name, call in direct.items():
                times[name][bits].append(
                    _time_ms(lambda: call(libs[bits])))
    for name, t in times.items():
        print('%s %s: 32-bit %s (median %.4f ms), 64-bit %s (median %.4f '
              'ms), through the wrapper %.4f ms'
              % (name, STEM if name != 'add_act_fwd' else JOIN,
                 ['%.4f' % v for v in t['32']], statistics.median(t['32']),
                 ['%.4f' % v for v in t['64']], statistics.median(t['64']),
                 _time_ms(wrapped[name])))
    try:
        torch.ops.aten._add_relu(xj, yj)
        print('aten._add_relu runs on the card: %.4f ms'
              % _time_ms(lambda: torch.ops.aten._add_relu(xj, yj)))
    except NotImplementedError as exc:
        print('aten._add_relu does not run on the card: %s'
              % str(exc).splitlines()[0])


if __name__ == '__main__':
    main()

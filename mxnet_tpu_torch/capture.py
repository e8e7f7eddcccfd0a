"""Captured programs: one CUDA graph a program, the port's counterpart of
the reference's compiled executables (``jax.jit(fn).lower(...).compile()``
in ``mxnet_tpu/serving/decode/program.py`` ``_build`` and
``mxnet_tpu/parallel/train_step.py`` ``_build``).

A program is a *body*: a function that reads its inputs from static
buffers and writes its results to static buffers (or to state that stays
where it is: a cache, parameters), with no host sync and no host scalar
that changes between calls. :class:`Program` captures one call of the
body into a ``torch.cuda.CUDAGraph`` on a card, after one eager warm-up
call when one is given, and :meth:`Program.run` replays it; on the CPU
the body runs as it is, the plain version of the program.

The launch counts follow the replays: what the capture launches is
recorded (``ops/kernels/_launch.py`` :class:`recording`) and added once a
replay; a warm-up whose work the caller undoes counts nothing.

Nothing falls back: a capture that fails raises :class:`CaptureError`,
and the caller never runs the body eagerly on the card in its place; one
that fails while the profiler's ``torch.profiler`` session runs
(``mxnet_tpu_torch/profiler.py``) raises :class:`ProfilerCaptureError`,
which names it.
"""
from __future__ import annotations

import gc
import time

import torch

from . import profiler as _profiler
from .ops.kernels._launch import add_counts, recording

__all__ = ['CaptureError', 'ProfilerCaptureError', 'Program']


class CaptureError(RuntimeError):
    """A program could not be captured as a CUDA graph."""


class ProfilerCaptureError(CaptureError):
    """A program could not be captured as a CUDA graph while the
    profiler's ``torch.profiler`` session ran."""


class Program:
    """``body`` as a captured program on ``device``.

    On a CUDA ``device``: ``warm`` (if given) runs once on a side stream,
    its counts discarded (it must leave the state as it found it), then
    one call of ``body`` is captured into a graph over ``pool``, each
    ``generators`` entry (a CUDA ``torch.Generator`` the body draws from)
    registered with it, so that each replay draws what the next eager
    call would, and the body is dropped. With ``device`` None or the CPU,
    :meth:`run` calls the body as it is. ``seconds``: the warm-up and
    capture time."""

    __slots__ = ('name', 'body', 'graph', 'counts', 'seconds')

    def __init__(self, name, body, device, pool=None, generators=(),
                 warm=None):
        self.name = name
        self.body = body
        self.graph = self.counts = None
        t0 = time.perf_counter()
        if device is not None and device.type == 'cuda':
            with torch.cuda.device(device):
                if warm is not None:
                    _warm_up(warm, device)
                self.graph, self.counts = _capture(name, body, pool,
                                                   generators)
            # a replay needs no body: let its closure (and whatever owns
            # this program through it) go with refcounts, not a cycle
            self.body = None
        self.seconds = time.perf_counter() - t0

    def run(self):
        """Replay the graph (its launch counts added), or call the body
        on the CPU."""
        if self.graph is None:
            return self.body()
        self.graph.replay()
        add_counts(self.counts)
        return None


def _warm_up(warm, device):
    """``warm`` on a side stream (the warm-up the graph recipe asks for:
    libraries, handles and plans made before the capture)."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side), recording():
        warm()
    main.wait_stream(side)
    torch.cuda.synchronize(device)


def _capture(name, body, pool, generators):
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        register = getattr(graph, 'register_generator_state', None)
        if register is None:
            raise CaptureError(
                '%s: this PyTorch (%s) cannot register a torch.Generator '
                'with a CUDA graph (CUDAGraph.register_generator_state), '
                'so replays would repeat one draw' % (name, torch.__version__))
        register(gen)
    # no garbage collection while capturing: a dead reference cycle that
    # still holds an earlier program's graph, collected mid-capture, would
    # destroy that graph inside this capture and invalidate it
    # (cudaErrorStreamCaptureInvalidated); torch.cuda.graph no longer
    # collects before it begins
    collecting = gc.isenabled()
    gc.disable()
    try:
        with recording() as rec:
            with torch.cuda.graph(graph, pool=pool):
                body()
    except CaptureError:
        raise
    except Exception as exc:
        hint = ''
        if 'legacy stream' in '%s %s' % (exc, exc.__context__):
            hint = (' (work on the default stream during the capture: for a '
                    'training step, an autograd graph of an earlier backward '
                    'that is still alive holds the parameters\' gradient '
                    'accumulators on that stream; free it first)')
        cls = CaptureError
        if _profiler.torch_session() is not None:
            cls = ProfilerCaptureError
            hint += (' (the profiler\'s torch.profiler session was running: '
                     'capture before mxnet_tpu_torch.profiler.set_state'
                     '(\'run\'), or stop it first)')
        raise cls('%s: the capture failed: %s: %s%s'
                  % (name, type(exc).__name__, exc, hint)) from exc
    finally:
        if collecting:
            gc.enable()
    return graph, rec

"""DecodeProgram: a decode model bound to its weights, a prompt-length
bucket ladder and a preallocated slot cache on one device, and
PagedDecodeProgram over a page pool. The port of
``mxnet_tpu/serving/decode/program.py``.

Two calls serve generation:

  * :meth:`DecodeProgram.run_prefill` pads a prompt to its bucket, runs
    the whole-prompt pass, lands the KV prefix in one cache slot and
    returns the first generated token;
  * :meth:`DecodeProgram.run_step` advances every slot one token.

``sample_args`` (default on, ``MXNET_TPU_SERVE_SAMPLE_ARGS``) builds
temperature / top-p / key sampling (:mod:`.sampling`) into every program
that emits tokens, as fixed-shape inputs beside its tokens (the
reference's ``extras``); a row with temperature 0 takes the greedy argmax
byte for byte. ``logit_mask`` (``MXNET_TPU_SERVE_SAMPLE_MASK``) adds an
additive (rows, vocab) mask input. ``adapter_spec``
(:class:`~..adapters.AdapterSpec`) gives the program a device-resident
adapter pool (:attr:`DecodeProgram.apool`, which an
:class:`~..adapters.AdapterPool` binds and writes in place) and one pool
row a slot as an input, so one program serves every resident adapter.
Greedy and sampled rows, temperatures and adapters change the values in
the programs' static buffers, never the programs.

:class:`PagedDecodeProgram` takes page ids and page tables in their
place, and adds ``run_verify`` (speculative decoding) and
``run_copy_page`` (copy-on-write). ``freeze_decode`` pages a transformer
by default and keeps an RNN on the slot cache, as the JAX package does;
it also freezes gluon RNN blocks (an ``(embedding, rnn, decoder)`` triple
or an object holding them) through ``from_gluon_rnn_lm``. A family
without adapters (``RNNLM``) is called without an ``ad`` argument.

Each call runs a *program*, as the reference's calls run its compiled
executables: one a prefill bucket (``'prefill:<bucket>'``), ``'step'``,
and for the paged program ``'verify:<spec_k + 1>'`` and ``'copy'``, the
reference's keys. :meth:`~DecodeProgram.compile_prefill`,
:meth:`~DecodeProgram.compile_step`, ``compile_verify`` and
``compile_copy_page`` build one, :meth:`~DecodeProgram.warmup` the
reference's set (the engine calls it at start), and a ``run_*`` builds its
program on first use; ``compile_count`` and ``compile_seconds`` account
for them as the reference does, and each program built counts one
``mxnet_tpu_serve_compiles_total`` and records ``serve_compile`` with its
key and seconds. On a card a program is a CUDA graph
(:class:`~mxnet_tpu_torch.capture.Program`), captured after one eager
warm-up call whose cache writes are undone, over static buffers: its
host ints cross in one copy, its tokens and logits come back in one copy
into pinned memory (the logits only with ``emit_logits``). All the
graphs of a program share one memory pool, and they are bound to the
cache the program owns: :meth:`~DecodeProgram.new_cache` hands out that
storage, zeroed in place, never a new one. On the CPU the same bodies run
uncaptured. A call's extras (temperatures, top-ps and keys as int32
bits, the mask, the adapter rows) cross in the same one copy as its ints;
omitted ones take the neutral values (greedy, no mask, the base).

Live migration reads and writes the program's own storage in place:
:meth:`DecodeProgram.export_slot_state` / ``import_slot_state`` one slot's
rows, :meth:`PagedDecodeProgram.export_pages` / ``import_pages`` the pages
of one sequence (gathered on the card, one copy to the host; one copy to
the card, written into the pool). They run on the caller's current
stream, the stream the programs replay on, so a write lands before the
next replay reads the pool and a read follows the last replay that wrote
it; the captured programs keep their addresses.

:meth:`DecodeProgram.fallback_generate` is the degraded path the engine
completes a stream on after a transient device fault or while its breaker
is open: the model's plain path on the CPU through a one-slot cache, from
a host copy of the parameters taken when the program is made, with the
card's emission rule, so a trip changes latency, not tokens.

:meth:`DecodeProgram.save` writes the reference's decode artifact
(``mxnet_tpu.frozen.v1``, ``kind: decode``: ``MANIFEST.json`` and
``params.npz``) and :meth:`DecodeProgram.load` (``load_decode``) reads
it back, whichever package wrote it: a paged manifest reloads as a
:class:`PagedDecodeProgram`, and the extras (sampling, mask, adapter
pool) are rebuilt from the manifest.
"""
from __future__ import annotations

import io
import json
import os
import threading
import time

import numpy as onp
import torch

from ... import config as _config
from ...capture import Program
from ...context import resolve_device
from ...observability import emit as _emit
from ...resilience.checkpoint import atomic_write_bytes
from ..adapters import AdapterSpec
from ..bucket import BucketPolicy, default_buckets
from ..freeze import FROZEN_SCHEMA
from .cache import cache_bytes, init_cache, write_slot
from .model import DecodeModel, from_gluon_rnn_lm, model_from_config
from .paged import (TRASH_PAGE, copy_page, init_pool, pages_for, pool_bytes,
                    write_prefill_pages)
from .sampling import key_for, sample_tokens

__all__ = ['DecodeProgram', 'PagedDecodeProgram', 'freeze_decode',
           'load_decode']

_DECODE_KIND = 'decode'

# the extras a program may carry: their dtype on the host (each crosses as
# its int32 bits) and the neutral value an omitted one takes
_EXTRAS = {'temps': ('float32', 0.0), 'top_ps': ('float32', 1.0),
           'keys': ('uint32', 0), 'masks': ('float32', 0.0),
           'aidx': ('int32', 0)}


def _as_param(value, device):
    if isinstance(value, torch.Tensor):
        return value.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(onp.asarray(value, dtype='float32'),
                           device=device)


_CPU = torch.device('cpu')


class _Buffers:
    """One program's static buffers: ``inp`` (int32: one segment a host
    input, of ``sizes`` elements each, every one starting on a 16-byte
    boundary as the kernels ask of their int32 inputs; :meth:`arg`) and
    ``out`` (float32: ``ntok`` tokens as int32 bits, padded to a 16-byte
    boundary, then the logits of ``logit_shape``), their host mirrors
    (pinned on a card) and the captured program (``prog``). The last
    inputs are the ``extras`` ((name, shape) each, after the ``len(sizes)
    - len(extras)`` ints)."""

    def __init__(self, device, sizes, ntok=0, logit_shape=(), extras=()):
        self.extras = list(extras)
        self.sizes = list(sizes) + [int(onp.prod(shape))
                                    for _, shape in extras]
        self.starts = [0]
        for n in self.sizes:
            self.starts.append(self.starts[-1] + -(-n // 4) * 4)
        self.ntok = ntok
        self.logit_shape = tuple(logit_shape)
        self.at = -(-ntok // 4) * 4
        n_out = self.at + (int(onp.prod(logit_shape)) if logit_shape else 0)
        pin = device.type == 'cuda'
        n_in = self.starts[-1]
        self.inp = torch.zeros(n_in, dtype=torch.int32, device=device)
        self.out = torch.zeros(n_out, dtype=torch.float32, device=device)
        self.inp_h = torch.zeros(n_in, dtype=torch.int32, pin_memory=pin)
        self.out_h = torch.zeros(n_out, dtype=torch.float32, pin_memory=pin)
        self.done = torch.cuda.Event() if pin else None
        self.prog = None

    def arg(self, i, shape=None):
        """Input ``i``'s segment of ``inp`` (viewed as ``shape``)."""
        seg = self.inp[self.starts[i]:self.starts[i] + self.sizes[i]]
        return seg if shape is None else seg.view(shape)

    def extra_args(self):
        """The extras as tensors viewing ``inp``: float inputs as float32,
        keys and pool rows as int32."""
        base = len(self.sizes) - len(self.extras)
        out = {}
        for j, (name, shape) in enumerate(self.extras):
            seg = self.arg(base + j, shape)
            out[name] = seg.view(torch.float32) \
                if _EXTRAS[name][0] == 'float32' else seg
        return out

    def pack(self, host, arrays):
        """``arrays``, one an input, into the int32 array ``host``."""
        for at, a in zip(self.starts, arrays):
            a = onp.asarray(a, 'int32').reshape(-1)
            host[at:at + a.size] = a
        return host

    def put(self, tokens, logits):
        """The body's results into ``out`` (on the device)."""
        self.out[:self.ntok].view(torch.int32).copy_(tokens.reshape(-1))
        self.out[self.at:].copy_(logits.reshape(-1))

    def load(self, *arrays):
        """Host ints into ``inp``, in one copy (the last call's
        :meth:`fetch` waited for the copy out of ``inp_h`` before)."""
        self.pack(self.inp_h.numpy(), arrays)
        self.inp.copy_(self.inp_h, non_blocking=True)

    def fetch(self, emit_logits):
        """(tokens np int32 (ntok,), logits np | None) in one copy back,
        after the program ran, waiting for the stream (without outputs it
        only waits, so the next :meth:`load` may rewrite ``inp_h``)."""
        m = self.out.numel() if emit_logits else self.ntok
        if m:
            self.out_h[:m].copy_(self.out[:m], non_blocking=True)
        if self.done is not None:
            self.done.record()
            self.done.synchronize()
        if not self.ntok:
            return None, None
        toks = self.out_h[:self.ntok].view(torch.int32).numpy().copy()
        logits = self.out_h[self.at:].numpy().reshape(
            self.logit_shape).copy() if emit_logits else None
        return toks, logits


class DecodeProgram:
    """Prefill/step over a slot cache for one decode model.

    ``params`` is a ``{name: ndarray | tensor}`` dict under the model's
    names (a JAX model's weights carry over as they are). ``device``
    defaults to ``cuda`` and raises without it; ``device='cpu'`` runs the
    plain PyTorch versions of the kernels. ``emit_logits`` returns each
    call's logits to the host beside the tokens, as the JAX default does.
    ``capture`` (True) makes each program a CUDA graph on a card; set it
    False before the first call to run the same bodies uncaptured there
    (the eager reference the replays are held to). ``sample_args`` /
    ``logit_mask`` (None: their knobs) and ``adapter_spec`` choose the
    extras every token-emitting program carries (see the module).
    """

    paged = False
    capture = True
    # verify programs exist on the paged subclass; the extras' key rows
    # read it
    spec_k = 0

    def __init__(self, model, params, slots=None, prefill_buckets=None,
                 name=None, emit_logits=True, device=None, sample_args=None,
                 logit_mask=None, adapter_spec=None):
        if not isinstance(model, DecodeModel):
            raise TypeError('DecodeProgram wraps a DecodeModel; got %s'
                            % type(model).__name__)
        self.model = model
        self.device = resolve_device(device)
        self.name = name or '%s-decoder' % model.family
        self.slots = int(slots if slots is not None
                         else _config.get('MXNET_TPU_SERVE_DECODE_SLOTS'))
        if self.slots < 1:
            raise ValueError('slots must be >= 1')
        if prefill_buckets is None:
            prefill_buckets = (
                _config.get('MXNET_TPU_SERVE_PREFILL_BUCKETS')
                or default_buckets(min(
                    _config.get('MXNET_TPU_SERVE_MAX_PREFILL'),
                    model.max_len - 1)))
        self.policy = BucketPolicy(buckets=prefill_buckets)
        if self.policy.max_batch >= model.max_len:
            raise ValueError(
                'top prefill bucket %d leaves no room to generate '
                'within max_len %d'
                % (self.policy.max_batch, model.max_len))
        self.max_len = model.max_len
        self._lock = threading.Lock()
        self.params = {k: _as_param(v, self.device)
                       for k, v in params.items()}
        model.check_params(self.params)
        # the host copy the CPU fallback decodes from, taken once here from
        # what the caller gave: after a real fault the CUDA context may be
        # dead, so a fallback never reads the card's tensors
        with self._lock:
            self._params_host = self.params if self.device == _CPU else {
                k: _as_param(v, _CPU) for k, v in params.items()}
        self._spec = model.cache_spec()
        self.emit_logits = bool(emit_logits)
        self.sample_args = bool(
            sample_args if sample_args is not None
            else _config.get('MXNET_TPU_SERVE_SAMPLE_ARGS'))
        self.logit_mask = bool(
            logit_mask if logit_mask is not None
            else _config.get('MXNET_TPU_SERVE_SAMPLE_MASK'))
        if self.logit_mask and not self.sample_args:
            raise ValueError('logit_mask requires sample_args (the mask '
                             'applies at the sampling point)')
        self.adapter_spec = adapter_spec
        # the pool the programs read: static tensors, rows written in place
        self.apool = None if adapter_spec is None \
            else adapter_spec.device_tree(self.device)
        self._cache = None
        self._compiled = {}           # key -> _Buffers
        self._pool = None             # the graphs' one pool: they never
                                      # run concurrently
        self.compile_seconds = {}
        # the keys a loaded artifact listed as serialized programs: none
        # deserializes here, warmup() builds them (the reference's list
        # of the keys it re-traced)
        self.retraced_buckets = []

    @property
    def prefill_buckets(self):
        return self.policy.buckets

    @property
    def compile_count(self):
        """Programs built (captured on a card) so far."""
        return len(self._compiled)

    def cache_bytes(self):
        """Device bytes of the slot cache (slots x max_len rows)."""
        return cache_bytes(self._spec, self.slots)

    def per_sequence_bytes(self, seq_len=None):
        """Cache bytes one sequence reserves: its whole slot, whatever its
        length (the memory wall the paged cache breaks)."""
        del seq_len
        return cache_bytes(self._spec, 1)

    def _init_cache(self):
        return init_cache(self._spec, self.slots, self.device)

    @torch.inference_mode()
    def new_cache(self):
        """The program's cache, zeroed in place: the storage its programs
        were (or will be) captured against, made at first use."""
        if self._cache is None:
            self._cache = self._init_cache()
        else:
            for t in self._cache.values():
                t.zero_()
        return self._cache

    def _owned(self, cache):
        if self._cache is None:
            self._cache = self._init_cache()
        if cache is not None and cache is not self._cache:
            raise ValueError('%s: the programs run on the cache the program '
                             'owns (new_cache()), not another one'
                             % self.name)
        return self._cache

    def max_prompt_len(self):
        return self.policy.max_batch

    # -- the extras: sampling and adapter inputs ----------------------------

    def _extra_shapes(self, kind):
        """(name, shape) of each extra of a program of ``kind``
        ('prefill' | 'step' | 'verify'); none without sampling or
        adapters, the programs then being the greedy ones."""
        S, V = self.slots, self.model.vocab
        rows = 1 if kind == 'prefill' else S
        out = []
        if self.sample_args:
            krows = S * (self.spec_k + 1) if kind == 'verify' else rows
            out += [('temps', (rows,)), ('top_ps', (rows,)),
                    ('keys', (krows, 2))]
            if self.logit_mask:
                out.append(('masks', (rows, V)))
        if self.adapter_spec is not None:
            out.append(('aidx', (rows,)))
        return out

    def _extra_args(self, kind, temps=None, top_ps=None, keys=None,
                    masks=None, aidx=None):
        """A call's extras as int32 arrays (float32 and uint32 as their
        bits), in the order of :meth:`_extra_shapes`; an omitted one takes
        its neutral value (greedy, no mask, the base adapter)."""
        given = dict(temps=temps, top_ps=top_ps, keys=keys, masks=masks,
                     aidx=aidx)
        out = []
        for name, shape in self._extra_shapes(kind):
            dtype, neutral = _EXTRAS[name]
            v = given[name]
            a = onp.full(shape, neutral, dtype) if v is None \
                else onp.asarray(v, dtype).reshape(shape)
            out.append(a.view('int32'))
        return out

    def _buffers(self, kind, sizes, ntok, logit_shape):
        return _Buffers(self.device, sizes, ntok, logit_shape,
                        self._extra_shapes(kind))

    def _adapters(self, ex, prefill=False):
        """The adapter keyword of a model call: ``{'ad': the pool rows the
        call's ``aidx`` selects}`` (2-D at prefill, one a slot after), or
        ``{}`` without a pool, so a family without ``lora_targets``
        (``RNNLM``) is called without one, as the reference calls it."""
        if self.apool is None:
            return {}
        idx = ex['aidx'].long()
        if prefill:
            return {'ad': {k: (a.index_select(0, idx)[0],
                               b.index_select(0, idx)[0])
                           for k, (a, b) in self.apool.items()}}
        return {'ad': {k: (a.index_select(0, idx), b.index_select(0, idx))
                       for k, (a, b) in self.apool.items()}}

    def _tokens(self, logits, ex):
        """The tokens of ``logits`` (..., V): the argmax, or with sampling
        :func:`~.sampling.sample_tokens` over the rows, each extra's row
        repeated across a verify chunk."""
        if not self.sample_args:
            return torch.argmax(logits, dim=-1)
        V = logits.shape[-1]
        rows = logits.reshape(-1, V)
        rep = rows.shape[0] // ex['temps'].shape[0]
        masks = ex.get('masks')
        if masks is not None:
            masks = masks.repeat_interleave(rep, dim=0)
        toks = sample_tokens(rows, ex['temps'].repeat_interleave(rep),
                             ex['top_ps'].repeat_interleave(rep),
                             ex['keys'], masks)
        return toks.reshape(logits.shape[:-1])

    # -- programs -----------------------------------------------------------

    @torch.inference_mode()
    def _build(self, key, buf, body, dummy):
        """Program ``key``: ``body`` over ``buf`` captured on a card after
        one warm-up call on the ``dummy`` inputs (one array an input)
        whose cache writes are undone; on the CPU the body itself. The
        reference's ``_build``."""
        got = self._compiled.get(key)
        if got is not None:
            return got
        with self._lock:
            got = self._compiled.get(key)
            if got is not None:
                return got
            cache = self._owned(None)
            capture = self.capture and self.device.type == 'cuda'
            if capture and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()

            def warm():
                saved = {k: t.clone() for k, t in cache.items()}
                buf.inp.copy_(torch.as_tensor(buf.pack(
                    onp.zeros(buf.inp.numel(), 'int32'),
                    list(dummy) + [[0] * n for n in buf.sizes[len(dummy):]]),
                    device=self.device))
                body()
                for k, t in cache.items():
                    t.copy_(saved[k])
            buf.prog = Program('%s %s' % (self.name, key), body,
                               self.device if capture else None,
                               pool=self._pool, warm=warm)
            self.compile_seconds[key] = buf.prog.seconds
            self._compiled[key] = buf
        inst = _emit.serving()
        if inst is not None:
            inst.compiles.inc()
        _emit.event('serve_compile', bucket=key,
                    seconds=round(self.compile_seconds[key], 4))
        return buf

    @torch.inference_mode()
    def _run(self, key, compile_fn, cache, *arrays):
        """Load ``arrays`` (one an input) into program ``key`` (built on
        first use), run it and bring its tokens and logits back."""
        self._owned(cache)
        buf = self._compiled.get(key) or compile_fn()
        buf.load(*arrays)
        buf.prog.run()
        return buf.fetch(self.emit_logits)

    def _bucket(self, bucket):
        bucket = int(bucket)
        if bucket not in self.policy.buckets:
            raise ValueError('%d is not a prefill bucket (%s)'
                             % (bucket, list(self.policy.buckets)))
        return bucket

    def compile_prefill(self, bucket):
        """Build the prefill program of ``bucket`` (a ladder bucket):
        inputs the padded tokens, the length and the slot."""
        bucket = self._bucket(bucket)
        buf = self._buffers('prefill', (bucket, 1, 1), 1, (self.model.vocab,))
        m, p = self.model, self.params

        def body():
            ex = buf.extra_args()
            _, logits = m.prefill(p, self._cache,
                                  buf.arg(0, (1, bucket)).long(), buf.arg(1),
                                  buf.arg(2), **self._adapters(ex, True))
            buf.put(self._tokens(logits, ex), logits)
        return self._build('prefill:%d' % bucket, buf, body,
                           [[0] * bucket, [1], [0]])

    def compile_step(self):
        """Build the step program: inputs each slot's token and
        position."""
        S = self.slots
        buf = self._buffers('step', (S, S), S, (S, self.model.vocab))
        m, p = self.model, self.params

        def body():
            ex = buf.extra_args()
            _, logits = m.step(p, self._cache, buf.arg(0).long(), buf.arg(1),
                               **self._adapters(ex))
            buf.put(self._tokens(logits, ex), logits)
        return self._build('step', buf, body, [[0] * S, [0] * S])

    def warmup(self, buckets=None):
        """Build the whole ladder + the step program (server start, not
        first request): exactly ``len(ladder) + 1`` programs."""
        for b in (buckets or self.policy.buckets):
            self.compile_prefill(b)
        self.compile_step()
        return self

    # -- execution ----------------------------------------------------------

    def _prompt(self, tokens):
        tokens = onp.asarray(tokens, 'int64').reshape(-1)
        n = tokens.shape[0]
        if n < 1:
            raise ValueError('empty prompt')
        bucket = self.policy.bucket_for(n)   # ValueError when too long
        padded = onp.zeros(bucket, 'int32')
        padded[:n] = tokens
        return padded, n, bucket

    def run_prefill(self, cache, tokens, slot, **extras):
        """Pad ``tokens`` (1-D int prompt) to its bucket and land the
        prefix in ``slot``. The kwargs ``temps``, ``top_ps``, ``keys``,
        ``masks`` and ``aidx`` are the values of the program's extras (one
        row; an omitted one greedy, no mask, the base; a program without
        an extra ignores its kwarg, as the reference's does).
        Returns (cache, first_token int, logits np (V,) | None)."""
        padded, n, bucket = self._prompt(tokens)
        toks, logits = self._run(
            'prefill:%d' % bucket, lambda: self.compile_prefill(bucket),
            cache, padded, [n], [int(slot)],
            *self._extra_args('prefill', **extras))
        return self._cache, int(toks[0]), \
            None if logits is None else logits.reshape(-1)

    def run_step(self, cache, tokens, positions, **extras):
        """Advance every slot one token (the extras a row a slot). Returns
        (cache, tokens np (slots,), logits np (slots, V) | None)."""
        S = self.slots
        toks, logits = self._run(
            'step', self.compile_step, cache,
            onp.asarray(tokens).reshape(S), onp.asarray(positions).reshape(S),
            *self._extra_args('step', **extras))
        return self._cache, toks, logits

    # -- live migration (seqstate export / import) -------------------------

    @torch.inference_mode()
    def export_slot_state(self, cache, slot):
        """Host copy of slot ``slot``'s rows, keyed by cache entry name
        (one gather on the card, one copy back)."""
        cache = self._owned(cache)
        idx = torch.tensor([int(slot)], dtype=torch.int64, device=self.device)
        names = list(cache)
        rows = torch.stack([cache[k].index_select(0, idx)[0] for k in names])
        host = rows.cpu().numpy()
        return {k: host[i] for i, k in enumerate(names)}

    @torch.inference_mode()
    def import_slot_state(self, cache, state, slot):
        """Write host rows from :meth:`export_slot_state` into slot
        ``slot`` of the program's cache, in place (``cache.write_slot``).
        Raises ``ValueError`` for a missing entry or a wrong shape, before
        any write. Returns the cache."""
        cache = self._owned(cache)
        rows = []
        for name, arr in cache.items():
            if name not in state:
                raise ValueError('slot state missing cache entry %r'
                                 % (name,))
            row = onp.asarray(state[name])
            if tuple(row.shape) != tuple(arr.shape[1:]):
                raise ValueError(
                    'slot state entry %r shape %r != per-slot shape %r'
                    % (name, tuple(row.shape), tuple(arr.shape[1:])))
            rows.append(row.astype('float32', copy=False))
        dev = torch.from_numpy(onp.stack(rows)).to(self.device)
        for i, arr in enumerate(cache.values()):
            write_slot(arr, dev[i], int(slot))
        return cache

    # -- the CPU fallback (degraded serving) --------------------------------

    @torch.inference_mode()
    def fallback_generate(self, tokens, max_new, eos_id=None,
                          temperature=0.0, top_p=1.0, seed=0, ad=None,
                          on_token=None):
        """Decode ``tokens`` (the prompt and what was generated so far)
        on the CPU through a one-slot cache: a prefill, then single
        steps, through the model's plain path. The card's emission rule:
        the argmax at ``temperature`` 0, else
        :func:`~.sampling.sample_tokens` keyed by ``key_for(seed, pos)``
        of each logits row's position. ``ad`` is an adapter's 2-D host
        tree ``{target: (A, B)}`` (``AdapterRegistry.host_tree``) or None
        for the base (the model is then called without one, so a family
        without adapters serves here too). Reads the host copy of the
        parameters only: no CUDA tensor is touched. Returns up to
        ``max_new`` tokens, stopping at ``eos_id`` or the cache's end, as
        the engine does. ``on_token``,
        where given, is called with each token as it is decoded, and a
        false return ends the decode there: the engine streams a degraded
        completion through it and stops it at a cancel or a deadline."""
        tokens = [int(t) for t in onp.asarray(tokens).reshape(-1)]
        temperature = float(temperature)
        params = self._params_host
        adkw = {} if ad is None else {'ad': {
            k: (torch.as_tensor(onp.asarray(a, 'float32')),
                torch.as_tensor(onp.asarray(b, 'float32')))
            for k, (a, b) in ad.items()}}

        def pick(row, pos):
            if temperature <= 0:
                return int(torch.argmax(row))
            return int(sample_tokens(row[None], [temperature], [top_p],
                                     key_for(seed, pos)[None])[0])

        cache = init_cache(self._spec, 1, _CPU)
        cache, logits = self.model.prefill(
            params, cache, torch.tensor([tokens], dtype=torch.int64),
            len(tokens), 0, **adkw)
        tok = pick(logits, len(tokens) - 1)
        pos = len(tokens)
        out = []
        while True:
            out.append(tok)
            if on_token is not None and not on_token(tok):
                break
            if (eos_id is not None and tok == eos_id) \
                    or len(out) >= max_new or pos + 1 >= self.max_len:
                break
            cache, logits = self.model.step(
                params, cache, torch.tensor([tok], dtype=torch.int64),
                torch.tensor([pos], dtype=torch.int32), **adkw)
            tok = pick(logits[0], pos)
            pos += 1
        return out


    # -- persistence (mxnet_tpu.frozen.v1, kind=decode) ---------------------

    def save(self, path, include_programs=True):
        """Write the decode artifact, the reference's layout and manifest
        (``mxnet_tpu/serving/decode/program.py:575-639``)::

            <path>/params.npz       the parameters, float32, under the
                                    model's names
            <path>/MANIFEST.json    schema, kind=decode, the family and
                                    config, the ladder, the extras
                                    (sample_args, logit_mask, adapter),
                                    cache_bytes; a paged program its
                                    page geometry

        The parameters come from the host copy the program keeps, never
        off the card. A captured CUDA graph cannot be serialized, so
        ``include_programs`` writes nothing and ``programs`` is empty (a
        reload captures its programs at ``warmup()``); the reference's
        ``jax_version``, ``platform``, ``pallas`` and ``donate`` are left
        out, and ``torch_version`` and ``device`` (the card's name) say
        who wrote it. Every file is written atomically, the manifest
        last. Returns ``path``."""
        del include_programs
        os.makedirs(path, exist_ok=True)
        buf = io.BytesIO()
        onp.savez(buf, **{k: v.numpy() for k, v in self._params_host.items()})
        # the buffer's own bytes, not a second copy of them
        with buf.getbuffer() as view:
            atomic_write_bytes(os.path.join(path, 'params.npz'), view)
        del buf
        manifest = {
            'schema': FROZEN_SCHEMA,
            'kind': _DECODE_KIND,
            'name': self.name,
            'family': self.model.family,
            'config': self.model.config,
            'slots': self.slots,
            'prefill_buckets': list(self.policy.buckets),
            'emit_logits': self.emit_logits,
            'sample_args': self.sample_args,
            'logit_mask': self.logit_mask,
            'adapter': (None if self.adapter_spec is None
                        else self.adapter_spec.to_manifest()),
            'cache_bytes': self.cache_bytes(),
            'torch_version': torch.__version__,
            'device': (torch.cuda.get_device_name(self.device)
                       if self.device.type == 'cuda' else 'cpu'),
            'programs': {},
        }
        manifest.update(self._manifest_extra())
        atomic_write_bytes(
            os.path.join(path, 'MANIFEST.json'),
            (json.dumps(manifest, indent=1, sort_keys=True) + '\n').encode())
        return path

    def _manifest_extra(self):
        """The layout's own manifest keys (a paged program's geometry, by
        which :meth:`load` dispatches)."""
        return {}

    @classmethod
    def load(cls, path, device=None):
        """Reload a decode artifact written by either package on
        ``device`` (default cuda): a ``paged`` manifest as a
        :class:`PagedDecodeProgram`, its extras and ladders as saved. The
        weights go from the file to the device once; the CPU fallback's
        host copy is the loaded arrays themselves. Nothing is captured
        here: ``warmup()`` (the engine's start) builds the programs, and
        every key of a JAX-written ``programs`` table lands in
        ``retraced_buckets``. ``load_seconds`` on the program: ``read``
        (the manifest and the arrays into host memory) and ``to_device``
        (the program built, the weights copied to the device). Raises
        ValueError on another schema or kind."""
        t0 = time.perf_counter()
        with open(os.path.join(path, 'MANIFEST.json')) as f:
            manifest = json.load(f)
        if manifest.get('schema') != FROZEN_SCHEMA or \
                manifest.get('kind') != _DECODE_KIND:
            raise ValueError(
                'not a %s decode artifact: schema=%r kind=%r at %s'
                % (FROZEN_SCHEMA, manifest.get('schema'),
                   manifest.get('kind'), path))
        model = model_from_config(manifest['family'], manifest['config'])
        with onp.load(os.path.join(path, 'params.npz')) as z:
            params = {k: z[k] for k in z.files}
        kwargs = {}
        target = DecodeProgram
        if manifest.get('paged'):
            target = PagedDecodeProgram
            kwargs = {'page_size': manifest['page_size'],
                      'pages': manifest['pages'],
                      'spec_k': manifest.get('spec_k', 0)}
        aspec = None
        if manifest.get('adapter'):
            aspec = AdapterSpec.from_manifest(manifest['adapter'])
        t1 = time.perf_counter()
        prog = target(model, params, slots=manifest['slots'],
                      prefill_buckets=manifest['prefill_buckets'],
                      name=manifest.get('name'),
                      emit_logits=manifest.get('emit_logits', True),
                      device=device,
                      sample_args=manifest.get('sample_args', False),
                      logit_mask=manifest.get('logit_mask', False),
                      adapter_spec=aspec, **kwargs)
        prog.retraced_buckets.extend(sorted(manifest.get('programs') or {}))
        prog.load_seconds = {'read': t1 - t0,
                             'to_device': time.perf_counter() - t1}
        return prog


class PagedDecodeProgram(DecodeProgram):
    """Prefill / step / verify over a page pool plus per-sequence page
    tables (the JAX ``PagedDecodeProgram``, ``program.py:706-1046``).

      * ``run_prefill(pool, tokens, page_ids)`` writes the prompt's K/V
        page by page to the host-allocated page ids (trailing padding
        pages go to the trash page);
      * ``run_step(pool, tokens, positions, tables)`` advances every slot
        one token, its row written at ``(table[pos // page_size], pos %
        page_size)``, its keys read through its table by the paged
        decode kernel;
      * ``run_verify`` (``spec_k > 0``) scores ``spec_k + 1`` tokens a
        slot in one call, the speculative target pass;
      * ``run_copy_page`` copies one page (copy-on-write).

    Allocation, refcounts, prefix sharing and copy-on-write decisions
    live in the engine (:mod:`.paged`). ``pages`` defaults to the slot
    cache's worst case, ``slots x max_pages + 1`` (the trash page). The
    warm-ups write only the trash page. The CPU fallback
    (``fallback_generate``) is the slot program's, as in the reference:
    a degraded stream decodes through a one-slot cache, not the pool."""

    paged = True

    def __init__(self, model, params, slots=None, prefill_buckets=None,
                 name=None, emit_logits=True, device=None, page_size=None,
                 pages=None, spec_k=None, sample_args=None, logit_mask=None,
                 adapter_spec=None):
        if not getattr(model, 'supports_paging', False):
            raise TypeError('family %r does not support a paged cache; use '
                            'DecodeProgram' % (model.family,))
        super().__init__(model, params, slots=slots,
                         prefill_buckets=prefill_buckets, name=name,
                         emit_logits=emit_logits, device=device,
                         sample_args=sample_args, logit_mask=logit_mask,
                         adapter_spec=adapter_spec)
        self.page_size = int(
            page_size if page_size is not None
            else _config.get('MXNET_TPU_SERVE_PAGE_SIZE'))
        self._pspec = model.paged_spec(self.page_size)
        self.max_pages = self._pspec.max_pages
        if pages is None:
            pages = _config.get('MXNET_TPU_SERVE_PAGES') or (
                self.slots * self.max_pages + 1)
        self.pages = int(pages)
        if self.pages < 2:
            raise ValueError('pool needs >= 2 pages (page 0 is the '
                             'reserved trash page)')
        self.spec_k = int(spec_k if spec_k is not None
                          else _config.get('MXNET_TPU_SERVE_SPEC_K'))
        if self.spec_k < 0:
            raise ValueError('spec_k must be >= 0')

    # -- accounting: the pool's bytes, not slots x max_len ------------------

    def cache_bytes(self):
        """Device bytes of the page pool."""
        return pool_bytes(self._pspec, self.pages)

    def page_bytes(self):
        """Bytes one page holds across every cache entry."""
        return pool_bytes(self._pspec, 1)

    def _manifest_extra(self):
        return {'paged': True, 'page_size': self.page_size,
                'pages': self.pages, 'spec_k': self.spec_k,
                'max_pages': self.max_pages,
                'page_bytes': self.page_bytes()}

    def per_sequence_bytes(self, seq_len=None):
        """Cache bytes a sequence of ``seq_len`` tokens holds (default
        max_len, the worst case): whole pages."""
        n = self.max_len if seq_len is None else int(seq_len)
        return pages_for(n, self.page_size) * self.page_bytes()

    def _init_cache(self):
        return init_pool(self._pspec, self.pages, self.device)

    # -- programs -----------------------------------------------------------

    def compile_prefill(self, bucket):
        """Build the prefill program of ``bucket``: inputs the padded
        tokens, the length and the bucket's page ids."""
        bucket = self._bucket(bucket)
        npages = pages_for(bucket, self.page_size)
        buf = self._buffers('prefill', (bucket, 1, npages), 1,
                            (self.model.vocab,))
        m, p = self.model, self.params

        def body():
            ex = buf.extra_args()
            _, logits = m.paged_prefill(p, self._cache,
                                        buf.arg(0, (1, bucket)).long(),
                                        buf.arg(1), buf.arg(2).long(),
                                        **self._adapters(ex, True))
            buf.put(self._tokens(logits, ex), logits)
        return self._build('prefill:%d' % bucket, buf, body,
                           [[0] * bucket, [1], [TRASH_PAGE] * npages])

    def compile_step(self):
        """Build the paged step program: inputs each slot's token,
        position and page table."""
        S, P, V = self.slots, self.max_pages, self.model.vocab
        buf = self._buffers('step', (S, S, S * P), S, (S, V))
        m, p = self.model, self.params

        def body():
            ex = buf.extra_args()
            _, logits = m.paged_step(p, self._cache, buf.arg(0).long(),
                                     buf.arg(1), buf.arg(2, (S, P)),
                                     **self._adapters(ex))
            buf.put(self._tokens(logits, ex), logits)
        return self._build('step', buf, body, [[0] * S, [0] * S,
                                               [TRASH_PAGE] * (S * P)])

    def compile_verify(self):
        """Build the speculative verify program (``spec_k > 0``): inputs
        (slots, spec_k + 1) tokens, positions and tables."""
        if not self.spec_k:
            raise ValueError('verify program needs spec_k > 0')
        S, P, V, C = self.slots, self.max_pages, self.model.vocab, \
            self.spec_k + 1
        buf = self._buffers('verify', (S * C, S, S * P), S * C, (S, C, V))
        m, p = self.model, self.params

        def body():
            ex = buf.extra_args()
            _, logits = m.paged_verify(p, self._cache,
                                       buf.arg(0, (S, C)).long(), buf.arg(1),
                                       buf.arg(2, (S, P)),
                                       **self._adapters(ex))
            buf.put(self._tokens(logits, ex), logits)
        return self._build('verify:%d' % C, buf, body,
                           [[0] * (S * C), [0] * S, [TRASH_PAGE] * (S * P)])

    def compile_copy_page(self):
        """Build the copy-on-write program: inputs the source and
        destination pages."""
        buf = _Buffers(self.device, (1, 1))

        def body():
            for arr in self._cache.values():
                copy_page(arr, buf.arg(0), buf.arg(1))
        return self._build('copy', buf, body, [[TRASH_PAGE], [TRASH_PAGE]])

    def warmup(self, buckets=None):
        """Ladder + step + copy_page (+ verify under speculation): every
        program the engine can ever run, built up front."""
        for b in (buckets or self.policy.buckets):
            self.compile_prefill(b)
        self.compile_step()
        self.compile_copy_page()
        if self.spec_k:
            self.compile_verify()
        return self

    # -- execution ----------------------------------------------------------

    def run_prefill(self, pool, tokens, page_ids, **extras):
        """Pad ``tokens`` to its bucket and write its K/V into the
        host-allocated ``page_ids`` (padded with the trash page to the
        bucket's page count); the extras as the slot program takes them.
        Returns (pool, first_token int, logits np (V,) | None)."""
        padded, n, bucket = self._prompt(tokens)
        npages = pages_for(bucket, self.page_size)
        ids = list(page_ids)
        if len(ids) > npages:
            raise ValueError('%d page ids for a %d-page bucket'
                             % (len(ids), npages))
        toks, logits = self._run(
            'prefill:%d' % bucket, lambda: self.compile_prefill(bucket),
            pool, padded, [n], ids + [TRASH_PAGE] * (npages - len(ids)),
            *self._extra_args('prefill', **extras))
        return self._cache, int(toks[0]), \
            None if logits is None else logits.reshape(-1)

    def _tables(self, tables):
        return onp.asarray(tables, 'int32').reshape(self.slots,
                                                    self.max_pages)

    def run_step(self, pool, tokens, positions, tables, **extras):
        """Advance every slot one token through its page table (tokens,
        positions, tables and the extras cross to the device in one
        copy). Returns (pool, tokens np (slots,), logits np (slots, V) |
        None)."""
        toks, logits = self._run(
            'step', self.compile_step, pool,
            onp.asarray(tokens).reshape(self.slots),
            onp.asarray(positions).reshape(self.slots), self._tables(tables),
            *self._extra_args('step', **extras))
        return self._cache, toks, logits

    def run_verify(self, pool, tokens, positions, tables, **extras):
        """The speculative verify: (slots, spec_k + 1) tokens in, the
        target's token at each of them out, K/V rows written for every
        position (rejected rows stay masked until overwritten). ``keys``
        is (slots, spec_k + 1, 2), the keys of the chunk's positions; the
        other extras are a row a slot, repeated across the chunk. Returns
        (pool, tokens np (slots, spec_k + 1), logits | None)."""
        if not self.spec_k:
            raise ValueError('the verify pass needs spec_k > 0')
        C = self.spec_k + 1
        toks, logits = self._run(
            'verify:%d' % C, self.compile_verify, pool,
            onp.asarray(tokens).reshape(self.slots, C),
            onp.asarray(positions).reshape(self.slots), self._tables(tables),
            *self._extra_args('verify', **extras))
        return self._cache, toks.reshape(self.slots, C), logits

    def run_copy_page(self, pool, src, dst):
        """Copy-on-write: duplicate page ``src`` into ``dst`` in every
        pool. Returns the pool."""
        self._run('copy', self.compile_copy_page, pool, [int(src)],
                  [int(dst)])
        return self._cache

    # -- live migration (seqstate export / import) -------------------------

    @torch.inference_mode()
    def export_pages(self, pool, page_ids):
        """Host rows of ``page_ids``, keyed by cache entry name: ``{name:
        (len(page_ids) * page_size, *row)}`` float32. The pages are
        gathered on the card and only they cross to the host, in one
        copy."""
        pool = self._owned(pool)
        ids = torch.as_tensor(onp.asarray(list(page_ids), 'int64'),
                              device=self.device)
        names = list(pool)
        rows = torch.stack([pool[k].index_select(0, ids) for k in names])
        host = rows.cpu().numpy()
        n = host.shape[1] * host.shape[2]
        return {k: host[i].reshape((n,) + host.shape[3:])
                for i, k in enumerate(names)}

    @torch.inference_mode()
    def import_pages(self, pool, rows, page_ids):
        """Write host rows from :meth:`export_pages` (re-chunked to this
        program's page size, the tail page zero-padded) into ``page_ids``
        of the program's own pool, in place (``paged.write_prefill_pages``:
        the captured programs keep their addresses). ``rows[name]`` must
        be ``(len(page_ids) * page_size, *row)``; ``ValueError`` otherwise,
        before any write. Returns the pool."""
        pool = self._owned(pool)
        ids = onp.asarray(list(page_ids), 'int64')
        want = ids.shape[0] * self.page_size
        chunks = []
        for name, arr in pool.items():
            if name not in rows:
                raise ValueError('page rows missing cache entry %r' % (name,))
            chunk = onp.asarray(rows[name])
            if chunk.shape[0] != want or \
                    tuple(chunk.shape[1:]) != tuple(arr.shape[2:]):
                raise ValueError('page rows for %r are %r, want (%d, *%r)'
                                 % (name, tuple(chunk.shape), want,
                                    tuple(arr.shape[2:])))
            chunks.append(chunk.astype('float32', copy=False))
        dev = torch.from_numpy(onp.stack(chunks)).to(self.device)
        tid = torch.from_numpy(ids).to(self.device)
        for i, arr in enumerate(pool.values()):
            write_prefill_pages(arr, dev[i], tid)
        return pool


def freeze_decode(obj, params=None, slots=None, prefill_buckets=None,
                  max_len=None, name=None, emit_logits=True, paged=None,
                  page_size=None, pages=None, spec_k=None, adapter_rank=None,
                  sample_args=None, logit_mask=None, adapter_slots=None,
                  device=None):
    """Bind a decode model and its weights into a program on ``device``
    (default cuda). ``obj`` is one of:

      * a :class:`~.model.DecodeModel`, with ``params``;
      * an ``(embedding, rnn, decoder)`` triple of the port's gluon blocks
        (``nn.Embedding``, ``rnn.LSTM`` / ``GRU`` / ``RNN``, ``nn.Dense``);
      * an object with those three as ``.embedding``, ``.lstm`` or
        ``.rnn``, and ``.decoder`` (``examples/word_lm.py``'s model);

    the gluon forms through :func:`~.model.from_gluon_rnn_lm`, their cache
    length ``max_len`` (``MXNET_TPU_SERVE_MAX_SEQ_LEN``). The program is a
    :class:`PagedDecodeProgram` when ``paged`` (None:
    ``MXNET_TPU_SERVE_PAGED``, default True, for a family that supports
    paging, so an RNN keeps the slot cache), else a slot-cache
    :class:`DecodeProgram`. ``page_size`` / ``pages`` / ``spec_k``
    configure the pool and the speculative verify
    (``MXNET_TPU_SERVE_PAGE_SIZE`` / ``_PAGES`` / ``_SPEC_K``).

    ``adapter_rank`` > 0 (``MXNET_TPU_SERVE_ADAPTER_RANK``) builds an
    adapter pool of ``adapter_slots`` rows (``MXNET_TPU_SERVE_ADAPTER_SLOTS``,
    the base row included) into every program, for a family with
    ``lora_targets``; ``sample_args`` / ``logit_mask`` (None: their knobs,
    sampling on by default) choose the sampling inputs (see
    :class:`DecodeProgram`). With a DecodeModel, ``max_len``, if given,
    must equal the model's (the cache length is the model's max_len).
    Anything else raises TypeError.
    """
    if isinstance(obj, DecodeModel):
        if params is None:
            raise ValueError('params required when freezing a DecodeModel')
        model = obj
    else:
        if isinstance(obj, tuple) and len(obj) == 3:
            embedding, rnn, decoder = obj
        else:
            embedding = getattr(obj, 'embedding', None)
            rnn = getattr(obj, 'lstm', None) or getattr(obj, 'rnn', None)
            decoder = getattr(obj, 'decoder', None)
            if embedding is None or rnn is None or decoder is None:
                raise TypeError(
                    'cannot freeze %r for decoding: need a DecodeModel + '
                    'params, an (embedding, rnn, decoder) gluon triple, or '
                    'an object with those attributes' % (type(obj).__name__,))
        if max_len is None:
            max_len = _config.get('MXNET_TPU_SERVE_MAX_SEQ_LEN')
        model, params = from_gluon_rnn_lm(embedding, rnn, decoder,
                                          max_len=int(max_len))
    if adapter_rank is None:
        adapter_rank = _config.get('MXNET_TPU_SERVE_ADAPTER_RANK') or 0
    adapter_spec = None
    if adapter_rank > 0:
        if not hasattr(model, 'lora_targets'):
            raise TypeError('family %r has no LoRA targets: adapter_rank > 0 '
                            'needs a model exposing lora_targets()'
                            % (model.family,))
        if adapter_slots is None:
            adapter_slots = _config.get('MXNET_TPU_SERVE_ADAPTER_SLOTS')
        adapter_spec = AdapterSpec.for_model(model, int(adapter_rank),
                                             int(adapter_slots))
    if max_len is not None and int(max_len) != model.max_len:
        raise ValueError('max_len %d differs from the model\'s %d (the '
                         'slot cache length is the model\'s max_len)'
                         % (int(max_len), model.max_len))
    if paged is None:
        paged = bool(_config.get('MXNET_TPU_SERVE_PAGED')) \
            and model.supports_paging
    if paged:
        return PagedDecodeProgram(
            model, params, slots=slots, prefill_buckets=prefill_buckets,
            name=name, emit_logits=emit_logits, device=device,
            page_size=page_size, pages=pages, spec_k=spec_k,
            sample_args=sample_args, logit_mask=logit_mask,
            adapter_spec=adapter_spec)
    return DecodeProgram(model, params, slots=slots,
                         prefill_buckets=prefill_buckets, name=name,
                         emit_logits=emit_logits, device=device,
                         sample_args=sample_args, logit_mask=logit_mask,
                         adapter_spec=adapter_spec)


def load_decode(path, device=None):
    """:meth:`DecodeProgram.load` (the reference's module-level alias)."""
    return DecodeProgram.load(path, device=device)

"""DecodeProgram: a decode model bound to its weights, a prompt-length
bucket ladder and a preallocated slot cache on one device, and
PagedDecodeProgram over a page pool. The port of
``mxnet_tpu/serving/decode/program.py`` (greedy decoding).

Two calls serve generation:

  * :meth:`DecodeProgram.run_prefill` pads a prompt to its bucket, runs
    the whole-prompt pass, lands the KV prefix in one cache slot and
    returns the first generated token (greedy argmax);
  * :meth:`DecodeProgram.run_step` advances every slot one token.

:class:`PagedDecodeProgram` takes page ids and page tables in their
place, and adds ``run_verify`` (speculative decoding) and
``run_copy_page`` (copy-on-write). ``freeze_decode`` pages a transformer
by default, as the JAX package does.

PyTorch runs eagerly, so there is nothing to trace or compile ahead of
time: the JAX package's AOT compile, artifact save/load and CPU fallback
have no counterpart here yet (ROADMAP queue A).
"""
from __future__ import annotations

import numpy as onp
import torch

from ... import config as _config
from ...context import resolve_device
from ..bucket import BucketPolicy, default_buckets
from .cache import cache_bytes, init_cache
from .model import DecodeModel
from .paged import TRASH_PAGE, copy_page, init_pool, pages_for, pool_bytes

__all__ = ['DecodeProgram', 'PagedDecodeProgram', 'freeze_decode']


def _as_param(value, device):
    if isinstance(value, torch.Tensor):
        return value.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(onp.asarray(value, dtype='float32'),
                           device=device)


class DecodeProgram:
    """Prefill/step over a slot cache for one decode model.

    ``params`` is a ``{name: ndarray | tensor}`` dict under the model's
    names (a JAX model's weights carry over as they are). ``device``
    defaults to ``cuda`` and raises without it; ``device='cpu'`` runs the
    plain PyTorch versions of the kernels. ``emit_logits`` returns each
    call's logits to the host beside the tokens, as the JAX default does.
    """

    paged = False

    def __init__(self, model, params, slots=None, prefill_buckets=None,
                 name=None, emit_logits=True, device=None):
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
        self.params = {k: _as_param(v, self.device)
                       for k, v in params.items()}
        model.check_params(self.params)
        self._spec = model.cache_spec()
        self.emit_logits = bool(emit_logits)

    @property
    def prefill_buckets(self):
        return self.policy.buckets

    def cache_bytes(self):
        """Device bytes of the slot cache (slots x max_len rows)."""
        return cache_bytes(self._spec, self.slots)

    def per_sequence_bytes(self, seq_len=None):
        """Cache bytes one sequence reserves: its whole slot, whatever its
        length (the memory wall the paged cache breaks)."""
        del seq_len
        return cache_bytes(self._spec, 1)

    def new_cache(self):
        """Fresh zero-filled cache for ``slots`` sequences."""
        return init_cache(self._spec, self.slots, self.device)

    def max_prompt_len(self):
        return self.policy.max_batch

    @torch.inference_mode()
    def run_prefill(self, cache, tokens, slot):
        """Pad ``tokens`` (1-D int prompt) to its bucket and land the
        prefix in ``slot``. Returns (cache, first_token int, logits np
        (V,) | None)."""
        tokens = onp.asarray(tokens, 'int64').reshape(-1)
        n = tokens.shape[0]
        if n < 1:
            raise ValueError('empty prompt')
        bucket = self.policy.bucket_for(n)   # ValueError when too long
        padded = onp.zeros((1, bucket), 'int64')
        padded[0, :n] = tokens
        cache, logits = self.model.prefill(
            self.params, cache, torch.as_tensor(padded, device=self.device),
            n, int(slot))
        tok = int(torch.argmax(logits))
        return cache, tok, \
            logits.cpu().numpy() if self.emit_logits else None

    @torch.inference_mode()
    def run_step(self, cache, tokens, positions):
        """Advance every slot one token. Returns (cache, tokens np
        (slots,), logits np (slots, V) | None)."""
        tokens = torch.as_tensor(
            onp.asarray(tokens, 'int64').reshape(self.slots),
            device=self.device)
        positions = torch.as_tensor(
            onp.asarray(positions, 'int32').reshape(self.slots),
            device=self.device)
        cache, logits = self.model.step(self.params, cache, tokens,
                                        positions)
        toks = torch.argmax(logits, dim=-1).cpu().numpy().astype('int32')
        return cache, toks, \
            logits.cpu().numpy() if self.emit_logits else None


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
    cache's worst case, ``slots x max_pages + 1`` (the trash page)."""

    paged = True

    def __init__(self, model, params, slots=None, prefill_buckets=None,
                 name=None, emit_logits=True, device=None, page_size=None,
                 pages=None, spec_k=None):
        if not getattr(model, 'supports_paging', False):
            raise TypeError('family %r does not support a paged cache; use '
                            'DecodeProgram' % (model.family,))
        super().__init__(model, params, slots=slots,
                         prefill_buckets=prefill_buckets, name=name,
                         emit_logits=emit_logits, device=device)
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

    def per_sequence_bytes(self, seq_len=None):
        """Cache bytes a sequence of ``seq_len`` tokens holds (default
        max_len, the worst case): whole pages."""
        n = self.max_len if seq_len is None else int(seq_len)
        return pages_for(n, self.page_size) * self.page_bytes()

    def new_cache(self):
        """Fresh zero-filled page pool."""
        return init_pool(self._pspec, self.pages, self.device)

    def _slot_ints(self, *arrays):
        """Host int32 arrays -> device int32 tensors in ONE copy: each
        array padded to a multiple of four elements (16-byte aligned
        views of one buffer)."""
        flat = [onp.asarray(a, 'int32').reshape(-1) for a in arrays]
        sizes = [-(-f.size // 4) * 4 for f in flat]
        buf = onp.zeros(sum(sizes), 'int32')
        at = 0
        for f, n in zip(flat, sizes):
            buf[at:at + f.size] = f
            at += n
        dev = torch.as_tensor(buf, device=self.device)
        out, at = [], 0
        for a, f, n in zip(arrays, flat, sizes):
            out.append(dev[at:at + f.size].view(onp.shape(a)))
            at += n
        return out

    @torch.inference_mode()
    def run_prefill(self, pool, tokens, page_ids):
        """Pad ``tokens`` to its bucket and write its K/V into the
        host-allocated ``page_ids`` (padded with the trash page to the
        bucket's page count). Returns (pool, first_token int, logits np
        (V,) | None)."""
        tokens = onp.asarray(tokens, 'int64').reshape(-1)
        n = tokens.shape[0]
        if n < 1:
            raise ValueError('empty prompt')
        bucket = self.policy.bucket_for(n)   # ValueError when too long
        npages = pages_for(bucket, self.page_size)
        ids = list(page_ids)
        if len(ids) > npages:
            raise ValueError('%d page ids for a %d-page bucket'
                             % (len(ids), npages))
        padded = onp.zeros((1, bucket), 'int32')
        padded[0, :n] = tokens
        toks, ids_t = self._slot_ints(
            padded, ids + [TRASH_PAGE] * (npages - len(ids)))
        pool, logits = self.model.paged_prefill(
            self.params, pool, toks.long(), n, ids_t.long())
        tok = int(torch.argmax(logits))
        return pool, tok, \
            logits.cpu().numpy() if self.emit_logits else None

    def _tables(self, tables):
        return onp.asarray(tables, 'int32').reshape(self.slots,
                                                    self.max_pages)

    @torch.inference_mode()
    def run_step(self, pool, tokens, positions, tables):
        """Advance every slot one token through its page table (tokens,
        positions and tables cross to the device in one copy). Returns
        (pool, tokens np (slots,), logits np (slots, V) | None)."""
        toks, pos, tabs = self._slot_ints(
            onp.asarray(tokens).reshape(self.slots),
            onp.asarray(positions).reshape(self.slots), self._tables(tables))
        pool, logits = self.model.paged_step(self.params, pool, toks.long(),
                                             pos, tabs)
        out = torch.argmax(logits, dim=-1).cpu().numpy().astype('int32')
        return pool, out, \
            logits.cpu().numpy() if self.emit_logits else None

    @torch.inference_mode()
    def run_verify(self, pool, tokens, positions, tables):
        """The speculative verify: (slots, spec_k + 1) tokens in, the
        target's greedy token at each of them out, K/V rows written for
        every position (rejected rows stay masked until overwritten).
        Returns (pool, tokens np (slots, spec_k + 1), logits | None)."""
        if not self.spec_k:
            raise ValueError('the verify pass needs spec_k > 0')
        toks, pos, tabs = self._slot_ints(
            onp.asarray(tokens).reshape(self.slots, self.spec_k + 1),
            onp.asarray(positions).reshape(self.slots), self._tables(tables))
        pool, logits = self.model.paged_verify(self.params, pool,
                                               toks.long(), pos, tabs)
        out = torch.argmax(logits, dim=-1).cpu().numpy().astype('int32')
        return pool, out, \
            logits.cpu().numpy() if self.emit_logits else None

    @torch.inference_mode()
    def run_copy_page(self, pool, src, dst):
        """Copy-on-write: duplicate page ``src`` into ``dst`` in every
        pool. Returns the pool."""
        for arr in pool.values():
            copy_page(arr, src, dst)
        return pool


def freeze_decode(model, params=None, slots=None, prefill_buckets=None,
                  max_len=None, name=None, emit_logits=True, paged=None,
                  page_size=None, pages=None, spec_k=None, adapter_rank=None,
                  sample_args=None, logit_mask=None, device=None):
    """Bind a :class:`~.model.DecodeModel` and its ``params`` into a
    program on ``device`` (default cuda): a :class:`PagedDecodeProgram`
    when ``paged`` (None: ``MXNET_TPU_SERVE_PAGED``, default True, for a
    family that supports paging), else a slot-cache
    :class:`DecodeProgram`. ``page_size`` / ``pages`` / ``spec_k``
    configure the pool and the speculative verify
    (``MXNET_TPU_SERVE_PAGE_SIZE`` / ``_PAGES`` / ``_SPEC_K``).

    The port decodes greedily. Asking for what it does not serve yet
    raises ``NotImplementedError`` naming the ROADMAP item, rather than
    serving another configuration: ``adapter_rank`` (LoRA adapters), or
    ``sample_args`` / ``logit_mask`` (sampling). ``max_len``, if given,
    must equal the model's (the cache length is the model's max_len).
    """
    if not isinstance(model, DecodeModel):
        raise TypeError('freeze_decode takes a DecodeModel + params; '
                        'freezing gluon RNN blocks waits for the RNN-LM '
                        'family (ROADMAP)')
    if params is None:
        raise ValueError('params required when freezing a DecodeModel')
    if adapter_rank:
        raise NotImplementedError(
            'LoRA adapters are not ported yet (ROADMAP: "LoRA adapters")')
    if sample_args or logit_mask:
        raise NotImplementedError(
            'sampled decoding is not ported yet (ROADMAP: "sampling on a '
            'torch.Generator"); the port decodes greedily')
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
            page_size=page_size, pages=pages, spec_k=spec_k)
    return DecodeProgram(model, params, slots=slots,
                         prefill_buckets=prefill_buckets, name=name,
                         emit_logits=emit_logits, device=device)
